"""Training on the differentiable render pair (counterpart of
``vpt/dist``). So far: the kernel train step and fit_kernel
(train_fast.py) and the parameter domains (train.py). Meshes, sharded
rendering and the sharded steps are ROADMAP Queue 1 item 8; the engine SPMD
step is item 9.
"""
from .train import project_params
from .train_fast import fit_kernel, make_kernel_train_step

__all__ = ["project_params", "make_kernel_train_step", "fit_kernel"]
