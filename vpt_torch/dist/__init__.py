"""Training on the port's kernels (counterpart of ``vpt/dist``). So far:
the kernel train step and fit_kernel on the differentiable pair, the
geometric trainers fit_geom (dual tangents) and fit_geom_fd (CRN finite
differences) on the dual kernel (train_fast.py), and the parameter domains
(train.py). Multi-view training is ROADMAP Queue 1 item 5; meshes, sharded
rendering and the sharded steps are item 8; the engine SPMD step is item 9.
"""
from .train import project_params
from .train_fast import (exponential_decay, fit_geom, fit_geom_fd,
                         fit_kernel, make_fd_geom_train_step,
                         make_geom_train_step, make_kernel_train_step)

__all__ = ["project_params", "make_kernel_train_step", "fit_kernel",
           "exponential_decay", "make_geom_train_step", "fit_geom",
           "make_fd_geom_train_step", "fit_geom_fd"]
