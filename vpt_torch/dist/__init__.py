"""Training on the port's kernels (counterpart of ``vpt/dist``): the
kernel train step, fit_kernel and the multi-view trainer fit_multiview on
the differentiable pair, the geometric trainers fit_geom (dual tangents)
and fit_geom_fd (CRN finite differences) on the dual kernel, adam() with
per-leaf rates and schedules (train_fast.py), and the parameter domains
(train.py). Meshes, sharded rendering and the sharded steps are ROADMAP
Queue 1 item 8; the engine SPMD step is item 9.
"""
from .train import project_params
from .train_fast import (adam, exponential_decay, fit_geom, fit_geom_fd,
                         fit_kernel, fit_multiview, make_fd_geom_train_step,
                         make_geom_train_step, make_kernel_train_step,
                         make_multiview_train_step)

__all__ = ["project_params", "adam", "exponential_decay",
           "make_kernel_train_step", "fit_kernel",
           "make_multiview_train_step", "fit_multiview",
           "make_geom_train_step", "fit_geom", "make_fd_geom_train_step",
           "fit_geom_fd"]
