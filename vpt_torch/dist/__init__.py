"""Training and multi-rank rendering on the port's kernels (counterpart of
``vpt/dist``): the kernel train step, fit_kernel and the multi-view trainer
fit_multiview on the differentiable pair, the geometric trainers fit_geom
(dual tangents) and fit_geom_fd (CRN finite differences) on the dual
kernel, adam() with per-leaf rates and schedules (train_fast.py), voxel
tomography (make_grid_train_step, fit_grid: tomography.py), the parameter
domains (train.py); the (data, sample) mesh over torch.distributed ranks
(mesh.py, multihost.py), sharded rendering (sharded.py, sharded_pallas.py)
and the two sharded train steps (train_fast.py). vpt's engine SPMD step
(make_train_step, fit) is ROADMAP Queue 1 item 9.
"""
from .mesh import DATA_AXIS, SAMPLE_AXIS, make_mesh, mesh_shape_for
from .sharded import render_sharded
from .tomography import fit_grid, make_grid_train_step
from .train import project_params
from .train_fast import (adam, exponential_decay, fit_geom, fit_geom_fd,
                         fit_kernel, fit_multiview, make_fd_geom_train_step,
                         make_geom_train_step, make_kernel_train_step,
                         make_multiview_train_step,
                         make_sharded_fd_geom_train_step,
                         make_sharded_kernel_train_step)

__all__ = ["DATA_AXIS", "SAMPLE_AXIS", "make_mesh", "mesh_shape_for",
           "render_sharded", "project_params", "adam", "exponential_decay",
           "make_kernel_train_step", "fit_kernel",
           "make_multiview_train_step", "fit_multiview",
           "make_geom_train_step", "fit_geom", "make_fd_geom_train_step",
           "fit_geom_fd", "make_sharded_kernel_train_step",
           "make_sharded_fd_geom_train_step", "make_grid_train_step",
           "fit_grid"]
