// K1 in a voxel-grid density field, clamped equi-angular distance sampling
// without NEE (implicit_equiangular). The kernel is in
// csrc/wavefront_kernel.cuh, the grid code in csrc/grid.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_GRID_ENTRY(vpt_wavefront_eac_implicit_grid, false, vpt::kEaClamped)
