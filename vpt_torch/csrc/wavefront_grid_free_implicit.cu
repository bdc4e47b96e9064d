// K1 in a voxel-grid density field, free-flight distance sampling without
// NEE (implicit_free, implicit_free_physical). The kernel is in
// csrc/wavefront_kernel.cuh, the grid code in csrc/grid.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_GRID_ENTRY(vpt_wavefront_free_implicit_grid, false, vpt::kFree)
