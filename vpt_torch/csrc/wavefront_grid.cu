// K1 in a voxel-grid density field, free-flight distance sampling with NEE
// (explicit_free, iterative_vpt_free, explicit_free_physical). The kernel is in
// csrc/wavefront_kernel.cuh, the grid code in csrc/grid.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_GRID_ENTRY(vpt_wavefront_free_nee_grid, true, vpt::kFree)
