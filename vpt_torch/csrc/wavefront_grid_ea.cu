// K1 in a voxel-grid density field, equi-angular distance sampling with NEE
// (explicit_equiangular, mis_hybrid). The kernel is in
// csrc/wavefront_kernel.cuh, the grid code in csrc/grid.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_GRID_ENTRY(vpt_wavefront_ea_nee_grid, true, vpt::kEquiangular)
