// K1 in an analytic density field, equi-angular distance sampling with NEE
// (explicit_equiangular, mis_hybrid). The kernel is in
// csrc/wavefront_kernel.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_ENTRY(vpt_wavefront_ea_nee_field, true, vpt::kEquiangular, true)
