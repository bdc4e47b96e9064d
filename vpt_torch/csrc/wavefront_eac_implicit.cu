// K1, clamped equi-angular distance sampling without NEE
// (implicit_equiangular). The kernel is in csrc/wavefront_kernel.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_ENTRY(vpt_wavefront_eac_implicit, false, vpt::kEaClamped)
