// K1, free-flight distance sampling without NEE (implicit_free,
// implicit_free_physical). The kernel is in csrc/wavefront_kernel.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_ENTRY(vpt_wavefront_free_implicit, false, vpt::kFree, false)
