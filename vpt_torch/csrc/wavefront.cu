// K1, free-flight distance sampling with NEE: the main path's instantiation
// (explicit_free, iterative_vpt_free, explicit_free_physical), and the C
// helpers the wrappers share. The kernel is in csrc/wavefront_kernel.cuh.
#include "wavefront_kernel.cuh"

VPT_WAVEFRONT_ENTRY(vpt_wavefront_free_nee, true, vpt::kFree, false)

extern "C" int vpt_params_words(void) { return (int)(sizeof(VptParams) / 4); }

extern "C" const char* vpt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
