// K2 in an analytic density field (foggy_cornell, blob_cloud; the fog
// falloff or the blob rows traced or not). The kernel is in
// csrc/diff_kernel.cuh, the field code in csrc/field.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_field(const void* params, const void* pvec, const void* seed,
                                  void* out, void* stream) {
  return vpt_diff::launch_fwd<true>(params, pvec, seed, out, stream);
}
