// K3 with the extended estimators in an analytic density field. The kernel
// is in csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_bwd_field_ext(const void* params, const void* pvec, const void* seed,
                                      int base, int n_lanes, const void* gbar, void* partials,
                                      void* per_lane, void* stream) {
  return vpt_diff::launch_ext_bwd<vpt::kAnalytic>(params, pvec, seed, base, n_lanes, gbar, partials,
                                                  per_lane, nullptr, nullptr, stream);
}
