// K2 with the extended estimators in an analytic density field, with or
// without traced field parameters (equi-angular: the field's Bernoulli
// scores and deferred medium terms). The kernel is in csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_field_ext(const void* params, const void* pvec, const void* seed,
                                      int base, int n_lanes, void* out, void* stream) {
  return vpt_diff::launch_ext_fwd<vpt::kAnalytic>(params, pvec, seed, base, n_lanes, out, nullptr,
                                                  stream);
}
