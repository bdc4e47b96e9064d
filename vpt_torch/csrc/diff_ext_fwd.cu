// K2 with the extended estimators in a homogeneous medium: equi-angular
// distances, the implicit and physical estimators, material-3 shells, any
// phase. The kernel is in csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_ext(const void* params, const void* pvec, const void* seed,
                                int base, int n_lanes, void* out, void* stream) {
  return vpt_diff::launch_ext_fwd<vpt::kHomogeneous>(params, pvec, seed, base, n_lanes, out,
                                                     nullptr, stream);
}
