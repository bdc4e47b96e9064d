// K2 with a Henyey-Greenstein phase (baked g or diff_g) in an analytic
// density field, with or without traced field parameters. The kernel is in
// csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_field_hg(const void* params, const void* pvec, const void* seed,
                                     int base, int n_lanes, void* out, void* stream) {
  return vpt_diff::launch_fwd<true, true>(params, pvec, seed, base, n_lanes, out, stream);
}
