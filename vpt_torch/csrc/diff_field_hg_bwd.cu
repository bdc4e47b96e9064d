// K3 with a Henyey-Greenstein phase (baked g or diff_g: the g slot's
// pathwise NEE term and deferred phase-draw scores) in an analytic density
// field, with or without traced field parameters. The kernel is in
// csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_bwd_field_hg(const void* params, const void* pvec, const void* seed,
                                     int base, int n_lanes, const void* gbar, void* partials,
                                     void* per_lane, void* stream) {
  return vpt_diff::launch_bwd<true, true>(params, pvec, seed, base, n_lanes, gbar, partials,
                                          per_lane, stream);
}
