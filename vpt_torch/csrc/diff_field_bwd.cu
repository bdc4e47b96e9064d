// K3 in an analytic density field, with the deferred field-parameter pairs
// of diff_field (1 slot) or diff_blobs (5K slots). The kernel is in
// csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_bwd_field(const void* params, const void* pvec, const void* seed,
                                  int base, int n_lanes, const void* gbar, void* partials,
                                  void* per_lane, void* stream) {
  return vpt_diff::launch_bwd<true>(params, pvec, seed, base, n_lanes, gbar, partials,
                                    per_lane, stream);
}
