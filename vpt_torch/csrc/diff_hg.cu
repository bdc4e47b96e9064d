// K2 and K3 with a Henyey-Greenstein phase in a homogeneous medium: the
// scene's baked g != 0, or the traced diff_g (its slot IG = 2 + 6S), a
// runtime mode of one instantiation. The kernels are in
// csrc/diff_kernel.cuh, the HG branches in csrc/diff_path.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_hg(const void* params, const void* pvec, const void* seed,
                               int base, int n_lanes, void* out, void* stream) {
  return vpt_diff::launch_fwd<false, true>(params, pvec, seed, base, n_lanes, out, stream);
}

extern "C" int vpt_diff_bwd_hg(const void* params, const void* pvec, const void* seed,
                               int base, int n_lanes, const void* gbar, void* partials,
                               void* per_lane, void* stream) {
  return vpt_diff::launch_bwd<false, true>(params, pvec, seed, base, n_lanes, gbar, partials,
                                           per_lane, stream);
}
