// K2 and K3, the differentiable pair, in a homogeneous medium, and the C
// helpers of the pair's wrappers. The kernels are in csrc/diff_kernel.cuh;
// the field instantiations in csrc/diff_field_fwd.cu and diff_field_bwd.cu.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_params_words(void) { return (int)(sizeof(DiffParams) / 4); }

extern "C" int vpt_diff_block_threads(void) { return vpt_diff::kThreads; }

extern "C" int vpt_diff_fwd(const void* params, const void* pvec, const void* seed, void* out,
                            void* stream) {
  return vpt_diff::launch_fwd<false>(params, pvec, seed, out, stream);
}

extern "C" int vpt_diff_bwd(const void* params, const void* pvec, const void* seed,
                            const void* gbar, void* partials, void* per_lane, void* stream) {
  return vpt_diff::launch_bwd<false>(params, pvec, seed, gbar, partials, per_lane, stream);
}
