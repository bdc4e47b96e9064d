// K3 with the extended estimators in a voxel grid; with diff_grid under
// equi-angular sampling the Bernoulli voxel scores and the medium factor's
// value chains (T's forward or reversed march, 1/pSuccess, the trilinear
// sigma_s(xt) scatter) join the two-phase replay's scatter. The kernel is in
// csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_bwd_grid_ext(const void* params, const void* pvec, const void* seed,
                                     int base, int n_lanes, const void* gbar, void* partials,
                                     void* per_lane, const void* tab, void* ggrid, void* stream) {
  return vpt_diff::launch_ext_bwd<vpt::kGridField>(params, pvec, seed, base, n_lanes, gbar,
                                                   partials, per_lane, tab, ggrid, stream);
}

// the dynamic shared memory this K3 takes for a grid of T voxels (0: it
// adds the voxel terms to global memory directly)
extern "C" int vpt_diff_grid_ext_shared_bytes(int T) {
  return vpt_diff::ext_shared_bytes<vpt::kGridField>(T);
}
