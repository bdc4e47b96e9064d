// K2 with the extended estimators in a voxel grid (equi-angular, the
// implicit and physical estimators, an HG phase). The kernel is in
// csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

extern "C" int vpt_diff_fwd_grid_ext(const void* params, const void* pvec, const void* seed,
                                     int base, int n_lanes, void* out, const void* tab,
                                     void* stream) {
  return vpt_diff::launch_ext_fwd<vpt::kGridField>(params, pvec, seed, base, n_lanes, out, tab,
                                                   stream);
}
