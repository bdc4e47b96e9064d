// K2 in a voxel-grid density field, the table baked from the scene or
// rebuilt from the traced "grid" leaf. The kernel is in csrc/diff_kernel.cuh,
// the grid code in csrc/grid.cuh.
#include "diff_kernel.cuh"

namespace vpt_diff {

static int launch_grid_fwd(const void* params, const void* pvec, const void* seed, void* out,
                           const void* tab, void* stream) {
  DiffParams D;
  if (!read_grid_params(params, D) || tab == nullptr) return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  grid_fwd_kernel<vpt::kGridField><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (float*)out, (const uint32_t*)tab);
  return (int)cudaGetLastError();
}

}  // namespace vpt_diff

extern "C" int vpt_diff_fwd_grid(const void* params, const void* pvec, const void* seed,
                                 void* out, const void* tab, void* stream) {
  return vpt_diff::launch_grid_fwd(params, pvec, seed, out, tab, stream);
}
