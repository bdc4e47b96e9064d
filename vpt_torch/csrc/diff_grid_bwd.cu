// K3 in a voxel-grid density field: the replay with the grid's sigma scores
// and transmittances and, with diff_grid, vpt's two-phase replay per sample
// and the voxel scatter. The kernel is in csrc/diff_kernel.cuh.
#include "diff_kernel.cuh"

namespace vpt_diff {

// The bytes of dynamic shared memory a grid K3 uses for a grid of T voxels:
// T floats when they fit this device's opt-in limit beside the kernel's
// static shared memory, else 0 (global atomics)
static int grid_shared_bytes(int T) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, grid_bwd_kernel<vpt::kGridField>) != cudaSuccess) return 0;
  const size_t need = (size_t)T * sizeof(float);
  return need + attr.sharedSizeBytes <= (size_t)optin ? (int)need : 0;
}

// As launch_bwd, plus tab (the packed table) and ggrid: NULL, or with
// D.diff_grid device float32[T] the voxel gradient, which this adds to
static int launch_grid_bwd(const void* params, const void* pvec, const void* seed,
                           const void* gbar, void* partials, void* per_lane, const void* tab,
                           void* ggrid, void* stream) {
  DiffParams D;
  if (!read_grid_params(params, D) || tab == nullptr || (D.diff_grid != 0) != (ggrid != nullptr))
    return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  const int T = D.base.grid.n[0] * D.base.grid.n[1] * D.base.grid.n[2];
  const int smem = ggrid != nullptr ? grid_shared_bytes(T) : 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(grid_bwd_kernel<vpt::kGridField>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  grid_bwd_kernel<vpt::kGridField><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (const float*)gbar, (float*)partials,
      (float*)per_lane, (const uint32_t*)tab, (float*)ggrid, smem > 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace vpt_diff

extern "C" int vpt_diff_bwd_grid(const void* params, const void* pvec, const void* seed,
                                 const void* gbar, void* partials, void* per_lane,
                                 const void* tab, void* ggrid, void* stream) {
  return vpt_diff::launch_grid_bwd(params, pvec, seed, gbar, partials, per_lane, tab, ggrid,
                                   stream);
}

// the dynamic shared memory K3 takes for a grid of T voxels (0: it adds
// the voxel terms to global memory directly)
extern "C" int vpt_diff_grid_shared_bytes(int T) { return vpt_diff::grid_shared_bytes(T); }
