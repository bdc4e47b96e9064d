// Differentiable render pair for Hopper (sm_90a): the forward K2 and its
// single-replay backward K3, one thread per pixel.
//
// Replaces the Pallas TPU kernels of vpt/kernels/diff.py: make_kernel
// (grads=False) launched by run_fwd, and make_kernel(grads=True) launched by
// run_bwd (diff.py:284-1336). As in csrc/wavefront.cu, each thread owns one
// pixel and leaves its loop when its own samples are done; vpt's lockstep
// tile gives the same per-pixel values (csrc/diff_path.cuh has the per-path
// code and the parity rules).
//
// The parameter vector pvec (float32[P], P = 2 + 6S) lives in device memory,
// so a training step never copies parameters to the host or synchronises;
// each block stages it in shared memory once. Geometry, camera and estimator
// constants ride in the by-value __grid_constant__ DiffParams.
//
// K3 writes no per-pixel gradient: each thread folds its own path terms into
// a P-vector, and the block reduces the 128 vectors deterministically (warp
// shuffles in a fixed tree, then the 4 warp sums in order) into one row of
// partials[n_blocks, P]. The wrapper sums the rows in torch, as vpt sums its
// per-tile rows outside the kernel (diff.py:1336). No float atomics, so the
// gradient is the same from run to run.
//
// What bounds them on this card: arithmetic and divergence, as for K1. K2
// reads 4P bytes and writes 12 bytes per pixel; K3 reads the 12-byte
// cotangent of each pixel and writes 4P bytes per block. K3 carries its
// accumulators (the packed vector and the deferred lambert pairs, indexed
// by sphere id) in per-thread arrays in local memory.
//
// Simple on purpose: no path-state compaction, no accumulators kept in
// registers by specialising on the scene, no persistent blocks. Those are
// later work, measured against this version.
#include <cuda_runtime.h>

#include "diff_path.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ void stage_params(const DiffParams& D, const float* __restrict__ pvec,
                                             float* pv) {
  for (int k = threadIdx.x; k < D.n_params; k += kThreads) pv[k] = pvec[k];
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
    vpt_diff_fwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                        const int* __restrict__ seed, float* __restrict__ out) {
  __shared__ float pv[VPT_MAX_PARAMS];
  stage_params(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  if (pixel >= npix) return;
  float L[3];
  vpt::diff_pixel<false>(D, pv, pixel, seed[0], nullptr, L, nullptr);
  out[3 * pixel + 0] = L[0];
  out[3 * pixel + 1] = L[1];
  out[3 * pixel + 2] = L[2];
}

__global__ void __launch_bounds__(kThreads)
    vpt_diff_bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                        const int* __restrict__ seed, const float* __restrict__ gbar,
                        float* __restrict__ partials, float* __restrict__ per_lane) {
  __shared__ float pv[VPT_MAX_PARAMS];
  __shared__ float warp_sum[kWarps][VPT_MAX_PARAMS];
  stage_params(D, pvec, pv);
  const int P = D.n_params;
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  float g[VPT_MAX_PARAMS];
  if (pixel < npix) {
    vpt::diff_pixel<true>(D, pv, pixel, seed[0], gbar + 3 * pixel, nullptr, g);
    if (per_lane != nullptr)
      for (int k = 0; k < P; ++k) per_lane[(size_t)pixel * P + k] = g[k];
  } else {
    for (int k = 0; k < P; ++k) g[k] = 0.0f;
  }
  // every thread of the block reaches the reduction
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int k = 0; k < P; ++k) {
    float v = g[k];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) warp_sum[warp][k] = v;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < P; k += kThreads) {
    float s = warp_sum[0][k];
    for (int w = 1; w < kWarps; ++w) s += warp_sum[w][k];
    partials[(size_t)blockIdx.x * P + k] = s;
  }
}

bool read_params(const void* params, DiffParams& D) {
  memcpy(&D, params, sizeof D);
  return D.n_params > 0 && D.n_params <= VPT_MAX_PARAMS &&
         D.n_params == 2 + 6 * D.base.n_spheres;
}

}  // namespace

extern "C" int vpt_diff_params_words(void) { return (int)(sizeof(DiffParams) / 4); }

extern "C" int vpt_diff_block_threads(void) { return kThreads; }

// params: host pointer to a DiffParams (copied into the launch);
// pvec: device float32[P]; seed: device int32[1]; out: device float32[npix * 3]
// (radiance sums over the samples; the wrapper divides by spp).
// Returns cudaGetLastError() right after the launch; does not synchronise.
extern "C" int vpt_diff_fwd(const void* params, const void* pvec, const void* seed, void* out,
                            void* stream) {
  DiffParams D;
  if (!read_params(params, D)) return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  vpt_diff_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (float*)out);
  return (int)cudaGetLastError();
}

// As vpt_diff_fwd, plus gbar: device float32[npix * 3], the cotangent of the
// image; partials: device float32[n_blocks * P], one row per block of
// vpt_diff_block_threads() pixels; per_lane: NULL, or device
// float32[npix * P] to receive each pixel's own gradient vector as well.
extern "C" int vpt_diff_bwd(const void* params, const void* pvec, const void* seed,
                            const void* gbar, void* partials, void* per_lane, void* stream) {
  DiffParams D;
  if (!read_params(params, D)) return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  vpt_diff_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (const float*)gbar, (float*)partials,
      (float*)per_lane);
  return (int)cudaGetLastError();
}
