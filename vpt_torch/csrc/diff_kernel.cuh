// The differentiable render pair for Hopper (sm_90a): the forward K2 and its
// single-replay backward K3, one thread per pixel.
//
// Replaces the Pallas TPU kernels of vpt/kernels/diff.py: make_kernel
// (grads=False) launched by run_fwd, and make_kernel(grads=True) launched by
// run_bwd (diff.py:284-1336). As in csrc/wavefront.cu, each thread owns one
// pixel and leaves its loop when its own samples are done; vpt's lockstep
// tile gives the same per-pixel values (csrc/diff_path.cuh has the per-path
// code and the parity rules).
//
// Instantiations, one per source so that nvcc builds them in parallel:
// csrc/diff.cu (both kernels, homogeneous medium) and csrc/diff_field_fwd.cu,
// csrc/diff_field_bwd.cu (kField = true: an analytic density field, with the
// fog falloff or the blob rows traced or not); with a Henyey-Greenstein
// phase (kHG = true: the scene's baked g or the traced diff_g, a runtime
// mode) csrc/diff_hg.cu (homogeneous) and csrc/diff_field_hg_fwd.cu,
// csrc/diff_field_hg_bwd.cu. The field and the phase are compile-time
// parameters so that the isotropic homogeneous kernels keep their code and
// their accumulators (K3 already spills there). A voxel grid runs in
// csrc/diff_grid_fwd.cu and diff_grid_bwd.cu (kField = kGridField, no HG
// phase), whose kernels read the grid's packed table; with diff_grid (a
// launch parameter) K3 also writes the voxel gradient.
//
// The parameter vector pvec (float32[P], P = 2 + 6S [+ 1 g] + n_fp) lives in device
// memory, so a training step never copies parameters to the host or
// synchronises; each block stages it in shared memory once. In a field the
// block also stages the field: the host's constants (folded in double, as
// vpt bakes them) or, for the traced parameters, the same constants computed
// in f32 from the staged vector, as vpt's traced forms compute them.
// Geometry, camera and estimator constants ride in the by-value
// __grid_constant__ DiffParams.
//
// K3 writes no per-pixel gradient: each thread folds its own path terms into
// a P-vector, and the block reduces the 128 vectors deterministically (warp
// shuffles in a fixed tree, then the 4 warp sums in order) into one row of
// partials[n_blocks, P]. The wrapper sums the rows in torch, as vpt sums its
// per-tile rows outside the kernel (diff.py:1336). No float atomics, so the
// gradient is the same from run to run.
//
// The voxel gradient (K3 with diff_grid) is the exception: each thread adds
// its terms with atomicAdd, into a per-block accumulator of the grid's size
// in shared memory when it fits (the kernel opts in above 48 KB; 32^3 is 128
// KB), flushed once per block with global atomicAdd, or straight into the
// global buffer above that. Its sum order varies from run to run, so it is
// held to its plain version to a tolerance, not bit for bit.
//
// What bounds them on this card: arithmetic and divergence, as for K1. K2
// reads 4P bytes and writes 12 bytes per pixel; K3 reads the 12-byte
// cotangent of each pixel and writes 4P bytes per block. K3 carries its
// accumulators (the packed vector, the deferred lambert pairs indexed by
// sphere id, and in a field the deferred field-parameter pairs) in
// per-thread arrays in local memory.
//
// Simple on purpose: no path-state compaction, no accumulators kept in
// registers by specialising on the scene, no persistent blocks. Those are
// later work, measured against this version.
#pragma once

#include <cuda_runtime.h>

#include "diff_path.cuh"

namespace vpt_diff {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// the packed vector's largest size for an instantiation
template <bool kField, bool kHG>
__host__ __device__ constexpr int max_params() {
  return VPT_MAX_PARAMS + (kHG ? 1 : 0) + (kField ? VPT_MAX_FP : 0);
}

// Stage the parameter vector in shared memory; returns the field the
// block's threads read: in a field instantiation a shared copy of the
// host's with its traced entries recomputed from the staged vector
// (pair_field, one thread), otherwise the (unread) launch parameters' field
template <bool kField>
__device__ __forceinline__ const FieldParams& stage(const DiffParams& D,
                                                    const float* __restrict__ pvec, float* pv) {
  for (int k = threadIdx.x; k < D.n_params; k += kThreads) pv[k] = pvec[k];
  __syncthreads();
  if constexpr (kField) {
    __shared__ FieldParams F;
    if (threadIdx.x == 0) vpt::pair_field(D, pv, F);
    __syncthreads();
    return F;
  } else {
    return D.base.field;
  }
}

template <bool kField, bool kHG>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
               const int* __restrict__ seed, float* __restrict__ out) {
  __shared__ float pv[max_params<kField, kHG>()];
  const FieldParams& F = stage<kField>(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  if (pixel >= npix) return;
  float L[3];
  vpt::diff_pixel<false, kField, kHG>(D, pv, F, pixel, seed[0], nullptr, L, nullptr);
  out[3 * pixel + 0] = L[0];
  out[3 * pixel + 1] = L[1];
  out[3 * pixel + 2] = L[2];
}

template <bool kField, bool kHG>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
               const int* __restrict__ seed, const float* __restrict__ gbar,
               float* __restrict__ partials, float* __restrict__ per_lane) {
  constexpr int kMaxP = max_params<kField, kHG>();
  __shared__ float pv[kMaxP];
  __shared__ float warp_sum[kWarps][kMaxP];
  const FieldParams& F = stage<kField>(D, pvec, pv);
  const int P = D.n_params;
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  float g[kMaxP];
  if (pixel < npix) {
    vpt::diff_pixel<true, kField, kHG>(D, pv, F, pixel, seed[0], gbar + 3 * pixel, nullptr, g);
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

// A DiffParams this instantiation takes: P = 2 + 6S [+ 1] + n_fp within
// its limit, a field exactly where kField, an HG mode exactly where kHG
template <bool kField, bool kHG>
bool read_params(const void* params, DiffParams& D) {
  memcpy(&D, params, sizeof D);
  const bool field_ok = kField ? D.base.field.kind != 0 : (D.base.field.kind == 0 && D.n_fp == 0);
  const bool hg_ok = kHG ? (D.hg_mode == vpt::kHgBaked || D.hg_mode == vpt::kHgTraced)
                         : D.hg_mode == 0;
  return field_ok && hg_ok && D.n_fp >= 0 && D.n_fp <= VPT_MAX_FP && D.n_params > 0 &&
         D.n_params <= max_params<kField, kHG>() &&
         D.n_params == vpt::field_slot0(D) + D.n_fp;
}

// params: host pointer to a DiffParams (copied into the launch);
// pvec: device float32[P]; seed: device int32[1]; out: device float32[npix * 3]
// (radiance sums over the samples; the wrapper divides by spp).
// Returns cudaGetLastError() right after the launch; does not synchronise.
template <bool kField, bool kHG = false>
int launch_fwd(const void* params, const void* pvec, const void* seed, void* out, void* stream) {
  DiffParams D;
  if (!read_params<kField, kHG>(params, D)) return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  fwd_kernel<kField, kHG><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (float*)out);
  return (int)cudaGetLastError();
}

// As launch_fwd, plus gbar: device float32[npix * 3], the cotangent of the
// image; partials: device float32[n_blocks * P], one row per block of
// kThreads pixels; per_lane: NULL, or device float32[npix * P] to receive
// each pixel's own gradient vector as well.
template <bool kField, bool kHG = false>
int launch_bwd(const void* params, const void* pvec, const void* seed, const void* gbar,
               void* partials, void* per_lane, void* stream) {
  DiffParams D;
  if (!read_params<kField, kHG>(params, D)) return (int)cudaErrorInvalidValue;
  const int npix = D.base.width * D.base.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  bwd_kernel<kField, kHG><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, (const float*)gbar, (float*)partials,
      (float*)per_lane);
  return (int)cudaGetLastError();
}

}  // namespace vpt_diff

namespace vpt_diff {

// ---- a voxel grid (csrc/diff_grid_fwd.cu, diff_grid_bwd.cu) ---------------

// templates, so that only the sources that launch them (csrc/diff_grid_*.cu)
// compile them; kField is vpt::kGridField
template <int kField>
__global__ void __launch_bounds__(kThreads)
    grid_fwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                    const int* __restrict__ seed, float* __restrict__ out,
                    const uint32_t* __restrict__ tab) {
  __shared__ float pv[VPT_MAX_PARAMS];
  const FieldParams& F = stage<false>(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  if (pixel >= npix) return;
  float L[3];
  vpt::diff_pixel<false, kField, false>(D, pv, F, pixel, seed[0], nullptr, L, nullptr, tab);
  out[3 * pixel + 0] = L[0];
  out[3 * pixel + 1] = L[1];
  out[3 * pixel + 2] = L[2];
}

// ggrid: NULL (no diff_grid) or device float32[T], T = nx ny nz, zeroed by
// the caller; shared: accumulate each block's voxel terms in dynamic shared
// memory of T floats first
template <int kField>
__global__ void __launch_bounds__(kThreads)
    grid_bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                    const int* __restrict__ seed, const float* __restrict__ gbar,
                    float* __restrict__ partials, float* __restrict__ per_lane,
                    const uint32_t* __restrict__ tab, float* __restrict__ ggrid, int shared) {
  constexpr int kMaxP = VPT_MAX_PARAMS;
  __shared__ float pv[kMaxP];
  __shared__ float warp_sum[kWarps][kMaxP];
  extern __shared__ float sgrid[];
  const FieldParams& F = stage<false>(D, pvec, pv);
  const int P = D.n_params;
  const int T = D.base.grid.n[0] * D.base.grid.n[1] * D.base.grid.n[2];
  float* acc = ggrid;
  if (ggrid != nullptr && shared) {
    for (int k = threadIdx.x; k < T; k += kThreads) sgrid[k] = 0.0f;
    __syncthreads();
    acc = sgrid;
  }
  const int npix = D.base.width * D.base.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  float g[kMaxP];
  if (pixel < npix) {
    vpt::diff_pixel<true, kField, false>(D, pv, F, pixel, seed[0], gbar + 3 * pixel, nullptr, g,
                                         tab, acc);
    if (per_lane != nullptr)
      for (int k = 0; k < P; ++k) per_lane[(size_t)pixel * P + k] = g[k];
  } else {
    for (int k = 0; k < P; ++k) g[k] = 0.0f;
  }
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
  if (ggrid != nullptr && shared) {  // flush the block's voxel terms
    for (int k = threadIdx.x; k < T; k += kThreads) {
      const float v = sgrid[k];
      if (v != 0.0f) atomicAdd(ggrid + k, v);
    }
  }
}

// A DiffParams of a grid's pair: a grid, no analytic field, no traced field
// parameter, no HG phase
inline bool read_grid_params(const void* params, DiffParams& D) {
  memcpy(&D, params, sizeof D);
  const GridParams& G = D.base.grid;
  return G.n[0] >= 2 && G.n[1] >= 2 && G.n[2] >= 2 && G.n_march >= 1 &&
         D.base.field.kind == 0 && D.n_fp == 0 && D.hg_mode == 0 && D.n_params > 0 &&
         D.n_params <= VPT_MAX_PARAMS && D.n_params == vpt::field_slot0(D);
}

}  // namespace vpt_diff
