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
// Lanes: thread i of a launch runs lane base + i for i < n_lanes, as K4's
// kernel does (csrc/geom_kernel.cuh): its PCG streams are keyed by that
// global lane and its camera ray takes pixel min(lane, npix - 1), vpt's
// clamp; its outputs (K2's image row, K3's cotangent row and per-lane row)
// are indexed by i. The whole frame is base = 0, n_lanes = npix; a shard of
// one device's tile range (vpt/kernels/diff.py make_shard, fwd_shard :1406,
// bwd_shard :1430) is any other range. K3 masks lanes past the frame: they
// add no gradient and no voxel term (vpt zeroes their cotangent,
// diff.py:362-365; its VJP is linear in it, so that is the same zero), and
// its threads take the count of lanes within the frame, so the
// whole-frame kernel keeps its one bound check.
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

// the pixel of a lane: vpt's clamp of a lane past the frame to its last pixel
__device__ __forceinline__ int lane_pixel(int lane, int npix) {
  return lane < npix - 1 ? lane : npix - 1;
}

// K3's lanes within the frame of the launch's lanes base .. base + n_lanes
// - 1: its threads i < valid_lanes run, the others (past the frame) add
// nothing
inline int valid_lanes(const DiffParams& D, int base, int n_lanes) {
  const int left = D.base.width * D.base.height - base;
  return left < 0 ? 0 : (left < n_lanes ? left : n_lanes);
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
               const int* __restrict__ seed, int base, int n_lanes, float* __restrict__ out) {
  __shared__ float pv[max_params<kField, kHG>()];
  const FieldParams& F = stage<kField>(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const int lane = base + i;
  float L[3];
  vpt::diff_pixel<false, kField, kHG>(D, pv, F, (uint32_t)lane, lane_pixel(lane, npix), seed[0],
                                      nullptr, L, nullptr);
  out[3 * i + 0] = L[0];
  out[3 * i + 1] = L[1];
  out[3 * i + 2] = L[2];
}

template <bool kField, bool kHG>
__global__ void __launch_bounds__(kThreads)
    bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
               const int* __restrict__ seed, int base, int n_valid, const float* __restrict__ gbar,
               float* __restrict__ partials, float* __restrict__ per_lane) {
  constexpr int kMaxP = max_params<kField, kHG>();
  __shared__ float pv[kMaxP];
  __shared__ float warp_sum[kWarps][kMaxP];
  const FieldParams& F = stage<kField>(D, pvec, pv);
  const int P = D.n_params;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float g[kMaxP];
  if (i < n_valid) {  // lane base + i, within the frame
    vpt::diff_pixel<true, kField, kHG>(D, pv, F, (uint32_t)(base + i), base + i, seed[0],
                                       gbar + 3 * i, nullptr, g);
    if (per_lane != nullptr)
      for (int k = 0; k < P; ++k) per_lane[(size_t)i * P + k] = g[k];
  } else {  // past the frame (masked), or past the launch
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
// pvec: device float32[P]; seed: device int32[1]; base, n_lanes: the lanes
// base .. base + n_lanes - 1 (the whole frame: 0, npix); out: device
// float32[n_lanes * 3] (radiance / spp per lane).
// Returns cudaGetLastError() right after the launch; does not synchronise.
template <bool kField, bool kHG = false>
int launch_fwd(const void* params, const void* pvec, const void* seed, int base, int n_lanes,
               void* out, void* stream) {
  DiffParams D;
  if (!read_params<kField, kHG>(params, D) || base < 0) return (int)cudaErrorInvalidValue;
  if (D.base.width * D.base.height <= 0 || n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  fwd_kernel<kField, kHG><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, base, n_lanes, (float*)out);
  return (int)cudaGetLastError();
}

// As launch_fwd, plus gbar: device float32[n_lanes * 3], the cotangent of
// the lanes' image; partials: device float32[n_blocks * P], one row per
// block of kThreads lanes; per_lane: NULL, or device float32[n_lanes * P]
// to receive each lane's own gradient vector as well (its rows past the
// frame are not written: the caller zeroes them).
template <bool kField, bool kHG = false>
int launch_bwd(const void* params, const void* pvec, const void* seed, int base, int n_lanes,
               const void* gbar, void* partials, void* per_lane, void* stream) {
  DiffParams D;
  if (!read_params<kField, kHG>(params, D) || base < 0) return (int)cudaErrorInvalidValue;
  if (D.base.width * D.base.height <= 0 || n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  bwd_kernel<kField, kHG><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, base, valid_lanes(D, base, n_lanes),
      (const float*)gbar, (float*)partials, (float*)per_lane);
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
                    const int* __restrict__ seed, int base, int n_lanes, float* __restrict__ out,
                    const uint32_t* __restrict__ tab) {
  __shared__ float pv[VPT_MAX_PARAMS];
  const FieldParams& F = stage<false>(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const int lane = base + i;
  float L[3];
  vpt::diff_pixel<false, kField, false>(D, pv, F, (uint32_t)lane, lane_pixel(lane, npix), seed[0],
                                        nullptr, L, nullptr, tab);
  out[3 * i + 0] = L[0];
  out[3 * i + 1] = L[1];
  out[3 * i + 2] = L[2];
}

// ggrid: NULL (no diff_grid) or device float32[T], T = nx ny nz, zeroed by
// the caller; shared: accumulate each block's voxel terms in dynamic shared
// memory of T floats first
template <int kField>
__global__ void __launch_bounds__(kThreads)
    grid_bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                    const int* __restrict__ seed, int base, int n_valid,
                    const float* __restrict__ gbar,
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
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float g[kMaxP];
  if (i < n_valid) {  // lane base + i, within the frame
    vpt::diff_pixel<true, kField, false>(D, pv, F, (uint32_t)(base + i), base + i, seed[0],
                                         gbar + 3 * i, nullptr, g, tab, acc);
    if (per_lane != nullptr)
      for (int k = 0; k < P; ++k) per_lane[(size_t)i * P + k] = g[k];
  } else {  // past the frame (masked), or past the launch
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

namespace vpt_diff {

// ---- the extended estimators (csrc/diff_ext*.cu) --------------------------

// K2 and K3 with diff_pixel<..., kHG = true, kExt = true>: equi-angular
// distances, the implicit estimator, the physical credit, material-3 shells
// and any phase, read from DiffParams at run time, in a homogeneous medium,
// an analytic field (kField = vpt::kAnalytic) or a voxel grid
// (vpt::kGridField, with the table tab and, with diff_grid, the voxel
// gradient ggrid as in grid_bwd_kernel); tab and ggrid are NULL outside a
// grid. One template of each per field kind, each in a source of its own.
template <int kField>
__global__ void __launch_bounds__(kThreads)
    ext_fwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                   const int* __restrict__ seed, int base, int n_lanes, float* __restrict__ out,
                   const uint32_t* __restrict__ tab) {
  constexpr bool kAn = kField == vpt::kAnalytic;
  __shared__ float pv[max_params<kAn, true>()];
  const FieldParams& F = stage<kAn>(D, pvec, pv);
  const int npix = D.base.width * D.base.height;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  const int lane = base + i;
  float L[3];
  vpt::diff_pixel<false, kField, true, true>(D, pv, F, (uint32_t)lane, lane_pixel(lane, npix),
                                             seed[0], nullptr, L, nullptr, tab);
  out[3 * i + 0] = L[0];
  out[3 * i + 1] = L[1];
  out[3 * i + 2] = L[2];
}

template <int kField>
__global__ void __launch_bounds__(kThreads)
    ext_bwd_kernel(const __grid_constant__ DiffParams D, const float* __restrict__ pvec,
                   const int* __restrict__ seed, int base, int n_valid,
                   const float* __restrict__ gbar,
                   float* __restrict__ partials, float* __restrict__ per_lane,
                   const uint32_t* __restrict__ tab, float* __restrict__ ggrid, int shared) {
  constexpr bool kAn = kField == vpt::kAnalytic;
  constexpr int kMaxP = max_params<kAn, true>();
  __shared__ float pv[kMaxP];
  __shared__ float warp_sum[kWarps][kMaxP];
  extern __shared__ float sgrid[];
  const FieldParams& F = stage<kAn>(D, pvec, pv);
  const int P = D.n_params;
  float* acc = ggrid;
  int T = 0;
  if constexpr (kField == vpt::kGridField) {
    T = D.base.grid.n[0] * D.base.grid.n[1] * D.base.grid.n[2];
    if (ggrid != nullptr && shared) {
      for (int k = threadIdx.x; k < T; k += kThreads) sgrid[k] = 0.0f;
      __syncthreads();
      acc = sgrid;
    }
  }
  const int i = blockIdx.x * kThreads + threadIdx.x;
  float g[kMaxP];
  if (i < n_valid) {  // lane base + i, within the frame
    vpt::diff_pixel<true, kField, true, true>(D, pv, F, (uint32_t)(base + i), base + i, seed[0],
                                              gbar + 3 * i, nullptr, g, tab, acc);
    if (per_lane != nullptr)
      for (int k = 0; k < P; ++k) per_lane[(size_t)i * P + k] = g[k];
  } else {  // past the frame (masked), or past the launch
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
  if constexpr (kField == vpt::kGridField) {
    if (ggrid != nullptr && shared) {  // flush the block's voxel terms
      for (int k = threadIdx.x; k < T; k += kThreads) {
        const float v = sgrid[k];
        if (v != 0.0f) atomicAdd(ggrid + k, v);
      }
    }
  }
}

// A DiffParams of an extended launch: the field kind kField, any HG mode, a
// known distance, and not the refused nee = 0, physical = 0
template <int kField>
bool read_ext_params(const void* params, DiffParams& D) {
  memcpy(&D, params, sizeof D);
  bool field_ok;
  if constexpr (kField == vpt::kGridField) {
    const GridParams& G = D.base.grid;
    field_ok = G.n[0] >= 2 && G.n[1] >= 2 && G.n[2] >= 2 && G.n_march >= 1 &&
               D.base.field.kind == 0 && D.n_fp == 0;
  } else if constexpr (kField == vpt::kAnalytic) {
    field_ok = D.base.field.kind != 0;
  } else {
    field_ok = D.base.field.kind == 0 && D.n_fp == 0;
  }
  constexpr int kMaxP = max_params<kField == vpt::kAnalytic, true>();
  return field_ok && D.hg_mode >= 0 && D.hg_mode <= vpt::kHgTraced &&
         (D.distance == 0 || D.distance == vpt::kDistEa) && (D.nee != 0 || D.physical != 0) &&
         D.n_fp >= 0 && D.n_fp <= VPT_MAX_FP && D.n_params > 0 && D.n_params <= kMaxP &&
         D.n_params == vpt::field_slot0(D) + D.n_fp;
}

// The bytes of dynamic shared memory an extended grid K3 uses for T voxels
// (as grid_shared_bytes)
template <int kField>
int ext_shared_bytes(int T) {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, ext_bwd_kernel<kField>) != cudaSuccess) return 0;
  const size_t need = (size_t)T * sizeof(float);
  return need + attr.sharedSizeBytes <= (size_t)optin ? (int)need : 0;
}

// As launch_fwd; tab: a grid's packed table (NULL outside a grid)
template <int kField>
int launch_ext_fwd(const void* params, const void* pvec, const void* seed, int base, int n_lanes,
                   void* out, const void* tab, void* stream) {
  DiffParams D;
  if (!read_ext_params<kField>(params, D) || (kField == vpt::kGridField) != (tab != nullptr) ||
      base < 0)
    return (int)cudaErrorInvalidValue;
  if (D.base.width * D.base.height <= 0 || n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  ext_fwd_kernel<kField><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, base, n_lanes, (float*)out, (const uint32_t*)tab);
  return (int)cudaGetLastError();
}

// As launch_bwd; tab and ggrid as launch_grid_bwd's in a grid, NULL
// outside one
template <int kField>
int launch_ext_bwd(const void* params, const void* pvec, const void* seed, int base, int n_lanes,
                   const void* gbar, void* partials, void* per_lane, const void* tab, void* ggrid,
                   void* stream) {
  DiffParams D;
  constexpr bool kGrid = kField == vpt::kGridField;
  if (!read_ext_params<kField>(params, D) || kGrid != (tab != nullptr) ||
      (kGrid && D.diff_grid != 0) != (ggrid != nullptr) || base < 0)
    return (int)cudaErrorInvalidValue;
  if (D.base.width * D.base.height <= 0 || n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  int smem = 0;
  if (ggrid != nullptr) {
    smem = ext_shared_bytes<kField>(D.base.grid.n[0] * D.base.grid.n[1] * D.base.grid.n[2]);
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(ext_bwd_kernel<kField>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
  }
  ext_bwd_kernel<kField><<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      D, (const float*)pvec, (const int*)seed, base, valid_lanes(D, base, n_lanes),
      (const float*)gbar, (float*)partials, (float*)per_lane, (const uint32_t*)tab,
      (float*)ggrid, smem > 0 ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace vpt_diff
