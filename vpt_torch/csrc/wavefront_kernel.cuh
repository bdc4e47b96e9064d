// The forward render kernel K1 for Hopper (sm_90a): one thread per lane.
//
// Replaces the Pallas TPU kernel of vpt/kernels/wavefront.py
// (build_tile_renderer: kernel body :230-741, pallas_call in _call
// :745-771). The TPU kernel walks (R, 128) lane tiles in lockstep and loops
// until every lane of the tile has its spp samples; here each thread owns
// one lane and leaves its loop when its own samples are done, which gives
// the same per-lane result with no tile-wide reduction (csrc/path.cuh has
// the per-path code and the parity rules).
//
// One instantiation per (nee, distance) pair of vpt's fused-kernel
// integrators, each in its own source so nvcc builds them in parallel:
// wavefront.cu (free flight + NEE, the main path), wavefront_free_implicit.cu,
// wavefront_ea.cu (equi-angular + NEE), wavefront_eac_implicit.cu (clamped
// equi-angular, no NEE). The physical mode, HG g and the material-3 shells
// are launch parameters.
//
// Lanes: lane i of the launch (bases == NULL), or tile i / 4096 of the
// launch from bases[] (vpt's scatter-tile mode, adaptive sampling's second
// pass). A lane renders pixel min(lane, npix - 1) and writes radiance / spp
// or, in the raw modes, its radiance sums.
//
// What bounds it on this card: arithmetic and divergence. Each thread runs
// its own path loop (intersections against every sphere, NEE and MIS traces,
// transcendentals); threads of a warp diverge on material, event and path
// length. Its only device-memory traffic is the 12 bytes of radiance it
// writes per lane; the scene is a kernel parameter read through the constant
// cache, and it uses no shared memory.
//
// Simple on purpose: no path-state compaction, no warp-level path
// regeneration and no persistent blocks. Those are later work, measured
// against this version.
#pragma once

#include <cuda_runtime.h>

#include "path.cuh"

namespace vpt_wavefront {

constexpr int kThreads = 128;

template <bool kNee, int kDist>
__global__ void __launch_bounds__(kThreads)
    kernel(const __grid_constant__ VptParams P, const int* __restrict__ seed,
           const int* __restrict__ bases, int n_lanes, int sums, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  vpt::render_lane<kNee, kDist>(P, seed[0], bases, i, sums, out);
}

// params: host pointer to a VptParams (copied into the launch); seed: device
// int32[1]; bases: device int32[n_lanes / 4096] or NULL; out: device
// float32[n_lanes * 3]; stream: cudaStream_t.
// Returns cudaGetLastError() right after the launch; does not synchronise.
template <bool kNee, int kDist>
int launch(const void* params, const void* seed, const void* bases, int n_lanes, int sums,
           void* out, void* stream) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  kernel<kNee, kDist><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      P, (const int*)seed, (const int*)bases, n_lanes, sums, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace vpt_wavefront

#define VPT_WAVEFRONT_ENTRY(name, nee, dist)                                                  \
  extern "C" int name(const void* params, const void* seed, const void* bases, int n_lanes, \
                      int sums, void* out, void* stream) {                                     \
    return vpt_wavefront::launch<nee, dist>(params, seed, bases, n_lanes, sums, out, stream); \
  }
