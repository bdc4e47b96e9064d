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
// are launch parameters. A medium with an analytic density field runs in a
// second set, one per pair again (wavefront_field*.cu, kField = kAnalytic): the
// field is a compile-time parameter so that the homogeneous instantiations
// keep their code (K1's main path holds 116 registers without spills), and
// exp_height against blobs is a uniform switch inside them. A voxel grid
// runs in a third set (wavefront_grid*.cu, kField = kGridField), whose
// kernels take the grid's packed table as one more argument; its transport
// interpolant is a uniform switch.
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
// cache, and it uses no shared memory. A grid instantiation also reads its
// table, 4 bytes per voxel, through the read-only cache: (n_march + 2) pc
// densities of one to four words each per march.
//
// Simple on purpose: no path-state compaction, no warp-level path
// regeneration and no persistent blocks. Those are later work, measured
// against this version.
#pragma once

#include <cuda_runtime.h>

#include "path.cuh"

namespace vpt_wavefront {

constexpr int kThreads = 128;

template <bool kNee, int kDist, bool kField>
__global__ void __launch_bounds__(kThreads)
    kernel(const __grid_constant__ VptParams P, const int* __restrict__ seed,
           const int* __restrict__ bases, int n_lanes, int sums, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  vpt::render_lane<kNee, kDist, kField ? vpt::kAnalytic : vpt::kHomogeneous>(P, seed[0], bases,
                                                                          i, sums, out);
}

// the grid instantiations: tab is the grid's packed table (uint32[T])
template <bool kNee, int kDist>
__global__ void __launch_bounds__(kThreads)
    grid_kernel(const __grid_constant__ VptParams P, const int* __restrict__ seed,
                const int* __restrict__ bases, int n_lanes, int sums, float* __restrict__ out,
                const uint32_t* __restrict__ tab) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_lanes) return;
  vpt::render_lane<kNee, kDist, vpt::kGridField>(P, seed[0], bases, i, sums, out, tab);
}

// params: host pointer to a VptParams (copied into the launch); seed: device
// int32[1]; bases: device int32[n_lanes / 4096] or NULL; out: device
// float32[n_lanes * 3]; stream: cudaStream_t.
// Returns cudaGetLastError() right after the launch; does not synchronise.
template <bool kNee, int kDist, bool kField>
int launch(const void* params, const void* seed, const void* bases, int n_lanes, int sums,
           void* out, void* stream) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  kernel<kNee, kDist, kField><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      P, (const int*)seed, (const int*)bases, n_lanes, sums, (float*)out);
  return (int)cudaGetLastError();
}

// As launch, plus tab: device uint32[nx * ny * nz], the packed table; a
// VptParams without a grid is refused
template <bool kNee, int kDist>
int launch_grid(const void* params, const void* seed, const void* bases, int n_lanes, int sums,
                void* out, const void* tab, void* stream) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  if (P.grid.n[0] < 2 || P.grid.n[1] < 2 || P.grid.n[2] < 2 || P.grid.n_march < 1 ||
      tab == nullptr)
    return (int)cudaErrorInvalidValue;
  if (n_lanes <= 0) return 0;
  const int blocks = (n_lanes + kThreads - 1) / kThreads;
  grid_kernel<kNee, kDist><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      P, (const int*)seed, (const int*)bases, n_lanes, sums, (float*)out, (const uint32_t*)tab);
  return (int)cudaGetLastError();
}

}  // namespace vpt_wavefront

#define VPT_WAVEFRONT_ENTRY(name, nee, dist, field)                                        \
  extern "C" int name(const void* params, const void* seed, const void* bases, int n_lanes, \
                      int sums, void* out, void* stream) {                                     \
    return vpt_wavefront::launch<nee, dist, field>(params, seed, bases, n_lanes, sums, out,    \
                                                   stream);                                    \
  }

#define VPT_WAVEFRONT_GRID_ENTRY(name, nee, dist)                                          \
  extern "C" int name(const void* params, const void* seed, const void* bases, int n_lanes, \
                      int sums, void* out, const void* tab, void* stream) {                    \
    return vpt_wavefront::launch_grid<nee, dist>(params, seed, bases, n_lanes, sums, out, tab, \
                                                 stream);                                      \
  }
