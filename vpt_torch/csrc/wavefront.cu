// Forward render kernel for Hopper (sm_90a): one thread per pixel.
//
// Replaces the Pallas TPU kernel of vpt/kernels/wavefront.py
// (build_tile_renderer: kernel body :230-741, pallas_call in _call
// :745-771). The TPU kernel walks (R, 128) lane tiles in lockstep and loops
// until every lane of the tile has its spp samples; here each thread owns
// one pixel and leaves its loop when its own samples are done, which gives
// the same per-pixel result with no tile-wide reduction (csrc/path.cuh has
// the per-path code and the parity rules).
//
// What bounds it on this card: arithmetic and divergence. Each thread runs
// its own path loop (intersections against every sphere, NEE and MIS
// traces, transcendentals); threads of a warp diverge on material, event
// and path length. Its only device-memory traffic is the 12 bytes of
// radiance it writes per pixel; the scene is a kernel parameter read
// through the constant cache, and it uses no shared memory.
//
// Simple on purpose: no path-state compaction, no warp-level path
// regeneration and no persistent blocks. Those are later work, measured
// against this version.
#include <cuda_runtime.h>

#include "path.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    vpt_wavefront_kernel(const __grid_constant__ VptParams P,
                         const int* __restrict__ seed, float* __restrict__ out) {
  const int npix = P.width * P.height;
  const int pixel = blockIdx.x * kThreads + threadIdx.x;
  if (pixel >= npix) return;
  float L[3];
  vpt::render_pixel(P, pixel, seed[0], L);
  out[3 * pixel + 0] = L[0];
  out[3 * pixel + 1] = L[1];
  out[3 * pixel + 2] = L[2];
}

}  // namespace

extern "C" int vpt_params_words(void) { return (int)(sizeof(VptParams) / 4); }

extern "C" const char* vpt_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// params: host pointer to a VptParams (copied into the launch);
// seed: device int32[1]; out: device float32[npix * 3]; stream: cudaStream_t.
// Returns cudaGetLastError() right after the launch; does not synchronise.
extern "C" int vpt_wavefront_fwd(const void* params, const void* seed, void* out,
                                 void* stream) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  const int npix = P.width * P.height;
  if (npix <= 0) return 0;
  const int blocks = (npix + kThreads - 1) / kThreads;
  vpt_wavefront_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      P, (const int*)seed, (float*)out);
  return (int)cudaGetLastError();
}
