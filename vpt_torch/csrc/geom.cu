// Geometric-gradient render kernel K4 for Hopper (sm_90a): forward-mode
// dual numbers, one thread per pixel.
//
// Replaces the Pallas TPU kernel of vpt/kernels/geom.py (make_geom_renderer:
// kernel body :182-599, pallas_call in run :609 and make_raw :690). vpt
// walks (R, 128) lane tiles in lockstep until every lane has its samples;
// here each thread owns one pixel and leaves its loop when its own samples
// are done (csrc/geom_path.cuh has the per-path code and the parity rules).
//
// Inputs: the by-value __grid_constant__ GeomParams (scene, frame, tangent
// basis), the 12-float theta in device memory (each block stages it in
// shared memory once, so a training step never copies it to the host), the
// seed, and a base pixel: thread i of the launch renders pixel base + i, its
// PCG streams keyed by that global id, so a shard of the frame reproduces
// the whole frame's draws. Output: 3 (1 + K) planes of n_out per-pixel
// sums, plane c (1 + K) + j for channel c, j = 0 the image, j >= 1 tangent
// j - 1; the wrapper scales them by 1/spp.
//
// K is a template parameter (csrc/geom_kernel.cuh), instantiated for 0, 3,
// 4, 6, 7 and 10, one per source csrc/geom_k<K>.cu so that they compile in
// parallel: every mix of the centre (3), camera origin + fov (4) and
// look-direction (3) blocks. The block offsets and the sphere index are
// runtime values; this file dispatches on K. In a homogeneous medium
// vpt_geom_fwd runs the default estimator (free flight, NEE, not physical,
// isotropic; material-3 shells too: vpt's K4 treats them as Lambertian
// spheres), vpt_geom_fwd_ext every other one (csrc/geom_ext_k<K>.cu, the
// estimator read from GeomParams); in a density field vpt_geom_fwd_field
// runs every estimator (csrc/geom_field_k<K>.cu: exp_height or blobs at any
// K, a voxel grid's table at K = 0).
//
// What bounds it on this card: arithmetic, divergence and, from K = 7, the
// path state (o, d, tp and L are 12 duals of 1 + K floats per thread) and
// the temporaries of the dual chains, which do not fit in registers: ptxas
// reports the spills. Simple on purpose: no state compaction, no tangent
// planes kept in shared memory, no persistent blocks.
#include <cuda_runtime.h>

#include "geom_kernel.cuh"

extern "C" int vpt_geom_params_words(void) { return (int)(sizeof(GeomParams) / 4); }

namespace {

// one launch of the instantiation <K = G.n_tan, kExt, kField>
template <bool kExt, bool kField>
int dispatch(const void* params, const void* theta, const void* seed, int base, int n_out,
             const void* tab, void* out, void* stream) {
  using namespace vpt::geom;
  GeomParams G;
  memcpy(&G, params, sizeof G);
  if (n_out <= 0) return 0;
  const float* th = (const float*)theta;
  const int* sd = (const int*)seed;
  const uint32_t* tb = (const uint32_t*)tab;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  if (tb != nullptr && G.n_tan != 0) return (int)cudaErrorInvalidValue;
  switch (G.n_tan) {
    case 0: return launch<0, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    case 3: return launch<3, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    case 4: return launch<4, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    case 6: return launch<6, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    case 7: return launch<7, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    case 10: return launch<10, kExt, kField>(G, th, sd, base, n_out, tb, o, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// params: host pointer to a GeomParams (copied into the launch); theta:
// device float32[12]; seed: device int32[1]; base: the first pixel; n_out:
// pixels to render; out: device float32[3 (1 + K) * n_out]; stream:
// cudaStream_t. Returns cudaGetLastError() right after the launch (or
// cudaErrorInvalidValue for a K it is not built for); does not synchronise.
extern "C" int vpt_geom_fwd(const void* params, const void* theta, const void* seed, int base,
                            int n_out, void* out, void* stream) {
  return dispatch<false, false>(params, theta, seed, base, n_out, nullptr, out, stream);
}

// the extended estimators, with vpt_geom_fwd's arguments
extern "C" int vpt_geom_fwd_ext(const void* params, const void* theta, const void* seed, int base,
                                int n_out, void* out, void* stream) {
  return dispatch<true, false>(params, theta, seed, base, n_out, nullptr, out, stream);
}

// a density field, with vpt_geom_fwd's arguments and tab: device uint32 of
// a voxel grid's packed table (K = 0 only), or NULL for an analytic field
extern "C" int vpt_geom_fwd_field(const void* params, const void* theta, const void* seed,
                                  int base, int n_out, const void* tab, void* out, void* stream) {
  return dispatch<true, true>(params, theta, seed, base, n_out, tab, out, stream);
}
