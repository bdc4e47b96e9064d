// Kernel K4 (see csrc/geom.cu): the __global__ template over the tangent
// count K and the estimator and medium flags, and its launcher. Each
// csrc/geom_k<K>.cu instantiates one K of the default estimator
// (vpt_geom_kernel<K, false, false>), each csrc/geom_ext_k<K>.cu one K of
// the extended estimators (<K, true, false>: geom_pixel reads the
// estimator from GeomParams), each csrc/geom_field_k<K>.cu one K in a
// density field (<K, true, true>: the field kind read from GeomParams too;
// at K = 0 a voxel grid's table rides beside), so the build compiles the
// eighteen instantiations in parallel, one nvcc each.
#pragma once

#include <cuda_runtime.h>

#include "geom_path.cuh"

namespace vpt {
namespace geom {

constexpr int kThreads = 128;
constexpr int kTheta = 12;

// One instantiation of K4: kExt reads the estimator from GeomParams,
// kField (with kExt) a density field; tab: a voxel grid's packed table
// (kField, K = 0) or nullptr.
template <int K, bool kExt, bool kField>
__global__ void __launch_bounds__(kThreads)
    vpt_geom_kernel(const __grid_constant__ GeomParams G, const float* __restrict__ theta,
                    const int* __restrict__ seed, int base, int n_out,
                    const uint32_t* __restrict__ tab, float* __restrict__ out) {
  __shared__ float th[kTheta];
  if (threadIdx.x < kTheta) th[threadIdx.x] = theta[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int npix = G.base.width * G.base.height;
  const int lane = base + i;
  const int pixel = lane < npix - 1 ? lane : npix - 1;  // vpt's clamp
  float L[3 * (1 + K)];
  geom_pixel<K, kExt, kField>(G, th, (uint32_t)lane, pixel, seed[0], L, tab);
  for (int p = 0; p < 3 * (1 + K); ++p) out[(size_t)p * n_out + i] = L[p];
}

// one launch of K4 with K tangents; cudaGetLastError() after it
template <int K, bool kExt, bool kField>
int launch(const GeomParams& G, const float* theta, const int* seed, int base, int n_out,
           const uint32_t* tab, float* out, cudaStream_t stream) {
  const int blocks = (n_out + kThreads - 1) / kThreads;
  vpt_geom_kernel<K, kExt, kField>
      <<<blocks, kThreads, 0, stream>>>(G, theta, seed, base, n_out, tab, out);
  return (int)cudaGetLastError();
}

// The eighteen instantiations: each source csrc/geom_k<K>.cu (the default
// estimator), geom_ext_k<K>.cu (kExt) and geom_field_k<K>.cu (kExt,
// kField) defines one with VPT_GEOM_INSTANCE; every other file that
// includes this header only declares them.
#define VPT_GEOM_LAUNCH(K, EXT, FIELD)                                                    \
  int launch<K, EXT, FIELD>(const GeomParams&, const float*, const int*, int, int,        \
                            const uint32_t*, float*, cudaStream_t)
#define VPT_GEOM_INSTANCE(K, EXT, FIELD) template VPT_GEOM_LAUNCH(K, EXT, FIELD)
#define VPT_GEOM_DECLARE(EXT, FIELD)                                                      \
  extern template VPT_GEOM_LAUNCH(0, EXT, FIELD);                                          \
  extern template VPT_GEOM_LAUNCH(3, EXT, FIELD);                                          \
  extern template VPT_GEOM_LAUNCH(4, EXT, FIELD);                                          \
  extern template VPT_GEOM_LAUNCH(6, EXT, FIELD);                                          \
  extern template VPT_GEOM_LAUNCH(7, EXT, FIELD);                                          \
  extern template VPT_GEOM_LAUNCH(10, EXT, FIELD)
VPT_GEOM_DECLARE(false, false);
VPT_GEOM_DECLARE(true, false);
VPT_GEOM_DECLARE(true, true);

}  // namespace geom
}  // namespace vpt
