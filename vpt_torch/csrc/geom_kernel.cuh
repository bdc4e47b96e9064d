// Kernel K4 (see csrc/geom.cu): the __global__ templates over the tangent
// count K and their launchers. Each csrc/geom_k<K>.cu instantiates one K of
// the default estimator (vpt_geom_kernel<K>), each csrc/geom_ext_k<K>.cu one
// K of the extended estimators (vpt_geom_ext_kernel<K>: geom_pixel<K, true>
// reads the estimator from GeomParams), so the build compiles the twelve
// instantiations in parallel, one nvcc each.
#pragma once

#include <cuda_runtime.h>

#include "geom_path.cuh"

namespace vpt {
namespace geom {

constexpr int kThreads = 128;
constexpr int kTheta = 12;

template <int K>
__global__ void __launch_bounds__(kThreads)
    vpt_geom_kernel(const __grid_constant__ GeomParams G, const float* __restrict__ theta,
                    const int* __restrict__ seed, int base, int n_out,
                    float* __restrict__ out) {
  __shared__ float th[kTheta];
  if (threadIdx.x < kTheta) th[threadIdx.x] = theta[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int npix = G.base.width * G.base.height;
  const int lane = base + i;
  const int pixel = lane < npix - 1 ? lane : npix - 1;  // vpt's clamp
  float L[3 * (1 + K)];
  geom_pixel<K>(G, th, (uint32_t)lane, pixel, seed[0], L);
  for (int p = 0; p < 3 * (1 + K); ++p) out[(size_t)p * n_out + i] = L[p];
}

// the extended estimators: the same thread body with geom_pixel<K, true>
template <int K>
__global__ void __launch_bounds__(kThreads)
    vpt_geom_ext_kernel(const __grid_constant__ GeomParams G, const float* __restrict__ theta,
                        const int* __restrict__ seed, int base, int n_out,
                        float* __restrict__ out) {
  __shared__ float th[kTheta];
  if (threadIdx.x < kTheta) th[threadIdx.x] = theta[threadIdx.x];
  __syncthreads();
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_out) return;
  const int npix = G.base.width * G.base.height;
  const int lane = base + i;
  const int pixel = lane < npix - 1 ? lane : npix - 1;  // vpt's clamp
  float L[3 * (1 + K)];
  geom_pixel<K, true>(G, th, (uint32_t)lane, pixel, seed[0], L);
  for (int p = 0; p < 3 * (1 + K); ++p) out[(size_t)p * n_out + i] = L[p];
}

// one launch of K4 with K tangents; cudaGetLastError() after it
template <int K>
int launch(const GeomParams& G, const float* theta, const int* seed, int base, int n_out,
           float* out, cudaStream_t stream) {
  const int blocks = (n_out + kThreads - 1) / kThreads;
  vpt_geom_kernel<K><<<blocks, kThreads, 0, stream>>>(G, theta, seed, base, n_out, out);
  return (int)cudaGetLastError();
}
template <int K>
int launch_ext(const GeomParams& G, const float* theta, const int* seed, int base, int n_out,
               float* out, cudaStream_t stream) {
  const int blocks = (n_out + kThreads - 1) / kThreads;
  vpt_geom_ext_kernel<K><<<blocks, kThreads, 0, stream>>>(G, theta, seed, base, n_out, out);
  return (int)cudaGetLastError();
}

// the launcher of one K as a plain function, defined by csrc/geom_k<K>.cu
#define VPT_GEOM_LAUNCHER(K)                                                              \
  int launch_k##K(const GeomParams& G, const float* theta, const int* seed, int base,     \
                  int n_out, float* out, cudaStream_t stream)
VPT_GEOM_LAUNCHER(0);
VPT_GEOM_LAUNCHER(3);
VPT_GEOM_LAUNCHER(4);
VPT_GEOM_LAUNCHER(6);
VPT_GEOM_LAUNCHER(7);
VPT_GEOM_LAUNCHER(10);

// ... and of the extended estimators, defined by csrc/geom_ext_k<K>.cu
#define VPT_GEOM_EXT_LAUNCHER(K)                                                          \
  int launch_ext_k##K(const GeomParams& G, const float* theta, const int* seed, int base, \
                      int n_out, float* out, cudaStream_t stream)
VPT_GEOM_EXT_LAUNCHER(0);
VPT_GEOM_EXT_LAUNCHER(3);
VPT_GEOM_EXT_LAUNCHER(4);
VPT_GEOM_EXT_LAUNCHER(6);
VPT_GEOM_EXT_LAUNCHER(7);
VPT_GEOM_EXT_LAUNCHER(10);

}  // namespace geom
}  // namespace vpt
