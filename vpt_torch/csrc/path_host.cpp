// Host build of the kernels' per-path code, for the CPU tests only.
//
// Compiles csrc/path.cuh, csrc/diff_path.cuh and csrc/geom_path.cuh with a
// C++ compiler and loops over the pixels in place of the CUDA grid, so the
// kernels' path code can be held against the plain torch versions where
// there is no card
// (tests/test_torch_path_host.py). The renderer never uses it.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC path_host.cpp
#include "diff_path.cuh"
#include "geom_path.cuh"

extern "C" int vpt_params_words(void) { return (int)(sizeof(VptParams) / 4); }

extern "C" int vpt_diff_params_words(void) { return (int)(sizeof(DiffParams) / 4); }

// params: a VptParams; out: float32[npix * 3]
extern "C" void vpt_render_host(const void* params, int seed, float* out) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  const int npix = P.width * P.height;
  for (int p = 0; p < npix; ++p) vpt::render_pixel(P, p, seed, out + 3 * p);
}

// K2's path code. params: a DiffParams; pvec: float32[P];
// out: float32[npix * 3], the radiance sums divided by spp
extern "C" void vpt_diff_fwd_host(const void* params, const float* pvec, int seed, float* out) {
  DiffParams D;
  memcpy(&D, params, sizeof D);
  const int npix = D.base.width * D.base.height;
  for (int p = 0; p < npix; ++p) vpt::diff_pixel<false>(D, pvec, p, seed, nullptr, out + 3 * p, nullptr);
}

// K3's path code. gbar: float32[npix * 3]; gout: float32[npix * P], each
// pixel's own gradient vector (the kernel sums them by block)
extern "C" void vpt_diff_bwd_host(const void* params, const float* pvec, int seed,
                                  const float* gbar, float* gout) {
  DiffParams D;
  memcpy(&D, params, sizeof D);
  const int npix = D.base.width * D.base.height;
  for (int p = 0; p < npix; ++p)
    vpt::diff_pixel<true>(D, pvec, p, seed, gbar + 3 * p, nullptr, gout + (size_t)D.n_params * p);
}

extern "C" int vpt_geom_params_words(void) { return (int)(sizeof(GeomParams) / 4); }

template <int K>
static void geom_host(const GeomParams& G, const float* theta, int seed, float* out) {
  const int npix = G.base.width * G.base.height;
  float L[3 * (1 + K)];
  for (int p = 0; p < npix; ++p) {
    vpt::geom::geom_pixel<K>(G, theta, (uint32_t)p, p, seed, L);
    for (int j = 0; j < 3 * (1 + K); ++j) out[(size_t)j * npix + p] = L[j];
  }
}

// K4's path code. params: a GeomParams; theta: float32[12];
// out: float32[3 (1 + K) * npix], K4's planes. Returns -1 for a K the
// kernel is not built for.
extern "C" int vpt_geom_fwd_host(const void* params, const float* theta, int seed, float* out) {
  GeomParams G;
  memcpy(&G, params, sizeof G);
  switch (G.n_tan) {
    case 0: geom_host<0>(G, theta, seed, out); return 0;
    case 3: geom_host<3>(G, theta, seed, out); return 0;
    case 4: geom_host<4>(G, theta, seed, out); return 0;
    case 6: geom_host<6>(G, theta, seed, out); return 0;
    case 7: geom_host<7>(G, theta, seed, out); return 0;
    case 10: geom_host<10>(G, theta, seed, out); return 0;
    default: return -1;
  }
}
