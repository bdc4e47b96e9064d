// Host build of the kernels' per-path code, for the CPU tests only.
//
// Compiles csrc/path.cuh and csrc/diff_path.cuh with a C++ compiler and
// loops over the pixels in place of the CUDA grid, so the kernels' path code
// can be held against the plain torch versions where there is no card
// (tests/test_torch_path_host.py). The renderer never uses it.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC path_host.cpp
#include "diff_path.cuh"

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
