// Host build of the render kernel's per-path code, for the CPU tests only.
//
// Compiles csrc/path.cuh with a C++ compiler and loops over the pixels in
// place of the CUDA grid, so the kernel's path code can be held against the
// plain torch version where there is no card
// (tests/test_torch_path_host.py). The renderer never uses it.
//
//   g++ -O2 -std=c++17 -ffp-contract=off -shared -fPIC path_host.cpp
#include "path.cuh"

extern "C" int vpt_params_words(void) { return (int)(sizeof(VptParams) / 4); }

// params: a VptParams; out: float32[npix * 3]
extern "C" void vpt_render_host(const void* params, int seed, float* out) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  const int npix = P.width * P.height;
  for (int p = 0; p < npix; ++p) vpt::render_pixel(P, p, seed, out + 3 * p);
}
