// Host build of the kernels' per-path code, for the CPU tests only.
//
// Compiles csrc/path.cuh (with csrc/field.cuh and grid.cuh), csrc/diff_path.cuh and
// csrc/geom_path.cuh with a
// C++ compiler and loops over the pixels in place of the CUDA grid, so the
// kernels' path code can be held against the plain torch versions where
// there is no card
// (tests/test_torch_path_host.py). The renderer never uses it.
//
//   g++ -O1 -std=c++17 -ffp-contract=off -shared -fPIC path_host.cpp
#include "diff_path.cuh"
#include "geom_path.cuh"

extern "C" int vpt_params_words(void) { return (int)(sizeof(VptParams) / 4); }

extern "C" int vpt_diff_params_words(void) { return (int)(sizeof(DiffParams) / 4); }

template <bool kNee, int kDist, int kField>
static void render_host(const VptParams& P, int seed, const int* bases, int n_lanes,
                        int sums, float* out, const uint32_t* tab = nullptr) {
  for (int i = 0; i < n_lanes; ++i)
    vpt::render_lane<kNee, kDist, kField>(P, seed, bases, i, sums, out, tab);
}

// K1's path code, the lanes of one launch of csrc/wavefront_kernel.cuh.
// params: a VptParams; variant: 0 free + NEE, 1 free, 2 equi-angular + NEE,
// 3 clamped equi-angular (the kernel's instantiations), 4-7 the same in a
// density field; bases: int32 tile bases or NULL; out: float32[n_lanes * 3].
// Returns -1 for another variant.
extern "C" int vpt_render_host(const void* params, int variant, int seed, const int* bases,
                               int n_lanes, int sums, float* out) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  switch (variant) {
    case 0: render_host<true, vpt::kFree, false>(P, seed, bases, n_lanes, sums, out); break;
    case 1: render_host<false, vpt::kFree, false>(P, seed, bases, n_lanes, sums, out); break;
    case 2: render_host<true, vpt::kEquiangular, false>(P, seed, bases, n_lanes, sums, out); break;
    case 3: render_host<false, vpt::kEaClamped, false>(P, seed, bases, n_lanes, sums, out); break;
    case 4: render_host<true, vpt::kFree, true>(P, seed, bases, n_lanes, sums, out); break;
    case 5: render_host<false, vpt::kFree, true>(P, seed, bases, n_lanes, sums, out); break;
    case 6: render_host<true, vpt::kEquiangular, true>(P, seed, bases, n_lanes, sums, out); break;
    case 7: render_host<false, vpt::kEaClamped, true>(P, seed, bases, n_lanes, sums, out); break;
    default: return -1;
  }
  return 0;
}

// K1's grid instantiations (csrc/wavefront_grid*.cu): variant as above (0-3),
// tab the grid's packed table uint32[nx * ny * nz]
extern "C" int vpt_render_grid_host(const void* params, int variant, int seed, const int* bases,
                                    int n_lanes, int sums, const uint32_t* tab, float* out) {
  VptParams P;
  memcpy(&P, params, sizeof P);
  constexpr int g = vpt::kGridField;
  switch (variant) {
    case 0: render_host<true, vpt::kFree, g>(P, seed, bases, n_lanes, sums, out, tab); break;
    case 1: render_host<false, vpt::kFree, g>(P, seed, bases, n_lanes, sums, out, tab); break;
    case 2: render_host<true, vpt::kEquiangular, g>(P, seed, bases, n_lanes, sums, out, tab); break;
    case 3: render_host<false, vpt::kEaClamped, g>(P, seed, bases, n_lanes, sums, out, tab); break;
    default: return -1;
  }
  return 0;
}

// The pair's pixels through the instantiation the kernels' wrapper picks:
// kField where the scene has a field, kHG where D.hg_mode is set
template <bool kGrads, bool kField, bool kHG>
static void pair_host(const DiffParams& D, const float* pvec, const FieldParams& F, int seed,
                      const float* gbar, float* out) {
  const int npix = D.base.width * D.base.height;
  for (int p = 0; p < npix; ++p) {
    if constexpr (kGrads)
      vpt::diff_pixel<true, kField, kHG>(D, pvec, F, p, seed, gbar + 3 * p, nullptr,
                                         out + (size_t)D.n_params * p);
    else
      vpt::diff_pixel<false, kField, kHG>(D, pvec, F, p, seed, nullptr, out + 3 * p, nullptr);
  }
}

template <bool kGrads>
static void pair_host(const void* params, const float* pvec, int seed, const float* gbar,
                      float* out) {
  DiffParams D;
  memcpy(&D, params, sizeof D);
  FieldParams F;
  vpt::pair_field(D, pvec, F);
  const bool field = F.kind != 0, hg = D.hg_mode != 0;
  if (field && hg)
    pair_host<kGrads, true, true>(D, pvec, F, seed, gbar, out);
  else if (field)
    pair_host<kGrads, true, false>(D, pvec, F, seed, gbar, out);
  else if (hg)
    pair_host<kGrads, false, true>(D, pvec, F, seed, gbar, out);
  else
    pair_host<kGrads, false, false>(D, pvec, F, seed, gbar, out);
}

// K2's path code. params: a DiffParams; pvec: float32[P]; out:
// float32[npix * 3], the radiance sums divided by spp
extern "C" void vpt_diff_fwd_host(const void* params, const float* pvec, int seed, float* out) {
  pair_host<false>(params, pvec, seed, nullptr, out);
}

// K3's path code. gbar: float32[npix * 3]; gout: float32[npix * P], each
// pixel's own gradient vector (the kernel sums them by block)
extern "C" void vpt_diff_bwd_host(const void* params, const float* pvec, int seed,
                                  const float* gbar, float* gout) {
  pair_host<true>(params, pvec, seed, gbar, gout);
}

// The pair's path code in a voxel grid (tab: the packed table). gout, K3:
// float32[npix * P]; ggrid: NULL, or float32[T] (diff_grid) that gains the
// voxel gradient
extern "C" void vpt_diff_grid_host(const void* params, const float* pvec, int seed,
                                   const float* gbar, const uint32_t* tab, float* out,
                                   float* ggrid) {
  DiffParams D;
  memcpy(&D, params, sizeof D);
  const FieldParams& F = D.base.field;
  const int npix = D.base.width * D.base.height;
  constexpr int g = vpt::kGridField;
  for (int p = 0; p < npix; ++p) {
    if (gbar != nullptr)
      vpt::diff_pixel<true, g, false>(D, pvec, F, p, seed, gbar + 3 * p, nullptr,
                                      out + (size_t)D.n_params * p, tab, ggrid);
    else
      vpt::diff_pixel<false, g, false>(D, pvec, F, p, seed, nullptr, out + 3 * p, nullptr, tab);
  }
}

// The extended instantiations' path code (diff_pixel<..., true, true>,
// csrc/diff_ext*.cu): a homogeneous medium, an analytic field or (tab set)
// a voxel grid, picked as the wrapper picks them. gbar NULL: K2, out
// float32[npix * 3]; else K3, out float32[npix * P], ggrid NULL or
// float32[T] (diff_grid)
template <int kField>
static void ext_host(const DiffParams& D, const float* pvec, const FieldParams& F, int seed,
                     const float* gbar, const uint32_t* tab, float* out, float* ggrid) {
  const int npix = D.base.width * D.base.height;
  for (int p = 0; p < npix; ++p) {
    if (gbar != nullptr)
      vpt::diff_pixel<true, kField, true, true>(D, pvec, F, p, seed, gbar + 3 * p, nullptr,
                                                out + (size_t)D.n_params * p, tab, ggrid);
    else
      vpt::diff_pixel<false, kField, true, true>(D, pvec, F, p, seed, nullptr, out + 3 * p,
                                                 nullptr, tab);
  }
}

extern "C" void vpt_diff_ext_host(const void* params, const float* pvec, int seed,
                                  const float* gbar, const uint32_t* tab, float* out,
                                  float* ggrid) {
  DiffParams D;
  memcpy(&D, params, sizeof D);
  FieldParams F;
  vpt::pair_field(D, pvec, F);
  if (tab != nullptr)
    ext_host<vpt::kGridField>(D, pvec, F, seed, gbar, tab, out, ggrid);
  else if (F.kind != 0)
    ext_host<vpt::kAnalytic>(D, pvec, F, seed, gbar, nullptr, out, nullptr);
  else
    ext_host<vpt::kHomogeneous>(D, pvec, F, seed, gbar, nullptr, out, nullptr);
}

extern "C" int vpt_geom_params_words(void) { return (int)(sizeof(GeomParams) / 4); }

template <int K, bool kExt>
static void geom_host(const GeomParams& G, const float* theta, int seed, float* out) {
  const int npix = G.base.width * G.base.height;
  float L[3 * (1 + K)];
  for (int p = 0; p < npix; ++p) {
    vpt::geom::geom_pixel<K, kExt>(G, theta, (uint32_t)p, p, seed, L);
    for (int j = 0; j < 3 * (1 + K); ++j) out[(size_t)j * npix + p] = L[j];
  }
}

template <bool kExt>
static int geom_host_k(const GeomParams& G, const float* theta, int seed, float* out) {
  switch (G.n_tan) {
    case 0: geom_host<0, kExt>(G, theta, seed, out); return 0;
    case 3: geom_host<3, kExt>(G, theta, seed, out); return 0;
    case 4: geom_host<4, kExt>(G, theta, seed, out); return 0;
    case 6: geom_host<6, kExt>(G, theta, seed, out); return 0;
    case 7: geom_host<7, kExt>(G, theta, seed, out); return 0;
    case 10: geom_host<10, kExt>(G, theta, seed, out); return 0;
    default: return -1;
  }
}

// K4's path code. params: a GeomParams; theta: float32[12];
// out: float32[3 (1 + K) * npix], K4's planes; ext: the extended
// estimators (geom_pixel<K, true>). Returns -1 for a K the kernel is not
// built for.
extern "C" int vpt_geom_fwd_host(const void* params, const float* theta, int seed, int ext,
                                 float* out) {
  GeomParams G;
  memcpy(&G, params, sizeof G);
  return ext ? geom_host_k<true>(G, theta, seed, out) : geom_host_k<false>(G, theta, seed, out);
}
