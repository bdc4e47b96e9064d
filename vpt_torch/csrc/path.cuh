// Per-path device code of the forward render kernel
// (csrc/wavefront_kernel.cuh).
//
// Thread-scalar transcription of vpt's fused render kernel body
// (vpt/kernels/wavefront.py:266-741) and of the primitives it inlines
// (vpt/kernels/prims.py): free-flight and the two equi-angular distance
// samplers, with or without NEE, the physical RR compensation, the baked
// Henyey-Greenstein g, material-3 shells in pLight's cascade, samplers
// "random" and "ld", in a homogeneous medium or in an analytic density field
// (exp_height or Gaussian blobs). (nee, distance, field) are template
// parameters of render_pixel; the rest are launch parameters. Everything is
// __host__ __device__: nvcc builds it into the kernel, and the test build
// compiles the same header with g++ through csrc/path_host.cpp.
//
// Parity with vpt at one seed rests on three rules:
//  - the PCG stream is uint32 arithmetic (vpt: int32 with wraparound and
//    logical shifts) and the uniform comes from a mantissa bitcast;
//  - every iteration takes every draw vpt's body takes, in vpt's order,
//    whether or not the branch that uses it runs (Pcg::skip advances the
//    stream for the branches a thread does not take);
//  - every f32 operation keeps vpt's order and rounding: no FMA
//    contraction (nvcc --fmad=false, g++ -ffp-contract=off), constants
//    folded in double on the host exactly where vpt folds them in python
//    (VptParams carries them), and the same floors and epsilons.
// Only selected values are computed: vpt evaluates every material branch
// and selects, a thread evaluates the branch it selects, which gives the
// same value.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define VPT_HD __host__ __device__ __forceinline__
// the code of launch modes the main path does not take (HG g, material-3
// shells) stays out of line, so that it costs the main path no registers;
// static: each source that includes this header keeps its own copy
#define VPT_COLD static __host__ __device__ __noinline__
#else
#define VPT_HD inline
#define VPT_COLD inline
#endif

#define VPT_MAX_SPHERES 16
#define VPT_MAX_BLOBS 16

// One Gaussian blob of a density field and the constants its formulas fold
// (vpt folds them in float64 where it bakes the field, and computes them in
// f32 where its pair traces the blob; the host or the pair's kernel fills
// them accordingly): FieldBlob words of kernels/wavefront.py BLOB_KEYS.
struct FieldBlob {
  float cx, cy, cz, r, w;
  float dens_c;  // 1 / (r r)            field_density
  float tau_c;   // (1 / r)^2            field_tau
  float amp_c;   // r sqrt(pi / 2) w     field_tau
  float kh;      // (1 / r) sqrt(1 / 2)  field_tau
  float inv_r;   // 1 / r                the blob derivatives
  float ramp;    // r sqrt(pi / 2)       the blob derivatives
};

// An analytic density field (vpt/media/density.py), laid out by
// kernels/wavefront.py field_words(); all zeros in a homogeneous medium.
struct FieldParams {
  int kind;          // 1 exp_height, 2 blobs
  int n_blobs;       // blobs: rows in blob[]
  int max_null;      // blobs: delta-tracking null collisions per flight
  float k, y0;       // exp_height: d(x) = exp(-k (x_y - y0))
  float maj;         // majorant, f32
  float inv_maj;     // 1 / majorant, folded in double
  float inv_maj_rate;  // 1 / (sigma_t majorant), folded in double (K1)
  FieldBlob blob[VPT_MAX_BLOBS];
};

// A voxel-grid density field (vpt/media/density.py grid), laid out by
// kernels/wavefront.py grid_words(); all zeros without a grid. The values
// ride beside the launch as vpt's packed bf16 z-pair table (csrc/grid.cuh).
struct GridParams {
  int n[3];          // nx, ny, nz
  int n_march, m1;   // segments of the transport model, region A's share
  int nearest;       // transport interpolant: 0 trilinear, 1 xy-nearest
  float org[3];      // world min corner
  float inv_sp[3];   // 1 / spacing, folded in double
  float lo[3], hi[3];  // clamp rails, folded in double
  float cap;         // window cap: march_extent * diagonal, folded in double
  float inv_m1, inv_m2;  // 1 / M1, 1 / M2
};

// Launch parameters, laid out word by word by
// vpt_torch/kernels/wavefront.py Packed.words(). All fields are 4 bytes.
struct VptParams {
  int width, height, spp, max_bounces, max_iters;
  int ld, jitter;
  int n_spheres, n_emitters, n_mis, n_vol;
  int physical;                     // credit x 1/cp (textbook RR compensation)
  int emitters[VPT_MAX_SPHERES];    // emitter sphere ids (-1 padded)
  int mis_lights[VPT_MAX_SPHERES];  // r > 0 and radiance.x > 0
  int mat[VPT_MAX_SPHERES];         // material codes
  int vol[VPT_MAX_SPHERES];         // material-3 shells (-1 padded)
  float cam_o[3], cam_d[3], cx[3], cy[3];
  float inv_w, inv_h;               // 1/width, 1/height
  float q;                          // 1 - continue_prob
  float inv_cp;                     // 1 / continue_prob
  float sigma_t, inv_sigma_t;
  float tp_med;                     // (sigma_s / sigma_t) / cp
  float med_c;                      // n_emitters * (sigma_s / sigma_t) / cp
  float n_em_f;                     // n_emitters as f32
  float nee_phase;                  // (1 / 4pi) * 2pi
  float slack;                      // 1 - 1024 * FLT_EPSILON
  float ss_cp;                      // sigma_s / cp
  float g;                          // HG anisotropy, 0 = isotropic
  // HG constants folded in double (0 at g == 0): 1 + g^2, 2g,
  // (1/4pi)(1 - g^2), 1 - g^2, 1 - g, 1/(2g)
  float hg_1pg2, hg_2g, hg_phase, hg_1mg2, hg_1mg, hg_inv2g;
  float r[VPT_MAX_SPHERES];
  float r2[VPT_MAX_SPHERES];        // r*r folded in double
  float eps[VPT_MAX_SPHERES];       // 1e-4 + 16 * FLT_EPSILON * r, in double
  float alpha[VPT_MAX_SPHERES];
  float c[VPT_MAX_SPHERES][3];
  float alb[VPT_MAX_SPHERES][3];
  float rad[VPT_MAX_SPHERES][3];
  float eta[VPT_MAX_SPHERES][3];
  float kap[VPT_MAX_SPHERES][3];
  FieldParams field;                // read by the field instantiations only
  GridParams grid;                  // read by the grid instantiations only
};

namespace vpt {

constexpr double kPi = 3.141592653589793;
constexpr float BIG = 1e8f;
constexpr float INV_PI = (float)(1.0 / kPi);
constexpr float INV_4PI = (float)(1.0 / (4.0 * kPi));
constexpr float TWO_PI = (float)(2.0 * kPi);
constexpr float ETA_T = 1.5f;                           // glass, ETA_I = 1
constexpr float INV_RATIO2 = (float)((1.0 / 1.5) * (1.0 / 1.5));
constexpr float LD_A1 = (float)0.8812714616335696;
constexpr float LD_A2 = (float)0.7766393890897682;
constexpr float LD_A3 = (float)0.6844301295853426;
constexpr float LD_A4 = (float)0.6031687406857282;
constexpr float LD_A5 = (float)0.5315553977157913;
constexpr int MICROFACET = 1;
constexpr int DIELECTRIC = 2;

// ---- scalar helpers with jnp semantics ----------------------------------

// jnp.maximum / jnp.minimum propagate NaN (fmaxf/fminf do not)
VPT_HD float vmax(float a, float b) { return (a > b || a != a) ? a : b; }
VPT_HD float vmin(float a, float b) { return (a < b || a != a) ? a : b; }
VPT_HD float vclip(float x, float lo, float hi) { return vmin(vmax(x, lo), hi); }

VPT_HD float vrsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

VPT_HD float bits_to_float(uint32_t u) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(u);
#else
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
#endif
}

struct V3 {
  float x, y, z;
};

VPT_HD V3 mk(float x, float y, float z) {
  V3 r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
VPT_HD V3 neg3(V3 a) { return mk(-a.x, -a.y, -a.z); }
VPT_HD V3 sub3(V3 a, V3 b) { return mk(a.x - b.x, a.y - b.y, a.z - b.z); }
VPT_HD V3 add3(V3 a, V3 b) { return mk(a.x + b.x, a.y + b.y, a.z + b.z); }
VPT_HD V3 scale3(V3 a, float k) { return mk(a.x * k, a.y * k, a.z * k); }
VPT_HD V3 ray_at(V3 o, float t, V3 d) {  // o + t*d per component
  return mk(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
}
VPT_HD float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
VPT_HD float norm3(V3 a) { return sqrtf(vmax(dot3(a, a), 1e-20f)); }
VPT_HD V3 normalize3(V3 a) {
  float inv = vrsqrt(vmax(dot3(a, a), 1e-20f));
  return mk(a.x * inv, a.y * inv, a.z * inv);
}

// ---- PCG (vpt/kernels/prims.py Pcg, pcg_seed, ld_*) ---------------------

struct Pcg {
  uint32_t s;
  VPT_HD float next() {
    s = s * 747796405u + 2891336453u;
    uint32_t w = ((s >> ((s >> 28u) + 4u)) ^ s) * 277803737u;
    uint32_t x = (w >> 22u) ^ w;
    return bits_to_float((x >> 9u) | 0x3F800000u) - 1.0f;
  }
  // advance past n draws that a branch this thread skips would take
  VPT_HD void skip(int n) {
    for (int k = 0; k < n; ++k) s = s * 747796405u + 2891336453u;
  }
};

VPT_HD uint32_t pcg_seed(uint32_t lane, uint32_t seed) {
  uint32_t s = (lane * 2654435769u) ^ (seed * 2246822507u + 1u);
  return s * 747796405u + 2891336453u;
}

VPT_HD float ld_strat(float a, float off, float s_f) {
  float x = a * s_f + off;
  return x - floorf(x);
}

// ---- frames -------------------------------------------------------------

struct Onb {
  V3 s, t;
};

VPT_HD Onb onb(V3 n) {  // branch-free coordinateSystem (mathUtilities.h:10-19)
  bool cond = fabsf(n.x) > fabsf(n.y);
  float inv_a = vrsqrt(vmax(n.x * n.x + n.z * n.z, 1e-20f));
  float inv_b = vrsqrt(vmax(n.y * n.y + n.z * n.z, 1e-20f));
  V3 t = cond ? mk(n.z * inv_a, 0.0f, -n.x * inv_a)
              : mk(0.0f, n.z * inv_b, -n.y * inv_b);
  Onb b;
  b.s = mk(t.y * n.z - t.z * n.y, t.z * n.x - t.x * n.z, t.x * n.y - t.y * n.x);
  b.t = t;
  return b;
}

VPT_HD V3 to_local(V3 n, V3 w) {
  Onb b = onb(n);
  return normalize3(mk(dot3(w, b.s), dot3(w, b.t), dot3(w, n)));
}

VPT_HD V3 from_local(V3 n, V3 w) {
  Onb b = onb(n);
  return mk(b.s.x * w.x + b.t.x * w.y + n.x * w.z,
            b.s.y * w.x + b.t.y * w.y + n.y * w.z,
            b.s.z * w.x + b.t.z * w.y + n.z * w.z);
}

// ---- scene intersection -------------------------------------------------

// nearest-root t with the reference's rescue rule (Sphere.h:27-37)
VPT_HD float sphere_first_t(const VptParams& P, V3 o, V3 d, int s, bool& valid) {
  V3 oc = mk(o.x - P.c[s][0], o.y - P.c[s][1], o.z - P.c[s][2]);
  float b = dot3(oc, d);
  float c0 = dot3(oc, oc) - P.r2[s];
  float disc = P.r2[s] - (dot3(oc, oc) - b * b);
  bool pos = disc > 0.0f;
  float sq = sqrtf(pos ? disc : 1.0f) * (pos ? 1.0f : 0.0f);
  float sgn = b >= 0.0f ? 1.0f : -1.0f;
  float qq = -(b + sgn * sq);
  float other = c0 / (qq != 0.0f ? qq : 1.0f);
  float t1 = vmin(qq, other);
  float t2 = vmax(qq, other);
  float eps = P.eps[s];
  float t = (t1 < 0.0f || fabsf(t1) < eps) ? t2 : t1;
  valid = pos && t > 0.0f && fabsf(t) > eps;
  return t;
}

// nearest sphere id (-1 on a miss); t_out is its t (0 on a miss). Spheres
// whose bit is set in `skip` are left out (intersectVPT skips material 3).
VPT_HD int nearest_id_t(const VptParams& P, V3 o, V3 d, float& t_out, uint32_t skip = 0u) {
  float t_min = INFINITY;
  int sid = -1;
  for (int s = 0; s < P.n_spheres; ++s) {
    if ((skip >> s) & 1u) continue;
    bool valid;
    float t = sphere_first_t(P, o, d, s, valid);
    if (valid && t < t_min) {
      t_min = t;
      sid = s;
    }
  }
  t_out = sid >= 0 ? t_min : 0.0f;
  return sid;
}

struct Attr {  // per-lane sphere attributes; all zero on a miss
  V3 c;
  float alb[3], rad[3], eta[3], kap[3];
  float alpha;
  bool is_em, is_mic, is_die;
};

VPT_HD Attr attrs(const VptParams& P, int sid) {
  Attr a;
  if (sid < 0) {
    a.c = mk(0.0f, 0.0f, 0.0f);
    for (int i = 0; i < 3; ++i) a.alb[i] = a.rad[i] = a.eta[i] = a.kap[i] = 0.0f;
    a.alpha = 0.0f;
    a.is_em = a.is_mic = a.is_die = false;
    return a;
  }
  a.c = mk(P.c[sid][0], P.c[sid][1], P.c[sid][2]);
  for (int i = 0; i < 3; ++i) {
    a.alb[i] = P.alb[sid][i];
    a.rad[i] = P.rad[sid][i];
    a.eta[i] = P.eta[sid][i];
    a.kap[i] = P.kap[sid][i];
  }
  a.alpha = P.alpha[sid];
  a.is_em = a.rad[0] > 0.0f || a.rad[1] > 0.0f || a.rad[2] > 0.0f;
  a.is_mic = P.mat[sid] == MICROFACET;
  a.is_die = P.mat[sid] == DIELECTRIC;
  return a;
}

// raw both roots of sphere s (Sphere::intersectVPT, Sphere.h:39-45), both 0
// when the discriminant is not positive
VPT_HD void sphere_both_roots(const VptParams& P, V3 o, V3 d, int s, float& t1, float& t2) {
  V3 oc = mk(o.x - P.c[s][0], o.y - P.c[s][1], o.z - P.c[s][2]);
  float b = dot3(oc, d);
  float c0 = dot3(oc, oc) - P.r2[s];
  float disc = P.r2[s] - (dot3(oc, oc) - b * b);
  bool pos = disc > 0.0f;
  float sq = sqrtf(pos ? disc : 1.0f) * (pos ? 1.0f : 0.0f);
  float sgn = b >= 0.0f ? 1.0f : -1.0f;
  float qq = -(b + sgn * sq);
  float other = c0 / (qq != 0.0f ? qq : 1.0f);
  t1 = pos ? vmin(qq, other) : 0.0f;
  t2 = pos ? vmax(qq, other) : 0.0f;
}

// pLight attenuation (vptShadeMethods.h:62-91) without material-3 shells:
// cast from the light toward xs; visible -> 1/d^2 else 0
VPT_HD float plight_le_scale(const VptParams& P, V3 lc, V3 xs, float& dist, V3& dl) {
  V3 lx = sub3(xs, lc);
  dist = norm3(lx);
  float inv_d = 1.0f / dist;
  dl = scale3(lx, inv_d);
  float t;
  int sid = nearest_id_t(P, lc, dl, t);
  bool vis = (t > dist * P.slack) || sid < 0;
  return vis ? inv_d * inv_d : 0.0f;
}

// sigma_t of pLight's material-3 fallback, hard-coded by the reference
// (vptShadeMethods.h:72)
constexpr float SHELL_SIGMA_T = (float)(0.05 + 0.009);

// pLight's cascade where the light is not visible and the scene has
// material-3 shells: visible with the shells ignored -> 1/d^2 times
// multipleT at SHELL_SIGMA_T through them, else 0
VPT_COLD float plight_shell_scale(const VptParams& P, V3 lc, float dist, V3 dl) {
  uint32_t skip = 0u;
  for (int j = 0; j < P.n_vol; ++j) skip |= 1u << P.vol[j];
  float t_v;
  int sid_v = nearest_id_t(P, lc, dl, t_v, skip);
  if (!((t_v > dist * P.slack) || sid_v < 0)) return 0.0f;
  // multipleT on the reversed (xs -> light) ray: roots dist - t2 and
  // dist - t1 (volumetricBasicFunctions.h:26-57)
  float tau = 0.0f;
  for (int j = 0; j < P.n_vol; ++j) {
    float t1, t2;
    sphere_both_roots(P, lc, dl, P.vol[j], t1, t2);
    float r1 = dist - t2;
    float r2 = dist - t1;
    tau = tau + (r2 < 0.0f ? SHELL_SIGMA_T * r1 : 0.0f);
    tau = tau + (r2 - r1 > 0.0f ? SHELL_SIGMA_T * (r2 - r1) : 0.0f);
  }
  float inv_d = 1.0f / dist;
  return inv_d * inv_d * expf(-tau);
}

// pLight attenuation with the material-3 cascade (K1)
VPT_HD float plight_le_scale_vol(const VptParams& P, V3 lc, V3 xs, float& dist, V3& dl) {
  float scale = plight_le_scale(P, lc, xs, dist, dl);
  return (P.n_vol > 0 && scale == 0.0f) ? plight_shell_scale(P, lc, dist, dl) : scale;
}

// ---- Beckmann / Fresnel -------------------------------------------------

VPT_HD float ndf_beckmann(float cosine, float alpha) {
  float c2 = cosine * cosine;
  float inv_c2 = 1.0f / vmax(c2, 1e-4f);
  float inv_a2 = 1.0f / vmax(alpha * alpha, 1e-8f);
  float tan2 = vmax(1.0f - c2, 0.0f) * inv_c2;
  float val = expf(-tan2 * inv_a2) * (inv_a2 * INV_PI) * (inv_c2 * inv_c2);
  return cosine >= 0.0f ? val : 0.0f;
}

VPT_HD float g1(V3 n, V3 wv, V3 wh, float alpha) {
  float cos = dot3(n, wv);
  float sin = sqrtf(vmax(1.0f - cos * cos, 1e-12f));
  float cos_g = cos != 0.0f ? cos : 1e-12f;
  float a = cos_g / (vmax(alpha, 1e-6f) * (sin != 0.0f ? sin : 1e-12f * cos_g));
  float rational = (3.535f * a + 2.181f * a * a) / (1.0f + 2.276f * a + 2.577f * a * a);
  float g = a < 1.6f ? rational : 1.0f;
  bool same = dot3(wv, wh) * cos_g > 0.0f;
  return same ? g : 0.0f;
}

VPT_HD float fresnel_cond1(float cos, float sin2, float e, float k) {
  float e2k2 = e * e - k * k - sin2;
  float a2b2 = sqrtf(vmax(e2k2 * e2k2 + 4.0f * e * e * k * k, 1e-12f));
  float a = sqrtf(vmax(0.5f * (a2b2 + e * e - k * k - sin2), 1e-12f));
  float c2 = cos * cos;
  float pn = a2b2 + c2 - 2.0f * a * cos;
  float pd = a2b2 + c2 + 2.0f * a * cos;
  float sin4 = sin2 * sin2;
  float qn = a2b2 * c2 + sin4 - 2.0f * a * cos * sin2;
  float qd = a2b2 * c2 + sin4 + 2.0f * a * cos * sin2;
  return 0.5f * pn * (qn + qd) / (pd * qd);
}

VPT_HD void fresnel_cond(float cos, const Attr& at, float f[3]) {
  float sin2 = vmax(1.0f - cos * cos, 1e-12f);
  for (int i = 0; i < 3; ++i) f[i] = fresnel_cond1(cos, sin2, at.eta[i], at.kap[i]);
}

// Cook-Torrance in the local frame (n = +z)
VPT_HD void fr_microfacet(const Attr& at, V3 wi_l, V3 wh_l, V3 wo_l, float fr[3]) {
  V3 nz = mk(0.0f, 0.0f, 1.0f);
  float den = 4.0f * vmax(fabsf(wi_l.z) * fabsf(wo_l.z), 1e-12f);
  float f[3];
  fresnel_cond(dot3(wi_l, wh_l), at, f);
  float dg = ndf_beckmann(wh_l.z, at.alpha) * g1(nz, wi_l, wh_l, at.alpha) *
             g1(nz, wo_l, wh_l, at.alpha) / den;
  for (int i = 0; i < 3; ++i) fr[i] = f[i] * dg;
}

// Cook-Torrance in the global frame
VPT_HD void fr_microfacet_global(const Attr& at, V3 wi, V3 wh, V3 wo, V3 n, float fr[3]) {
  float den = 4.0f * vmax(fabsf(dot3(n, wi)) * fabsf(dot3(n, wo)), 1e-12f);
  float f[3];
  fresnel_cond(dot3(wi, wh), at, f);
  float dg = ndf_beckmann(dot3(n, wh), at.alpha) * g1(n, wi, wh, at.alpha) *
             g1(n, wo, wh, at.alpha) / den;
  for (int i = 0; i < 3; ++i) fr[i] = f[i] * dg;
}

VPT_HD float fresnel_die(float cos_t, float cos_i) {
  float par = (ETA_T * cos_i - cos_t) / (ETA_T * cos_i + cos_t);
  float perp = (cos_i - ETA_T * cos_t) / (cos_i + ETA_T * cos_t);
  return 0.5f * (par * par + perp * perp);
}

// reference refraction incl. the stray -1 (microFacetUtilities.h:123-141)
VPT_HD V3 refract_quirk(V3 wo, V3 n) {
  V3 wo_l = to_local(n, wo);
  float cos_i = dot3(wo, n);
  float s2 = vmax(1.0f - INV_RATIO2 * (1.0f - cos_i * cos_i), 1e-12f);
  float cos_t = sqrtf(s2);
  V3 wt_l = mk(wo_l.x * -1.5f, wo_l.y * -1.5f, cos_t - 1.0f);
  return normalize3(from_local(n, wt_l));
}

// ---- samplers -----------------------------------------------------------

VPT_HD V3 cone_dir(V3 wc, float cos_max, float u1, float u2) {
  float ct = vclip((1.0f - u1) + u1 * cos_max, -1.0f, 1.0f);
  float st = sqrtf(vmax(1.0f - ct * ct, 1e-12f));
  float phi = TWO_PI * u2;
  return normalize3(from_local(wc, mk(st * cosf(phi), st * sinf(phi), ct)));
}

VPT_HD V3 cosine_hemi(V3 n, float u1, float u2) {
  float ct = sqrtf(vmax(1.0f - u1, 0.0f));
  float st = sqrtf(vmax(u1, 0.0f));
  float phi = TWO_PI * u2;
  return normalize3(from_local(n, mk(st * cosf(phi), st * sinf(phi), ct)));
}

VPT_HD V3 uniform_sphere(float u1, float u2) {
  float ct = 1.0f - 2.0f * u1;
  float st = sqrtf(vmax(1.0f - ct * ct, 0.0f));
  float phi = TWO_PI * u2;
  return mk(st * cosf(phi), st * sinf(phi), ct);
}

// ---- equi-angular trig and Henyey-Greenstein (vpt/kernels/prims.py) ----
//
// vpt builds atan from a minimax polynomial and tan from sin/cos (Mosaic has
// neither primitive); the port keeps those forms so both round the same
// operations.

VPT_HD float atan_poly(float z) {
  float z2 = z * z;
  return z * (0.99997726f +
              z2 * (-0.33262347f +
                    z2 * (0.19354346f + z2 * (-0.11643287f + z2 * (0.05265332f + z2 * -0.01172120f)))));
}

VPT_HD float atan2_posx(float y, float x) {  // x > 0
  float z = y / x;
  bool inv = fabsf(z) > 1.0f;
  float zz = inv ? 1.0f / (z != 0.0f ? z : 1.0f) : z;
  float p = atan_poly(zz);
  float sgn = z >= 0.0f ? 1.0f : -1.0f;
  return inv ? sgn * (float)(kPi / 2.0) - p : p;
}

VPT_HD float tan_sc(float t) { return sinf(t) / cosf(t); }

// HG phase value at the packed g != 0; 1/d^1.5 as rsqrt(d)^3
VPT_COLD float hg_phase_const(const VptParams& P, float cos_t) {
  float den = vmax(P.hg_1pg2 - P.hg_2g * cos_t, 1e-12f);
  float rs = vrsqrt(den);
  return P.hg_phase * rs * rs * rs;
}

// HG direction around the propagation direction d (phase/pdf == 1)
VPT_COLD V3 hg_dir(const VptParams& P, V3 d, float u1, float u2) {
  float s = P.hg_1mg2 / (P.hg_1mg + P.hg_2g * u1);
  float cos_t = vclip((P.hg_1pg2 - s * s) * P.hg_inv2g, -1.0f, 1.0f);
  float sin_t = sqrtf(vmax(1.0f - cos_t * cos_t, 0.0f));
  float phi = TWO_PI * u2;
  return normalize3(from_local(d, mk(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
}

// The same at a traced g (the pair's diff_g, vpt's hg_phase_const on the
// vector, hg_dir_traced and dlog_hg_dg): f32 operations on g, a true
// division by 2g, the isotropic snap at |g| <= 1e-3 on the same draws
VPT_HD float hg_phase_traced(float cos_t, float g) {
  float den = vmax(1.0f + g * g - 2.0f * g * cos_t, 1e-12f);
  float rs = vrsqrt(den);
  return (INV_4PI * (1.0f - g * g)) * rs * rs * rs;
}

VPT_HD V3 hg_dir_traced(V3 d, float g, float u1, float u2) {
  if (!(fabsf(g) > 1e-3f)) return uniform_sphere(u1, u2);
  float s = (1.0f - g * g) / (1.0f - g + 2.0f * g * u1);
  float cos_t = vclip((1.0f + g * g - s * s) / (2.0f * g), -1.0f, 1.0f);
  float sin_t = sqrtf(vmax(1.0f - cos_t * cos_t, 0.0f));
  float phi = TWO_PI * u2;
  return normalize3(from_local(d, mk(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
}

// d/dg log hg(cos, g): the phase-draw score of the dL/dg estimator
VPT_HD float dlog_hg_dg(float cos_t, float g) {
  float den = vmax(1.0f + g * g - 2.0f * g * cos_t, 1e-12f);
  return (-2.0f * g) / vmax(1.0f - g * g, 1e-6f) - (3.0f * (g - cos_t)) / den;
}

VPT_HD V3 beckmann_wh(float alpha, float u1, float u2) {
  float t2 = vmax(-(alpha * alpha) * logf(vmax(1.0f - u1, 1e-20f)), 1e-20f);
  float ct = vrsqrt(1.0f + t2);
  float st = sqrtf(t2) * ct;
  float phi = TWO_PI * u2;
  return mk(st * cosf(phi), st * sinf(phi), ct);
}

// bdsf (vptShadeMethods.h:16-59) with its three draws given
VPT_HD void sample_bsdf(const Attr& at, V3 d, V3 n, float u1, float u2, float u_choice,
                        float fs[3], V3& wi, float& pdf) {
  V3 wo = neg3(d);
  if (at.is_mic) {
    V3 wh = from_local(n, beckmann_wh(at.alpha, u1, u2));
    float wh_dot_wo = dot3(wh, wo);
    wi = mk(2.0f * wh_dot_wo * wh.x - wo.x, 2.0f * wh_dot_wo * wh.y - wo.y,
            2.0f * wh_dot_wo * wh.z - wo.z);
    fr_microfacet_global(at, wi, wh, wo, n, fs);
    pdf = ndf_beckmann(dot3(wh, n), at.alpha) * dot3(wh, n) /
          (4.0f * vmax(fabsf(wh_dot_wo), 1e-12f));
  } else if (at.is_die) {
    V3 wt = refract_quirk(wo, n);
    float fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    bool refl = u_choice < fres;
    float ndotwo = dot3(n, wo);
    V3 wr = normalize3(mk(2.0f * ndotwo * n.x - wo.x, 2.0f * ndotwo * n.y - wo.y,
                          2.0f * ndotwo * n.z - wo.z));
    wi = refl ? wr : wt;
    float cos_d = dot3(n, wi);
    float inv_cos = 1.0f / (cos_d != 0.0f ? cos_d : 1e-12f);
    float s = refl ? inv_cos * fres : inv_cos * (1.0f - fres) * ETA_T * ETA_T;
    fs[0] = fs[1] = fs[2] = s;
    pdf = refl ? fres : 1.0f - fres;
  } else {
    wi = cosine_hemi(n, u1, u2);
    pdf = dot3(n, wi) * INV_PI;
    for (int i = 0; i < 3; ++i) fs[i] = at.alb[i] * INV_PI;
  }
}

// light-strategy fr: lambert / 0 (dielectric) / local microfacet
// (samplingFunctions.h:163-194); plight=true is pLight's variant, which has
// no dielectric branch (vptShadeMethods.h:83-87)
VPT_HD void eval_fr_nee(const Attr& at, V3 n, V3 wray, V3 wi, bool plight, float fr[3]) {
  if (at.is_mic) {
    V3 wi_l = to_local(n, wi);
    V3 wo_l = to_local(n, neg3(wray));
    V3 wh = normalize3(add3(wi_l, wo_l));
    fr_microfacet(at, wi_l, wh, wo_l, fr);
  } else if (at.is_die && !plight) {
    fr[0] = fr[1] = fr[2] = 0.0f;
  } else {
    for (int i = 0; i < 3; ++i) fr[i] = at.alb[i] * INV_PI;
  }
}

VPT_HD float bsdf_pdf_for_dir(const Attr& at, V3 n, V3 wo, V3 wi, float u_flip) {
  if (at.is_mic) {
    V3 wh = normalize3(add3(wi, wo));
    return ndf_beckmann(dot3(wh, n), at.alpha) * dot3(wh, n) /
           (4.0f * vmax(fabsf(dot3(wo, wh)), 1e-12f));
  }
  if (at.is_die) {
    V3 wt = refract_quirk(wo, n);
    float fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    return u_flip > fres ? 1.0f - fres : fres;
  }
  return dot3(n, wi) * INV_PI;
}

VPT_HD float power_h_invf(float f_inv, float g) {
  float r = vclip(g, 0.0f, 1e12f) * f_inv;
  return 1.0f / (1.0f + r * r);
}

VPT_HD float power_h_invg(float f, float g_inv) {
  float r = vclip(f, 0.0f, 1e12f) * g_inv;
  float r2 = r * r;
  return f > 0.0f ? r2 / (r2 + 1.0f) : 0.0f;
}

}  // namespace vpt

#include "field.cuh"
#include "grid.cuh"

namespace vpt {

// the medium's density: none, an analytic field (P.field) or a voxel grid
// (P.grid with its table), a compile-time parameter of the render and pair
// kernels so that each kind keeps its own code
enum FieldMode { kHomogeneous = 0, kAnalytic = 1, kGridField = 2 };

// the transmittance exp(-tau) along (o, d) to t >= 0 through the density
// (kAnalytic or kGridField)
template <int kField>
VPT_HD float field_tr(const VptParams& P, const uint32_t* tab, float sigma_t, V3 o, V3 d,
                      float t) {
  if constexpr (kField == kGridField)
    return expf(-grid_tau(P.grid, tab, sigma_t, o, d, t, true));
  else
    return field_tr_toward(P.field, sigma_t, o, d, t);
}

// ---- estimator pieces (vpt/kernels/wavefront.py) ------------------------

// MISv2 (misSamplingFunctions.h:96-170): takes 3 draws per MIS light, then 3.
// kField: the light strategy's transmittance through the density (tab: a
// grid's table).
template <int kField>
VPT_HD void mis_v2(const VptParams& P, Pcg& rng, const Attr& at, V3 xs, V3 n, V3 d,
                   float acc[3], const uint32_t* tab = nullptr) {
  acc[0] = acc[1] = acc[2] = 0.0f;
  V3 wo = neg3(d);
  for (int j = 0; j < P.n_mis; ++j) {
    int e = P.mis_lights[j];
    V3 cxv = mk(P.c[e][0] - xs.x, P.c[e][1] - xs.y, P.c[e][2] - xs.z);
    float normcx = norm3(cxv);
    float inv_ncx = 1.0f / normcx;
    V3 wc = scale3(cxv, inv_ncx);
    float ratio = P.r[e] * inv_ncx;
    float cos_max = sqrtf(vmax(1.0f - ratio * ratio, 1e-12f));
    float u1 = rng.next();
    float u2 = rng.next();
    V3 wi = cone_dir(wc, cos_max, u1, u2);
    float t_unused;
    int sid = nearest_id_t(P, xs, wi, t_unused);
    bool visible = sid >= 0 && sid == e;
    float fr[3];
    eval_fr_nee(at, n, d, wi, false, fr);
    float fpdf_inv = TWO_PI * vmax(1.0f - cos_max, 1e-12f);
    float tr;
    if constexpr (kField != kHomogeneous)
      tr = field_tr<kField>(P, tab, P.sigma_t, xs, wc, normcx);
    else
      tr = expf(-P.sigma_t * normcx);
    float w_vis = visible ? tr * dot3(n, wi) * fpdf_inv : 0.0f;
    float gpdf = bsdf_pdf_for_dir(at, n, wo, wi, rng.next());
    float wf = power_h_invf(fpdf_inv, gpdf);
    for (int i = 0; i < 3; ++i) acc[i] = acc[i] + P.rad[e][i] * fr[i] * w_vis * wf;
  }
  // BSDF strategy: sample the lane's lobe, one trace
  float u1 = rng.next(), u2 = rng.next(), u_choice = rng.next();
  float g[3], gpdf;
  // the lobe's direction first (the trace needs it), its weight after
  const V3 zero = mk(0.0f, 0.0f, 0.0f);
  V3 wi_sel = zero, wi_l = zero, wi_d = zero, wh_loc = zero, wo_loc = zero,
     wi_m_loc = zero;
  float fres = 0.0f;
  bool refl = false;
  if (at.is_mic) {
    wh_loc = beckmann_wh(at.alpha, u1, u2);
    wo_loc = to_local(n, wo);
    float whw = 2.0f * dot3(wh_loc, wo_loc);
    wi_m_loc = normalize3(mk(whw * wh_loc.x - wo_loc.x, whw * wh_loc.y - wo_loc.y,
                             whw * wh_loc.z - wo_loc.z));
    wi_sel = normalize3(from_local(n, wi_m_loc));
  } else if (at.is_die) {
    V3 wt = refract_quirk(wo, n);
    fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    refl = u_choice < fres;
    float ndotwo = dot3(n, wo);
    V3 wr = normalize3(mk(2.0f * ndotwo * n.x - wo.x, 2.0f * ndotwo * n.y - wo.y,
                          2.0f * ndotwo * n.z - wo.z));
    wi_d = refl ? wr : wt;
    wi_sel = wi_d;
  } else {
    wi_l = cosine_hemi(n, u1, u2);
    wi_sel = wi_l;
  }
  float t_unused;
  int sid = nearest_id_t(P, xs, wi_sel, t_unused);
  bool hit = sid >= 0;
  Attr h = attrs(P, sid);
  float hit_r = hit ? P.r[sid] : 0.0f;
  if (at.is_mic) {
    float fr_m[3];
    fr_microfacet(at, wi_m_loc, wh_loc, wo_loc, fr_m);
    float gpdf_m = ndf_beckmann(wh_loc.z, at.alpha) * wh_loc.z /
                   (4.0f * vmax(fabsf(dot3(wo_loc, wh_loc)), 1e-12f));
    float winv_m = wi_m_loc.z / vmax(gpdf_m, 1e-20f);
    for (int i = 0; i < 3; ++i) g[i] = h.rad[i] * fr_m[i] * winv_m;
    gpdf = gpdf_m;
  } else if (at.is_die) {
    float cos_d = fabsf(dot3(n, wi_d));
    float scale_d = (refl ? 1.0f : ETA_T * ETA_T) / vmax(cos_d, 1e-12f);
    for (int i = 0; i < 3; ++i) g[i] = h.rad[i] * scale_d;
    gpdf = refl ? fres : 1.0f - fres;
  } else {
    float gpdf_l = dot3(n, wi_l) * INV_PI;
    // (le*a/pi*cos_l) / (cos_l/pi) is exactly le*a, 0 when cos_l == 0
    for (int i = 0; i < 3; ++i) g[i] = gpdf_l != 0.0f ? h.rad[i] * at.alb[i] : 0.0f;
    gpdf = gpdf_l;
  }
  bool pos_all = g[0] > 0.0f && g[1] > 0.0f && g[2] > 0.0f;
  bool gate = at.is_mic ? g[0] > 0.0f : pos_all;
  V3 hcx = sub3(h.c, xs);
  float n2 = vmax(dot3(hcx, hcx), 1e-20f);
  float cmax = sqrtf(vmax(1.0f - hit_r * hit_r / n2, 1e-12f));
  float fpdf_h_inv = TWO_PI * vmax(1.0f - cmax, 1e-12f);
  float wg = (gate && hit) ? power_h_invg(gpdf, fpdf_h_inv) : 0.0f;
  for (int i = 0; i < 3; ++i) acc[i] = acc[i] + g[i] * wg;
}

// freeSingleScattering (volumetricBasicFunctions.h:284-340) with the
// missing-else point kill: point sources (lr == 0) contribute 0. d is the
// incoming propagation direction: at g != 0 the phase value toward the cone
// sample is HG. kField: the shadow ray's transmittance through the field.
// In a grid (kGridField) vpt leaves the transmittance out of the weight and
// multiplies the radiance by it after (its merged NEE march,
// vpt/kernels/wavefront.py:421-428, 614-626), which rounds differently.
template <int kField>
VPT_HD void medium_nee(const VptParams& P, V3 d, V3 xt, V3 lc, const float lrad[3], float lr,
                       int lid, float u1, float u2, float out[3],
                       const uint32_t* tab = nullptr) {
  V3 wc = sub3(lc, xt);
  float inv_mag = vrsqrt(vmax(dot3(wc, wc), 1e-20f));
  V3 wc_n = scale3(wc, inv_mag);
  float ratio = lr * inv_mag;
  float cos_max = sqrtf(vmax(1.0f - ratio * ratio, 1e-12f));
  V3 wl = cone_dir(wc_n, cos_max, u1, u2);
  float t;
  int sid = nearest_id_t(P, xt, wl, t);
  bool visible = sid >= 0 && sid == lid && lr > 0.0f;
  // phase / cone pdf = phase * 2pi * (1 - cos_max)
  float phase_2pi = P.g != 0.0f ? hg_phase_const(P, dot3(d, wl)) * TWO_PI : P.nee_phase;
  if constexpr (kField == kGridField) {
    float w = visible ? phase_2pi * vmax(1.0f - cos_max, 1e-12f) : 0.0f;
    float tr_l = expf(-grid_tau(P.grid, tab, P.sigma_t, xt, wl, t, true));
    for (int i = 0; i < 3; ++i) out[i] = lrad[i] * w * tr_l;
    return;
  }
  float tr_l;
  if constexpr (kField != kHomogeneous)
    tr_l = field_tr<kField>(P, tab, P.sigma_t, xt, wl, t);
  else
    tr_l = expf(-P.sigma_t * t);
  float w = visible ? tr_l * phase_2pi * vmax(1.0f - cos_max, 1e-12f) : 0.0f;
  for (int i = 0; i < 3; ++i) out[i] = lrad[i] * w;
}

// distance sampling: vpt's build_tile_renderer(distance=...)
enum Distance { kFree = 0, kEquiangular = 1, kEaClamped = 2 };

// One lane's spp samples (vpt/kernels/wavefront.py:698-737 for one lane):
// radiance SUMS into out. The lane seeds its streams with its id and its
// camera ray with `pixel` (min(lane, npix - 1)). It leaves its loop once
// samples == spp: vpt's tile keeps iterating until every lane is done, but a
// finished lane is frozen (alive and need stay false, so nothing more
// reaches L).
//
// Draws per iteration, in order (absent draws are absent in vpt's body too;
// skipped ones are taken with Pcg::skip): camera u, v ("random" with
// jitter); u_rr, u_pick; u_dist; u_ev (equi-angular families); with NEE the
// MISv2 draws, skipped on lanes that do not shade; BSDF u1, u2, u_choice;
// phase u_p1, u_p2; with NEE the two medium-NEE cone draws. In a blobs field
// the free flight takes 2 * max_null draws right after u_dist
// (field_sample_free).
//
// kField: the medium's density (FieldMode): an analytic field (P.field,
// exp_height or blobs) or a voxel grid (P.grid and its table tab). A flight
// may then escape (d_s == BIG off any surface), which kills the lane; every
// transmittance is the field's, and the equi-angular medium weight takes
// sigma_s(xt) = sigma_s d(xt). In a grid the free flight is one march of the
// transport model that also gives the surface's optical depth
// (grid_sample_free_and_tau; no extra draw: it inverts with u_dist), and
// the shadow rays march the same model.
template <bool kNee, int kDist, int kField = kHomogeneous>
VPT_HD void render_pixel(const VptParams& P, uint32_t lane, int pixel, int seed, float out[3],
                         const uint32_t* tab = nullptr) {
  const float px = (float)(pixel % P.width);
  const float py = (float)(P.height - 1 - pixel / P.width);
  float off[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (P.ld) {  // Cranley-Patterson offsets from a decorrelated stream
    Pcg r;
    r.s = pcg_seed(lane ^ 0x2545F491u, (uint32_t)seed + 747796405u);
    for (int k = 0; k < 5; ++k) off[k] = r.next();
  }
  Pcg rng;
  rng.s = pcg_seed(lane, (uint32_t)seed);
  const int n_em = P.n_emitters;
  // draws the MIS step takes; skipped on lanes that do not shade
  const int mis_draws = 3 * P.n_mis + 3;
  const V3 cam_o = mk(P.cam_o[0], P.cam_o[1], P.cam_o[2]);

  V3 o = mk(0.0f, 0.0f, 0.0f), d = mk(0.0f, 0.0f, 1.0f);
  float tp[3] = {0.0f, 0.0f, 0.0f};
  float L[3] = {0.0f, 0.0f, 0.0f};
  bool alive = false;
  int depth = 0, samples = 0;

  for (int it = 0; it < P.max_iters && samples < P.spp; ++it) {
    // ---- regenerate a dead lane: camera ray (draws u, v only when the
    // "random" sampler jitters)
    float u = 0.5f, v = 0.5f;
    if (P.ld && P.jitter) {
      float s_f = (float)samples;
      u = ld_strat(LD_A1, off[0], s_f);
      v = ld_strat(LD_A2, off[1], s_f);
    } else if (P.jitter) {
      u = rng.next();
      v = rng.next();
    }
    if (!alive) {
      float sx = (px + u - 0.5f) * P.inv_w - 0.5f;
      float sy = (py + v - 0.5f) * P.inv_h - 0.5f;
      d = normalize3(mk(P.cx[0] * sx + P.cy[0] * sy + P.cam_d[0],
                        P.cx[1] * sx + P.cy[1] * sy + P.cam_d[1],
                        P.cx[2] * sx + P.cy[2] * sy + P.cam_d[2]));
      o = cam_o;
      tp[0] = tp[1] = tp[2] = 1.0f;
      alive = true;
      depth = 0;
    }

    // ---- bounce
    float u_rr = rng.next();
    float u_pick = rng.next();
    if (P.ld && depth == 0) {
      float s_f = (float)samples;
      u_rr = ld_strat(LD_A4, off[3], s_f);
      u_pick = ld_strat(LD_A5, off[4], s_f);
    }
    // after regeneration every lane in this loop is alive; `live` is the
    // Russian-roulette survival of this iteration
    bool live = u_rr >= P.q;
    float t;
    int sid = nearest_id_t(P, o, d, t);
    bool hit = sid >= 0;
    Attr at = attrs(P, sid);
    float t_eff = hit ? t : BIG;
    V3 xs = ray_at(o, t_eff, d);
    V3 nrm = normalize3(sub3(xs, at.c));
    // uniform emitter pick
    int k = (int)(u_pick * P.n_em_f);
    k = k < 0 ? 0 : k;
    k = k > n_em - 1 ? n_em - 1 : k;
    int lid = -1;
    V3 lc = mk(0.0f, 0.0f, 0.0f);
    float lrad[3] = {0.0f, 0.0f, 0.0f}, lr = 0.0f;
    if (k >= 0) {
      lid = P.emitters[k];
      lc = mk(P.c[lid][0], P.c[lid][1], P.c[lid][2]);
      for (int i = 0; i < 3; ++i) lrad[i] = P.rad[lid][i];
      lr = P.r[lid];
    }

    float u_dist = rng.next();
    if (P.ld && depth == 0) u_dist = ld_strat(LD_A3, off[2], (float)samples);
    bool surface;
    V3 xt;
    // transmittance to the surface: the implicit free weight and the
    // equi-angular event probability
    float tr_actual = 0.0f;
    if constexpr (kField != kHomogeneous) {
      // in the field: equi-angular's event probability here, the implicit
      // free weight's (1 - Tr) on the medium lanes below (in a grid from
      // the free flight's march)
      if (kDist != kFree && hit) tr_actual = field_tr<kField>(P, tab, P.sigma_t, o, d, t);
    } else {
      if (kDist != kFree || (!kNee && !P.physical)) tr_actual = hit ? expf(-P.sigma_t * t) : 0.0f;
    }
    float d_along = 0.0f, pdf_success = 1.0f;
    if (kDist == kFree) {
      float d_s;
      if constexpr (kField == kGridField) {
        float tau_cap;
        d_s = grid_sample_free_and_tau(P.grid, tab, P.sigma_t, o, d, u_dist, t_eff, tau_cap);
        tr_actual = hit ? expf(-tau_cap) : 0.0f;
      } else if constexpr (kField == kAnalytic)
        d_s = field_sample_free(P.field, P.sigma_t, P.field.inv_maj_rate, o, d, u_dist, rng, t_eff);
      else
        d_s = -log1pf(-u_dist) * P.inv_sigma_t;
      surface = d_s > t_eff && hit;
      // an escaped flight kills the lane
      if (kField) live = live && (d_s < 0.5f * BIG || surface);
      xt = ray_at(o, d_s, d);
    } else {
      // equi-angular (equiAngularParams2, volumetricBasicFunctions.h:209-223)
      // or its clamped form (equiAngularParams, :180-207): the foot point
      // clamped into [o, xs], D measured from it to the light centre
      V3 lo = sub3(lc, o);
      float delta, D;
      V3 x0 = o;
      if (kDist == kEquiangular) {
        delta = dot3(lo, d);
        D = sqrtf(vmax(dot3(lo, lo) - delta * delta, 1e-12f));
      } else {
        delta = vmin(vmax(dot3(lo, d), 0.0f), t_eff);
        x0 = ray_at(o, delta, d);
        V3 x0c = sub3(x0, lc);
        D = sqrtf(vmax(dot3(x0c, x0c), 1e-12f));
      }
      float th_a = atan2_posx(-delta, D);
      float th_b = atan2_posx(t_eff - delta, D);
      // clipped: f32 tan reaches inf where cos == 0
      float sample_t = vclip(D * tan_sc((1.0f - u_dist) * th_a + u_dist * th_b), -BIG, BIG);
      if (kDist == kEquiangular) {
        d_along = sample_t + delta;
        xt = ray_at(o, d_along, d);
      } else {
        d_along = delta + sample_t;
        xt = ray_at(x0, sample_t, d);
      }
      float dist_pdf = D / (vmax(fabsf(th_b - th_a), 1e-12f) * (sample_t * sample_t + D * D));
      float u_ev = rng.next();
      surface = u_ev <= tr_actual && hit;
      // pSuccess = pdf * (1 - Tr), floored twice: the product can underflow
      // f32 where the medium is thin along the ray
      pdf_success = vmax(dist_pdf * vmax(1.0f - tr_actual, 1e-20f), 1e-30f);
    }

    bool em_hit = surface && at.is_em;
    if (live && em_hit && (!kNee || depth == 0)) {
      for (int i = 0; i < 3; ++i) {
        float add = at.rad[i] * tp[i];
        if (P.physical) add = add * P.inv_cp;  // compensate this iteration's RR
        L[i] = L[i] + add;
      }
    }
    bool shade = live && surface && !em_hit;
    bool medium = live && !surface;

    if (kNee) {
      if (shade) {  // surface NEE: pLight + MISv2
        float dist_l;
        V3 dl;
        float le_scale = plight_le_scale_vol(P, lc, xs, dist_l, dl);
        V3 wi = neg3(dl);
        float fr[3];
        eval_fr_nee(at, nrm, d, wi, true, fr);
        float cosw = dot3(nrm, wi);
        float trs;
        if constexpr (kField != kHomogeneous) {
          float inv_dl = 1.0f / vmax(dist_l, 1e-20f);
          V3 wlight = scale3(sub3(lc, xs), inv_dl);
          trs = field_tr<kField>(P, tab, P.sigma_t, xs, wlight, dist_l);
        } else {
          trs = expf(-P.sigma_t * dist_l);
        }
        float ldm[3];
        mis_v2<kField>(P, rng, at, xs, nrm, d, ldm, tab);
        for (int i = 0; i < 3; ++i) {
          float ldp = lrad[i] * le_scale * fr[i] * cosw;
          float ld = ldp * (trs * P.n_em_f) + ldm[i];
          L[i] = L[i] + ld * tp[i] * P.inv_cp;
        }
      } else {
        rng.skip(mis_draws);
      }
    }
    float b1 = rng.next(), b2 = rng.next(), b3 = rng.next();  // sample_bsdf
    float u_p1 = rng.next(), u_p2 = rng.next();               // phase
    float m1 = 0.0f, m2 = 0.0f;
    if (kNee) {  // medium NEE cone
      m1 = rng.next();
      m2 = rng.next();
    }

    if (shade) {
      float fs[3], pdf_b;
      V3 wi_s;
      sample_bsdf(at, d, nrm, b1, b2, b3, fs, wi_s, pdf_b);
      float wscale = dot3(nrm, wi_s) * P.inv_cp / vmax(pdf_b, 1e-20f);
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * fs[i] * wscale;
      o = xs;
      d = wi_s;
    } else if (medium) {
      float w_med;
      if (kDist == kFree) {
        if (kNee) {
          // explicit free flight: transmittance/pdf cancel analytically
          // (the PBRT simplification, vptShadeMethods.h:1248)
          float ld_med[3];
          medium_nee<kField>(P, d, xt, lc, lrad, lr, lid, m1, m2, ld_med, tab);
          for (int i = 0; i < 3; ++i) L[i] = L[i] + ld_med[i] * tp[i] * P.med_c;
          w_med = P.tp_med;
        } else if (P.physical) {
          w_med = P.tp_med;  // textbook: sigma_s * T / ffProb
        } else {
          // implicit free: (sigma_s / sigma_t) / (cp (1 - Tr))
          // (vptShadeMethods.h:977,1006)
          if constexpr (kField == kAnalytic)
            tr_actual = hit ? expf(-field_tau(P.field, P.sigma_t, o, d, t)) : 0.0f;
          w_med = P.tp_med / vmax(1.0f - tr_actual, 1e-20f);
        }
      } else {
        // equi-angular: T and pdf appear explicitly
        // (vptShadeMethods.h:1134-1146)
        float t_xt;
        if constexpr (kField == kGridField)  // the reverse march behind the origin
          t_xt = expf(-fabsf(grid_tau(P.grid, tab, P.sigma_t, o, d, d_along, false)));
        else if constexpr (kField == kAnalytic)  // tau is odd in t: |tau| behind the origin
          t_xt = expf(-fabsf(field_tau(P.field, P.sigma_t, o, d, d_along)));
        else
          t_xt = expf(-P.sigma_t * fabsf(d_along));
        float inv_pdf_s = 1.0f / pdf_success;
        w_med = P.ss_cp * t_xt * inv_pdf_s;
        if constexpr (kField == kGridField)  // sigma_s(xt), trilinear
          w_med = w_med * grid_density(P.grid, tab, xt);
        else if constexpr (kField == kAnalytic)
          w_med = w_med * field_density(P.field, xt);  // sigma_s(xt)
        if (kNee) {
          float ld_med[3];
          medium_nee<kField>(P, d, xt, lc, lrad, lr, lid, m1, m2, ld_med, tab);
          float scale = w_med * P.n_em_f;
          for (int i = 0; i < 3; ++i) L[i] = L[i] + ld_med[i] * scale * tp[i];
        }
      }
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * w_med;
      o = xt;
      d = P.g != 0.0f ? hg_dir(P, d, u_p1, u_p2) : uniform_sphere(u_p1, u_p2);
    }
    alive = (shade || medium) && depth + 1 < P.max_bounces;
    if (alive)
      depth = depth + 1;
    else
      samples = samples + 1;  // the path that started this sample ended
  }
  for (int i = 0; i < 3; ++i) out[i] = L[i];
}

// lanes per tile of the raw (sums) modes: vpt_torch.kernels.wavefront
// LANES_PER_TILE
constexpr int kLanesPerTile = 32 * 128;

// Lane i of a launch: lane i, or lane i % kLanesPerTile of tile i / kLanesPerTile
// from bases[]; writes the lane's sums (sums != 0) or its radiance / spp to
// out[3 i .. 3 i + 2]
template <bool kNee, int kDist, int kField = kHomogeneous>
VPT_HD void render_lane(const VptParams& P, int seed, const int* bases, int i,
                        int sums, float* out, const uint32_t* tab = nullptr) {
  const int npix = P.width * P.height;
  const int lane = bases ? bases[i / kLanesPerTile] + i % kLanesPerTile : i;
  const int pixel = lane < npix - 1 ? lane : npix - 1;
  float L[3];
  render_pixel<kNee, kDist, kField>(P, (uint32_t)lane, pixel, seed, L, tab);
  const float spp = (float)P.spp;
  for (int c = 0; c < 3; ++c) out[3 * i + c] = sums ? L[c] : L[c] / spp;
}

}  // namespace vpt
