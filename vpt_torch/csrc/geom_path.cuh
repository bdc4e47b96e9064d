// Per-path device code of the geometric-gradient kernel K4 (csrc/geom.cu):
// forward-mode dual numbers, one template geom_pixel<K> for K tangents.
//
// Thread-scalar transcription of vpt's geom kernel body
// (vpt/kernels/geom.py:182-599) and of the dual primitives it inlines
// (vpt/kernels/dual.py), samplers "random" and "ld". geom_pixel<K>
// (csrc/geom_k<K>.cu) is the free-flight NEE estimator in a homogeneous
// medium, not physical, isotropic; geom_pixel<K, kExt = true>
// (csrc/geom_ext_k<K>.cu) reads the estimator from GeomParams at run time:
// vpt's equi-angular branch, nee on or off, the physical credit, a baked HG
// g; geom_pixel<K, true, kField = true> (csrc/geom_field_k<K>.cu) does the
// same in a density field: exp_height or blobs in dual form (the kind read
// from FieldParams at run time), or at K = 0 a voxel grid (csrc/grid.cuh's
// plain march and trilinear on the primal values). vpt's K4 has no
// material-3 shell cascade (its pLight visibility is the plain
// nearest_id_t), so a shell is a Lambertian sphere to every trace in both:
// the default estimator on a shell scene runs in geom_pixel<K>. It reuses
// csrc/path.cuh's float
// helpers (Pcg, ld_strat, VptParams with the per-sphere eps and r*r folded
// in double, the plain samplers) and its parity rules: uint32 PCG, every
// draw in vpt's order (K2's), no FMA contraction, only the selected branch
// evaluated.
//
// Dual<K> is a primal and K tangent floats. vpt's D keeps structural zeros
// (None) and never computes them; here every component is computed, which
// gives the same values (x + 0 == x, 0 * finite == 0) except where a primal
// is inf or NaN. The primal's rounding follows vpt's dual.py, not the
// forward kernel's:
//  - a division with a dual on either side (ddiv) takes one reciprocal and
//    multiplies by it, the value and every tangent; a division of two plain
//    values stays a true division. vpt's loop carry rebuilds o, d, tp and L
//    as duals every iteration, even at K = 0, so nearly every path quantity
//    is dual and divides by reciprocal-multiply in every instantiation;
//  - the association of the NEE sums, 1/max(d^2, eps) for pLight, the
//    camera basis in f32 from theta, sigma_t, 1/sigma_t and
//    (sigma_s/sigma_t)/cp in f32 from theta (geom.py:202-231, 310, 539-567).
// So the primal plane is not bit-equal to K1's image (vpt's own contract is
// q99 < 1e-4), and does not depend on K.
//
// theta (12 floats): [centre 3, cam_origin 3, fov, sigma_a, sigma_s,
// cam_dir 3]. The centre of G.sphere, the camera and sigma come from theta;
// every other sphere is baked. Tangent k seeds 1 on theta entry slot(k):
// the centre block at k < n_center, origin + fov at k_cam.., the look
// direction at k_dir.. .
#pragma once

#include "path.cuh"

// Launch parameters of K4, laid out word by word by
// vpt_torch/kernels/geom.py GeomPacked.words().
struct GeomParams {
  VptParams base;  // scene, frame and estimator constants (K1's)
  int sphere;      // the sphere whose centre comes from theta; -1: none
  int n_tan;       // K: 3 * n_center/3 + n_cam + n_dir
  int n_center;    // 3 or 0
  int n_cam;       // 4 or 0
  int n_dir;       // 3 or 0
  int k_cam;       // first camera tangent
  int k_dir;       // first look-direction tangent
  float aspect;    // f32(width / height)
  float cp;        // continue_prob as f32
  // the estimator, read by the extended instantiations only
  int ea;          // 1: vpt's equi-angular branch (any distance but "free")
  int nee;         // 1: pLight + MISv2 and medium NEE; 0: implicit
  int physical;    // 1: credited emission times 1/cp
  int hg;          // 1: the baked HG g (VptParams.hg_*)
};

namespace vpt {
namespace geom {

#define VPT_FOR_K for (int k = 0; k < K; ++k)

template <int K>
struct Dual {
  float v;
  float t[K > 0 ? K : 1];
};

template <int K>
VPT_HD Dual<K> cst(float v) {  // a plain value: zero tangents
  Dual<K> r;
  r.v = v;
  VPT_FOR_K r.t[k] = 0.0f;
  return r;
}

// ---- arithmetic (dual.py D: __add__, __sub__, __rsub__, __mul__) --------

template <int K>
VPT_HD Dual<K> operator+(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v + b.v;
  VPT_FOR_K r.t[k] = a.t[k] + b.t[k];
  return r;
}
template <int K>
VPT_HD Dual<K> operator+(const Dual<K>& a, float b) {
  Dual<K> r = a;
  r.v = a.v + b;
  return r;
}
template <int K>
VPT_HD Dual<K> operator+(float a, const Dual<K>& b) {
  return b + a;
}
template <int K>
VPT_HD Dual<K> operator-(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v - b.v;
  VPT_FOR_K r.t[k] = a.t[k] - b.t[k];
  return r;
}
template <int K>
VPT_HD Dual<K> operator-(const Dual<K>& a, float b) {
  Dual<K> r = a;
  r.v = a.v - b;
  return r;
}
template <int K>
VPT_HD Dual<K> operator-(float a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a - b.v;
  VPT_FOR_K r.t[k] = -b.t[k];
  return r;
}
template <int K>
VPT_HD Dual<K> operator-(const Dual<K>& a) {
  Dual<K> r;
  r.v = -a.v;
  VPT_FOR_K r.t[k] = -a.t[k];
  return r;
}
template <int K>
VPT_HD Dual<K> operator*(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r;
  r.v = a.v * b.v;
  VPT_FOR_K r.t[k] = a.t[k] * b.v + b.t[k] * a.v;
  return r;
}
template <int K>
VPT_HD Dual<K> operator*(const Dual<K>& a, float b) {
  Dual<K> r;
  r.v = a.v * b;
  VPT_FOR_K r.t[k] = a.t[k] * b;
  return r;
}
template <int K>
VPT_HD Dual<K> operator*(float a, const Dual<K>& b) {
  return b * a;
}

// division with a dual side: one reciprocal (dual.py __truediv__ and
// __rtruediv__). There is no operator/ for Dual on purpose: every dual
// division is spelled ddiv, every plain one is a float '/'.
template <int K>
VPT_HD Dual<K> ddiv(const Dual<K>& a, const Dual<K>& b) {
  const float inv = 1.0f / b.v;
  Dual<K> r;
  r.v = a.v * inv;
  const float w = -r.v * inv;
  VPT_FOR_K r.t[k] = a.t[k] * inv + b.t[k] * w;
  return r;
}
template <int K>
VPT_HD Dual<K> ddiv(float a, const Dual<K>& b) {
  const float inv = 1.0f / b.v;
  Dual<K> r;
  r.v = a * inv;
  const float w = -r.v * inv;
  VPT_FOR_K r.t[k] = b.t[k] * w;
  return r;
}

// ---- functions (dual.py sqrt, rsqrt, exp, absd, maximum, minimum) -------

template <int K>
VPT_HD Dual<K> dsqrt(const Dual<K>& a) {
  Dual<K> r;
  r.v = sqrtf(a.v);
  const float inv2s = 0.5f / (r.v > 0.0f ? r.v : 1.0f);
  const float s = r.v > 0.0f ? inv2s : 0.0f;
  VPT_FOR_K r.t[k] = a.t[k] * s;
  return r;
}
template <int K>
VPT_HD Dual<K> drsqrt(const Dual<K>& a) {
  Dual<K> r;
  r.v = vrsqrt(a.v);
  const float s = -0.5f * r.v * r.v * r.v;
  VPT_FOR_K r.t[k] = a.t[k] * s;
  return r;
}
template <int K>
VPT_HD Dual<K> dexp(const Dual<K>& a) {
  Dual<K> r;
  r.v = expf(a.v);
  VPT_FOR_K r.t[k] = a.t[k] * r.v;
  return r;
}
template <int K>
VPT_HD Dual<K> dabs(const Dual<K>& a) {
  Dual<K> r;
  r.v = fabsf(a.v);
  const float s = a.v >= 0.0f ? 1.0f : -1.0f;
  VPT_FOR_K r.t[k] = a.t[k] * s;
  return r;
}
// the tangent of the winner; a tie goes to the first argument
template <int K>
VPT_HD Dual<K> dsin(const Dual<K>& a) {
  Dual<K> r;
  r.v = sinf(a.v);
  const float c = cosf(a.v);
  VPT_FOR_K r.t[k] = a.t[k] * c;
  return r;
}
template <int K>
VPT_HD Dual<K> dcos(const Dual<K>& a) {
  Dual<K> r;
  r.v = cosf(a.v);
  const float s = -sinf(a.v);
  VPT_FOR_K r.t[k] = a.t[k] * s;
  return r;
}
template <int K>
VPT_HD Dual<K> dmax(const Dual<K>& a, float b) {
  if (a.v >= b) return a;
  Dual<K> r = cst<K>(vmax(a.v, b));  // b, or a NaN a
  return r;
}
template <int K>
VPT_HD Dual<K> dmin(const Dual<K>& a, float b) {
  if (a.v <= b) return a;
  return cst<K>(vmin(a.v, b));
}
template <int K>
VPT_HD Dual<K> dmax(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r = a.v >= b.v ? a : b;
  r.v = vmax(a.v, b.v);
  return r;
}
template <int K>
VPT_HD Dual<K> dmin(const Dual<K>& a, const Dual<K>& b) {
  Dual<K> r = a.v <= b.v ? a : b;
  r.v = vmin(a.v, b.v);
  return r;
}
template <int K>
VPT_HD Dual<K> dclip(const Dual<K>& a, float lo, float hi) {
  return dmin(dmax(a, lo), hi);
}

// ---- vec3 of duals ------------------------------------------------------

template <int K>
struct DV3 {
  Dual<K> x, y, z;
};

template <int K>
VPT_HD DV3<K> mkd(const Dual<K>& x, const Dual<K>& y, const Dual<K>& z) {
  DV3<K> r;
  r.x = x;
  r.y = y;
  r.z = z;
  return r;
}
template <int K>
VPT_HD DV3<K> cst3(V3 a) {
  return mkd(cst<K>(a.x), cst<K>(a.y), cst<K>(a.z));
}
template <int K>
VPT_HD Dual<K> dot3(const DV3<K>& a, const DV3<K>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <int K>
VPT_HD Dual<K> dot3(const DV3<K>& a, V3 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <int K>
VPT_HD Dual<K> dot3(V3 a, const DV3<K>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
template <int K>
VPT_HD DV3<K> neg3(const DV3<K>& a) {
  return mkd(-a.x, -a.y, -a.z);
}
template <int K>
VPT_HD DV3<K> sub3(const DV3<K>& a, const DV3<K>& b) {
  return mkd(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <int K>
VPT_HD DV3<K> sub3(const DV3<K>& a, V3 b) {
  return mkd(a.x - b.x, a.y - b.y, a.z - b.z);
}
template <int K>
VPT_HD DV3<K> add3(const DV3<K>& a, const DV3<K>& b) {
  return mkd(a.x + b.x, a.y + b.y, a.z + b.z);
}
template <int K>
VPT_HD DV3<K> scale3(const DV3<K>& a, const Dual<K>& s) {
  return mkd(a.x * s, a.y * s, a.z * s);
}
template <int K>
VPT_HD Dual<K> norm3(const DV3<K>& a) {
  return dsqrt(dmax(dot3(a, a), 1e-20f));
}
template <int K>
VPT_HD DV3<K> normalize3(const DV3<K>& a) {
  Dual<K> inv = drsqrt(dmax(dot3(a, a), 1e-20f));
  return mkd(a.x * inv, a.y * inv, a.z * inv);
}
template <int K>
VPT_HD DV3<K> cross3(const DV3<K>& a, const DV3<K>& b) {
  return mkd(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
template <int K>
VPT_HD DV3<K> ray_at(const DV3<K>& o, const Dual<K>& t, const DV3<K>& d) {
  return mkd(o.x + t * d.x, o.y + t * d.y, o.z + t * d.z);
}
template <int K>
VPT_HD DV3<K> ray_at(const DV3<K>& o, const DV3<K>& d, float t) {  // o + d*t
  return mkd(o.x + d.x * t, o.y + d.y * t, o.z + d.z * t);
}

// ---- frames (dual.py onb, to_local, from_local) -------------------------

template <int K>
struct DOnb {
  DV3<K> s, t;
};

template <int K>
VPT_HD DOnb<K> onb(const DV3<K>& n) {
  const bool cond = fabsf(n.x.v) > fabsf(n.y.v);
  const Dual<K> z = cst<K>(0.0f);
  DV3<K> t;
  if (cond) {
    Dual<K> inv_a = drsqrt(dmax(n.x * n.x + n.z * n.z, 1e-20f));
    t = mkd(n.z * inv_a, z, -n.x * inv_a);
  } else {
    Dual<K> inv_b = drsqrt(dmax(n.y * n.y + n.z * n.z, 1e-20f));
    t = mkd(z, n.z * inv_b, -n.y * inv_b);
  }
  DOnb<K> b;
  b.s = mkd(t.y * n.z - t.z * n.y, t.z * n.x - t.x * n.z, t.x * n.y - t.y * n.x);
  b.t = t;
  return b;
}

template <int K>
VPT_HD DV3<K> to_local(const DV3<K>& n, const DV3<K>& w) {
  DOnb<K> b = onb(n);
  return normalize3(mkd(dot3(w, b.s), dot3(w, b.t), dot3(w, n)));
}

template <int K>
VPT_HD DV3<K> from_local(const DV3<K>& n, const DV3<K>& w) {
  DOnb<K> b = onb(n);
  return mkd(b.s.x * w.x + b.t.x * w.y + n.x * w.z, b.s.y * w.x + b.t.y * w.y + n.y * w.z,
             b.s.z * w.x + b.t.z * w.y + n.z * w.z);
}

template <int K>
VPT_HD DV3<K> from_local(const DV3<K>& n, V3 w) {  // a plain local vector
  DOnb<K> b = onb(n);
  return mkd(b.s.x * w.x + b.t.x * w.y + n.x * w.z, b.s.y * w.x + b.t.y * w.y + n.y * w.z,
             b.s.z * w.x + b.t.z * w.y + n.z * w.z);
}

// ---- samplers -----------------------------------------------------------

// cone around a dual axis with a dual aperture; detached uniforms
template <int K>
VPT_HD DV3<K> cone_dir(const DV3<K>& wc, const Dual<K>& cos_max, float u1, float u2) {
  Dual<K> ct = dclip((1.0f - u1) + u1 * cos_max, -1.0f, 1.0f);
  Dual<K> st = dsqrt(dmax(1.0f - ct * ct, 1e-12f));
  const float phi = TWO_PI * u2;
  return normalize3(from_local(wc, mkd(st * cosf(phi), st * sinf(phi), ct)));
}

template <int K>
VPT_HD DV3<K> cosine_hemi(const DV3<K>& n, float u1, float u2) {
  const float ct = sqrtf(vmax(1.0f - u1, 0.0f));
  const float st = sqrtf(vmax(u1, 0.0f));
  const float phi = TWO_PI * u2;
  return normalize3(from_local(n, mk(st * cosf(phi), st * sinf(phi), ct)));
}

// ---- Beckmann / Fresnel (dual.py ndf_beckmann .. refract_quirk) ---------

template <int K>
VPT_HD Dual<K> ndf_beckmann(const Dual<K>& cosine, float alpha) {
  Dual<K> c2 = cosine * cosine;
  Dual<K> inv_c2 = ddiv(1.0f, dmax(c2, 1e-4f));
  const float inv_a2 = 1.0f / vmax(alpha * alpha, 1e-8f);
  Dual<K> tan2 = dmax(1.0f - c2, 0.0f) * inv_c2;
  Dual<K> v = dexp(-tan2 * inv_a2) * (inv_a2 * INV_PI) * (inv_c2 * inv_c2);
  return cosine.v >= 0.0f ? v : cst<K>(0.0f);
}

template <int K>
VPT_HD Dual<K> g1(const DV3<K>& n, const DV3<K>& wv, const DV3<K>& wh, float alpha) {
  Dual<K> cos = dot3(n, wv);
  Dual<K> sin = dsqrt(dmax(1.0f - cos * cos, 1e-12f));
  Dual<K> cos_g = cos.v != 0.0f ? cos : cst<K>(1e-12f);
  Dual<K> den = (sin.v != 0.0f ? sin : 1e-12f * cos_g) * vmax(alpha, 1e-6f);
  Dual<K> a = ddiv(cos_g, den);
  Dual<K> rational =
      ddiv(3.535f * a + 2.181f * a * a, 1.0f + 2.276f * a + 2.577f * a * a);
  Dual<K> g = a.v < 1.6f ? rational : cst<K>(1.0f);
  const bool same = dot3(wv, wh).v * cos_g.v > 0.0f;
  return same ? g : cst<K>(0.0f);
}

template <int K>
VPT_HD Dual<K> fresnel_cond1(const Dual<K>& cos, const Dual<K>& sin2, float e, float k) {
  Dual<K> e2k2 = (e * e - k * k) - sin2;
  Dual<K> a2b2 = dsqrt(dmax(e2k2 * e2k2 + 4.0f * e * e * k * k, 1e-12f));
  Dual<K> a = dsqrt(dmax(0.5f * (a2b2 + e * e - k * k - sin2), 1e-12f));
  Dual<K> c2 = cos * cos;
  Dual<K> pn = a2b2 + c2 - 2.0f * a * cos;
  Dual<K> pd = a2b2 + c2 + 2.0f * a * cos;
  Dual<K> sin4 = sin2 * sin2;
  Dual<K> qn = a2b2 * c2 + sin4 - 2.0f * a * cos * sin2;
  Dual<K> qd = a2b2 * c2 + sin4 + 2.0f * a * cos * sin2;
  return ddiv(0.5f * pn * (qn + qd), pd * qd);
}

template <int K>
VPT_HD void fresnel_cond(const Dual<K>& cos, const Attr& at, Dual<K> f[3]) {
  Dual<K> sin2 = dmax(1.0f - cos * cos, 1e-12f);
  for (int i = 0; i < 3; ++i) f[i] = fresnel_cond1(cos, sin2, at.eta[i], at.kap[i]);
}

// Cook-Torrance in the local frame (n = +z)
template <int K>
VPT_HD void fr_microfacet(const Attr& at, const DV3<K>& wi_l, const DV3<K>& wh_l,
                          const DV3<K>& wo_l, Dual<K> fr[3]) {
  const DV3<K> nz = cst3<K>(mk(0.0f, 0.0f, 1.0f));
  Dual<K> den = 4.0f * dmax(dabs(wi_l.z) * dabs(wo_l.z), 1e-12f);
  Dual<K> f[3];
  fresnel_cond(dot3(wi_l, wh_l), at, f);
  Dual<K> dg = ddiv(ndf_beckmann(wh_l.z, at.alpha) * g1(nz, wi_l, wh_l, at.alpha) *
                        g1(nz, wo_l, wh_l, at.alpha),
                    den);
  for (int i = 0; i < 3; ++i) fr[i] = f[i] * dg;
}

// Cook-Torrance in the global frame
template <int K>
VPT_HD void fr_microfacet_global(const Attr& at, const DV3<K>& wi, const DV3<K>& wh,
                                 const DV3<K>& wo, const DV3<K>& n, Dual<K> fr[3]) {
  Dual<K> den = 4.0f * dmax(dabs(dot3(n, wi)) * dabs(dot3(n, wo)), 1e-12f);
  Dual<K> f[3];
  fresnel_cond(dot3(wi, wh), at, f);
  Dual<K> dg = ddiv(ndf_beckmann(dot3(n, wh), at.alpha) * g1(n, wi, wh, at.alpha) *
                        g1(n, wo, wh, at.alpha),
                    den);
  for (int i = 0; i < 3; ++i) fr[i] = f[i] * dg;
}

template <int K>
VPT_HD Dual<K> fresnel_die(const Dual<K>& cos_t, const Dual<K>& cos_i) {
  Dual<K> par = ddiv(ETA_T * cos_i - 1.0f * cos_t, ETA_T * cos_i + 1.0f * cos_t);
  Dual<K> perp = ddiv(1.0f * cos_i - ETA_T * cos_t, 1.0f * cos_i + ETA_T * cos_t);
  return 0.5f * (par * par + perp * perp);
}

// reference refraction incl. the stray -1 (microFacetUtilities.h:133)
template <int K>
VPT_HD DV3<K> refract_quirk(const DV3<K>& wo, const DV3<K>& n) {
  DV3<K> wo_l = to_local(n, wo);
  Dual<K> cos_i = dot3(wo, n);
  Dual<K> s2 = dmax(1.0f - INV_RATIO2 * (1.0f - cos_i * cos_i), 1e-12f);
  Dual<K> cos_t = dsqrt(s2);
  return normalize3(from_local(n, mkd(wo_l.x * -1.5f, wo_l.y * -1.5f, cos_t - 1.0f)));
}

template <int K>
VPT_HD DV3<K> reflect_about(const DV3<K>& n, const DV3<K>& wo) {  // 2 (n.wo) n - wo
  Dual<K> ndotwo = dot3(n, wo);
  return normalize3(mkd(2.0f * ndotwo * n.x - wo.x, 2.0f * ndotwo * n.y - wo.y,
                        2.0f * ndotwo * n.z - wo.z));
}

// bdsf (vptShadeMethods.h:16-59) with a dual normal, its three draws given
template <int K>
VPT_HD void sample_bsdf(const Attr& at, const DV3<K>& d, const DV3<K>& n, float u1, float u2,
                        float u_choice, Dual<K> fs[3], DV3<K>& wi, Dual<K>& pdf) {
  DV3<K> wo = neg3(d);
  if (at.is_mic) {
    DV3<K> wh = from_local(n, beckmann_wh(at.alpha, u1, u2));
    Dual<K> wh_dot_wo = dot3(wh, wo);
    wi = mkd(2.0f * wh_dot_wo * wh.x - wo.x, 2.0f * wh_dot_wo * wh.y - wo.y,
             2.0f * wh_dot_wo * wh.z - wo.z);
    fr_microfacet_global(at, wi, wh, wo, n, fs);
    pdf = ddiv(ndf_beckmann(dot3(wh, n), at.alpha) * dot3(wh, n),
               4.0f * dmax(dabs(wh_dot_wo), 1e-12f));
  } else if (at.is_die) {
    DV3<K> wt = refract_quirk(wo, n);
    Dual<K> fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    const bool refl = u_choice < fres.v;
    wi = refl ? reflect_about(n, wo) : wt;
    Dual<K> cos_d = dot3(n, wi);
    Dual<K> inv_cos = ddiv(1.0f, cos_d.v != 0.0f ? cos_d : cst<K>(1e-12f));
    Dual<K> s = refl ? inv_cos * fres : inv_cos * (1.0f - fres) * (ETA_T * ETA_T);
    fs[0] = fs[1] = fs[2] = s;
    pdf = refl ? fres : 1.0f - fres;
  } else {
    wi = cosine_hemi(n, u1, u2);
    pdf = dot3(n, wi) * INV_PI;
    for (int i = 0; i < 3; ++i) fs[i] = cst<K>(at.alb[i] * INV_PI);
  }
}

// light-strategy fr: lambert / 0 (dielectric) / local microfacet;
// plight=true is pLight's variant, which has no dielectric branch
template <int K>
VPT_HD void eval_fr_nee(const Attr& at, const DV3<K>& n, const DV3<K>& wray, const DV3<K>& wi,
                        bool plight, Dual<K> fr[3]) {
  if (at.is_mic) {
    DV3<K> wi_l = to_local(n, wi);
    DV3<K> wo_l = to_local(n, neg3(wray));
    DV3<K> wh = normalize3(add3(wi_l, wo_l));
    fr_microfacet(at, wi_l, wh, wo_l, fr);
  } else if (at.is_die && !plight) {
    fr[0] = fr[1] = fr[2] = cst<K>(0.0f);
  } else {
    for (int i = 0; i < 3; ++i) fr[i] = cst<K>(at.alb[i] * INV_PI);
  }
}

template <int K>
VPT_HD Dual<K> bsdf_pdf_for_dir(const Attr& at, const DV3<K>& n, const DV3<K>& wo,
                                const DV3<K>& wi, float u_flip) {
  if (at.is_mic) {
    DV3<K> wh = normalize3(add3(wi, wo));
    return ddiv(ndf_beckmann(dot3(wh, n), at.alpha) * dot3(wh, n),
                4.0f * dmax(dabs(dot3(wo, wh)), 1e-12f));
  }
  if (at.is_die) {
    DV3<K> wt = refract_quirk(wo, n);
    Dual<K> fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    return u_flip > fres.v ? 1.0f - fres : fres;
  }
  return dot3(n, wi) * INV_PI;
}

template <int K>
VPT_HD Dual<K> power_h_invf(const Dual<K>& f_inv, const Dual<K>& g) {
  Dual<K> r = dclip(g, 0.0f, 1e12f) * f_inv;
  return ddiv(1.0f, 1.0f + r * r);
}

template <int K>
VPT_HD Dual<K> power_h_invg(const Dual<K>& f, const Dual<K>& g_inv) {
  Dual<K> r = dclip(f, 0.0f, 1e12f) * g_inv;
  Dual<K> r2 = r * r;
  return f.v > 0.0f ? ddiv(r2, r2 + 1.0f) : cst<K>(0.0f);
}

// ---- equi-angular trig (dual.py atan_poly, atan2_posx, tan_sc) ---------

template <int K>
VPT_HD Dual<K> datan_poly(const Dual<K>& z) {
  Dual<K> z2 = z * z;
  return z * (0.99997726f +
              z2 * (-0.33262347f +
                    z2 * (0.19354346f +
                          z2 * (-0.11643287f + z2 * (0.05265332f + z2 * -0.01172120f)))));
}

template <int K>
VPT_HD Dual<K> datan2_posx(const Dual<K>& y, const Dual<K>& x) {  // x > 0
  Dual<K> zq = ddiv(y, x);
  const bool inv = fabsf(zq.v) > 1.0f;
  Dual<K> zz = inv ? ddiv(1.0f, zq.v != 0.0f ? zq : cst<K>(1.0f)) : zq;
  Dual<K> p = datan_poly(zz);
  const float sgn = zq.v >= 0.0f ? 1.0f : -1.0f;
  return inv ? sgn * (float)(kPi / 2.0) - p : p;
}

template <int K>
VPT_HD Dual<K> dtan_sc(const Dual<K>& t) {
  return ddiv(dsin(t), dcos(t));
}

// ---- Henyey-Greenstein at the baked g (dual.py hg_phase, hg_dir) --------
//
// vpt's g is a python float: 1 + g^2, 2g, (1/4pi)(1 - g^2), 1 - g^2, 1 - g
// and 1/(2g) fold in float64 and meet the lanes rounded to f32, which are
// the packed VptParams.hg_*. Out of line: no main-path launch takes them.

template <int K>
VPT_COLD Dual<K> dhg_phase(const VptParams& P, const Dual<K>& cos_t) {
  Dual<K> den = dmax(P.hg_1pg2 - P.hg_2g * cos_t, 1e-12f);
  Dual<K> rs = drsqrt(den);
  return P.hg_phase * rs * rs * rs;
}

// the local angles are plain (detached uniforms), the frame rotates with d
template <int K>
VPT_COLD DV3<K> dhg_dir(const VptParams& P, const DV3<K>& d, float u1, float u2) {
  const float s = P.hg_1mg2 / (P.hg_1mg + P.hg_2g * u1);
  const float cos_t = vclip((P.hg_1pg2 - s * s) * P.hg_inv2g, -1.0f, 1.0f);
  const float sin_t = sqrtf(vmax(1.0f - cos_t * cos_t, 0.0f));
  const float phi = TWO_PI * u2;
  return normalize3(from_local(d, mk(sin_t * cosf(phi), sin_t * sinf(phi), cos_t)));
}

// ---- density fields (dual.py:683-790) over csrc/field.cuh's plain forms --
//
// Positions, directions and distances are dual, the field's parameters
// baked (FieldParams), sigma_t plain. exp_height's free flight inverts its
// CDF in dual form (the distance moves with the ray); blobs' delta tracking
// stays field.cuh's plain loop on the primal values (detached event logic,
// 2 max_null draws). Every rail of the plain forms is kept: the +-80
// exponent clip, the |k d_y| < 1e-6 limit, the |t| min(d0, d_end) floor odd
// in t and the +-TAU_CAP clip, whose gate also zeroes the tangent of a
// clipped optical depth, as vpt's clip does.

template <int K>
VPT_HD V3 prim3(const DV3<K>& a) {
  return mk(a.x.v, a.y.v, a.z.v);
}

template <int K>
VPT_HD Dual<K> dlog1p(const Dual<K>& a) {
  Dual<K> r;
  r.v = log1pf(a.v);
  const float s = 1.0f / (1.0f + a.v);
  VPT_FOR_K r.t[k] = a.t[k] * s;
  return r;
}

// A&S 7.1.26 erf with the sign detached (dual.py erf_poly)
template <int K>
VPT_HD Dual<K> derf_poly(const Dual<K>& x) {
  const float s = x.v >= 0.0f ? 1.0f : -1.0f;
  const Dual<K> a = dabs(x);
  const Dual<K> t = ddiv(1.0f, 1.0f + (float)0.3275911 * a);
  const Dual<K> y =
      1.0f - t * ((float)0.254829592 +
                  t * ((float)-0.284496736 +
                       t * ((float)1.421413741 +
                            t * ((float)-1.453152027 + t * (float)1.061405429)))) *
                 dexp(-a * a);
  return s * y;
}

template <int K>
VPT_HD Dual<K> dexp_clip(const Dual<K>& x) {
  return dexp(dclip(x, -80.0f, 80.0f));
}

// d(x) of an analytic field
template <int K>
VPT_HD Dual<K> dfield_density(const FieldParams& F, const DV3<K>& x) {
  if (F.kind == kExpHeight) return dexp_clip(-F.k * (x.y - F.y0));
  Dual<K> dens = cst<K>(0.0f);
  for (int b = 0; b < F.n_blobs; ++b) {
    const FieldBlob& B = F.blob[b];
    const DV3<K> dx = mkd(x.x - B.cx, x.y - B.cy, x.z - B.cz);
    const Dual<K> g = B.w * dexp(-0.5f * dot3(dx, dx) * B.dens_c);
    dens = b == 0 ? g : dens + g;
  }
  return dens;
}

// sigma_t * int_0^t d(o + s d) ds along unit d, closed form
template <int K>
VPT_HD Dual<K> dfield_tau(const FieldParams& F, float sigma_t, const DV3<K>& o, const DV3<K>& d,
                          const Dual<K>& t) {
  if (F.kind == kExpHeight) {
    const Dual<K> d0 = dexp_clip(-F.k * (o.y - F.y0));
    const Dual<K> d_end = dexp_clip(-F.k * (o.y + t * d.y - F.y0));
    const Dual<K> m = F.k * d.y;
    const bool cnst = fabsf(m.v) < 1e-6f;
    const Dual<K> base = cnst ? d0 * t : ddiv(d0 - d_end, m);
    const Dual<K> lb = t * dmin(d0, d_end);
    const Dual<K> tau = t.v >= 0.0f ? dmax(base, lb) : dmin(base, lb);
    return sigma_t * dclip(tau, -TAU_CAP, TAU_CAP);
  }
  Dual<K> tau = cst<K>(0.0f);
  for (int b = 0; b < F.n_blobs; ++b) {
    const FieldBlob& B = F.blob[b];
    const DV3<K> oc = mkd(B.cx - o.x, B.cy - o.y, B.cz - o.z);
    const Dual<K> a = dot3(oc, d);
    const Dual<K> b2 = dmax(dot3(oc, oc) - a * a, 0.0f);
    const Dual<K> amp = dexp(-0.5f * b2 * B.tau_c) * B.amp_c;
    const Dual<K> hi = derf_poly((t - a) * B.kh);
    const Dual<K> lo = derf_poly(a * B.kh);
    const Dual<K> g = amp * (hi + lo);
    tau = b == 0 ? g : tau + g;
  }
  return sigma_t * tau;
}

// num / a with one reciprocal (ddiv), except where a's tangent term
// a.t (-q / a) overflows f32: there vpt's tangent is inf or NaN (0 * inf
// where a.t is 0), and the term is taken as -(q (a.t / a)). No finite value
// changes (ROADMAP Queue 3).
template <int K>
VPT_HD Dual<K> ddiv_guarded(const Dual<K>& num, const Dual<K>& a) {
  const float inv = 1.0f / a.v;
  Dual<K> r;
  r.v = num.v * inv;
  const float w = -r.v * inv;
  if (fabsf(w) <= F32_MAX) {
    VPT_FOR_K r.t[k] = num.t[k] * inv + a.t[k] * w;
  } else {
    VPT_FOR_K r.t[k] = num.t[k] * inv + -(r.v * (a.t[k] * inv));
  }
  return r;
}
template <int K>
VPT_HD Dual<K> ddiv_guarded(float num, const Dual<K>& a) {
  const float inv = 1.0f / a.v;
  Dual<K> r;
  r.v = num * inv;
  const float w = -r.v * inv;
  if (fabsf(w) <= F32_MAX) {
    VPT_FOR_K r.t[k] = a.t[k] * w;
  } else {
    VPT_FOR_K r.t[k] = -(r.v * (a.t[k] * inv));
  }
  return r;
}

// exp_height's free-flight distance: the closed-form inversion of its CDF
// at u, in dual form (BIG when the flight escapes). Far above the fog plane
// a = sigma_t d0 is tiny and the divisions by it take ddiv_guarded.
template <int K>
VPT_HD Dual<K> dsample_exp_height(const FieldParams& F, float sigma_t, const DV3<K>& o,
                                  const DV3<K>& d, float u) {
  const Dual<K> d0 = dexp_clip(-F.k * (o.y - F.y0));
  const Dual<K> m = F.k * d.y;
  const float tau_star = -log1pf(-u);
  const Dual<K> a = dmax(sigma_t * d0, 1e-30f);
  const bool cnst = fabsf(m.v) < 1e-6f;
  const Dual<K> safe_m = cnst ? cst<K>(1.0f) : m;
  const Dual<K> arg = ddiv_guarded(-tau_star * safe_m, a);
  const bool escapes = !cnst && arg.v <= -1.0f;
  if (escapes) return cst<K>(BIG);
  return dmin(cnst ? ddiv_guarded(tau_star, a) : ddiv(-dlog1p(arg), safe_m), BIG);
}

// The medium of the field instantiations: an analytic field (P.field), or
// at K = 0 with a table a voxel grid (P.grid), whose forms run on the
// primal values
template <int K>
struct Medium {
  const VptParams& P;
  const uint32_t* tab;  // a grid's packed table; nullptr: analytic
  float sigma_t;

  VPT_HD bool grid() const {
    if constexpr (K == 0)
      return tab != nullptr;
    else
      return false;
  }
  // the signed optical depth along (o, d) to t
  VPT_HD Dual<K> tau(const DV3<K>& o, const DV3<K>& d, const Dual<K>& t) const {
    if (grid()) return cst<K>(grid_tau(P.grid, tab, sigma_t, prim3(o), prim3(d), t.v, false));
    return dfield_tau(P.field, sigma_t, o, d, t);
  }
  VPT_HD Dual<K> tr(const DV3<K>& o, const DV3<K>& d, const Dual<K>& t) const {
    return dexp(-tau(o, d, t));
  }
  // the appearance density (a grid's trilinear)
  VPT_HD Dual<K> density(const DV3<K>& x) const {
    if (grid()) return cst<K>(grid_density(P.grid, tab, prim3(x)));
    return dfield_density(P.field, x);
  }
};

// ---- the scene, with the theta sphere's dual centre ---------------------

template <int K>
struct Scene {
  const VptParams& P;
  int sphere;     // -1: every centre baked
  DV3<K> ctr;     // the centre of `sphere`, from theta
};

template <int K>
VPT_HD DV3<K> centre(const Scene<K>& sc, int s) {  // zeros for s == -1
  if (s < 0) return cst3<K>(mk(0.0f, 0.0f, 0.0f));
  if (s == sc.sphere) return sc.ctr;
  return cst3<K>(mk(sc.P.c[s][0], sc.P.c[s][1], sc.P.c[s][2]));
}

// nearest-root t with the Sphere.h:27-37 rescue (dual.py sphere_first_t)
template <int K>
VPT_HD Dual<K> sphere_first_t(const Scene<K>& sc, const DV3<K>& o, const DV3<K>& d, int s,
                              bool& valid) {
  const VptParams& P = sc.P;
  DV3<K> oc = s == sc.sphere ? sub3(o, sc.ctr) : sub3(o, mk(P.c[s][0], P.c[s][1], P.c[s][2]));
  Dual<K> b = dot3(oc, d);
  Dual<K> ococ = dot3(oc, oc);
  Dual<K> c0 = ococ - P.r2[s];
  Dual<K> disc = P.r2[s] - (ococ - b * b);
  const bool pos = disc.v > 0.0f;
  const Dual<K> one = cst<K>(1.0f);
  Dual<K> sq = dsqrt(pos ? disc : one) * (pos ? 1.0f : 0.0f);
  const float sgn = b.v >= 0.0f ? 1.0f : -1.0f;
  Dual<K> qq = -(b + sgn * sq);
  Dual<K> other = ddiv(c0, qq.v != 0.0f ? qq : one);
  Dual<K> t1 = dmin(qq, other);
  Dual<K> t2 = dmax(qq, other);
  const float eps = P.eps[s];
  Dual<K> t = (t1.v < 0.0f || fabsf(t1.v) < eps) ? t2 : t1;
  valid = pos && t.v > 0.0f && fabsf(t.v) > eps;
  return t;
}

// nearest sphere id (-1 on a miss); t_out its t (0 on a miss)
template <int K>
VPT_HD int nearest_id_t(const Scene<K>& sc, const DV3<K>& o, const DV3<K>& d, Dual<K>& t_out) {
  Dual<K> t_min = cst<K>(INFINITY);
  int sid = -1;
  for (int s = 0; s < sc.P.n_spheres; ++s) {
    bool valid;
    Dual<K> t = sphere_first_t(sc, o, d, s, valid);
    if (valid && t.v < t_min.v) {
      t_min = t;
      sid = s;
    }
  }
  t_out = sid >= 0 ? t_min : cst<K>(0.0f);
  return sid;
}

// light -> x visibility (pathTracingUtilities.h:39-53): detached boolean,
// dual distance and unit direction
template <int K>
VPT_HD bool visibility_from(const Scene<K>& sc, const DV3<K>& light, const DV3<K>& x,
                            Dual<K>& dist, DV3<K>& dl) {
  DV3<K> lx = sub3(x, light);
  dist = norm3(lx);
  dl = scale3(lx, ddiv(1.0f, dist));
  Dual<K> t;
  int sid = nearest_id_t(sc, light, dl, t);
  return t.v > dist.v * sc.P.slack || sid < 0;
}

// ---- estimator pieces (geom.py plight_term, mis_v2, medium_nee) ---------

template <int K>
VPT_HD void plight_term(const Scene<K>& sc, const Attr& at, const DV3<K>& xs, const DV3<K>& n,
                        const DV3<K>& d, const DV3<K>& lc, const float lrad[3], Dual<K> ldp[3],
                        Dual<K>& dist) {
  DV3<K> dl;
  const bool vis = visibility_from(sc, lc, xs, dist, dl);
  Dual<K> le_scale = vis ? ddiv(1.0f, dmax(dist * dist, 1e-20f)) : cst<K>(0.0f);
  DV3<K> wi = neg3(dl);
  Dual<K> fr[3];
  eval_fr_nee(at, n, d, wi, true, fr);
  Dual<K> cosw = dot3(n, wi);
  for (int i = 0; i < 3; ++i) ldp[i] = lrad[i] * (le_scale * fr[i] * cosw);
}

// MISv2 (misSamplingFunctions.h:96-170): 3 draws per MIS light, then 3.
// kField: the light strategy's transmittance through the medium md
template <int K, bool kField = false>
VPT_HD void mis_v2(const Scene<K>& sc, float sigma_t, Pcg& rng, const Attr& at, const DV3<K>& xs,
                   const DV3<K>& n, const DV3<K>& d, Dual<K> acc[3],
                   const Medium<K>* md = nullptr) {
  const VptParams& P = sc.P;
  for (int i = 0; i < 3; ++i) acc[i] = cst<K>(0.0f);
  DV3<K> wo = neg3(d);
  for (int j = 0; j < P.n_mis; ++j) {
    const int e = P.mis_lights[j];
    DV3<K> cxv = sub3(centre(sc, e), xs);
    Dual<K> normcx = norm3(cxv);
    Dual<K> inv_ncx = ddiv(1.0f, normcx);
    DV3<K> wc = scale3(cxv, inv_ncx);
    Dual<K> ratio = P.r[e] * inv_ncx;
    Dual<K> cos_max = dsqrt(dmax(1.0f - ratio * ratio, 1e-12f));
    const float u1 = rng.next();
    const float u2 = rng.next();
    DV3<K> wi = cone_dir(wc, cos_max, u1, u2);
    Dual<K> t_unused;
    const int sid = nearest_id_t(sc, xs, wi, t_unused);
    const bool visible = sid >= 0 && sid == e;
    Dual<K> fr[3];
    eval_fr_nee(at, n, d, wi, false, fr);
    Dual<K> fpdf_inv = TWO_PI * dmax(1.0f - cos_max, 1e-12f);
    Dual<K> tr;
    if constexpr (kField)
      tr = md->tr(xs, wc, normcx);  // moves with xs and the light
    else
      tr = dexp(normcx * (-sigma_t));
    Dual<K> w_vis = visible ? tr * dot3(n, wi) * fpdf_inv : cst<K>(0.0f);
    Dual<K> gpdf = bsdf_pdf_for_dir(at, n, wo, wi, rng.next());
    Dual<K> wf = power_h_invf(fpdf_inv, gpdf);
    for (int i = 0; i < 3; ++i) acc[i] = acc[i] + P.rad[e][i] * (fr[i] * w_vis * wf);
  }
  // BSDF strategy: sample the lane's lobe, one trace
  const float u1 = rng.next(), u2 = rng.next(), u_choice = rng.next();
  const DV3<K> zero = cst3<K>(mk(0.0f, 0.0f, 0.0f));
  DV3<K> wi_sel = zero, wi_l = zero, wi_d = zero, wo_loc = zero, wi_m_loc = zero;
  V3 wh_loc = mk(0.0f, 0.0f, 0.0f);
  Dual<K> fres = cst<K>(0.0f);
  bool refl = false;
  if (at.is_mic) {
    wh_loc = beckmann_wh(at.alpha, u1, u2);
    wo_loc = to_local(n, wo);
    Dual<K> whw = 2.0f * dot3(wh_loc, wo_loc);
    wi_m_loc = normalize3(mkd(whw * wh_loc.x - wo_loc.x, whw * wh_loc.y - wo_loc.y,
                              whw * wh_loc.z - wo_loc.z));
    wi_sel = normalize3(from_local(n, wi_m_loc));
  } else if (at.is_die) {
    DV3<K> wt = refract_quirk(wo, n);
    fres = fresnel_die(dot3(n, wt), dot3(n, wo));
    refl = u_choice < fres.v;
    wi_d = refl ? reflect_about(n, wo) : wt;
    wi_sel = wi_d;
  } else {
    wi_l = cosine_hemi(n, u1, u2);
    wi_sel = wi_l;
  }
  Dual<K> t_unused;
  const int sid2 = nearest_id_t(sc, xs, wi_sel, t_unused);
  const bool hit = sid2 >= 0;
  float le[3];
  for (int i = 0; i < 3; ++i) le[i] = hit ? P.rad[sid2][i] : 0.0f;
  const float hit_r = hit ? P.r[sid2] : 0.0f;
  DV3<K> hc = centre(sc, sid2);
  Dual<K> g[3], gpdf;
  if (at.is_mic) {
    Dual<K> fr_m[3];
    fr_microfacet(at, wi_m_loc, cst3<K>(wh_loc), wo_loc, fr_m);
    Dual<K> gpdf_m = ddiv(vpt::ndf_beckmann(wh_loc.z, at.alpha) * wh_loc.z,
                          4.0f * dmax(dabs(dot3(wo_loc, wh_loc)), 1e-12f));
    Dual<K> winv_m = ddiv(wi_m_loc.z, dmax(gpdf_m, 1e-20f));
    for (int i = 0; i < 3; ++i) g[i] = le[i] * (fr_m[i] * winv_m);
    gpdf = gpdf_m;
  } else if (at.is_die) {
    Dual<K> cos_d = dabs(dot3(n, wi_d));
    Dual<K> scale_d = ddiv(1.0f, dmax(cos_d, 1e-12f)) * (refl ? 1.0f : ETA_T * ETA_T);
    for (int i = 0; i < 3; ++i) g[i] = le[i] * scale_d;
    gpdf = refl ? fres : 1.0f - fres;
  } else {
    Dual<K> gpdf_l = dot3(n, wi_l) * INV_PI;
    // cos_l/gpdf_l == pi when gpdf_l != 0, else 0: a gate on le * albedo
    const bool nz_l = gpdf_l.v != 0.0f;
    for (int i = 0; i < 3; ++i) g[i] = cst<K>(nz_l ? le[i] * at.alb[i] : 0.0f);
    gpdf = gpdf_l;
  }
  const bool pos_all = g[0].v > 0.0f && g[1].v > 0.0f && g[2].v > 0.0f;
  const bool gate = at.is_mic ? g[0].v > 0.0f : pos_all;
  DV3<K> hcx = sub3(hc, xs);
  Dual<K> n2 = dmax(dot3(hcx, hcx), 1e-20f);
  Dual<K> cmax = dsqrt(dmax(1.0f - ddiv(hit_r * hit_r, n2), 1e-12f));
  Dual<K> fpdf_h_inv = TWO_PI * dmax(1.0f - cmax, 1e-12f);
  Dual<K> wg = (gate && hit) ? power_h_invg(gpdf, fpdf_h_inv) : cst<K>(0.0f);
  for (int i = 0; i < 3; ++i) acc[i] = acc[i] + g[i] * wg;
}

// freeSingleScattering with the point-source kill: point sources
// (lr == 0) contribute 0. hg: the phase toward the cone sample at the baked
// g, dual through d and wl (else the folded isotropic constant). kField:
// the transmittance through the medium md
template <int K, bool kField = false>
VPT_HD void medium_nee(const Scene<K>& sc, float sigma_t, const DV3<K>& d, bool hg,
                       const DV3<K>& xt, const DV3<K>& lc, const float lrad[3], float lr, int lid,
                       float u1, float u2, Dual<K> out[3], const Medium<K>* md = nullptr) {
  DV3<K> wc = sub3(lc, xt);
  Dual<K> inv_mag = drsqrt(dmax(dot3(wc, wc), 1e-20f));
  DV3<K> wc_n = scale3(wc, inv_mag);
  Dual<K> ratio = lr * inv_mag;
  Dual<K> cos_max = dsqrt(dmax(1.0f - ratio * ratio, 1e-12f));
  DV3<K> wl = cone_dir(wc_n, cos_max, u1, u2);
  Dual<K> t;
  const int sid = nearest_id_t(sc, xt, wl, t);
  const bool visible = sid >= 0 && sid == lid && lr > 0.0f;
  Dual<K> tr_l;
  if constexpr (kField)
    tr_l = md->tr(xt, wl, t);
  else
    tr_l = dexp(t * (-sigma_t));
  // phase / cone_pdf = phase * 2pi * (1 - cos_max): no dual division
  Dual<K> w;
  if (hg)
    w = visible ? tr_l * (dhg_phase(sc.P, dot3(d, wl)) * TWO_PI) * dmax(1.0f - cos_max, 1e-12f)
                : cst<K>(0.0f);
  else
    w = visible ? tr_l * sc.P.nee_phase * dmax(1.0f - cos_max, 1e-12f) : cst<K>(0.0f);
  for (int i = 0; i < 3; ++i) out[i] = lrad[i] * w;
}

template <int K>
VPT_HD Dual<K> seeded(float v, int k) {  // theta entry v with tangent e_k
  Dual<K> r = cst<K>(v);
  if (k >= 0 && k < K) r.t[k] = 1.0f;
  return r;
}

// vpt's loop carry: every value and tangent re-materialised as x + 0
template <int K>
VPT_HD Dual<K> carry(const Dual<K>& a) {
  Dual<K> r;
  r.v = a.v + 0.0f;
  VPT_FOR_K r.t[k] = a.t[k] + 0.0f;
  return r;
}
template <int K>
VPT_HD DV3<K> carry3(const DV3<K>& a) {
  return mkd(carry(a.x), carry(a.y), carry(a.z));
}

// One pixel's spp samples (geom.py:427-579 for one lane): out[c*(1+K) + j]
// is channel c's radiance sum (j = 0) or its tangent j-1. lane keys the
// PCG streams, pixel the camera ray (they differ only past the frame's
// last pixel, as in vpt's tiles). A lane leaves its loop at samples == spp:
// in vpt's tile a finished lane is frozen.
//
// kExt: the estimator comes from G (ea, nee, physical, hg); the draws are
// camera u, v (random with jitter), u_rr, u_pick, u_dist, blobs' 2 max_null
// delta-tracking draws (free flight in a blobs field only), u_ev
// (equi-angular only), MISv2 (with NEE only), BSDF 3, phase 2, medium NEE 2
// (with NEE only). Without kExt it is free-flight NEE, not physical,
// isotropic. kField (with kExt): a density field, analytic, or at K = 0
// with tab a voxel grid.
template <int K, bool kExt = false, bool kField = false>
VPT_HD void geom_pixel(const GeomParams& G, const float* th, uint32_t lane, int pixel, int seed,
                       float* out, const uint32_t* tab = nullptr) {
  const VptParams& P = G.base;
  const bool cam = G.n_cam > 0, dir = G.n_dir > 0;
  const bool ea = kExt && G.ea != 0;
  const bool nee = !kExt || G.nee != 0;
  const bool physical = kExt && G.physical != 0;
  const bool hg = kExt && G.hg != 0;
  // ---- parameters from theta
  Scene<K> sc{P, G.sphere, mkd(seeded<K>(th[0], G.n_center ? 0 : -1),
                               seeded<K>(th[1], G.n_center ? 1 : -1),
                               seeded<K>(th[2], G.n_center ? 2 : -1))};
  const DV3<K> cam_o = mkd(seeded<K>(th[3], cam ? G.k_cam : -1),
                           seeded<K>(th[4], cam ? G.k_cam + 1 : -1),
                           seeded<K>(th[5], cam ? G.k_cam + 2 : -1));
  const Dual<K> fov = seeded<K>(th[6], cam ? G.k_cam + 3 : -1);
  const float sigma_t = th[7] + th[8];
  const float inv_st = 1.0f / sigma_t;
  const float ar_cp = th[8] * inv_st * P.inv_cp;
  const float ss_cp = th[8] / G.cp;  // equi-angular: sigma_s / cp
  const Medium<K> md{P, tab, sigma_t};
  const DV3<K> cam_d = mkd(seeded<K>(th[9], dir ? G.k_dir : -1),
                           seeded<K>(th[10], dir ? G.k_dir + 1 : -1),
                           seeded<K>(th[11], dir ? G.k_dir + 2 : -1));
  // camera frame (src/rt.cpp:755-759) in f32 from theta
  const DV3<K> cx = mkd(fov * G.aspect, cst<K>(0.0f), cst<K>(0.0f));
  const DV3<K> cy_u = normalize3(cross3(cx, cam_d));
  const DV3<K> cy = mkd(cy_u.x * fov, cy_u.y * fov, cy_u.z * fov);

  const float px = (float)(pixel % P.width);
  const float py = (float)(P.height - 1 - pixel / P.width);
  float off[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (P.ld) {
    Pcg r;
    r.s = pcg_seed(lane ^ 0x2545F491u, (uint32_t)seed + 747796405u);
    for (int k = 0; k < 5; ++k) off[k] = r.next();
  }
  Pcg rng;
  rng.s = pcg_seed(lane, (uint32_t)seed);
  const int n_em = P.n_emitters;
  const int mis_draws = 3 * P.n_mis + 3;
  const float inv_ps = P.n_em_f;

  const Dual<K> z = cst<K>(0.0f);
  DV3<K> o = mkd(z, z, z), d = mkd(z, z, cst<K>(1.0f));
  Dual<K> tp[3] = {z, z, z}, L[3] = {z, z, z};
  bool alive = false;
  int depth = 0, samples = 0;

  for (int it = 0; it < P.max_iters && samples < P.spp; ++it) {
    float u = 0.5f, v = 0.5f;
    if (P.ld && P.jitter) {
      const float s_f = (float)samples;
      u = ld_strat(LD_A1, off[0], s_f);
      v = ld_strat(LD_A2, off[1], s_f);
    } else if (P.jitter) {
      u = rng.next();
      v = rng.next();
    }
    if (!alive) {
      const float sx = (px + u - 0.5f) / (float)P.width - 0.5f;
      const float sy = (py + v - 0.5f) / (float)P.height - 0.5f;
      d = normalize3(mkd(cx.x * sx + cy.x * sy + cam_d.x, cx.y * sx + cy.y * sy + cam_d.y,
                         cx.z * sx + cy.z * sy + cam_d.z));
      o = cam_o;
      tp[0] = tp[1] = tp[2] = cst<K>(1.0f);
      alive = true;
      depth = 0;
    }

    // ---- bounce (K2's draw order)
    float u_rr = rng.next();
    float u_pick = rng.next();
    float u_dist = rng.next();
    if (P.ld && depth == 0) {
      const float s_f = (float)samples;
      u_rr = ld_strat(LD_A4, off[3], s_f);
      u_pick = ld_strat(LD_A5, off[4], s_f);
      u_dist = ld_strat(LD_A3, off[2], s_f);
    }
    bool live = u_rr >= P.q;
    Dual<K> t;
    const int sid = nearest_id_t(sc, o, d, t);
    const bool hit = sid >= 0;
    const Attr at = attrs(P, sid);
    const Dual<K> t_eff = hit ? t : cst<K>(BIG);
    const DV3<K> xs = ray_at(o, t_eff, d);
    const DV3<K> nrm = normalize3(sub3(xs, centre(sc, sid)));
    int k = (int)(u_pick * P.n_em_f);
    k = k < 0 ? 0 : k;
    k = k > n_em - 1 ? n_em - 1 : k;
    int lid = -1;
    float lrad[3] = {0.0f, 0.0f, 0.0f}, lr = 0.0f;
    if (k >= 0) {
      lid = P.emitters[k];
      for (int i = 0; i < 3; ++i) lrad[i] = P.rad[lid][i];
      lr = P.r[lid];
    }
    const DV3<K> lc = centre(sc, lid);

    bool surface;
    DV3<K> xt;
    Dual<K> t_xt, pdf_success;  // equi-angular only
    if (ea) {
      // equiAngularParams2 + Bernoulli(TrActual) (geom.py:478-511): the
      // distance transform is pure geometry, so xt moves with the light and
      // the camera (it reparameterizes)
      const DV3<K> lo_v = sub3(lc, o);
      const Dual<K> delta = dot3(lo_v, d);
      const Dual<K> Dq = dsqrt(dmax(dot3(lo_v, lo_v) - delta * delta, 1e-12f));
      const Dual<K> th_a = datan2_posx(-delta, Dq);
      const Dual<K> th_b = datan2_posx(t_eff - delta, Dq);
      const Dual<K> sample_t =
          dclip(Dq * dtan_sc(th_a * (1.0f - u_dist) + th_b * u_dist), -BIG, BIG);
      const Dual<K> d_along = sample_t + delta;
      xt = ray_at(o, d_along, d);
      const Dual<K> dist_pdf =
          ddiv(Dq, dmax(dabs(th_b - th_a), 1e-12f) * (sample_t * sample_t + Dq * Dq));
      Dual<K> tr_act;
      if constexpr (kField) {
        // Bernoulli(Tr) and T through dual optical depths; |tau| where the
        // sample lies behind the origin
        tr_act = hit ? md.tr(o, d, t) : cst<K>(0.0f);
        t_xt = dexp(-dabs(md.tau(o, d, d_along)));
      } else {
        tr_act = hit ? dexp(t * (-sigma_t)) : cst<K>(0.0f);
        t_xt = dexp(dabs(d_along) * (-sigma_t));
      }
      const float u_ev = rng.next();
      surface = tr_act.v >= u_ev && hit;
      const Dual<K> one_m_tr = dmax(1.0f - tr_act, 1e-20f);
      // floored like the forward kernel (f32 underflow -> 0 * inf)
      pdf_success = dmax(dist_pdf * one_m_tr, 1e-30f);
    } else if constexpr (kField) {
      // exp_height's inversion reparameterizes; blobs' delta tracking and a
      // grid's march are detached, on the primal values
      float d_s;
      if (!md.grid() && P.field.kind == kExpHeight) {
        const Dual<K> dd_s = dsample_exp_height(P.field, sigma_t, o, d, u_dist);
        d_s = dd_s.v;
        xt = mkd(o.x + d.x * dd_s, o.y + d.y * dd_s, o.z + d.z * dd_s);
      } else {
        if (md.grid()) {
          float tau_cap;
          d_s = grid_sample_free_and_tau(P.grid, tab, sigma_t, prim3(o), prim3(d), u_dist,
                                         t_eff.v, tau_cap);
        } else {
          const float inv_maj_rate = 1.0f / (sigma_t * P.field.maj);
          d_s = field_sample_free(P.field, sigma_t, inv_maj_rate, prim3(o), prim3(d), u_dist, rng,
                                  t_eff.v);
        }
        xt = ray_at(o, d, d_s);
      }
      surface = t_eff.v < d_s && hit;
      live = live && (d_s < 0.5f * BIG || surface);  // an escaped flight ends
    } else {
      const float d_s = -log1pf(-u_dist) * inv_st;
      surface = t_eff.v < d_s && hit;
      xt = ray_at(o, d, d_s);
    }
    const bool medium = live && !surface;
    const bool em_hit = surface && at.is_em;
    // with NEE only the camera ray's emitter hit is credited; without, every
    // hit (the implicit estimator)
    if (live && em_hit && (!nee || depth == 0))
      for (int i = 0; i < 3; ++i) {
        Dual<K> add = at.rad[i] * tp[i];
        if (physical) add = add * P.inv_cp;  // this iteration's RR survival
        L[i] = L[i] + add;
      }
    const bool shade = live && surface && !em_hit;

    if (nee) {
      if (shade) {  // surface NEE: pLight + MISv2
        Dual<K> ldp[3], dist_ls;
        plight_term(sc, at, xs, nrm, d, lc, lrad, ldp, dist_ls);
        Dual<K> trs;
        if constexpr (kField) {
          const Dual<K> inv_dl = ddiv(1.0f, dmax(dist_ls, 1e-20f));
          trs = md.tr(xs, scale3(sub3(lc, xs), inv_dl), dist_ls);
        } else {
          trs = dexp(dist_ls * (-sigma_t));
        }
        Dual<K> ldm[3];
        mis_v2<K, kField>(sc, sigma_t, rng, at, xs, nrm, d, ldm, &md);
        for (int i = 0; i < 3; ++i)
          L[i] = L[i] + (ldp[i] * trs * inv_ps + ldm[i]) * tp[i] * P.inv_cp;
      } else {
        rng.skip(mis_draws);
      }
    }
    const float b1 = rng.next(), b2 = rng.next(), b3 = rng.next();  // sample_bsdf
    const float u_p1 = rng.next(), u_p2 = rng.next();               // phase
    float m1 = 0.0f, m2 = 0.0f;                                     // medium NEE cone
    if (nee) {
      m1 = rng.next();
      m2 = rng.next();
    }

    if (shade) {
      Dual<K> fs[3], pdf_b;
      DV3<K> wi_s;
      sample_bsdf(at, d, nrm, b1, b2, b3, fs, wi_s, pdf_b);
      Dual<K> wscale = ddiv(dot3(nrm, wi_s), dmax(pdf_b, 1e-20f) * G.cp);
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * fs[i] * wscale;
      o = xs;
      d = wi_s;
    } else if (medium) {
      Dual<K> ld_med[3];
      if (nee)
        medium_nee<K, kField>(sc, sigma_t, d, hg, xt, lc, lrad, lr, lid, m1, m2, ld_med, &md);
      if (ea) {  // (t_xt / pdf_success) * (sigma_s / cp), in a field * dens(xt)
        Dual<K> med_scale = ddiv(t_xt, pdf_success) * ss_cp;
        if constexpr (kField) med_scale = med_scale * md.density(xt);
        for (int i = 0; i < 3; ++i) {
          if (nee) L[i] = L[i] + ld_med[i] * inv_ps * tp[i] * med_scale;
          tp[i] = tp[i] * med_scale;
        }
      } else {
        for (int i = 0; i < 3; ++i) {
          if (nee) L[i] = L[i] + ld_med[i] * inv_ps * tp[i] * ar_cp;
          tp[i] = tp[i] * ar_cp;
        }
      }
      o = xt;
      d = hg ? dhg_dir(P, d, u_p1, u_p2) : cst3<K>(uniform_sphere(u_p1, u_p2));
    }
    alive = (shade || medium) && depth + 1 < P.max_bounces;
    if (alive)
      depth = depth + 1;
    else
      samples = samples + 1;  // the path that started this sample ended
    o = carry3(o);
    d = carry3(d);
    for (int i = 0; i < 3; ++i) {
      tp[i] = carry(tp[i]);
      L[i] = carry(L[i]);
    }
  }
  for (int c = 0; c < 3; ++c) {
    out[c * (1 + K)] = L[c].v;
    VPT_FOR_K out[c * (1 + K) + 1 + k] = L[c].t[k];
  }
}

#undef VPT_FOR_K

}  // namespace geom
}  // namespace vpt
