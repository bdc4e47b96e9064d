// Analytic density fields in device code: the thread-scalar transcription of
// vpt/kernels/prims.py:592-624, 892-1087 (vpt/media/density.py's baked
// forms), for the field instantiations of K1, K2 and K3. Included by
// csrc/path.cuh after its scalar helpers; __host__ __device__ like them, so
// the test build compiles it with g++ too.
//
// Every f32 rail of vpt's exp_height forms is kept: the +-80 exponent clip,
// the constant-density limit at |k d_y| < 1e-6, the monotone lower bound
// t min(d0, d_end) with tau odd in t, and the +-TAU_CAP clip. Each is a NaN
// guard of vpt's; without one, a backward on dead lanes gives NaN.
//
// The constants the formulas fold (FieldBlob, FieldParams.inv_maj*) come
// folded: in double on the host where vpt bakes the field (K1, and the pair
// when no field parameter is traced), in f32 from the parameter vector where
// vpt's pair traces it (csrc/diff_kernel.cuh).
#pragma once

namespace vpt {

enum FieldKind { kExpHeight = 1, kBlobs = 2 };

constexpr float TAU_CAP = 3.0e7f;  // unit-sigma optical-path cap (vpt _TAU_CAP)
constexpr float F32_MAX = 3.40282347e38f;
// sqrt(1/2) and sqrt(pi/2) as f32: the traced pair's blob constants
constexpr float SQRT_HALF = (float)0.7071067811865476;
constexpr float SQRT_HALF_PI = (float)1.2533141373155001;
constexpr float TWO_OVER_SQRTPI = (float)1.1283791670955126;

// A&S 7.1.26 erf (max abs error 1.5e-7), as vpt writes it
VPT_HD float erf_poly(float x) {
  float s = x >= 0.0f ? 1.0f : -1.0f;
  float a = fabsf(x);
  float t = 1.0f / (1.0f + (float)0.3275911 * a);
  float y = 1.0f - t * ((float)0.254829592 +
                        t * ((float)-0.284496736 +
                             t * ((float)1.421413741 +
                                  t * ((float)-1.453152027 + t * (float)1.061405429)))) *
                       expf(-a * a);
  return s * y;
}

VPT_HD float exp_clip(float x) { return expf(vclip(x, -80.0f, 80.0f)); }

// d(x)
VPT_HD float field_density(const FieldParams& F, V3 x) {
  if (F.kind == kExpHeight) return exp_clip(-F.k * (x.y - F.y0));
  float dens = 0.0f;
  for (int b = 0; b < F.n_blobs; ++b) {
    const FieldBlob& B = F.blob[b];
    V3 dx = mk(x.x - B.cx, x.y - B.cy, x.z - B.cz);
    float g = B.w * expf(-0.5f * dot3(dx, dx) * B.dens_c);
    dens = b == 0 ? g : dens + g;
  }
  return dens;
}

// sigma_t * int_0^t d(o + s dir) ds along unit d, closed form
VPT_HD float field_tau(const FieldParams& F, float sigma_t, V3 o, V3 d, float t) {
  if (F.kind == kExpHeight) {
    float d0 = exp_clip(-F.k * (o.y - F.y0));
    float d_end = exp_clip(-F.k * (o.y + t * d.y - F.y0));
    float m = F.k * d.y;
    bool cnst = fabsf(m) < 1e-6f;
    float safe_m = cnst ? 1.0f : m;
    float base = cnst ? d0 * t : (d0 - d_end) / safe_m;
    float lb = t * vmin(d0, d_end);
    float tau = t >= 0.0f ? vmax(base, lb) : vmin(base, lb);
    return sigma_t * vclip(tau, -TAU_CAP, TAU_CAP);
  }
  float tau = 0.0f;
  for (int b = 0; b < F.n_blobs; ++b) {
    const FieldBlob& B = F.blob[b];
    V3 oc = mk(B.cx - o.x, B.cy - o.y, B.cz - o.z);
    float a = dot3(oc, d);
    float b2 = vmax(dot3(oc, oc) - a * a, 0.0f);
    float amp = expf(-0.5f * b2 * B.tau_c) * B.amp_c;
    float hi = erf_poly((t - a) * B.kh);
    float lo = erf_poly(a * B.kh);
    float g = amp * (hi + lo);
    tau = b == 0 ? g : tau + g;
  }
  return sigma_t * tau;
}

VPT_HD float field_tr_toward(const FieldParams& F, float sigma_t, V3 x, V3 dir, float dist) {
  return expf(-field_tau(F, sigma_t, x, dir, dist));
}

// Free-flight distance: exp_height inverts its CDF in closed form from u;
// blobs run delta tracking, two draws per null step for max_null steps. A
// thread stops at acceptance (or on passing t_cap) and skips the draws the
// remaining steps would take, so its stream stays where vpt's lockstep
// lanes leave theirs. Returns t on acceptance, the overshooting t past t_cap
// (a surface event), BIG when the steps run out (the lane escapes).
// inv_maj_rate: 1 / (sigma_t majorant) in the caller's arithmetic.
VPT_HD float field_sample_free(const FieldParams& F, float sigma_t, float inv_maj_rate, V3 o,
                               V3 d, float u, Pcg& rng, float t_cap) {
  if (F.kind == kExpHeight) {
    float d0 = exp_clip(-F.k * (o.y - F.y0));
    float m = F.k * d.y;
    float tau_star = -log1pf(-u);
    float a = vmax(sigma_t * d0, 1e-30f);
    bool cnst = fabsf(m) < 1e-6f;
    float safe_m = cnst ? 1.0f : m;
    float arg = -tau_star * safe_m / a;
    bool escapes = !cnst && arg <= -1.0f;
    float t_gen = -log1pf(escapes ? -0.5f : arg) / safe_m;
    float t_const = tau_star / a;
    float t_fin = escapes ? BIG : (cnst ? t_const : t_gen);
    return vmin(t_fin, BIG);
  }
  float t = 0.0f;
  for (int i = 0; i < F.max_null; ++i) {
    float u1 = rng.next();
    float u2 = rng.next();
    float step = -log1pf(-u1) * inv_maj_rate;
    float t_new = t + step;
    bool accept = u2 < field_density(F, ray_at(o, t_new, d)) * F.inv_maj;
    t = t_new;
    if (accept || t_new > t_cap) {
      rng.skip(2 * (F.max_null - 1 - i));
      return t;
    }
  }
  return BIG;
}

// ---- the pair's field-parameter derivatives (traced fields only) --------

// d/dk of the exp_height optical path per unit sigma; the |m| < 1e-6 limit
// is -(a0 + a1)/2 d0 t
VPT_HD float field_tau_dk(const FieldParams& F, V3 o, V3 d, float t, bool guard = false) {
  float a0 = o.y - F.y0;
  float a1 = o.y + t * d.y - F.y0;
  float d0 = exp_clip(-F.k * a0);
  float d1 = exp_clip(-F.k * a1);
  float m = F.k * d.y;
  bool cnst = fabsf(m) < 1e-6f;
  float safe_m = cnst ? 1.0f : m;
  float inv_m = 1.0f / safe_m;
  float gen, lim;
  if (guard) {
    // each product that can overflow clamped to +-FLT_MAX (prims.py
    // field_tau_dk): far below the fog plane a0 d0 and a1 d1 reach -inf,
    // and the unguarded form gives inf - inf = NaN
    gen = ((vclip(a1 * d1, -F32_MAX, F32_MAX) - vclip(a0 * d0, -F32_MAX, F32_MAX)) -
           vclip((d0 - d1) * d.y * inv_m, -F32_MAX, F32_MAX)) *
          inv_m;
    lim = vclip(-0.5f * (a0 + a1) * d0, -F32_MAX, F32_MAX) * t;
  } else {
    gen = ((a1 * d1 - a0 * d0) - (d0 - d1) * d.y * inv_m) * inv_m;
    lim = -0.5f * (a0 + a1) * d0 * t;
  }
  return vclip(cnst ? lim : gen, -TAU_CAP, TAU_CAP);
}

// d/d(cx, cy, cz, r, w) of blob B's optical path per unit sigma
VPT_HD void blob_tau_grads(const FieldBlob& B, V3 o, V3 d, float t, float out[5]) {
  float oc[3] = {B.cx - o.x, B.cy - o.y, B.cz - o.z};
  const float dd[3] = {d.x, d.y, d.z};
  float a = oc[0] * d.x + oc[1] * d.y + oc[2] * d.z;
  float b2 = vmax(oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - a * a, 0.0f);
  const float inv_r = B.inv_r;
  float g = expf(-0.5f * b2 * B.tau_c);
  float amp = g * B.ramp;
  const float k = B.kh;
  float xh = (t - a) * k;
  float xl = a * k;
  float S = erf_poly(xh) + erf_poly(xl);
  float dphi_h = TWO_OVER_SQRTPI * expf(-xh * xh);
  float dphi_l = TWO_OVER_SQRTPI * expf(-xl * xl);
  for (int j = 0; j < 3; ++j) {
    float db2 = 2.0f * oc[j] - 2.0f * a * dd[j];
    float damp = amp * (-0.5f * inv_r * inv_r) * db2;
    float dhi = -dd[j] * k * dphi_h;
    float dlo = dd[j] * k * dphi_l;
    out[j] = B.w * (damp * S + amp * (dhi + dlo));
  }
  out[3] = B.w * (amp * (inv_r + b2 * inv_r * inv_r * inv_r) * S +
                  amp * (dphi_h * (-xh * inv_r) + dphi_l * (-xl * inv_r)));
  out[4] = amp * S;
}

// blob B's term w e of the density at x (e returned) and d/d(cx, cy, cz, r,
// w) of it
VPT_HD float blob_dens_grads(const FieldBlob& B, V3 x, float out[5]) {
  float dx[3] = {x.x - B.cx, x.y - B.cy, x.z - B.cz};
  float q2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2];
  float inv_r2 = B.dens_c;
  float e = expf(-0.5f * q2 * inv_r2);
  for (int j = 0; j < 3; ++j) out[j] = B.w * e * (dx[j] * inv_r2);
  out[3] = B.w * e * (q2 * inv_r2 / B.r);
  out[4] = e;
  return e;
}

}  // namespace vpt
