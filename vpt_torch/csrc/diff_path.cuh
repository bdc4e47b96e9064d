// Per-path device code of the differentiable pair (csrc/diff.cu): the
// forward K2 (kGrads = false) and its single-replay backward K3
// (kGrads = true) in one body, as vpt's make_kernel(grads) is one body.
//
// Thread-scalar transcription of vpt/kernels/diff.py:290-1251 for the
// free-flight NEE estimator (nee, distance "free", not physical), isotropic
// phase, no material-3 shells, samplers "random" and "ld", in a homogeneous
// medium or (kField) an analytic density field with vpt's diff_field /
// diff_blobs traced parameters. It reuses csrc/path.cuh's primitives and its parity rules (uint32
// PCG, every draw in vpt's order, no FMA contraction), and follows diff.py's
// arithmetic rather than the forward kernel's: sigma_t = sa + ss, 1/sigma_t
// and (sigma_s/sigma_t)/cp are f32 operations on the parameter vector, the
// camera divides by the frame size, and the NEE sums associate as diff.py
// writes them.
//
// Parameters: pv[0] = sigma_a, pv[1] = sigma_s, pv[2 + 3s + c] = albedo,
// pv[2 + 3S + 3s + c] = radiance, then n_fp traced field parameters from IK =
// 2 + 6S: fog_k (1) or the blob rows (5K: cx, cy, cz, r, w per blob); P =
// 2 + 6S + n_fp. The scene's own radiance (DiffParams.base.rad) still
// decides which spheres are emitters, as in vpt.
//
// The field's arithmetic: without traced field parameters its constants are
// K1's (folded in double on the host); with them, f32 operations on the
// vector (traced_blob), and 1/(sigma_t majorant) is always an f32 operation
// since sigma_t is traced. The pair matches K1 within vpt's 1e-5 of scale.
#pragma once

#include "path.cuh"

#define VPT_MAX_PARAMS (2 + 6 * VPT_MAX_SPHERES)
#define VPT_MAX_FP (5 * VPT_MAX_BLOBS)  // traced field-parameter slots

// Launch parameters of K2/K3, laid out word by word by
// vpt_torch/kernels/diff.py DiffPacked.words().
struct DiffParams {
  VptParams base;  // scene, camera, estimator constants (the render kernel's)
  float cp;        // continue_prob as f32
  float inv_spp;   // f32(1 / spp): the cotangent's scale
  int n_params;    // P = 2 + 6 * n_spheres
  int alb_mask;    // bit s: sphere s has an albedo gradient
  int lam_mask;    // bit s: sphere s has deferred lambert-albedo terms
  int n_fp;        // traced field-parameter slots (0, 1 or 5K)
  int fp_kind;     // 0 none, kFpFogK, kFpBlobs
};

namespace vpt {

enum FpKind { kFpFogK = 1, kFpBlobs = 2 };

// A traced blob's constants from its row (cx, cy, cz, r, w) of the vector,
// in f32 as vpt's traced field forms compute them
VPT_HD void traced_blob(const float* row, FieldBlob& B) {
  B.cx = row[0];
  B.cy = row[1];
  B.cz = row[2];
  B.r = row[3];
  B.w = row[4];
  const float inv_r = 1.0f / B.r;
  B.inv_r = inv_r;
  B.ramp = B.r * SQRT_HALF_PI;
  B.dens_c = 1.0f / (B.r * B.r);
  B.tau_c = inv_r * inv_r;
  B.amp_c = B.ramp * B.w;
  B.kh = inv_r * SQRT_HALF;
}

// The field the pair reads (staged per block by csrc/diff_kernel.cuh): the
// launch's, with the traced entries recomputed from the vector
VPT_HD void pair_field(const DiffParams& D, const float* pv, FieldParams& F) {
  F = D.base.field;
  const int ik = 2 + 6 * D.base.n_spheres;
  if (D.fp_kind == kFpFogK) F.k = pv[ik];
  if (D.fp_kind == kFpBlobs)
    for (int b = 0; b < F.n_blobs; ++b) traced_blob(pv + ik + 5 * b, F.blob[b]);
}

// vpt's fp_dI: d(optical path per unit sigma along (o, d) to t)/dtheta for
// the n_fp traced slots
VPT_HD void fp_dI(const FieldParams& F, int fp_kind, V3 o, V3 d, float t, float* out) {
  if (fp_kind == kFpFogK) {
    out[0] = field_tau_dk(F, o, d, t);
  } else {
    for (int b = 0; b < F.n_blobs; ++b) blob_tau_grads(F.blob[b], o, d, t, out + 5 * b);
  }
}

// vpt's fp_dlogdens: d log(density at x)/dtheta for the n_fp traced slots
VPT_HD void fp_dlogdens(const FieldParams& F, int fp_kind, V3 x, float* out) {
  if (fp_kind == kFpFogK) {
    out[0] = -(x.y - F.y0);
    return;
  }
  float dens = 0.0f;
  for (int b = 0; b < F.n_blobs; ++b) {
    float e = blob_dens_grads(F.blob[b], x, out + 5 * b);
    float we = F.blob[b].w * e;
    dens = b == 0 ? we : dens + we;
  }
  const float inv = 1.0f / vmax(dens, 1e-30f);
  for (int f = 0; f < 5 * F.n_blobs; ++f) out[f] = out[f] * inv;
}

VPT_HD Attr attrs_p(const VptParams& P, const float* pv, int sid) {
  Attr a = attrs(P, sid);
  if (sid >= 0) {
    for (int i = 0; i < 3; ++i) {
      a.alb[i] = pv[2 + 3 * sid + i];
      a.rad[i] = pv[2 + 3 * P.n_spheres + 3 * sid + i];
    }
  }
  return a;
}

// MISv2 and its partials (diff.py mis_v2): 3 draws per MIS light, then 3.
// With kGrads: dsig = d/dsigma_t of the light-strategy transmittances,
// dalb = d/dalbedo, drad[e] = d/dradiance of MIS light e, dle = d/d(hit
// radiance) of the BSDF strategy, sid2 its hit sphere. kField: the light
// strategy's transmittance through the field F, and with n_fp traced slots
// dk[f] = d/d(slot f) of the light strategy.
template <bool kGrads, bool kField>
VPT_HD void diff_mis_v2(const VptParams& P, const float* pv, const FieldParams& F, int fp_kind,
                        int n_fp, float sigma_t, Pcg& rng, const Attr& at, V3 xs, V3 n, V3 d,
                        float acc[3], float dsig[3], float dalb[3], float dle[3],
                        float drad[][3], float dk[][3], int& sid2) {
  const int rad0 = 2 + 3 * P.n_spheres;
  const bool is_lam = !at.is_mic && !at.is_die;
  for (int i = 0; i < 3; ++i) acc[i] = dsig[i] = dalb[i] = 0.0f;
  if constexpr (kGrads && kField)
    for (int f = 0; f < n_fp; ++f) dk[f][0] = dk[f][1] = dk[f][2] = 0.0f;
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
    // the optical path per unit sigma_t (the distance when homogeneous)
    float att;
    if constexpr (kField)
      att = field_tau(F, 1.0f, xs, wc, normcx);
    else
      att = normcx;
    float tr = expf(-sigma_t * att);
    float w_vis = visible ? tr * dot3(n, wi) * fpdf_inv : 0.0f;
    float gpdf = bsdf_pdf_for_dir(at, n, wo, wi, rng.next());
    float wf = power_h_invf(fpdf_inv, gpdf);
    for (int i = 0; i < 3; ++i) {
      float re = pv[rad0 + 3 * e + i];
      float term = re * fr[i] * w_vis * wf;
      acc[i] = acc[i] + term;
      if constexpr (kGrads) {
        dsig[i] = dsig[i] + term * (-att);
        dalb[i] = dalb[i] + (is_lam ? re * w_vis * wf * INV_PI : 0.0f);
        drad[e][i] = fr[i] * w_vis * wf;
      }
    }
    if constexpr (kGrads && kField) {
      if (n_fp > 0) {  // d(tr)/dtheta = tr (-sigma_t dI/dtheta)
        float dIs[VPT_MAX_FP];
        fp_dI(F, fp_kind, xs, wc, normcx, dIs);
        for (int f = 0; f < n_fp; ++f)
          for (int i = 0; i < 3; ++i) {
            float term = pv[rad0 + 3 * e + i] * fr[i] * w_vis * wf;
            dk[f][i] = dk[f][i] + term * (-sigma_t * dIs[f]);
          }
      }
    }
  }
  // BSDF strategy: sample the lane's lobe, one trace
  float u1 = rng.next(), u2 = rng.next(), u_choice = rng.next();
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
  sid2 = nearest_id_t(P, xs, wi_sel, t_unused);
  bool hit = sid2 >= 0;
  float le[3];
  for (int i = 0; i < 3; ++i) le[i] = hit ? pv[rad0 + 3 * sid2 + i] : 0.0f;
  float hit_r = hit ? P.r[sid2] : 0.0f;
  V3 hc = hit ? mk(P.c[sid2][0], P.c[sid2][1], P.c[sid2][2]) : zero;
  float coef[3], g[3], gpdf;
  bool nz_l = false;
  if (at.is_mic) {
    float fr_m[3];
    fr_microfacet(at, wi_m_loc, wh_loc, wo_loc, fr_m);
    float gpdf_m = ndf_beckmann(wh_loc.z, at.alpha) * wh_loc.z /
                   (4.0f * vmax(fabsf(dot3(wo_loc, wh_loc)), 1e-12f));
    float winv_m = wi_m_loc.z / vmax(gpdf_m, 1e-20f);
    for (int i = 0; i < 3; ++i) coef[i] = fr_m[i] * winv_m;
    gpdf = gpdf_m;
  } else if (at.is_die) {
    float cos_d = fabsf(dot3(n, wi_d));
    float scale_d = (refl ? 1.0f : ETA_T * ETA_T) / vmax(cos_d, 1e-12f);
    for (int i = 0; i < 3; ++i) coef[i] = scale_d;
    gpdf = refl ? fres : 1.0f - fres;
  } else {
    float gpdf_l = dot3(n, wi_l) * INV_PI;
    // (le*a/pi*cos_l) / (cos_l/pi) is exactly le*a, 0 when cos_l == 0
    nz_l = gpdf_l != 0.0f;
    for (int i = 0; i < 3; ++i) coef[i] = nz_l ? at.alb[i] : 0.0f;
    gpdf = gpdf_l;
  }
  for (int i = 0; i < 3; ++i) g[i] = le[i] * coef[i];
  bool pos_all = g[0] > 0.0f && g[1] > 0.0f && g[2] > 0.0f;
  bool gate = at.is_mic ? g[0] > 0.0f : pos_all;
  V3 hcx = sub3(hc, xs);
  float n2 = vmax(dot3(hcx, hcx), 1e-20f);
  float cmax = sqrtf(vmax(1.0f - hit_r * hit_r / n2, 1e-12f));
  float fpdf_h_inv = TWO_PI * vmax(1.0f - cmax, 1e-12f);
  float wg = (gate && hit) ? power_h_invg(gpdf, fpdf_h_inv) : 0.0f;
  for (int i = 0; i < 3; ++i) acc[i] = acc[i] + g[i] * wg;
  if constexpr (kGrads) {
    for (int i = 0; i < 3; ++i) {
      dle[i] = coef[i] * wg;
      dalb[i] = dalb[i] + ((is_lam && nz_l) ? le[i] * wg : 0.0f);
    }
  }
}

// freeSingleScattering with the point-source kill (diff.py medium_nee):
// radiance, its weight w (d/dlrad), the optical path per unit sigma att
// (d/dsigma_t of the transmittance is -att * value), the cone direction wl
// and the shadow distance t_sh
template <bool kField>
VPT_HD void diff_medium_nee(const VptParams& P, const FieldParams& F, float sigma_t, V3 xt,
                            V3 lc, const float lrad[3], float lr, int lid, float u1, float u2,
                            float out[3], float& w, float& att, V3& wl, float& t_sh) {
  V3 wc = sub3(lc, xt);
  float inv_mag = vrsqrt(vmax(dot3(wc, wc), 1e-20f));
  V3 wc_n = scale3(wc, inv_mag);
  float ratio = lr * inv_mag;
  float cos_max = sqrtf(vmax(1.0f - ratio * ratio, 1e-12f));
  wl = cone_dir(wc_n, cos_max, u1, u2);
  float t;
  int sid = nearest_id_t(P, xt, wl, t);
  bool visible = sid >= 0 && sid == lid && lr > 0.0f;
  if constexpr (kField)
    att = field_tau(F, 1.0f, xt, wl, t);
  else
    att = t;
  t_sh = t;
  w = visible ? expf(-sigma_t * att) * P.nee_phase * vmax(1.0f - cos_max, 1e-12f) : 0.0f;
  for (int i = 0; i < 3; ++i) out[i] = lrad[i] * w;
}

// One pixel of K2 (kGrads = false: out = radiance / spp) or K3 (kGrads =
// true: gout[0..P) = this pixel's contribution to the packed gradient of
// sum(image * gbar); gbar points at the pixel's 3 cotangents). The lane
// leaves its loop at samples == spp: in vpt's tile a finished lane is frozen
// (alive and need stay false, every accumulation is gated on shade, medium,
// credit or finished), so nothing more reaches L or the gradient.
//
// kField: the medium's density field F (csrc/diff_kernel.cuh stages it, with
// the traced parameters' constants from pv). Its free flight is K1's (the
// same draws; an escaped flight kills the lane), every transmittance and
// sigma score takes the field's optical paths per unit sigma, and the n_fp
// traced slots gain vpt's pathwise terms (pLight, MIS light strategy, medium
// NEE) and deferred event-score pairs.
template <bool kGrads, bool kField = false>
VPT_HD void diff_pixel(const DiffParams& D, const float* pv, const FieldParams& F, int pixel,
                       int seed, const float* gbar, float out[3], float* gout) {
  const VptParams& P = D.base;
  const int S = P.n_spheres;
  const int rad0 = 2 + 3 * S;
  const float sa = pv[0], ss = pv[1];
  const float sigma_t = sa + ss;
  const float inv_st = 1.0f / sigma_t;
  const float albedo_ratio = ss * inv_st;
  const float ar_cp = albedo_ratio / D.cp;  // the medium throughput factor
  const float inv_ss = 1.0f / ss;
  const float med_dsig = -inv_st;
  const float inv_ps = P.n_em_f;
  const float inv_cp = P.inv_cp;
  // the traced field-parameter slots and delta tracking's step scale
  const int n_fp = kField ? D.n_fp : 0;
  const int fp_kind = D.fp_kind;
  const int IK = 2 + 6 * S;
  float inv_mr = 0.0f;
  if constexpr (kField) inv_mr = 1.0f / (sigma_t * F.maj);
  constexpr int kFp = (kGrads && kField) ? VPT_MAX_FP : 1;

  const float px = (float)(pixel % P.width);
  const float py = (float)(P.height - 1 - pixel / P.width);
  const uint32_t lane = (uint32_t)pixel;
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
  const V3 cam_o = mk(P.cam_o[0], P.cam_o[1], P.cam_o[2]);

  // K3's per-thread accumulators: the sigma_t / sigma_s-only terms, the
  // deferred (A, B) pairs, and the albedo / radiance slots of the packed
  // vector (gv, indexed by sphere id)
  float wt[3] = {0.0f, 0.0f, 0.0f};
  float g_st = 0.0f, g_ssx = 0.0f, A_st = 0.0f, B_st = 0.0f, A_ssx = 0.0f, B_ssx = 0.0f;
  // (gv[IK + f] the immediate field-parameter terms, A_fp / B_fp their
  // deferred event-score pairs)
  float gv[kGrads ? (kField ? VPT_MAX_PARAMS + VPT_MAX_FP : VPT_MAX_PARAMS) : 1];
  float A_alb[kGrads ? VPT_MAX_SPHERES : 1][3], B_alb[kGrads ? VPT_MAX_SPHERES : 1][3];
  float A_fp[kFp], B_fp[kFp];
  if constexpr (kGrads) {
    for (int i = 0; i < 3; ++i) wt[i] = gbar[i] * D.inv_spp;
    for (int k = 0; k < D.n_params; ++k) gv[k] = 0.0f;
    for (int s = 0; s < S; ++s)
      for (int i = 0; i < 3; ++i) A_alb[s][i] = B_alb[s][i] = 0.0f;
    for (int f = 0; f < n_fp; ++f) A_fp[f] = B_fp[f] = 0.0f;
  }

  V3 o = mk(0.0f, 0.0f, 0.0f), d = mk(0.0f, 0.0f, 1.0f);
  float tp[3] = {0.0f, 0.0f, 0.0f};
  float L[3] = {0.0f, 0.0f, 0.0f};
  float Lps[3] = {0.0f, 0.0f, 0.0f};  // the current sample's radiance prefix
  bool alive = false;
  int depth = 0, samples = 0;

  for (int it = 0; it < P.max_iters && samples < P.spp; ++it) {
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
      float sx = (px + u - 0.5f) / (float)P.width - 0.5f;
      float sy = (py + v - 0.5f) / (float)P.height - 0.5f;
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
    float u_dist = rng.next();
    if (P.ld && depth == 0) {
      float s_f = (float)samples;
      u_rr = ld_strat(LD_A4, off[3], s_f);
      u_pick = ld_strat(LD_A5, off[4], s_f);
      u_dist = ld_strat(LD_A3, off[2], s_f);
    }
    bool live = u_rr >= P.q;
    float t;
    int sid = nearest_id_t(P, o, d, t);
    bool hit = sid >= 0;
    Attr at = attrs_p(P, pv, sid);
    float t_eff = hit ? t : BIG;
    V3 xs = ray_at(o, t_eff, d);
    V3 nrm = normalize3(sub3(xs, at.c));
    int k = (int)(u_pick * P.n_em_f);
    k = k < 0 ? 0 : k;
    k = k > n_em - 1 ? n_em - 1 : k;
    int lid = -1;
    V3 lc = mk(0.0f, 0.0f, 0.0f);
    float lrad[3] = {0.0f, 0.0f, 0.0f}, lr = 0.0f;
    if (k >= 0) {
      lid = P.emitters[k];
      lc = mk(P.c[lid][0], P.c[lid][1], P.c[lid][2]);
      for (int i = 0; i < 3; ++i) lrad[i] = pv[rad0 + 3 * lid + i];
      lr = P.r[lid];
    }

    float d_s;
    if constexpr (kField)
      d_s = field_sample_free(F, sigma_t, inv_mr, o, d, u_dist, rng, t_eff);
    else
      d_s = -log1pf(-u_dist) * inv_st;
    bool surface = d_s > t_eff && hit;
    if (kField) live = live && (d_s < 0.5f * BIG || surface);  // escaped: dies
    V3 xt = ray_at(o, d_s, d);
    bool medium = live && !surface;
    bool shade_pre = live && surface;
    if constexpr (kGrads) {
      // free-flight score vs the L-prefix before this bounce
      float k_sc;
      if constexpr (kField) {
        // dlog p/dsigma = 1/sigma_t - I(d) (medium) | -I(t) (surface), I
        // the optical path per unit sigma
        if (shade_pre)
          k_sc = -field_tau(F, 1.0f, o, d, t_eff);
        else if (medium)
          k_sc = inv_st - field_tau(F, 1.0f, o, d, d_s);
        else
          k_sc = 0.0f;
      } else {
        k_sc = shade_pre ? -t_eff : (medium ? inv_st - d_s : 0.0f);
      }
      float wL0 = wt[0] * Lps[0] + wt[1] * Lps[1] + wt[2] * Lps[2];
      A_st = A_st + k_sc;
      B_st = B_st + k_sc * wL0;
      if constexpr (kField) {
        if (n_fp > 0) {
          // field-parameter event scores: dlog dens(x_d)/dtheta - sigma
          // dI(d)/dtheta (medium), -sigma dI(t)/dtheta (surface)
          float dI[kFp], dld[kFp];
          if (shade_pre) fp_dI(F, fp_kind, o, d, t_eff, dI);
          if (medium) {
            fp_dI(F, fp_kind, o, d, d_s, dI);
            fp_dlogdens(F, fp_kind, xt, dld);
          }
          for (int f = 0; f < n_fp; ++f) {
            float k_f = shade_pre ? -sigma_t * dI[f]
                                  : (medium ? dld[f] - sigma_t * dI[f] : 0.0f);
            A_fp[f] = A_fp[f] + k_f;
            B_fp[f] = B_fp[f] + k_f * wL0;
          }
        }
      }
    }

    bool em_hit = surface && at.is_em;
    if (live && em_hit && depth == 0) {
      for (int i = 0; i < 3; ++i) {
        float add = at.rad[i] * tp[i];
        L[i] = L[i] + add;
        Lps[i] = Lps[i] + add;
        if constexpr (kGrads) gv[rad0 + 3 * sid + i] = gv[rad0 + 3 * sid + i] + wt[i] * tp[i];
      }
    }
    bool shade = live && surface && !em_hit;

    if (shade) {  // surface NEE: pLight + MISv2
      float dist_l;
      V3 dl;
      float le_scale = plight_le_scale(P, lc, xs, dist_l, dl);
      V3 wi = neg3(dl);
      float fr[3];
      eval_fr_nee(at, nrm, d, wi, true, fr);
      float cosw = dot3(nrm, wi);
      float coef[3], ldp[3];
      for (int i = 0; i < 3; ++i) {
        coef[i] = le_scale * fr[i] * cosw;
        ldp[i] = lrad[i] * coef[i];
      }
      float att_pl = dist_l;
      V3 wlight = mk(0.0f, 0.0f, 0.0f);
      if constexpr (kField) {
        float inv_dl = 1.0f / vmax(dist_l, 1e-20f);
        wlight = scale3(sub3(lc, xs), inv_dl);
        att_pl = field_tau(F, 1.0f, xs, wlight, dist_l);
      }
      float trs = expf(-sigma_t * att_pl);
      float ldm[3], dsig[3], dalb[3], dle[3];
      float drad[kGrads ? VPT_MAX_SPHERES : 1][3];
      float dk[kFp][3];
      int sid2;
      diff_mis_v2<kGrads, kField>(P, pv, F, fp_kind, n_fp, sigma_t, rng, at, xs, nrm, d, ldm,
                                  dsig, dalb, dle, drad, dk, sid2);
      for (int i = 0; i < 3; ++i) {
        float add = (ldp[i] * trs * inv_ps + ldm[i]) * tp[i] * inv_cp;
        L[i] = L[i] + add;
        Lps[i] = Lps[i] + add;
      }
      if constexpr (kGrads) {
        float gs = 0.0f;
        for (int i = 0; i < 3; ++i)
          gs = gs + wt[i] * (ldp[i] * trs * (-att_pl) * inv_ps + dsig[i]) * tp[i] * inv_cp;
        g_st = g_st + gs;
        if constexpr (kField) {
          if (n_fp > 0) {  // pLight's and the MIS light strategy's d(tr)/dtheta
            float dI_pl[kFp];
            fp_dI(F, fp_kind, xs, wlight, dist_l, dI_pl);
            for (int f = 0; f < n_fp; ++f) {
              float gk = 0.0f;
              for (int i = 0; i < 3; ++i)
                gk = gk + wt[i] * (ldp[i] * trs * (-sigma_t * dI_pl[f]) * inv_ps + dk[f][i]) *
                              tp[i] * inv_cp;
              gv[IK + f] = gv[IK + f] + gk;
            }
          }
        }
        for (int q = 0; q < n_em; ++q) {  // radiance: pLight, MIS light, MIS BSDF
          int e = P.emitters[q];
          bool is_mis = false;
          for (int j = 0; j < P.n_mis; ++j) is_mis = is_mis || P.mis_lights[j] == e;
          for (int i = 0; i < 3; ++i) {
            float g = lid == e ? wt[i] * coef[i] * trs * inv_ps * tp[i] * inv_cp : 0.0f;
            if (is_mis) g = g + wt[i] * drad[e][i] * tp[i] * inv_cp;
            g = g + (sid2 == e ? wt[i] * dle[i] * tp[i] * inv_cp : 0.0f);
            gv[rad0 + 3 * e + i] = gv[rad0 + 3 * e + i] + g;
          }
        }
        if ((D.alb_mask >> sid) & 1) {  // albedo of the shaded sphere
          for (int i = 0; i < 3; ++i) {
            float lam = !at.is_mic ? lrad[i] * le_scale * cosw * INV_PI : 0.0f;
            gv[2 + 3 * sid + i] =
                gv[2 + 3 * sid + i] + wt[i] * (lam * trs * inv_ps + dalb[i]) * tp[i] * inv_cp;
          }
        }
      }
    } else {
      rng.skip(mis_draws);
    }
    float b1 = rng.next(), b2 = rng.next(), b3 = rng.next();  // sample_bsdf
    float u_p1 = rng.next(), u_p2 = rng.next();               // phase
    float m1 = rng.next(), m2 = rng.next();                   // medium NEE cone

    if (shade) {
      float fs[3], pdf_b;
      V3 wi_s;
      sample_bsdf(at, d, nrm, b1, b2, b3, fs, wi_s, pdf_b);
      float wscale = dot3(nrm, wi_s) * inv_cp / vmax(pdf_b, 1e-20f);
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * fs[i] * wscale;
      o = xs;
      d = wi_s;
      if constexpr (kGrads) {
        // deferred lambert-albedo log-throughput terms vs the L-prefix
        // after this bounce's emissions
        if ((D.lam_mask >> sid) & 1) {
          for (int i = 0; i < 3; ++i) {
            float a = at.alb[i];
            float inv_a = a > 0.0f ? 1.0f / a : 0.0f;
            float kk = wt[i] * inv_a;
            A_alb[sid][i] = A_alb[sid][i] + kk;
            B_alb[sid][i] = B_alb[sid][i] + kk * Lps[i];
          }
        }
      }
    } else if (medium) {
      float ld_med[3], w_med, att_nee, t_nee;
      V3 wl_nee;
      diff_medium_nee<kField>(P, F, sigma_t, xt, lc, lrad, lr, lid, m1, m2, ld_med, w_med,
                              att_nee, wl_nee, t_nee);
      float adds[3];
      for (int i = 0; i < 3; ++i) {
        adds[i] = ld_med[i] * inv_ps * tp[i] * ar_cp;
        L[i] = L[i] + adds[i];
        Lps[i] = Lps[i] + adds[i];
      }
      if constexpr (kGrads) {
        float gs = 0.0f, gx = 0.0f;
        for (int i = 0; i < 3; ++i) {
          gs = gs + wt[i] * adds[i] * (-att_nee + med_dsig);
          gx = gx + wt[i] * adds[i];
        }
        g_st = g_st + gs;
        g_ssx = g_ssx + gx * inv_ss;
        if constexpr (kField) {
          if (n_fp > 0) {  // the medium-NEE transmittance's d/dtheta
            float dI_nee[kFp];
            fp_dI(F, fp_kind, xt, wl_nee, t_nee, dI_nee);
            for (int f = 0; f < n_fp; ++f)
              gv[IK + f] = gv[IK + f] + gx * (-sigma_t * dI_nee[f]);
          }
        }
        if (lid >= 0)
          for (int i = 0; i < 3; ++i)
            gv[rad0 + 3 * lid + i] =
                gv[rad0 + 3 * lid + i] + wt[i] * w_med * inv_ps * tp[i] * ar_cp;
        // deferred medium-factor terms vs the L-prefix after this bounce
        float wL1 = wt[0] * Lps[0] + wt[1] * Lps[1] + wt[2] * Lps[2];
        A_st = A_st + med_dsig;
        B_st = B_st + med_dsig * wL1;
        A_ssx = A_ssx + inv_ss;
        B_ssx = B_ssx + inv_ss * wL1;
      }
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * ar_cp;
      o = xt;
      d = uniform_sphere(u_p1, u_p2);
    }
    alive = (shade || medium) && depth + 1 < P.max_bounces;
    if (alive) {
      depth = depth + 1;
    } else {
      samples = samples + 1;  // the path that started this sample ended
      if constexpr (kGrads) {
        // fold the deferred pairs: A * L_total - B at path death
        float WL = wt[0] * Lps[0] + wt[1] * Lps[1] + wt[2] * Lps[2];
        g_st = g_st + (A_st * WL - B_st);
        g_ssx = g_ssx + (A_ssx * WL - B_ssx);
        A_st = B_st = A_ssx = B_ssx = 0.0f;
        for (int f = 0; f < n_fp; ++f) {
          gv[IK + f] = gv[IK + f] + (A_fp[f] * WL - B_fp[f]);
          A_fp[f] = B_fp[f] = 0.0f;
        }
        for (int s = 0; s < S; ++s) {
          if (!((D.lam_mask >> s) & 1)) continue;
          for (int i = 0; i < 3; ++i) {
            gv[2 + 3 * s + i] = gv[2 + 3 * s + i] + (A_alb[s][i] * Lps[i] - B_alb[s][i]);
            A_alb[s][i] = B_alb[s][i] = 0.0f;
          }
        }
        Lps[0] = Lps[1] = Lps[2] = 0.0f;
      }
    }
  }
  if constexpr (!kGrads) {
    const float spp = (float)P.spp;
    for (int i = 0; i < 3; ++i) out[i] = L[i] / spp;
  } else {
    // a lane cut by the iteration cap folds with its partial prefix
    float wt_sum = wt[0] * Lps[0] + wt[1] * Lps[1] + wt[2] * Lps[2];
    g_st = g_st + A_st * wt_sum - B_st;
    g_ssx = g_ssx + A_ssx * wt_sum - B_ssx;
    for (int f = 0; f < n_fp; ++f) gv[IK + f] = gv[IK + f] + A_fp[f] * wt_sum - B_fp[f];
    for (int s = 0; s < S; ++s) {
      if (!((D.lam_mask >> s) & 1)) continue;
      for (int i = 0; i < 3; ++i)
        gv[2 + 3 * s + i] = gv[2 + 3 * s + i] + (A_alb[s][i] * Lps[i] - B_alb[s][i]);
    }
    gout[0] = g_st;
    gout[1] = g_st + g_ssx;
    for (int q = 2; q < D.n_params; ++q) gout[q] = gv[q];
  }
}

}  // namespace vpt
