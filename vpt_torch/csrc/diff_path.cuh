// Per-path device code of the differentiable pair (csrc/diff.cu): the
// forward K2 (kGrads = false) and its single-replay backward K3
// (kGrads = true) in one body, as vpt's make_kernel(grads) is one body.
//
// Thread-scalar transcription of vpt/kernels/diff.py:290-1251 for the
// free-flight NEE estimator (nee, distance "free", not physical), no
// material-3 shells, samplers "random" and "ld", in a homogeneous medium,
// (kField == kAnalytic) an analytic density field with vpt's diff_field /
// diff_blobs traced parameters or (kGridField) a voxel grid, its voxel
// gradient with diff_grid, with an isotropic phase or (kHG) a Henyey-Greenstein
// one at the scene's baked g or at vpt's traced diff_g. It reuses
// csrc/path.cuh's primitives and its parity rules (uint32
// PCG, every draw in vpt's order, no FMA contraction), and follows diff.py's
// arithmetic rather than the forward kernel's: sigma_t = sa + ss, 1/sigma_t
// and (sigma_s/sigma_t)/cp are f32 operations on the parameter vector, the
// camera divides by the frame size, and the NEE sums associate as diff.py
// writes them.
//
// Parameters: pv[0] = sigma_a, pv[1] = sigma_s, pv[2 + 3s + c] = albedo,
// pv[2 + 3S + 3s + c] = radiance, with diff_g the HG g at IG = 2 + 6S, then
// n_fp traced field parameters from IK = 2 + 6S (+ 1 with diff_g): fog_k
// (1) or the blob rows (5K: cx, cy, cz, r, w per blob); P = 2 + 6S (+ 1) +
// n_fp. The scene's own radiance (DiffParams.base.rad) still decides which
// spheres are emitters, as in vpt.
//
// The HG phase's arithmetic: at a baked g, K1's constants folded in double
// (VptParams.hg_*, a multiply by 1/(2g)); at a traced g, f32 operations on
// pv[IG] with a true division by 2g (hg_phase_traced, hg_dir_traced). The
// two agree within 1e-5 of the image's scale, not bit for bit.
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
  int hg_mode;     // 0 isotropic, kHgBaked (the scene's g), kHgTraced (diff_g)
  int diff_grid;   // 1: K3 also returns the voxel gradient (a grid's pair)
  int distance;    // 0 free flight, kDistEa (vpt's equi-angular branch)
  int nee;         // 1: next-event estimation; 0: every emitter hit counts
  int physical;    // 1: credited emission times 1/cp
};

namespace vpt {

enum FpKind { kFpFogK = 1, kFpBlobs = 2 };
enum HgMode { kHgBaked = 1, kHgTraced = 2 };
enum PairDistance { kDistEa = 1 };

// the packed index of the first traced field parameter: after the traced g
VPT_HD int field_slot0(const DiffParams& D) {
  return 2 + 6 * D.base.n_spheres + (D.hg_mode == kHgTraced ? 1 : 0);
}

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
  const int ik = field_slot0(D);
  if (D.fp_kind == kFpFogK) F.k = pv[ik];
  if (D.fp_kind == kFpBlobs)
    for (int b = 0; b < F.n_blobs; ++b) traced_blob(pv + ik + 5 * b, F.blob[b]);
}

// vpt's fp_dI: d(optical path per unit sigma along (o, d) to t)/dtheta for
// the n_fp traced slots; guard: field_tau_dk's overflow guard (the extended
// instantiations)
VPT_HD void fp_dI(const FieldParams& F, int fp_kind, V3 o, V3 d, float t, float* out,
                  bool guard = false) {
  if (fp_kind == kFpFogK) {
    out[0] = field_tau_dk(F, o, d, t, guard);
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
// strategy's transmittance through the field F (kAnalytic), with n_fp traced
// slots dk[f] = d/d(slot f) of the light strategy, or through the grid
// P.grid and its table tab (kGridField). gg (a grid with diff_grid): each
// light strategy's voxel terms, the transmittance's -sigma_t dI/dv times
// sum_i wtp[i] term[i], are scattered into gg. kExt: fp_dI's overflow guard.
template <bool kGrads, int kField, bool kExt = false>
VPT_HD void diff_mis_v2(const VptParams& P, const float* pv, const FieldParams& F, int fp_kind,
                        int n_fp, float sigma_t, Pcg& rng, const Attr& at, V3 xs, V3 n, V3 d,
                        float acc[3], float dsig[3], float dalb[3], float dle[3],
                        float drad[][3], float dk[][3], int& sid2,
                        const uint32_t* tab = nullptr, float* gg = nullptr,
                        const float* wtp = nullptr) {
  const int rad0 = 2 + 3 * P.n_spheres;
  const bool is_lam = !at.is_mic && !at.is_die;
  for (int i = 0; i < 3; ++i) acc[i] = dsig[i] = dalb[i] = 0.0f;
  if constexpr (kGrads && kField == kAnalytic)
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
    if constexpr (kField == kGridField)
      att = grid_tau(P.grid, tab, 1.0f, xs, wc, normcx, true);
    else if constexpr (kField == kAnalytic)
      att = field_tau(F, 1.0f, xs, wc, normcx);
    else
      att = normcx;
    float tr = expf(-sigma_t * att);
    float w_vis = visible ? tr * dot3(n, wi) * fpdf_inv : 0.0f;
    float gpdf = bsdf_pdf_for_dir(at, n, wo, wi, rng.next());
    float wf = power_h_invf(fpdf_inv, gpdf);
    float w_sc = 0.0f;
    for (int i = 0; i < 3; ++i) {
      float re = pv[rad0 + 3 * e + i];
      float term = re * fr[i] * w_vis * wf;
      acc[i] = acc[i] + term;
      if constexpr (kGrads) {
        dsig[i] = dsig[i] + term * (-att);
        dalb[i] = dalb[i] + (is_lam ? re * w_vis * wf * INV_PI : 0.0f);
        drad[e][i] = fr[i] * w_vis * wf;
        if constexpr (kField == kGridField) w_sc = i == 0 ? wtp[0] * term : w_sc + wtp[i] * term;
      }
    }
    if constexpr (kGrads && kField == kGridField)
      if (gg != nullptr) grid_march_scatter(P.grid, xs, wc, -sigma_t * w_sc, normcx, 0.0f, 0.0f, gg);
    if constexpr (kGrads && kField == kAnalytic) {
      if (n_fp > 0) {  // d(tr)/dtheta = tr (-sigma_t dI/dtheta)
        float dIs[VPT_MAX_FP];
        fp_dI(F, fp_kind, xs, wc, normcx, dIs, kExt);
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
// and the shadow distance t_sh. kHG: the phase toward wl from the incoming
// direction d at the baked g, or at the traced g gph with dlogp = d/dg log
// phase (the pathwise dL/dg factor of this NEE value). kExt: the phase may
// also be isotropic (hg_mode 0)
template <int kField, bool kHG, bool kExt = false>
VPT_HD void diff_medium_nee(const VptParams& P, const FieldParams& F, float sigma_t, int hg_mode,
                            float gph, V3 d, V3 xt, V3 lc, const float lrad[3], float lr,
                            int lid, float u1, float u2, float out[3], float& w, float& att,
                            V3& wl, float& t_sh, float& dlogp, const uint32_t* tab = nullptr) {
  V3 wc = sub3(lc, xt);
  float inv_mag = vrsqrt(vmax(dot3(wc, wc), 1e-20f));
  V3 wc_n = scale3(wc, inv_mag);
  float ratio = lr * inv_mag;
  float cos_max = sqrtf(vmax(1.0f - ratio * ratio, 1e-12f));
  wl = cone_dir(wc_n, cos_max, u1, u2);
  float t;
  int sid = nearest_id_t(P, xt, wl, t);
  bool visible = sid >= 0 && sid == lid && lr > 0.0f;
  if constexpr (kField == kGridField)
    att = grid_tau(P.grid, tab, 1.0f, xt, wl, t, true);
  else if constexpr (kField == kAnalytic)
    att = field_tau(F, 1.0f, xt, wl, t);
  else
    att = t;
  t_sh = t;
  float phase_2pi = P.nee_phase;
  dlogp = 0.0f;
  if constexpr (kHG) {
    const float cos_nee = dot3(d, wl);
    if (hg_mode == kHgTraced) {
      phase_2pi = hg_phase_traced(cos_nee, gph) * TWO_PI;
      dlogp = dlog_hg_dg(cos_nee, gph);
    } else if (!kExt || hg_mode == kHgBaked) {
      phase_2pi = hg_phase_const(P, cos_nee) * TWO_PI;
    }
  }
  w = visible ? expf(-sigma_t * att) * phase_2pi * vmax(1.0f - cos_max, 1e-12f) : 0.0f;
  for (int i = 0; i < 3; ++i) out[i] = lrad[i] * w;
}

// One lane of K2 (kGrads = false: out = radiance / spp) or K3 (kGrads =
// true: gout[0..P) = this lane's contribution to the packed gradient of
// sum(image * gbar); gbar points at the lane's 3 cotangents). The lane seeds
// its PCG streams with its global id `lane` and its camera ray with `pixel`
// (min(lane, npix - 1), vpt's clamp: a shard's lanes past the frame render a
// duplicate of the last pixel with their own streams). The lane
// leaves its loop at samples == spp: in vpt's tile a finished lane is frozen
// (alive and need stay false, every accumulation is gated on shade, medium,
// credit or finished), so nothing more reaches L or the gradient.
//
// kField == kAnalytic: the medium's density field F (csrc/diff_kernel.cuh stages it, with
// the traced parameters' constants from pv). Its free flight is K1's (the
// same draws; an escaped flight kills the lane), every transmittance and
// sigma score takes the field's optical paths per unit sigma, and the n_fp
// traced slots gain vpt's pathwise terms (pLight, MIS light strategy, medium
// NEE) and deferred event-score pairs.
//
// kHG: the Henyey-Greenstein phase (D.hg_mode: the baked g or the traced g
// at IG) in medium NEE and the scatter draw, which takes the same u_p1,
// u_p2. With the traced g, K3 gains the pathwise NEE term gx * dlogp and the
// phase-draw score as a deferred pair (A_g, B_g), folded as A_g L - B_g into
// slot IG.
//
// kField == kGridField: a voxel grid (D.base.grid, its packed table tab). The
// free flight is K1's march (grid_sample_free_and_tau, no extra draw), and
// the sigma scores take its optical paths: I(t) = tau(t)/sigma_t at the
// surface, I(d) = -log1p(-u)/sigma_t at the sampled distance, exactly. With
// gg (K3 with diff_grid) each sample runs twice from the same PCG state
// (vpt's two-phase replay, vpt/kernels/diff.py:600-617, 1115-1126): phase A
// with the cotangent zeroed learns the sample's weighted total wLtot, phase
// B replays it and adds every gradient term, the voxel scatters into gg
// among them (the free-flight event scores against wLtot, the pathwise
// transmittance terms of pLight, medium NEE and the MIS light strategy);
// the iteration cap doubles.
//
// kExt: the estimators beyond free-flight NEE, read from D at run time
// (csrc/diff_ext*.cu). D.distance == kDistEa is vpt's equi-angular branch
// (vpt/kernels/diff.py:680-716, 751-760, 942-971): K1's equiAngularParams2
// on the pair's arithmetic, then the Bernoulli(Tr) draw u_ev; the sigma
// scores are the event's log-probabilities, the medium factor sigma_s T /
// (cp pSuccess) (times dens(xt) in a field) adds its pathwise terms, a
// field's slots their Bernoulli scores and deferred medium terms, and with
// diff_grid the voxel scores and the value chains of T (forward or reversed
// march by the sign of I), of 1/pSuccess and of dens(xt) (a trilinear
// scatter) are scattered against wLtot at once. D.nee == 0 credits every
// emitter hit and takes no pLight, MISv2 or medium-NEE draw; D.physical
// multiplies credited emission by 1/cp. pLight takes K1's material-3
// cascade, and the phase may be isotropic, baked or traced in any field.
template <bool kGrads, int kField = kHomogeneous, bool kHG = false, bool kExt = false>
VPT_HD void diff_pixel(const DiffParams& D, const float* pv, const FieldParams& F, uint32_t lane,
                       int pixel, int seed, const float* gbar, float out[3], float* gout,
                       const uint32_t* tab = nullptr, float* gg = nullptr) {
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
  constexpr bool kAnalyticField = kField == kAnalytic;
  const int n_fp = kAnalyticField ? D.n_fp : 0;
  const int fp_kind = D.fp_kind;
  const int IG = 2 + 6 * S;
  const int IK = kHG ? field_slot0(D) : IG;
  const int hg_mode = kHG ? D.hg_mode : 0;
  const bool traced_g = kHG && hg_mode == kHgTraced;
  const float gph = traced_g ? pv[IG] : 0.0f;
  float inv_mr = 0.0f;
  if constexpr (kAnalyticField) inv_mr = 1.0f / (sigma_t * F.maj);
  constexpr int kFp = (kGrads && kAnalyticField) ? VPT_MAX_FP : 1;
  // vpt's two-phase replay (K3 with diff_grid)
  const bool two_phase = kGrads && kField == kGridField && gg != nullptr;
  // the estimator (kExt): equi-angular, NEE, the physical credit
  const bool ea = kExt && D.distance == kDistEa;
  const bool nee = !kExt || D.nee != 0;
  const bool physical = kExt && D.physical != 0;

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
  const V3 cam_o = mk(P.cam_o[0], P.cam_o[1], P.cam_o[2]);

  // K3's per-thread accumulators: the sigma_t / sigma_s-only terms, the
  // deferred (A, B) pairs, and the albedo / radiance slots of the packed
  // vector (gv, indexed by sphere id)
  float wt[3] = {0.0f, 0.0f, 0.0f};
  float g_st = 0.0f, g_ssx = 0.0f, A_st = 0.0f, B_st = 0.0f, A_ssx = 0.0f, B_ssx = 0.0f;
  // (gv[IK + f] the immediate field-parameter terms, A_fp / B_fp their
  // deferred event-score pairs; gv[IG] the traced g's immediate terms,
  // A_g / B_g its phase-draw scores)
  float A_g = 0.0f, B_g = 0.0f;
  float gv[kGrads ? VPT_MAX_PARAMS + (kHG ? 1 : 0) + (kAnalyticField ? VPT_MAX_FP : 0) : 1];
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
  // the two-phase replay's state: the phase (B: replaying), the PCG state
  // at the sample's start, the sample's weighted total; wl is the cotangent
  // this iteration's terms use (zero in phase A)
  bool phB = false;
  uint32_t rng_save = 0u;
  float wLtot = 0.0f;
  float wl[3] = {wt[0], wt[1], wt[2]};
  const int iters = two_phase ? 2 * P.max_iters : P.max_iters;

  for (int it = 0; it < iters && samples < P.spp; ++it) {
    if (two_phase) {
      if (!alive) {  // a sample starts: phase A saves its stream, B replays it
        if (phB)
          rng.s = rng_save;
        else
          rng_save = rng.s;
      }
      for (int i = 0; i < 3; ++i) wl[i] = phB ? wt[i] : 0.0f;
    }
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

    float d_s = 0.0f, tau_cap = 0.0f;
    bool surface;
    V3 xt;
    // equi-angular: the sample's distance along the ray, the optical path
    // per unit sigma to the surface (0 off any surface), Tr, its floored
    // complement and pSuccess
    float d_along = 0.0f, t_det0 = 0.0f, att_t = 0.0f, tr_act = 0.0f, one_m_tr = 1.0f,
          pdf_success = 1.0f;
    if (ea) {
      const V3 lo = sub3(lc, o);
      const float delta = dot3(lo, d);
      const float Dq = sqrtf(vmax(dot3(lo, lo) - delta * delta, 1e-12f));
      const float th_a = atan2_posx(-delta, Dq);
      const float th_b = atan2_posx(t_eff - delta, Dq);
      const float sample_t =
          vclip(Dq * tan_sc((1.0f - u_dist) * th_a + u_dist * th_b), -BIG, BIG);
      d_along = sample_t + delta;
      xt = ray_at(o, d_along, d);
      const float dist_pdf =
          Dq / (vmax(fabsf(th_b - th_a), 1e-12f) * (sample_t * sample_t + Dq * Dq));
      t_det0 = hit ? t : 0.0f;
      if (hit) {
        if constexpr (kField == kGridField)
          att_t = grid_tau(P.grid, tab, 1.0f, o, d, t_det0, true);
        else if constexpr (kAnalyticField)
          att_t = field_tau(F, 1.0f, o, d, t_det0);
        else
          att_t = t_det0;
        tr_act = expf(-sigma_t * att_t);
      }
      const float u_ev = rng.next();
      surface = u_ev <= tr_act && hit;
      one_m_tr = vmax(1.0f - tr_act, 1e-20f);
      pdf_success = vmax(dist_pdf * one_m_tr, 1e-30f);
    } else {
      if constexpr (kField == kGridField)
        d_s = grid_sample_free_and_tau(P.grid, tab, sigma_t, o, d, u_dist, t_eff, tau_cap);
      else if constexpr (kAnalyticField)
        d_s = field_sample_free(F, sigma_t, inv_mr, o, d, u_dist, rng, t_eff);
      else
        d_s = -log1pf(-u_dist) * inv_st;
      surface = d_s > t_eff && hit;
      if (kField) live = live && (d_s < 0.5f * BIG || surface);  // escaped: dies
      xt = ray_at(o, d_s, d);
    }
    bool medium = live && !surface;
    bool shade_pre = live && surface;
    // equi-angular on medium lanes: the signed optical path per unit sigma
    // to the sample (odd in the distance), its sign, T
    float I_along = 0.0f, att_along = 0.0f, sign_I = 1.0f, t_xt = 0.0f;
    if (ea && medium) {
      if constexpr (kField == kGridField)
        I_along = grid_tau(P.grid, tab, 1.0f, o, d, d_along, false);
      else if constexpr (kAnalyticField)
        I_along = field_tau(F, 1.0f, o, d, d_along);
      att_along = kField ? fabsf(I_along) : fabsf(d_along);
      sign_I = I_along >= 0.0f ? 1.0f : -1.0f;
      t_xt = expf(-sigma_t * att_along);
    }
    // a field's d(optical path)/dtheta to the surface (equi-angular)
    float dI_t0[kFp];
    if constexpr (kGrads && kAnalyticField) {
      if (ea && n_fp > 0) {
        if (hit && (shade_pre || medium))
          fp_dI(F, fp_kind, o, d, t_det0, dI_t0, kExt);
        else
          for (int f = 0; f < n_fp; ++f) dI_t0[f] = 0.0f;
      }
    }
    if constexpr (kGrads) {
      if (ea) {
        // Bernoulli(Tr): log Tr = -sigma_t att_t at the surface, log(1 - Tr)
        // in the medium; the equi-angular pdf is sigma-independent
        const float k_sc =
            shade_pre ? -att_t : ((medium && hit) ? att_t * tr_act / one_m_tr : 0.0f);
        const float wL0 = wl[0] * Lps[0] + wl[1] * Lps[1] + wl[2] * Lps[2];
        A_st = A_st + k_sc;
        B_st = B_st + k_sc * wL0;
        if constexpr (kField == kGridField) {
          if (two_phase && phB && (shade_pre || medium)) {
            // the voxel event scores: dlog Tr/dv = -sigma dI(t)/dv,
            // dlog(1 - Tr)/dv = sigma dI(t)/dv Tr/(1 - Tr); one march
            const float w_sc = wLtot - wL0;
            const float w_ev = shade_pre ? -sigma_t * w_sc
                                         : (hit ? sigma_t * w_sc * tr_act / one_m_tr : 0.0f);
            grid_march_scatter(P.grid, o, d, w_ev, t_det0, 0.0f, 0.0f, gg);
          }
        }
        if constexpr (kAnalyticField) {
          for (int f = 0; f < n_fp; ++f) {  // the field parameters' Bernoulli scores
            const float k_f =
                shade_pre ? -sigma_t * dI_t0[f]
                          : ((medium && hit) ? sigma_t * dI_t0[f] * tr_act / one_m_tr : 0.0f);
            A_fp[f] = A_fp[f] + k_f;
            B_fp[f] = B_fp[f] + k_f * wL0;
          }
        }
      }
    }
    if constexpr (kGrads) if (!ea) {
      // free-flight score vs the L-prefix before this bounce
      float k_sc;
      if constexpr (kField == kGridField) {
        // p(d) = sigma_t rho_pc(d) e^{-sigma_t I(d)}, rho_pc independent of
        // sigma: both optical paths come from the sampling march
        const float I_surf = tau_cap * inv_st;
        const float I_med = -log1pf(-u_dist) * inv_st;
        k_sc = shade_pre ? -I_surf : (medium ? inv_st - I_med : 0.0f);
      } else if constexpr (kAnalyticField) {
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
      float wL0 = wl[0] * Lps[0] + wl[1] * Lps[1] + wl[2] * Lps[2];
      A_st = A_st + k_sc;
      B_st = B_st + k_sc * wL0;
      if constexpr (kField == kGridField) {
        if (two_phase && phB && (shade_pre || medium)) {
          // the voxel event scores, at once (phase B knows wLtot): dlog
          // P(surface)/dv = -sigma dI(t)/dv, dlog p(d)/dv = dlog
          // rho_pc(d)/dv - sigma dI(d)/dv
          const float w_sc = wLtot - wL0;
          const float t_detg = shade_pre ? t_eff : 0.0f;
          const float d_detg = (medium && d_s < 0.5f * BIG) ? d_s : 0.0f;
          grid_march_scatter(P.grid, o, d, shade_pre ? -sigma_t * w_sc : 0.0f, t_detg,
                             medium ? -sigma_t * w_sc : 0.0f, d_detg, gg);
          if (medium) {
            V3 x_pc;
            const float rho_pc = grid_pc_point(P.grid, tab, o, d, d_detg, x_pc);
            grid_scatter_point(P.grid, x_pc, w_sc / vmax(rho_pc, 1e-30f), gg);
          }
        }
      }
      if constexpr (kAnalyticField) {
        if (n_fp > 0) {
          // field-parameter event scores: dlog dens(x_d)/dtheta - sigma
          // dI(d)/dtheta (medium), -sigma dI(t)/dtheta (surface)
          float dI[kFp], dld[kFp];
          if (shade_pre) fp_dI(F, fp_kind, o, d, t_eff, dI, kExt);
          if (medium) {
            fp_dI(F, fp_kind, o, d, d_s, dI, kExt);
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
    // NEE credits the camera ray's emitter hits only, the implicit
    // estimator every one
    if (live && em_hit && (!nee || depth == 0)) {
      for (int i = 0; i < 3; ++i) {
        float add = at.rad[i] * tp[i];
        if (physical) add = add * inv_cp;  // compensate this iteration's RR
        L[i] = L[i] + add;
        Lps[i] = Lps[i] + add;
        if constexpr (kGrads) {
          float gw = wl[i] * tp[i];
          if (physical) gw = gw * inv_cp;
          gv[rad0 + 3 * sid + i] = gv[rad0 + 3 * sid + i] + gw;
        }
      }
    }
    bool shade = live && surface && !em_hit;

    if (nee && shade) {  // surface NEE: pLight + MISv2
      float dist_l;
      V3 dl;
      float le_scale;
      if constexpr (kExt)  // with K1's material-3 cascade
        le_scale = plight_le_scale_vol(P, lc, xs, dist_l, dl);
      else
        le_scale = plight_le_scale(P, lc, xs, dist_l, dl);
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
      if constexpr (kField != kHomogeneous) {
        float inv_dl = 1.0f / vmax(dist_l, 1e-20f);
        wlight = scale3(sub3(lc, xs), inv_dl);
        if constexpr (kField == kGridField)
          att_pl = grid_tau(P.grid, tab, 1.0f, xs, wlight, dist_l, true);
        else
          att_pl = field_tau(F, 1.0f, xs, wlight, dist_l);
      }
      float trs = expf(-sigma_t * att_pl);
      float ldm[3], dsig[3], dalb[3], dle[3];
      float drad[kGrads ? VPT_MAX_SPHERES : 1][3];
      float dk[kFp][3];
      int sid2;
      float wtp[3];
      for (int i = 0; i < 3; ++i) wtp[i] = wl[i] * tp[i] * inv_cp;
      diff_mis_v2<kGrads, kField, kExt>(P, pv, F, fp_kind, n_fp, sigma_t, rng, at, xs, nrm, d, ldm,
                                  dsig, dalb, dle, drad, dk, sid2, tab,
                                  two_phase ? gg : nullptr, wtp);
      for (int i = 0; i < 3; ++i) {
        float add = (ldp[i] * trs * inv_ps + ldm[i]) * tp[i] * inv_cp;
        L[i] = L[i] + add;
        Lps[i] = Lps[i] + add;
      }
      if constexpr (kGrads) {
        float gs = 0.0f;
        for (int i = 0; i < 3; ++i)
          gs = gs + wl[i] * (ldp[i] * trs * (-att_pl) * inv_ps + dsig[i]) * tp[i] * inv_cp;
        g_st = g_st + gs;
        if constexpr (kField == kGridField) {
          if (two_phase) {  // pLight's transmittance: -sigma_t dI/dv times its value
            float gpl = 0.0f;
            for (int i = 0; i < 3; ++i) gpl = gpl + wl[i] * ldp[i] * trs * inv_ps * tp[i] * inv_cp;
            grid_march_scatter(P.grid, xs, wlight, -sigma_t * (gpl + 0.0f), dist_l, 0.0f, 0.0f,
                               gg);
          }
        }
        if constexpr (kAnalyticField) {
          if (n_fp > 0) {  // pLight's and the MIS light strategy's d(tr)/dtheta
            float dI_pl[kFp];
            fp_dI(F, fp_kind, xs, wlight, dist_l, dI_pl, kExt);
            for (int f = 0; f < n_fp; ++f) {
              float gk = 0.0f;
              for (int i = 0; i < 3; ++i)
                gk = gk + wl[i] * (ldp[i] * trs * (-sigma_t * dI_pl[f]) * inv_ps + dk[f][i]) *
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
            float g = lid == e ? wl[i] * coef[i] * trs * inv_ps * tp[i] * inv_cp : 0.0f;
            if (is_mis) g = g + wl[i] * drad[e][i] * tp[i] * inv_cp;
            g = g + (sid2 == e ? wl[i] * dle[i] * tp[i] * inv_cp : 0.0f);
            gv[rad0 + 3 * e + i] = gv[rad0 + 3 * e + i] + g;
          }
        }
        if ((D.alb_mask >> sid) & 1) {  // albedo of the shaded sphere
          for (int i = 0; i < 3; ++i) {
            float lam = !at.is_mic ? lrad[i] * le_scale * cosw * INV_PI : 0.0f;
            gv[2 + 3 * sid + i] =
                gv[2 + 3 * sid + i] + wl[i] * (lam * trs * inv_ps + dalb[i]) * tp[i] * inv_cp;
          }
        }
      }
    } else if (nee) {
      rng.skip(mis_draws);
    }
    float b1 = rng.next(), b2 = rng.next(), b3 = rng.next();  // sample_bsdf
    float u_p1 = rng.next(), u_p2 = rng.next();               // phase
    float m1 = 0.0f, m2 = 0.0f;                               // medium NEE cone
    if (nee) {
      m1 = rng.next();
      m2 = rng.next();
    }

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
            float kk = wl[i] * inv_a;
            A_alb[sid][i] = A_alb[sid][i] + kk;
            B_alb[sid][i] = B_alb[sid][i] + kk * Lps[i];
          }
        }
      }
    } else if (medium) {
      // the medium factor and d(its log)/dsigma_t: free flight's (sigma_s /
      // sigma_t) / cp, or equi-angular's sigma_s(xt) T / (cp pSuccess)
      float med_scale = ar_cp, med_dsig_m = med_dsig, dens_xt = 1.0f;
      if (ea) {
        med_scale = ss * t_xt * inv_cp / pdf_success;
        if constexpr (kField == kGridField) {  // sigma_s(xt), trilinear
          dens_xt = grid_density(P.grid, tab, xt);
          med_scale = med_scale * dens_xt;
        } else if constexpr (kAnalyticField) {
          dens_xt = field_density(F, xt);
          med_scale = med_scale * dens_xt;
        }
        med_dsig_m = -att_along - att_t * tr_act / one_m_tr;
      }
      float wL1 = 0.0f, gx = 0.0f;
      if (nee) {
        float ld_med[3], w_med, att_nee, t_nee, dlogp_nee;
        V3 wl_nee;
        diff_medium_nee<kField, kHG, kExt>(P, F, sigma_t, hg_mode, gph, d, xt, lc, lrad, lr, lid,
                                           m1, m2, ld_med, w_med, att_nee, wl_nee, t_nee,
                                           dlogp_nee, tab);
        float adds[3];
        for (int i = 0; i < 3; ++i) {
          adds[i] = ld_med[i] * inv_ps * tp[i] * med_scale;
          L[i] = L[i] + adds[i];
          Lps[i] = Lps[i] + adds[i];
        }
        if constexpr (kGrads) {
          float gs = 0.0f;
          for (int i = 0; i < 3; ++i) {
            gs = gs + wl[i] * adds[i] * (-att_nee + med_dsig_m);
            gx = gx + wl[i] * adds[i];
          }
          g_st = g_st + gs;
          g_ssx = g_ssx + gx * inv_ss;
          if constexpr (kField == kGridField)  // medium NEE's transmittance
            if (two_phase)
              grid_march_scatter(P.grid, xt, wl_nee, -sigma_t * (0.0f + gx), t_nee, 0.0f, 0.0f,
                                 gg);
          if constexpr (kAnalyticField) {
            if (n_fp > 0) {  // the medium-NEE transmittance's d/dtheta
              float dI_nee[kFp];
              fp_dI(F, fp_kind, xt, wl_nee, t_nee, dI_nee, kExt);
              for (int f = 0; f < n_fp; ++f)
                gv[IK + f] = gv[IK + f] + gx * (-sigma_t * dI_nee[f]);
            }
          }
          if (traced_g) gv[IG] = gv[IG] + gx * dlogp_nee;  // the NEE phase value
          if (lid >= 0)
            for (int i = 0; i < 3; ++i)
              gv[rad0 + 3 * lid + i] =
                  gv[rad0 + 3 * lid + i] + wl[i] * w_med * inv_ps * tp[i] * med_scale;
        }
      }
      if constexpr (kGrads) {
        // deferred medium-factor terms vs the L-prefix after this bounce
        wL1 = wl[0] * Lps[0] + wl[1] * Lps[1] + wl[2] * Lps[2];
        A_st = A_st + med_dsig_m;
        B_st = B_st + med_dsig_m * wL1;
        A_ssx = A_ssx + inv_ss;
        B_ssx = B_ssx + inv_ss * wL1;
        if constexpr (kAnalyticField) {
          if (ea && n_fp > 0) {
            // equi-angular: T = e^{-sigma |I|} (dlog = -sigma sign(I)
            // dI(d_along)), the 1/pSuccess chain and sigma_s(xt)'s dlog dens
            float dI_al[kFp], dld[kFp];
            fp_dI(F, fp_kind, o, d, d_along, dI_al, kExt);
            fp_dlogdens(F, fp_kind, xt, dld);
            for (int f = 0; f < n_fp; ++f) {
              const float k_f = -sigma_t * sign_I * dI_al[f] -
                                sigma_t * dI_t0[f] * tr_act / one_m_tr + dld[f];
              A_fp[f] = A_fp[f] + k_f;
              B_fp[f] = B_fp[f] + k_f * wL1;
            }
          }
        }
        if constexpr (kField == kGridField) {
          if (ea && two_phase && phB) {
            // the medium factor's voxel chains (vpt/kernels/diff.py:1050-
            // 1086): it weights this bounce's NEE (gx) and every later
            // emission (wLtot - wL1), scattered at once. T marches the
            // forward ray for I >= 0, the reversed one for samples behind
            // the origin; 1/pSuccess rides the forward march; dens(xt) is a
            // trilinear appearance scatter whatever the transport
            const float adjv = (nee ? gx : 0.0f) + wLtot - wL1;
            const float w_pos = I_along >= 0.0f ? -sigma_t * adjv : 0.0f;
            const float w_neg = I_along < 0.0f ? -sigma_t * adjv : 0.0f;
            const float w_ps = -sigma_t * adjv * tr_act / one_m_tr;
            grid_march_scatter(P.grid, o, d, w_pos, vmax(d_along, 0.0f), w_ps, t_det0, gg);
            grid_march_scatter(P.grid, o, neg3(d), w_neg, vmax(-d_along, 0.0f), 0.0f, 0.0f, gg);
            grid_scatter_point(P.grid, xt, adjv / vmax(dens_xt, 1e-30f), gg, true);
          }
        }
      }
      for (int i = 0; i < 3; ++i) tp[i] = tp[i] * med_scale;
      o = xt;
      if constexpr (kHG) {  // the scatter direction at the baked or traced g
        V3 wi_m = traced_g                          ? hg_dir_traced(d, gph, u_p1, u_p2)
                  : (!kExt || hg_mode == kHgBaked) ? hg_dir(P, d, u_p1, u_p2)
                                                    : uniform_sphere(u_p1, u_p2);
        if (kGrads && traced_g) {
          // the phase draw's score reweights later contributions only
          float k_g = dlog_hg_dg(dot3(d, wi_m), gph);
          A_g = A_g + k_g;
          B_g = B_g + k_g * wL1;
        }
        d = wi_m;
      } else {
        d = uniform_sphere(u_p1, u_p2);
      }
    }
    alive = (shade || medium) && depth + 1 < P.max_bounces;
    if (alive) {
      depth = depth + 1;
    } else {
      if (!two_phase) {
        samples = samples + 1;  // the path that started this sample ended
      } else if (!phB) {
        // phase A ends: the sample's weighted total with the raw cotangent,
        // then its replay
        wLtot = wt[0] * Lps[0] + wt[1] * Lps[1] + wt[2] * Lps[2];
        phB = true;
      } else {
        phB = false;
        samples = samples + 1;
      }
      if constexpr (kGrads) {
        // fold the deferred pairs: A * L_total - B at path death
        float WL = wl[0] * Lps[0] + wl[1] * Lps[1] + wl[2] * Lps[2];
        g_st = g_st + (A_st * WL - B_st);
        g_ssx = g_ssx + (A_ssx * WL - B_ssx);
        A_st = B_st = A_ssx = B_ssx = 0.0f;
        if (traced_g) {
          gv[IG] = gv[IG] + (A_g * WL - B_g);
          A_g = B_g = 0.0f;
        }
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
    if (traced_g) gv[IG] = gv[IG] + A_g * wt_sum - B_g;
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
