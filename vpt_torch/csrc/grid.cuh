// Voxel-grid density fields in device code: the thread-scalar transcription
// of vpt/kernels/prims.py:630-890 and :1090-1207 (the grid lookups, vpt's
// canonical piecewise-constant transport model and the voxel scatter) for
// the grid instantiations of K1, K2 and K3. Included by csrc/path.cuh after
// field.cuh; __host__ __device__ like the rest, so the test build compiles
// it with g++ too.
//
// The table is vpt's grid_table: word j holds bf16(g[j]) in its high 16 bits
// and bf16(g[j + 1]) in its low 16, so one load gives a cell's two z-corners
// (a bf16 pattern in the top half of an f32 is that value). It is a plain
// global load through the read-only cache: a 16^3 grid is 16 KB and stays in
// L1/L2.
//
// The transport model (grid_window): a constant head on [0, t0] before the
// slab entry, M1 midpoint segments over [t0, ta] (the box crossing), M2 over
// [ta, tb] (the boundary slide to the railing distance), a constant tail past
// tb. The optical depth, the free-flight inversion, the model's sample
// density and every transmittance come from the same segments, summed in
// vpt's order (segment i = 0, 1, ...), with vpt's float64 folds of
// 1/spacing, 1/M1 and 1/M2 (GridParams).
//
// The scatter (K3 with diff_grid): w times the derivative of the
// interpolant at x with respect to each voxel it reads, added with
// atomicAdd into a float buffer of the grid's size (in shared memory or
// global memory, csrc/diff_kernel.cuh); on the host a plain add. The
// atomics flush subnormal sums to zero (PTX atom.add.f32).
#pragma once

namespace vpt {

VPT_HD uint32_t grid_word(const uint32_t* tab, int idx) {
#ifdef __CUDA_ARCH__
  return __ldg(tab + idx);
#else
  return tab[idx];
#endif
}

VPT_HD float word_hi(uint32_t w) { return bits_to_float(w & 0xFFFF0000u); }
VPT_HD float word_lo(uint32_t w) { return bits_to_float(w << 16); }

// the lattice coordinate of x along an axis, clamped to [0, n - 1]
VPT_HD float grid_coord(const GridParams& G, float x, int i) {
  return vclip((x - G.org[i]) * G.inv_sp[i] - 0.5f, 0.0f, (float)(G.n[i] - 1));
}

// truncation of a coordinate in [0, n - 1] (vpt's astype(int32)), at most
// hi; a NaN coordinate lands on cell 0
VPT_HD int grid_trunc(float u, int hi) {
  int i = u > 0.0f ? (int)u : 0;
  return i < hi ? i : hi;
}

// the clamped trilinear cell of x: base flat index and fractions
VPT_HD int grid_cell(const GridParams& G, V3 x, float& fx, float& fy, float& fz) {
  const float ux = grid_coord(G, x.x, 0), uy = grid_coord(G, x.y, 1),
              uz = grid_coord(G, x.z, 2);
  const int ix = grid_trunc(ux, G.n[0] - 2), iy = grid_trunc(uy, G.n[1] - 2),
            iz = grid_trunc(uz, G.n[2] - 2);
  fx = vclip(ux - (float)ix, 0.0f, 1.0f);
  fy = vclip(uy - (float)iy, 0.0f, 1.0f);
  fz = vclip(uz - (float)iz, 0.0f, 1.0f);
  return (ix * G.n[1] + iy) * G.n[2] + iz;
}

// the xy-nearest / z-linear cell of x: base flat index and fz
VPT_HD int grid_cell_nearest(const GridParams& G, V3 x, float& fz) {
  const float ux = grid_coord(G, x.x, 0), uy = grid_coord(G, x.y, 1),
              uz = grid_coord(G, x.z, 2);
  const int rx = grid_trunc(ux + 0.5f, G.n[0] - 1), ry = grid_trunc(uy + 0.5f, G.n[1] - 1),
            iz = grid_trunc(uz, G.n[2] - 2);
  fz = vclip(uz - (float)iz, 0.0f, 1.0f);
  return (rx * G.n[1] + ry) * G.n[2] + iz;
}

// trilinear clamp-to-edge density, four z-pair words (the appearance
// density, and the transport density under "tri")
VPT_HD float grid_density(const GridParams& G, const uint32_t* tab, V3 x) {
  float fx, fy, fz;
  const int base = grid_cell(G, x, fx, fy, fz);
  const int nz = G.n[2], snx = G.n[1] * nz;
  const uint32_t w00 = grid_word(tab, base), w01 = grid_word(tab, base + nz),
                 w10 = grid_word(tab, base + snx), w11 = grid_word(tab, base + snx + nz);
  const float c000 = word_hi(w00), c001 = word_lo(w00);
  const float c010 = word_hi(w01), c011 = word_lo(w01);
  const float c100 = word_hi(w10), c101 = word_lo(w10);
  const float c110 = word_hi(w11), c111 = word_lo(w11);
  const float c00 = c000 + (c001 - c000) * fz;
  const float c01 = c010 + (c011 - c010) * fz;
  const float c10 = c100 + (c101 - c100) * fz;
  const float c11 = c110 + (c111 - c110) * fz;
  const float c0 = c00 + (c01 - c00) * fy;
  const float c1 = c10 + (c11 - c10) * fy;
  return c0 + (c1 - c0) * fx;
}

VPT_HD float grid_density_nearest(const GridParams& G, const uint32_t* tab, V3 x) {
  float fz;
  const uint32_t w = grid_word(tab, grid_cell_nearest(G, x, fz));
  const float c0 = word_hi(w), c1 = word_lo(w);
  return c0 + (c1 - c0) * fz;
}

// a density of the transport model: the grid's transport interpolant
VPT_HD float grid_pc_eval(const GridParams& G, const uint32_t* tab, V3 x) {
  return G.nearest ? grid_density_nearest(G, tab, x) : grid_density(G, tab, x);
}

// (t0, ta, tb) of the ray's model
VPT_HD void grid_window(const GridParams& G, V3 o, V3 d, float& t0, float& ta, float& tb) {
  const float oo[3] = {o.x, o.y, o.z}, dd[3] = {d.x, d.y, d.z};
  float t_rail = 0.0f, t_enter = -BIG, t_exit = BIG;
  for (int i = 0; i < 3; ++i) {
    const float di = dd[i], oi = oo[i], lo_r = G.lo[i], hi_r = G.hi[i];
    const bool moving = fabsf(di) > 1e-12f;
    const float inv = 1.0f / (moving ? di : 1.0f);
    const float rail = di > 0.0f ? hi_r : lo_r;
    t_rail = vmax(t_rail, moving ? (rail - oi) * inv : 0.0f);
    const float a = (lo_r - oi) * inv, b = (hi_r - oi) * inv;
    const bool inside = oi >= lo_r && oi <= hi_r;
    const float nr = moving ? vmin(a, b) : (inside ? -BIG : BIG);
    const float fr = moving ? vmax(a, b) : (inside ? BIG : -BIG);
    t_enter = vmax(t_enter, nr);
    t_exit = vmin(t_exit, fr);
  }
  const bool box_hit = t_enter <= t_exit && t_exit > 0.0f;
  t0 = box_hit ? vmax(t_enter, 0.0f) : 0.0f;
  const float a = box_hit ? vmin(vmin(t_exit, t_rail), t0 + G.cap) : vmin(t_rail, G.cap) * 0.75f;
  ta = vmax(a, t0 + 1e-6f);
  tb = vmax(vmin(t_rail, ta + G.cap), ta + 1e-6f);
}

// segment i of the model: its start, returning its width
VPT_HD float grid_seg(const GridParams& G, int i, float t0, float ta, float h1, float h2,
                      float& seg0) {
  if (i < G.m1) {
    seg0 = t0 + (float)i * h1;
    return h1;
  }
  seg0 = ta + (float)(i - G.m1) * h2;
  return h2;
}

// the model's optical depth for t >= 0
VPT_HD float grid_tau_nonneg(const GridParams& G, const uint32_t* tab, float sigma_t, V3 o, V3 d,
                             float t) {
  float t0, ta, tb;
  grid_window(G, o, d, t0, ta, tb);
  const float h1 = (ta - t0) * G.inv_m1, h2 = (tb - ta) * G.inv_m2;
  float acc = 0.0f;
  for (int i = 0; i < G.n_march; ++i) {
    float seg0;
    const float w = grid_seg(G, i, t0, ta, h1, h2, seg0);
    const float rho = grid_pc_eval(G, tab, ray_at(o, seg0 + 0.5f * w, d));
    acc = acc + rho * vclip(t - seg0, 0.0f, w);
  }
  const float rho_head = grid_pc_eval(G, tab, ray_at(o, 0.5f * t0, d));
  const float d_inf = grid_pc_eval(G, tab, ray_at(o, tb + h2, d));
  return sigma_t * (rho_head * vmin(t, t0) + acc + d_inf * vmax(t - tb, 0.0f));
}

// the signed model optical depth: tau(t < 0) = -tau_reverse(-t) (equi-angular
// samples behind the origin); nonneg (every t >= 0) skips the reverse march
VPT_HD float grid_tau(const GridParams& G, const uint32_t* tab, float sigma_t, V3 o, V3 d,
                      float t, bool nonneg) {
  if (nonneg || t >= 0.0f) return grid_tau_nonneg(G, tab, sigma_t, o, d, vmax(t, 0.0f));
  return -grid_tau_nonneg(G, tab, sigma_t, o, neg3(d), vmax(-t, 0.0f));
}

// One march: the free-flight distance (the exact inversion of the model's
// tau at -log1p(-u); BIG when the flight escapes) and tau(t_cap)
VPT_HD float grid_sample_free_and_tau(const GridParams& G, const uint32_t* tab, float sigma_t,
                                      V3 o, V3 d, float u, float t_cap, float& tau_at_cap) {
  float t0, ta, tb;
  grid_window(G, o, d, t0, ta, tb);
  const float h1 = (ta - t0) * G.inv_m1, h2 = (tb - ta) * G.inv_m2;
  const float tau_star = -log1pf(-u);
  const float rho_head = grid_pc_eval(G, tab, ray_at(o, 0.5f * t0, d));
  const float tau_head = sigma_t * rho_head * t0;
  float cum = tau_head, tau_cap = 0.0f, d_found = -1.0f;
  for (int i = 0; i < G.n_march; ++i) {
    float seg0;
    const float w = grid_seg(G, i, t0, ta, h1, h2, seg0);
    const float rho = grid_pc_eval(G, tab, ray_at(o, seg0 + 0.5f * w, d));
    const float dtau = sigma_t * rho * w;
    tau_cap = tau_cap + rho * vclip(t_cap - seg0, 0.0f, w);
    if (d_found < 0.0f && cum + dtau > tau_star)
      d_found = seg0 + (tau_star - cum) / vmax(sigma_t * rho, 1e-30f);
    cum = cum + dtau;
  }
  const bool in_head = tau_star < tau_head;
  const float d_head = vmin(tau_star / vmax(sigma_t * rho_head, 1e-30f), t0);
  const float d_inf = grid_pc_eval(G, tab, ray_at(o, tb + h2, d));
  const float rate = sigma_t * d_inf;
  const float d_tail = tb + (tau_star - cum) / vmax(rate, 1e-30f);
  const float d_nf = rate > 1e-20f ? vmin(d_tail, BIG) : BIG;
  tau_at_cap = sigma_t * (rho_head * vmin(t_cap, t0) + tau_cap + d_inf * vmax(t_cap - tb, 0.0f));
  return in_head ? d_head : (d_found >= 0.0f ? d_found : d_nf);
}

// the model's sample point at ray parameter t >= 0 (x) and its density
VPT_HD float grid_pc_point(const GridParams& G, const uint32_t* tab, V3 o, V3 d, float t, V3& x) {
  float t0, ta, tb;
  grid_window(G, o, d, t0, ta, tb);
  const float h1 = (ta - t0) * G.inv_m1, h2 = (tb - ta) * G.inv_m2;
  const float kA = vclip(floorf((t - t0) / h1), 0.0f, (float)(G.m1 - 1));
  const float kB = vclip(floorf((t - ta) / h2), 0.0f, (float)(G.n_march - G.m1 - 1));
  const float t_mid = t < ta ? t0 + (kA + 0.5f) * h1 : ta + (kB + 0.5f) * h2;
  const float t_s = t < t0 ? 0.5f * t0 : (t > tb ? tb + h2 : t_mid);
  x = ray_at(o, t_s, d);
  return grid_pc_eval(G, tab, x);
}

// ---- the voxel scatter (K3 with diff_grid) -------------------------------

VPT_HD void grid_add(float* g, int idx, float v) {
#ifdef __CUDA_ARCH__
  atomicAdd(g + idx, v);
#else
  g[idx] += v;
#endif
}

// g += w d(interp(x))/d(voxels), interp the grid's transport interpolant
VPT_HD void grid_scatter_point(const GridParams& G, V3 x, float w, float* g) {
  if (w == 0.0f) return;
  const int nz = G.n[2], snx = G.n[1] * nz;
  if (G.nearest) {
    float fz;
    const int base = grid_cell_nearest(G, x, fz);
    grid_add(g, base, w * (1.0f - fz));
    grid_add(g, base + 1, w * fz);
    return;
  }
  float fx, fy, fz;
  const int base = grid_cell(G, x, fx, fy, fz);
  for (int a = 0; a < 2; ++a) {
    const float wa = a ? fx : 1.0f - fx;
    for (int b = 0; b < 2; ++b) {
      const float wb = b ? fy : 1.0f - fy;
      for (int c = 0; c < 2; ++c) {
        const float wc = c ? fz : 1.0f - fz;
        grid_add(g, base + a * snx + b * nz + c, w * wa * wb * wc);
      }
    }
  }
}

// g += d/dv of (wA I(tA) + wB I(tB)), I the model's optical path per unit
// sigma along (o, d): each segment's overlap at its midpoint, the head, the
// tail
VPT_HD void grid_march_scatter(const GridParams& G, V3 o, V3 d, float wA, float tA, float wB,
                               float tB, float* g) {
  if (wA == 0.0f && wB == 0.0f) return;
  float t0, ta, tb;
  grid_window(G, o, d, t0, ta, tb);
  const float h1 = (ta - t0) * G.inv_m1, h2 = (tb - ta) * G.inv_m2;
  for (int i = 0; i < G.n_march; ++i) {
    float seg0;
    const float w = grid_seg(G, i, t0, ta, h1, h2, seg0);
    const float cm = wA * vclip(tA - seg0, 0.0f, w) + wB * vclip(tB - seg0, 0.0f, w);
    grid_scatter_point(G, ray_at(o, seg0 + 0.5f * w, d), cm, g);
  }
  grid_scatter_point(G, ray_at(o, 0.5f * t0, d), wA * vmin(tA, t0) + wB * vmin(tB, t0), g);
  grid_scatter_point(G, ray_at(o, tb + h2, d),
                     wA * vmax(tA - tb, 0.0f) + wB * vmax(tB - tb, 0.0f), g);
}

}  // namespace vpt
