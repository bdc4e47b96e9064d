"""Plain torch versions of the per-path primitives of the render kernel.

Counterpart of ``vpt/kernels/prims.py``, restricted to what the forward
render uses (both distance families, the baked HG g, the material-3 pLight
cascade and the analytic density fields) and the differentiable pair's
field derivatives. Every function works on
lane tensors of any shape in lockstep, with the same masked selects and the
same f32 operation order as vpt, so that at one seed it gives the same
draws and (up to 1-ulp differences of the transcendentals) the same values.
The CUDA kernel's per-path code (csrc/path.cuh) is the thread-scalar
transcription of the same functions.

Vectors are lists of three lane tensors. Scene-dependent helpers take `ps`,
the packed scene from kernels/wavefront.pack_scene: python floats already
rounded to f32, including the constants vpt folds in float64 at build time
(r*r and the intersection epsilon per sphere, the HG constants).

PCG runs in int64 masked to 32 bits: vpt's int32 arithmetic wraps and
shifts logically, and `>>` on a torch int32 tensor is an arithmetic shift.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

BIG = 1e8
EPS_T = 1e-4
F32EPS = float(np.finfo(np.float32).eps)
INV_4PI = 1.0 / (4.0 * math.pi)
INV_PI = 1.0 / math.pi
TWO_PI = 2.0 * math.pi
GLASS_ETA_I, GLASS_ETA_T = 1.0, 1.5

# R5 Kronecker sequence (vpt/kernels/prims.py LD_ALPHA): pixel u, pixel v,
# depth-0 distance, depth-0 RR, depth-0 light pick
LD_ALPHA = (0.8812714616335696, 0.7766393890897682, 0.6844301295853426,
            0.6031687406857282, 0.5315553977157913)

_M32 = 0xFFFFFFFF
_PCG_MUL = 747796405
_PCG_INC = 2891336453          # -1403630843 as uint32


def f32(x: float) -> float:
    """Round a python float to the nearest f32 value."""
    return float(np.float32(x))


class Pcg:
    """Per-lane PCG-RXS-M-XS-32 stream (vpt/kernels/prims.py Pcg): uint32
    state held in int64, uniform in [0, 1) from a mantissa bitcast."""

    def __init__(self, state: torch.Tensor):
        self.s = state

    def __call__(self) -> torch.Tensor:
        s = (self.s * _PCG_MUL + _PCG_INC) & _M32
        self.s = s
        w = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & _M32
        x = (w >> 22) ^ w
        mant = (x >> 9) | 0x3F800000
        return mant.to(torch.int32).view(torch.float32) - 1.0


def pcg_seed(lane: torch.Tensor, seed) -> torch.Tensor:
    """Per-lane initial PCG state: hash(global seed, lane id) + one warmup
    step. `lane` is an integer tensor, `seed` an int or integer tensor."""
    lane = lane.to(torch.int64) & _M32
    if isinstance(seed, torch.Tensor):
        seed = seed.to(torch.int64)
    s = ((lane * 2654435769) & _M32) ^ ((seed * 2246822507 + 1) & _M32)
    return (s * _PCG_MUL + _PCG_INC) & _M32


def ld_offsets(lane: torch.Tensor, seed):
    """Per-pixel Cranley-Patterson rotation offsets (5 uniforms) from a PCG
    stream decorrelated from the path stream."""
    rng_off = Pcg(pcg_seed(lane.to(torch.int64) ^ 0x2545F491,
                           seed + _PCG_MUL))
    return rng_off(), rng_off(), rng_off(), rng_off(), rng_off()


def ld_strat(a: float, off, s_f):
    """Stratified uniform: frac(a * sample_index + offset)."""
    x = f32(a) * s_f + off
    return x - torch.floor(x)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(a):
    return torch.sqrt(torch.clamp_min(dot3(a, a), 1e-20))


def normalize3(a):
    inv = torch.rsqrt(torch.clamp_min(dot3(a, a), 1e-20))
    return [a[0] * inv, a[1] * inv, a[2] * inv]


def sel3(m, a, b):
    return [torch.where(m, a[i], b[i]) for i in range(3)]


def scale3(a, k):
    return [a[0] * k, a[1] * k, a[2] * k]


def add3(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def onb(n):
    """Branch-free coordinateSystem (mathUtilities.h:10-19)."""
    cond = torch.abs(n[0]) > torch.abs(n[1])
    inv_a = torch.rsqrt(torch.clamp_min(n[0] * n[0] + n[2] * n[2], 1e-20))
    inv_b = torch.rsqrt(torch.clamp_min(n[1] * n[1] + n[2] * n[2], 1e-20))
    z = torch.zeros_like(n[0])
    t = [torch.where(cond, n[2] * inv_a, z),
         torch.where(cond, z, n[2] * inv_b),
         torch.where(cond, -n[0] * inv_a, -n[1] * inv_b)]
    s = [t[1] * n[2] - t[2] * n[1],
         t[2] * n[0] - t[0] * n[2],
         t[0] * n[1] - t[1] * n[0]]
    return s, t


def to_local(n, w):
    s, t = onb(n)
    return normalize3([dot3(w, s), dot3(w, t), dot3(w, n)])


def from_local(n, w):
    s, t = onb(n)
    return [s[i] * w[0] + t[i] * w[1] + n[i] * w[2] for i in range(3)]


# --- scene intersection over the packed scene ------------------------------

def sphere_first_t(ps, o, d, s):
    """Per-sphere nearest-root t with the reference's rescue rule
    (Sphere.h:27-37), stable quadratic."""
    ctr = ps.c[s]
    r2 = ps.r2[s]
    oc = [o[0] - ctr[0], o[1] - ctr[1], o[2] - ctr[2]]
    b = dot3(oc, d)
    c0 = dot3(oc, oc) - r2
    disc = r2 - (dot3(oc, oc) - b * b)
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0)) * pos.to(torch.float32)
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    qq = -(b + sgn * sq)
    other = c0 / torch.where(qq != 0.0, qq, 1.0)
    t1 = torch.minimum(qq, other)
    t2 = torch.maximum(qq, other)
    eps = ps.eps[s]
    t = torch.where((t1 < 0.0) | (torch.abs(t1) < eps), t2, t1)
    valid = pos & (t > 0.0) & (torch.abs(t) > eps)
    return t, valid


def nearest_id_t(ps, o, d, skip=()):
    """Light trace: nearest id + t (0 on a miss). `skip` is a tuple of
    sphere ids left out of the scan (intersectVPT skips material 3,
    volumetricBasicFunctions.h:64-89)."""
    t_min = torch.full_like(o[0], math.inf)
    sid = torch.full(o[0].shape, -1, dtype=torch.int64, device=o[0].device)
    for s in range(ps.S):
        if s in skip:
            continue
        t, valid = sphere_first_t(ps, o, d, s)
        closer = valid & (t < t_min)
        t_min = torch.where(closer, t, t_min)
        sid = torch.where(closer, s, sid)
    hit = sid >= 0
    return hit, torch.where(hit, t_min, 0.0), sid


def per_sphere(tab, sid):
    """Rows of an (S, k) tensor by sphere id, zeros where sid == -1."""
    ext = torch.cat([tab, tab.new_zeros((1,) + tuple(tab.shape[1:]))])
    return ext[torch.where(sid >= 0, sid, tab.shape[0])]


def attrs(ps, sid, alb=None, rad=None):
    """Per-lane sphere attributes by id, zeros where sid == -1 (a miss) —
    the values vpt's chained nearest-select leaves behind. `alb`/`rad`,
    (S, 3) tensors, replace the packed albedo and radiance (vpt's
    ``nearest(sc, o, d, alb, rad)`` with traced tables); the emitter flag
    stays the scene's, as in vpt."""
    tab = ps.attr_table(sid.device)
    row = tab[torch.where(sid >= 0, sid, ps.S)]
    at = {k: row[:, i].reshape(sid.shape) for i, k in enumerate(ps.ATTR_KEYS)}
    for keys, table in ((("ar", "ag", "ab"), alb), (("rr", "rg", "rb"), rad)):
        if table is not None:
            rows = per_sphere(table, sid)
            for i, k in enumerate(keys):
                at[k] = rows[..., i]
    at["is_em"] = at.pop("em_f") > 0.5
    at["is_mic"] = at.pop("mic_f") > 0.5
    at["is_die"] = at.pop("die_f") > 0.5
    at["sid"] = sid
    return at


def nearest(ps, o, d, alb=None, rad=None):
    """Scene intersect with attribute lookup. Returns (hit, t, attrs)."""
    hit, t, sid = nearest_id_t(ps, o, d)
    return hit, t, attrs(ps, sid, alb, rad)


def sphere_both_roots(ps, o, d, s):
    """Raw both-roots of sphere s (Sphere::intersectVPT, Sphere.h:39-45):
    (t1, t2), both 0 when the discriminant is not positive."""
    ctr = ps.c[s]
    r2 = ps.r2[s]
    oc = [o[0] - ctr[0], o[1] - ctr[1], o[2] - ctr[2]]
    b = dot3(oc, d)
    c0 = dot3(oc, oc) - r2
    disc = r2 - (dot3(oc, oc) - b * b)
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, 1.0)) * pos.to(torch.float32)
    sgn = torch.where(b >= 0.0, 1.0, -1.0)
    qq = -(b + sgn * sq)
    other = c0 / torch.where(qq != 0.0, qq, 1.0)
    t1 = torch.minimum(qq, other)
    t2 = torch.maximum(qq, other)
    return torch.where(pos, t1, 0.0), torch.where(pos, t2, 0.0)


# sigma_t of the material-3 fallback in pLight, hard-coded by the reference
# (vptShadeMethods.h:72)
SHELL_SIGMA_T = 0.05 + 0.009


def plight_le_scale(ps, lc, xs):
    """pLight's light-to-point attenuation (vptShadeMethods.h:62-91):
    visible -> 1/d^2. With material-3 shells in the scene (ps.vol) the
    reference's cascade applies: visible when the shells are ignored ->
    1/d^2 times multipleT at SHELL_SIGMA_T through the shells, else 0.
    Returns (le_scale, dist, unit light->xs direction)."""
    lx = [xs[0] - lc[0], xs[1] - lc[1], xs[2] - lc[2]]
    dist = norm3(lx)
    inv_d = 1.0 / dist
    dl = scale3(lx, inv_d)
    hit, t, _ = nearest_id_t(ps, lc, dl)
    vis = (t > dist * ps.slack) | ~hit
    inv_d2 = inv_d * inv_d
    if not ps.vol:
        return torch.where(vis, inv_d2, 0.0), dist, dl
    hit_v, t_v, _ = nearest_id_t(ps, lc, dl, skip=ps.vol)
    vis_vpt = (t_v > dist * ps.slack) | ~hit_v
    # multipleT on the reversed (xs -> light) ray: roots dist - t2 and
    # dist - t1 (volumetricBasicFunctions.h:26-57)
    tau = torch.zeros_like(dist)
    st = f32(SHELL_SIGMA_T)
    for sv in ps.vol:
        t1, t2 = sphere_both_roots(ps, lc, dl, sv)
        r1 = dist - t2
        r2 = dist - t1
        tau = tau + torch.where(r2 < 0.0, st * r1, 0.0)
        tau = tau + torch.where(r2 - r1 > 0.0, st * (r2 - r1), 0.0)
    mt = torch.exp(-tau)
    return (torch.where(vis, inv_d2, torch.where(vis_vpt, inv_d2 * mt, 0.0)),
            dist, dl)


# --- Beckmann / Fresnel ----------------------------------------------------

def ndf_beckmann(cosine, alpha):
    c2 = cosine * cosine
    inv_c2 = 1.0 / torch.clamp_min(c2, 1e-4)
    inv_a2 = 1.0 / torch.clamp_min(alpha * alpha, 1e-8)
    tan2 = torch.clamp_min(1.0 - c2, 0.0) * inv_c2
    val = torch.exp(-tan2 * inv_a2) * (inv_a2 * INV_PI) * (inv_c2 * inv_c2)
    return torch.where(cosine >= 0.0, val, 0.0)


def g1(n, wv, wh, alpha):
    cos = dot3(n, wv)
    sin = torch.sqrt(torch.clamp_min(1.0 - cos * cos, 1e-12))
    cos_g = torch.where(cos != 0.0, cos, 1e-12)
    a = cos_g / (torch.clamp_min(alpha, 1e-6) *
                 torch.where(sin != 0.0, sin, 1e-12 * cos_g))
    rational = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    g = torch.where(a < 1.6, rational, 1.0)
    same = dot3(wv, wh) * cos_g > 0.0
    return torch.where(same, g, 0.0)


def fresnel_cond(cos_wh, eta, kappa):
    """Per-channel conductor Fresnel; eta/kappa per-lane tensors."""
    cos = cos_wh
    sin2 = torch.clamp_min(1.0 - cos * cos, 1e-12)
    out = []
    for e, k in zip(eta, kappa):
        e2k2 = e * e - k * k - sin2
        a2b2 = torch.sqrt(torch.clamp_min(e2k2 * e2k2 + 4.0 * e * e * k * k,
                                          1e-12))
        a = torch.sqrt(torch.clamp_min(0.5 * (a2b2 + e * e - k * k - sin2),
                                       1e-12))
        c2 = cos * cos
        pn = a2b2 + c2 - 2.0 * a * cos
        pd = a2b2 + c2 + 2.0 * a * cos
        sin4 = sin2 * sin2
        qn = a2b2 * c2 + sin4 - 2.0 * a * cos * sin2
        qd = a2b2 * c2 + sin4 + 2.0 * a * cos * sin2
        out.append(0.5 * pn * (qn + qd) / (pd * qd))
    return out


def _ior(at):
    return (at["er"], at["eg"], at["eb"]), (at["kr"], at["kg"], at["kb"])


def fr_microfacet(at, wi_l, wh_l, wo_l):
    """Cook-Torrance in the LOCAL frame (n = +z)."""
    nz = [torch.zeros_like(wi_l[0]), torch.zeros_like(wi_l[0]),
          torch.ones_like(wi_l[0])]
    den = 4.0 * torch.clamp_min(torch.abs(wi_l[2]) * torch.abs(wo_l[2]), 1e-12)
    f = fresnel_cond(dot3(wi_l, wh_l), *_ior(at))
    dg = ndf_beckmann(wh_l[2], at["alpha"]) * g1(nz, wi_l, wh_l, at["alpha"]) \
        * g1(nz, wo_l, wh_l, at["alpha"]) / den
    return [f[0] * dg, f[1] * dg, f[2] * dg]


def fr_microfacet_global(at, wi, wh, wo, n):
    """Cook-Torrance in the GLOBAL frame."""
    den = 4.0 * torch.clamp_min(torch.abs(dot3(n, wi)) * torch.abs(dot3(n, wo)),
                                1e-12)
    f = fresnel_cond(dot3(wi, wh), *_ior(at))
    dg = ndf_beckmann(dot3(n, wh), at["alpha"]) * g1(n, wi, wh, at["alpha"]) \
        * g1(n, wo, wh, at["alpha"]) / den
    return [f[0] * dg, f[1] * dg, f[2] * dg]


def fresnel_die(cos_t, cos_i):
    par = (GLASS_ETA_T * cos_i - GLASS_ETA_I * cos_t) / (
        GLASS_ETA_T * cos_i + GLASS_ETA_I * cos_t)
    perp = (GLASS_ETA_I * cos_i - GLASS_ETA_T * cos_t) / (
        GLASS_ETA_I * cos_i + GLASS_ETA_T * cos_t)
    return 0.5 * (par * par + perp * perp)


def refract_quirk(wo, n):
    """Reference refraction incl. the stray -1 (microFacetUtilities.h:123-141)."""
    wo_l = to_local(n, wo)
    cos_i = dot3(wo, n)
    inv_ratio = GLASS_ETA_I / GLASS_ETA_T
    # inv_ratio * inv_ratio folds in float64 first, as in vpt
    s2 = torch.clamp_min(
        1.0 - f32(inv_ratio * inv_ratio) * (1.0 - cos_i * cos_i), 1e-12)
    cos_t = torch.sqrt(s2)
    ratio = -(GLASS_ETA_T / GLASS_ETA_I)
    wt_l = [wo_l[0] * ratio, wo_l[1] * ratio, cos_t - 1.0]
    return normalize3(from_local(n, wt_l)), cos_t


# --- samplers --------------------------------------------------------------

def cone_dir(wc, cos_max, u1, u2):
    ct = torch.clamp((1.0 - u1) + u1 * cos_max, -1.0, 1.0)
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 1e-12))
    phi = TWO_PI * u2
    local = [st * torch.cos(phi), st * torch.sin(phi), ct]
    return normalize3(from_local(wc, local))


def atan_poly(z):
    """vpt's minimax atan on |z| <= 1 (max error ~1e-5 rad), kept instead
    of atan so both packages round the same operations."""
    z2 = z * z
    return z * (0.99997726 + z2 * (-0.33262347 + z2 * (
        0.19354346 + z2 * (-0.11643287 + z2 * (
            0.05265332 + z2 * -0.01172120)))))


def atan2_posx(y, x):
    """atan2(y, x) for x > 0 (the equi-angular D is floored positive)."""
    z = y / x
    inv = torch.abs(z) > 1.0
    zz = torch.where(inv, 1.0 / torch.where(z != 0.0, z, 1.0), z)
    p = atan_poly(zz)
    sgn = torch.where(z >= 0.0, 1.0, -1.0)
    return torch.where(inv, sgn * (math.pi / 2.0) - p, p)


def tan_sc(t):
    return torch.sin(t) / torch.cos(t)


def hg_consts(g: float) -> dict:
    """The Henyey-Greenstein constants vpt folds in float64 for a baked
    g != 0 (prims.hg_phase_const / hg_dir), rounded to f32; all 0.0 at
    g == 0 (the isotropic build uses none of them)."""
    if g == 0.0:
        return dict.fromkeys(("hg_1pg2", "hg_2g", "hg_phase", "hg_1mg2",
                              "hg_1mg", "hg_inv2g"), 0.0)
    return {"hg_1pg2": f32(1.0 + g * g), "hg_2g": f32(2.0 * g),
            "hg_phase": f32(INV_4PI * (1.0 - g * g)),
            "hg_1mg2": f32(1.0 - g * g), "hg_1mg": f32(1.0 - g),
            "hg_inv2g": f32(1.0 / (2.0 * g))}


def hg_phase_const(ps, cos_t):
    """Henyey-Greenstein phase value at the packed g != 0, 1/d^1.5 as
    rsqrt(d)^3."""
    den = torch.clamp_min(ps.hg_1pg2 - ps.hg_2g * cos_t, 1e-12)
    rs = torch.rsqrt(den)
    return ps.hg_phase * rs * rs * rs


def hg_dir(ps, d, u1, u2):
    """A Henyey-Greenstein direction around the propagation direction d at
    the packed g != 0 (phase/pdf == 1)."""
    den = ps.hg_1mg + ps.hg_2g * u1
    s = torch.full_like(den, ps.hg_1mg2) / den     # true division, as vpt
    cos_t = torch.clamp((ps.hg_1pg2 - s * s) * ps.hg_inv2g, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    local = [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t]
    return normalize3(from_local(d, local))


def hg_phase_traced(cos_t, g):
    """Henyey-Greenstein phase value at a traced f32 g (vpt's
    hg_phase_const on the pair's parameter vector): f32 operations on g,
    1/d^1.5 as rsqrt(d)^3."""
    den = torch.clamp_min(1.0 + g * g - 2.0 * g * cos_t, 1e-12)
    rs = torch.rsqrt(den)
    return (INV_4PI * (1.0 - g * g)) * rs * rs * rs


def hg_dir_traced(d, g, u1, u2):
    """A Henyey-Greenstein direction around d at a traced f32 g (vpt's
    hg_dir_traced): f32 operations on g with a true division by 2g, and the
    isotropic snap at |g| <= 1e-3 (uniform_sphere on the same draws;
    g_safe = 0.5 keeps the unselected lane finite)."""
    aniso = torch.abs(g) > 1e-3
    g_safe = torch.where(aniso, g, 0.5)
    s = (1.0 - g_safe * g_safe) / (1.0 - g_safe + 2.0 * g_safe * u1)
    cos_t = torch.clamp((1.0 + g_safe * g_safe - s * s) / (2.0 * g_safe),
                        -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    local = [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t]
    hg = normalize3(from_local(d, local))
    iso = uniform_sphere(u1, u2)
    return sel3(aniso.expand_as(u1), hg, iso)


def dlog_hg_dg(cos_t, g):
    """d/dg log hg(cos, g) = -2g/(1-g^2) - 3(g-cos)/(1+g^2-2g cos), with
    vpt's floors max(1 - g^2, 1e-6) and max(den, 1e-12): the phase-draw
    score of the dL/dg estimator (3 cos at g == 0)."""
    den = torch.clamp_min(1.0 + g * g - 2.0 * g * cos_t, 1e-12)
    return (-2.0 * g / torch.clamp_min(1.0 - g * g, 1e-6)
            - 3.0 * (g - cos_t) / den)


def cosine_hemi(n, u1, u2):
    ct = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    st = torch.sqrt(torch.clamp_min(u1, 0.0))
    phi = TWO_PI * u2
    return normalize3(from_local(n, [st * torch.cos(phi), st * torch.sin(phi),
                                     ct]))


def uniform_sphere(u1, u2):
    ct = 1.0 - 2.0 * u1
    st = torch.sqrt(torch.clamp_min(1.0 - ct * ct, 0.0))
    phi = TWO_PI * u2
    return [st * torch.cos(phi), st * torch.sin(phi), ct]


def beckmann_wh(alpha, u1, u2):
    t2 = torch.clamp_min(
        -(alpha * alpha) * torch.log(torch.clamp_min(1.0 - u1, 1e-20)), 1e-20)
    ct = torch.rsqrt(1.0 + t2)
    st = torch.sqrt(t2) * ct
    phi = TWO_PI * u2
    return [st * torch.cos(phi), st * torch.sin(phi), ct]


def sample_bsdf(rng, at, d, n):
    """bdsf (vptShadeMethods.h:16-59): (fs, wi, pdf). Takes three draws."""
    wo = [-d[0], -d[1], -d[2]]
    u1, u2, u_choice = rng(), rng(), rng()
    # lambert
    wi_l = cosine_hemi(n, u1, u2)
    cos_l = dot3(n, wi_l)
    pdf_l = cos_l * INV_PI
    fs_l = [at["ar"] * INV_PI, at["ag"] * INV_PI, at["ab"] * INV_PI]
    # dielectric
    wt, _ = refract_quirk(wo, n)
    fres = fresnel_die(dot3(n, wt), dot3(n, wo))
    refl = u_choice < fres
    ndotwo = dot3(n, wo)
    wr = normalize3([2.0 * ndotwo * n[i] - wo[i] for i in range(3)])
    wi_d = sel3(refl, wr, wt)
    cos_d = dot3(n, wi_d)
    inv_cos = 1.0 / torch.where(cos_d != 0.0, cos_d, 1e-12)
    fs_d_s = torch.where(refl, inv_cos * fres,
                         inv_cos * (1.0 - fres) * GLASS_ETA_T * GLASS_ETA_T)
    pdf_d = torch.where(refl, fres, 1.0 - fres)
    # microfacet
    wh = from_local(n, beckmann_wh(at["alpha"], u1, u2))
    wh_dot_wo = dot3(wh, wo)
    wi_m = [2.0 * wh_dot_wo * wh[i] - wo[i] for i in range(3)]
    fs_m = fr_microfacet_global(at, wi_m, wh, wo, n)
    pdf_m = ndf_beckmann(dot3(wh, n), at["alpha"]) * dot3(wh, n) / (
        4.0 * torch.clamp_min(torch.abs(wh_dot_wo), 1e-12))
    is_m, is_d = at["is_mic"], at["is_die"]
    fs = sel3(is_m, fs_m, sel3(is_d, [fs_d_s] * 3, fs_l))
    wi = sel3(is_m, wi_m, sel3(is_d, wi_d, wi_l))
    pdf = torch.where(is_m, pdf_m, torch.where(is_d, pdf_d, pdf_l))
    return fs, wi, pdf


def eval_fr_nee(at, n, wray, wi):
    """Light-strategy fr: lambert / 0 (dielectric) / local microfacet
    (samplingFunctions.h:163-194)."""
    wi_l = to_local(n, wi)
    wo_l = to_local(n, [-wray[0], -wray[1], -wray[2]])
    wh = normalize3(add3(wi_l, wo_l))
    fr_m = fr_microfacet(at, wi_l, wh, wo_l)
    fr_lam = [at["ar"] * INV_PI, at["ag"] * INV_PI, at["ab"] * INV_PI]
    zero = torch.zeros_like(fr_lam[0])
    return [torch.where(at["is_mic"], fr_m[i],
                        torch.where(at["is_die"], zero, fr_lam[i]))
            for i in range(3)]


def eval_fr_nee_plight(at, n, wray, wi):
    """pLight's fr: microfacet local / lambert (no dielectric branch,
    vptShadeMethods.h:83-87)."""
    wi_l = to_local(n, wi)
    wo_l = to_local(n, [-wray[0], -wray[1], -wray[2]])
    wh = normalize3(add3(wi_l, wo_l))
    fr_m = fr_microfacet(at, wi_l, wh, wo_l)
    fr_lam = [at["ar"] * INV_PI, at["ag"] * INV_PI, at["ab"] * INV_PI]
    return sel3(at["is_mic"], fr_m, fr_lam)


def bsdf_pdf_for_dir(at, n, wo, wi, u_flip):
    pdf_l = dot3(n, wi) * INV_PI
    wt, _ = refract_quirk(wo, n)
    fres = fresnel_die(dot3(n, wt), dot3(n, wo))
    pdf_d = torch.where(u_flip > fres, 1.0 - fres, fres)
    wh = normalize3(add3(wi, wo))
    pdf_m = ndf_beckmann(dot3(wh, n), at["alpha"]) * dot3(wh, n) / (
        4.0 * torch.clamp_min(torch.abs(dot3(wo, wh)), 1e-12))
    return torch.where(at["is_mic"], pdf_m,
                       torch.where(at["is_die"], pdf_d, pdf_l))


def power_h_invf(f_inv, g):
    """power_h(1/f_inv, g) = 1/(1 + (g*f_inv)^2); f_inv > 0."""
    r = torch.clamp(g, 0.0, 1e12) * f_inv
    return 1.0 / (1.0 + r * r)


def power_h_invg(f, g_inv):
    """power_h(f, 1/g_inv) = (f*g_inv)^2 / ((f*g_inv)^2 + 1); g > 0."""
    r = torch.clamp(f, 0.0, 1e12) * g_inv
    r2 = r * r
    return torch.where(f > 0.0, r2 / (r2 + 1.0), 0.0)


# --- analytic density fields (vpt/kernels/prims.py:592-624, 892-1087) ------
#
# `fc` is a FieldConsts: the field's parameters and the constants its
# formulas fold. vpt bakes the parameters as python floats, so its kernels
# fold 1/(r r), (1/r)^2, r sqrt(pi/2) w, (1/r) sqrt(1/2), 1/majorant and
# 1/(sigma_t majorant) in float64; field_consts folds them the same way.
# Where vpt's pair traces the parameters (diff_field, diff_blobs), the same
# expressions are f32 operations on the parameter vector, and the
# FieldConsts holds 0-dim f32 tensors computed so (kernels/diff.py).

_SQRT_HALF = math.sqrt(0.5)
_SQRT_HALF_PI = math.sqrt(0.5 * math.pi)
_TWO_OVER_SQRTPI = 1.1283791670955126
# unit-sigma optical-path cap: past total extinction at the sigma >= 1e-6
# floor, far below f32 overflow in the score chains (vpt: _TAU_CAP)
TAU_CAP = 3.0e7
F32_MAX = float(np.finfo(np.float32).max)


@dataclasses.dataclass(frozen=True)
class Blob:
    """One Gaussian blob and the constants its formulas fold."""

    cx: object
    cy: object
    cz: object
    r: object
    w: object
    dens_c: object      # 1 / (r r)           (field_density)
    tau_c: object       # (1 / r)^2           (field_tau)
    amp_c: object       # r sqrt(pi/2) w      (field_tau)
    kh: object          # (1 / r) sqrt(1/2)   (field_tau)
    inv_r: object       # 1 / r               (the blob derivatives)
    ramp: object        # r sqrt(pi/2)        (the blob derivatives)


@dataclasses.dataclass(frozen=True)
class FieldConsts:
    kind: str           # "exp_height" or "blobs"
    k: object = 0.0     # exp_height falloff
    y0: float = 0.0
    maj: float = 1.0    # majorant, f32
    inv_maj: float = 1.0    # 1 / majorant, folded in float64
    max_null: int = 64
    blobs: tuple = ()


def baked_blob(row) -> Blob:
    """A blob row (float64 values of its f32 parameters) with its constants
    folded in float64 and rounded to f32, as vpt's baked kernels have
    them."""
    cx, cy, cz, r, w = (float(v) for v in row)
    inv_r = 1.0 / r
    return Blob(cx=f32(cx), cy=f32(cy), cz=f32(cz), r=f32(r), w=f32(w),
                dens_c=f32(1.0 / (r * r)), tau_c=f32(inv_r * inv_r),
                amp_c=f32(r * _SQRT_HALF_PI * w), kh=f32(inv_r * _SQRT_HALF),
                inv_r=f32(inv_r), ramp=f32(r * _SQRT_HALF_PI))


def field_consts(kind: str, params, majorant: float,
                 max_null: int) -> FieldConsts:
    """FieldConsts of a density field (params: float64 numpy of its f32
    values)."""
    p = np.asarray(params, np.float64)
    if kind == "exp_height":
        return FieldConsts(kind=kind, k=f32(p.reshape(-1)[0]),
                           y0=f32(p.reshape(-1)[1]), maj=f32(majorant),
                           inv_maj=f32(1.0 / majorant),
                           max_null=int(max_null))
    return FieldConsts(kind=kind, maj=f32(majorant),
                       inv_maj=f32(1.0 / majorant), max_null=int(max_null),
                       blobs=tuple(baked_blob(r) for r in p.reshape(-1, 5)))


def erf_poly(x):
    """A&S 7.1.26 erf (max abs err 1.5e-7), as vpt writes it (not
    torch.erf)."""
    s = torch.where(x >= 0.0, 1.0, -1.0)
    a = torch.abs(x)
    t = 1.0 / (1.0 + 0.3275911 * a)
    y = 1.0 - t * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429)))) \
        * torch.exp(-a * a)
    return s * y


def _exp_clip(x):
    return torch.exp(torch.clamp(x, -80.0, 80.0))


def field_density(fc: FieldConsts, x):
    """Density multiplier d(x); x is a list of 3 lane tensors. A grid's is
    its trilinear appearance density, whatever its transport
    interpolant."""
    if fc.kind == "grid":
        return grid_density(fc, x)
    if fc.kind == "exp_height":
        return _exp_clip(-fc.k * (x[1] - fc.y0))
    dens = None
    for b in fc.blobs:
        dx = [x[0] - b.cx, x[1] - b.cy, x[2] - b.cz]
        g = b.w * torch.exp(-0.5 * dot3(dx, dx) * b.dens_c)
        dens = g if dens is None else dens + g
    return dens


def field_tau(fc: FieldConsts, sigma_t, o, d, t, nonneg=False):
    """Optical depth sigma_t * int_0^t d(o + s dir) ds along unit d, closed
    form, or for a grid its canonical march (grid_tau; nonneg=True, where
    every t >= 0, skips the reverse march). exp_height keeps vpt's f32
    rails: the +-80 exponent clip, the constant-density limit at |k d_y| <
    1e-6, the monotone lower bound t min(d0, d_end), odd in t, and the
    +-TAU_CAP clip."""
    if fc.kind == "grid":
        return grid_tau(fc, sigma_t, o, d, t, nonneg=nonneg)
    if fc.kind == "exp_height":
        d0 = _exp_clip(-fc.k * (o[1] - fc.y0))
        d_end = _exp_clip(-fc.k * (o[1] + t * d[1] - fc.y0))
        m = fc.k * d[1]
        const = torch.abs(m) < 1e-6
        safe_m = torch.where(const, 1.0, m)
        base = torch.where(const, d0 * t, (d0 - d_end) / safe_m)
        lb = t * torch.minimum(d0, d_end)
        tau = torch.where(t >= 0.0, torch.maximum(base, lb),
                          torch.minimum(base, lb))
        tau = torch.clamp(tau, -TAU_CAP, TAU_CAP)
        return sigma_t * tau
    tau = None
    for b in fc.blobs:
        oc = [b.cx - o[0], b.cy - o[1], b.cz - o[2]]
        a = dot3(oc, d)
        b2 = torch.clamp_min(dot3(oc, oc) - a * a, 0.0)
        amp = torch.exp(-0.5 * b2 * b.tau_c) * b.amp_c
        hi = erf_poly((t - a) * b.kh)
        lo = erf_poly(a * b.kh)
        g = amp * (hi + lo)
        tau = g if tau is None else tau + g
    return sigma_t * tau


def field_tr_toward(fc: FieldConsts, sigma_t, x, target_dir, dist):
    """exp(-tau) from x along unit target_dir for dist >= 0."""
    return torch.exp(-field_tau(fc, sigma_t, x, target_dir, dist,
                                nonneg=True))


def field_tau_dk(fc: FieldConsts, o, d, t, guard: bool = False):
    """d/dk of the exp_height optical path per unit sigma (the traced-k
    pair's hook); the |m| < 1e-6 limit is -(a0 + a1)/2 d0 t. guard (the
    pair's extended estimators): each product that can overflow f32 is
    clamped to +-FLT_MAX first. Far below the fog plane, where the density
    saturates at e^80, a0 d0 and a1 d1 reach -inf and vpt's form gives inf
    - inf = NaN (an equi-angular path that left the box scatters there);
    the clamp changes no finite value."""
    a0 = o[1] - fc.y0
    a1 = o[1] + t * d[1] - fc.y0
    d0 = _exp_clip(-fc.k * a0)
    d1 = _exp_clip(-fc.k * a1)
    m = fc.k * d[1]
    const = torch.abs(m) < 1e-6
    safe_m = torch.where(const, 1.0, m)
    inv_m = 1.0 / safe_m
    if guard:
        fin = lambda x: torch.clamp(x, -F32_MAX, F32_MAX)  # noqa: E731
        gen = ((fin(a1 * d1) - fin(a0 * d0))
               - fin((d0 - d1) * d[1] * inv_m)) * inv_m
        lim = fin(-0.5 * (a0 + a1) * d0) * t
    else:
        gen = ((a1 * d1 - a0 * d0) - (d0 - d1) * d[1] * inv_m) * inv_m
        lim = -0.5 * (a0 + a1) * d0 * t
    return torch.clamp(torch.where(const, lim, gen), -TAU_CAP, TAU_CAP)


def field_blob_tau_grads(blobs, o, d, t):
    """Per-blob 5-tuples (d/dcx, d/dcy, d/dcz, d/dr, d/dw) of the blobs
    optical path per unit sigma along unit d (the traced-blob pair's
    hook)."""
    dI = []
    for b in blobs:
        oc = [b.cx - o[0], b.cy - o[1], b.cz - o[2]]
        a = dot3(oc, d)
        b2 = torch.clamp_min(dot3(oc, oc) - a * a, 0.0)
        inv_r = b.inv_r
        g = torch.exp(-0.5 * b2 * b.tau_c)
        amp = g * b.ramp
        k = b.kh
        xh = (t - a) * k
        xl = a * k
        S = erf_poly(xh) + erf_poly(xl)
        dphi_h = _TWO_OVER_SQRTPI * torch.exp(-xh * xh)
        dphi_l = _TWO_OVER_SQRTPI * torch.exp(-xl * xl)
        dcs = []
        for j in range(3):
            db2 = 2.0 * oc[j] - 2.0 * a * d[j]
            damp = amp * (-0.5 * inv_r * inv_r) * db2
            dhi = -d[j] * k * dphi_h
            dlo = d[j] * k * dphi_l
            dcs.append(b.w * (damp * S + amp * (dhi + dlo)))
        dr = b.w * (amp * (inv_r + b2 * inv_r * inv_r * inv_r) * S
                    + amp * (dphi_h * (-xh * inv_r)
                             + dphi_l * (-xl * inv_r)))
        dI.append((dcs[0], dcs[1], dcs[2], dr, amp * S))
    return dI


def field_blob_dens_grads(blobs, x):
    """(dens, per-blob 5-tuples of d dens / d(cx, cy, cz, r, w)) at x."""
    dens = None
    dd = []
    for b in blobs:
        dx = [x[0] - b.cx, x[1] - b.cy, x[2] - b.cz]
        q2 = dot3(dx, dx)
        inv_r2 = b.dens_c
        e = torch.exp(-0.5 * q2 * inv_r2)
        dens = b.w * e if dens is None else dens + b.w * e
        dd.append((b.w * e * (dx[0] * inv_r2), b.w * e * (dx[1] * inv_r2),
                   b.w * e * (dx[2] * inv_r2), b.w * e * (q2 * inv_r2 / b.r),
                   e))
    return dens, dd


def field_sample_free(fc: FieldConsts, sigma_t, inv_maj_rate, o, d, u, rng,
                      t_cap, active=None, work=None):
    """Heterogeneous free-flight distance: closed-form inversion for
    exp_height (the uniform u); delta tracking for blobs, which takes 2
    draws from `rng` on each of fc.max_null steps whether or not the lane
    has accepted. Returns t on acceptance, the overshooting t when a step
    passes t_cap (a surface event), BIG when the steps run out.
    inv_maj_rate is 1/(sigma_t majorant) in the caller's arithmetic.
    `work`, a 1-element int64 tensor, gains the steps the kernel's threads
    take: a thread stops at acceptance, on the lanes in `active`."""
    if fc.kind == "exp_height":
        d0 = _exp_clip(-fc.k * (o[1] - fc.y0))
        m = fc.k * d[1]
        tau_star = -torch.log1p(-u)
        a = torch.clamp_min(sigma_t * d0, 1e-30)
        const = torch.abs(m) < 1e-6
        safe_m = torch.where(const, 1.0, m)
        arg = -tau_star * safe_m / a
        escapes = ~const & (arg <= -1.0)
        t_gen = -torch.log1p(torch.where(escapes, -0.5, arg)) / safe_m
        t_const = tau_star / a
        t_fin = torch.where(escapes, BIG,
                            torch.where(const, t_const, t_gen))
        return torch.clamp_max(t_fin, BIG)
    t = torch.zeros_like(o[0])
    done = torch.zeros_like(o[0], dtype=torch.bool)
    for _ in range(fc.max_null):
        if work is not None:
            work += (~done & active).sum()
        u1 = rng()
        u2 = rng()
        step = -torch.log1p(-u1) * inv_maj_rate
        t_new = t + step
        x = [o[j] + t_new * d[j] for j in range(3)]
        accept = u2 < field_density(fc, x) * fc.inv_maj
        t = torch.where(done, t, t_new)
        done = done | accept | (t_new > t_cap)
    return torch.where(done, t, BIG)


# --- voxel grids (vpt/kernels/prims.py:630-890, 1090-1207) ----------------
#
# `gc` is a GridConsts: the grid's geometry folded as vpt's _scene_consts
# bakes it (python floats rounded to f32: origin, 1/spacing, the clamp
# rails, the window cap, 1/M1 and 1/M2 folded in float64) and its packed
# table, the int32 words of grid_table on the lanes' device. Transport is
# the canonical piecewise-constant ray model: a constant head on [0, t0],
# M1 midpoint segments over [t0, ta] and M2 over [ta, tb], a constant tail
# beyond tb (grid_window); the optical depth, the free-flight inversion and
# every transmittance come from the same segments.


@dataclasses.dataclass(frozen=True)
class GridConsts:
    kind: str           # "grid"
    dims: tuple         # (nx, ny, nz)
    org: tuple          # world min corner, f32
    inv_sp: tuple       # f32(1 / spacing)
    lo: tuple           # clamp rails org + spacing / 2, f32
    hi: tuple           # clamp rails org + (n - 1/2) spacing, f32
    cap: float          # march_extent * the grid's diagonal, f32
    n_march: int
    m1: int             # segments of region A (the box crossing)
    inv_m1: float       # f32(1 / M1)
    inv_m2: float       # f32(1 / (M - M1))
    nearest: bool       # transport interpolant xy-nearest / z-linear
    tab: object = None  # int32 (T,) packed words on the lanes' device


def grid_m_split(M: int):
    """vpt's split of the n_march budget: M - max(1, M // 4) segments to
    region A, the rest to region B."""
    m2 = max(1, M // 4)
    return M - m2, m2


def grid_consts(field, device="cpu", tab=None) -> GridConsts:
    """GridConsts of a voxel-grid DensityField, folded as vpt's
    _scene_consts folds them (vpt/kernels/wavefront.py:101-126); tab
    defaults to grid_table(field.params) on `device`."""
    from ..media.density import grid_rails

    nx, ny, nz = (int(n) for n in field.params.shape)
    lo, hi = grid_rails(field)
    diag = float(np.sqrt(sum((n * sp) ** 2 for n, sp in
                             zip((nx, ny, nz), field.grid_spacing))))
    M = int(field.n_march)
    m1, m2 = grid_m_split(M)
    if tab is None:
        tab = grid_table(field.params).to(device)
    return GridConsts(
        kind="grid", dims=(nx, ny, nz),
        org=tuple(f32(v) for v in field.grid_origin),
        inv_sp=tuple(f32(1.0 / float(v)) for v in field.grid_spacing),
        lo=tuple(f32(v) for v in lo), hi=tuple(f32(v) for v in hi),
        cap=f32(float(field.march_extent) * diag), n_march=M, m1=m1,
        inv_m1=f32(1.0 / float(m1)), inv_m2=f32(1.0 / float(m2)),
        nearest=field.transport_interp == "nearest", tab=tab)


def _u32_as_f32(x: torch.Tensor) -> torch.Tensor:
    """uint32 bit patterns held in int64 -> float32 values."""
    return ((x ^ 0x80000000) - 0x80000000).to(torch.int32).view(torch.float32)


def grid_table(values: torch.Tensor) -> torch.Tensor:
    """vpt's grid_table packing as int32 words (T,): word j holds bf16(g[j])
    in its high 16 bits and bf16(g[j + 1]) in its low 16 (the last word
    repeats g[T - 1]), rounded to nearest even as astype(bfloat16) rounds.
    Elementwise, on the values' device; vpt's padding of the table to
    (8k, 128) words is a TPU layout rule and is left out."""
    flat = values.detach().reshape(-1).to(torch.float32)
    u = flat.to(torch.bfloat16).view(torch.int16).to(torch.int64) & 0xFFFF
    nxt = torch.cat([u[1:], u[-1:]])
    word = (u << 16) | nxt
    return ((word ^ 0x80000000) - 0x80000000).to(torch.int32)


def grid_lookup_pair(tab: torch.Tensor, idx: torch.Tensor):
    """(g[idx], g[idx + 1]) as the bf16 values of one table word."""
    w = tab[idx].to(torch.int64) & 0xFFFFFFFF
    return _u32_as_f32(w & 0xFFFF0000), _u32_as_f32((w << 16) & 0xFFFFFFFF)


def _grid_u(gc: GridConsts, x, i):
    return torch.clamp((x[i] - gc.org[i]) * gc.inv_sp[i] - 0.5, 0.0,
                       gc.dims[i] - 1.0)


def _trunc(u, hi: int):
    # u >= 0 after the clip, so truncation is vpt's astype(int32); a NaN
    # coordinate lands on cell 0
    return torch.clamp(torch.nan_to_num(u, nan=0.0).to(torch.int64), 0, hi)


def grid_cell(gc: GridConsts, x):
    """Clamped trilinear cell of x: (base flat index, fx, fy, fz)."""
    nx, ny, nz = gc.dims
    ux, uy, uz = (_grid_u(gc, x, i) for i in range(3))
    ix, iy, iz = _trunc(ux, nx - 2), _trunc(uy, ny - 2), _trunc(uz, nz - 2)
    fx = torch.clamp(ux - ix.to(torch.float32), 0.0, 1.0)
    fy = torch.clamp(uy - iy.to(torch.float32), 0.0, 1.0)
    fz = torch.clamp(uz - iz.to(torch.float32), 0.0, 1.0)
    return (ix * ny + iy) * nz + iz, fx, fy, fz


def grid_density(gc: GridConsts, x):
    """Trilinear clamp-to-edge density from four z-pair words."""
    nz = gc.dims[2]
    snx = gc.dims[1] * nz
    base, fx, fy, fz = grid_cell(gc, x)
    c000, c001 = grid_lookup_pair(gc.tab, base)
    c010, c011 = grid_lookup_pair(gc.tab, base + nz)
    c100, c101 = grid_lookup_pair(gc.tab, base + snx)
    c110, c111 = grid_lookup_pair(gc.tab, base + snx + nz)
    c00 = c000 + (c001 - c000) * fz
    c01 = c010 + (c011 - c010) * fz
    c10 = c100 + (c101 - c100) * fz
    c11 = c110 + (c111 - c110) * fz
    c0 = c00 + (c01 - c00) * fy
    c1 = c10 + (c11 - c10) * fy
    return c0 + (c1 - c0) * fx


def grid_cell_nearest(gc: GridConsts, x):
    """(base flat index, fz) of the xy-nearest / z-linear interpolant."""
    nx, ny, nz = gc.dims
    ux, uy, uz = (_grid_u(gc, x, i) for i in range(3))
    rx = _trunc(ux + 0.5, nx - 1)
    ry = _trunc(uy + 0.5, ny - 1)
    iz = _trunc(uz, nz - 2)
    fz = torch.clamp(uz - iz.to(torch.float32), 0.0, 1.0)
    return (rx * ny + ry) * nz + iz, fz


def grid_density_nearest(gc: GridConsts, x):
    base, fz = grid_cell_nearest(gc, x)
    c0, c1 = grid_lookup_pair(gc.tab, base)
    return c0 + (c1 - c0) * fz


def grid_pc_eval(gc: GridConsts, x):
    """A density of the transport model: the grid's interpolant."""
    return grid_density_nearest(gc, x) if gc.nearest else grid_density(gc, x)


def grid_window(gc: GridConsts, o, d):
    """(t0, ta, tb): the constant head before the slab entry t0, region A
    to ta (the box crossing), region B to tb (the boundary slide to the
    railing distance), the window capped at gc.cap."""
    t_rail = torch.zeros_like(o[0])
    t_enter = torch.full_like(o[0], -BIG)
    t_exit = torch.full_like(o[0], BIG)
    for i in range(3):
        lo_r, hi_r = gc.lo[i], gc.hi[i]
        di, oi = d[i], o[i]
        moving = torch.abs(di) > 1e-12
        inv = 1.0 / torch.where(moving, di, 1.0)
        rail = torch.where(di > 0.0, hi_r, lo_r)
        t_rail = torch.maximum(t_rail,
                               torch.where(moving, (rail - oi) * inv, 0.0))
        ta = (lo_r - oi) * inv
        tb = (hi_r - oi) * inv
        inside = (oi >= lo_r) & (oi <= hi_r)
        near = torch.where(moving, torch.minimum(ta, tb),
                           torch.where(inside, -BIG, BIG))
        far = torch.where(moving, torch.maximum(ta, tb),
                          torch.where(inside, BIG, -BIG))
        t_enter = torch.maximum(t_enter, near)
        t_exit = torch.minimum(t_exit, far)
    box_hit = (t_enter <= t_exit) & (t_exit > 0.0)
    t0 = torch.where(box_hit, torch.clamp_min(t_enter, 0.0), 0.0)
    ta = torch.where(box_hit,
                     torch.minimum(torch.minimum(t_exit, t_rail),
                                   t0 + gc.cap),
                     torch.clamp_max(t_rail, gc.cap) * 0.75)
    ta = torch.maximum(ta, t0 + 1e-6)
    tb = torch.minimum(t_rail, ta + gc.cap)
    tb = torch.maximum(tb, ta + 1e-6)
    return t0, ta, tb


def _grid_segs(gc: GridConsts, t0, ta, tb):
    """(seg0, width) of the canonical segments, stacked in order along a
    new first axis (n_march, *t0.shape): t0 + i h1 in region A, ta + (i -
    m1) h2 in region B, each the f32 value of its segment."""
    h1 = (ta - t0) * gc.inv_m1
    h2 = (tb - ta) * gc.inv_m2
    i = torch.arange(gc.n_march, dtype=t0.dtype, device=t0.device).reshape(
        (-1,) + (1,) * t0.dim())
    in_a = i < gc.m1
    return (torch.where(in_a, t0 + i * h1, ta + (i - gc.m1) * h2),
            torch.where(in_a, h1, h2))


def _ray(o, d, t):
    return [o[j] + t * d[j] for j in range(3)]


def grid_tau_nonneg(gc: GridConsts, sigma_t, o, d, t):
    """The model's optical depth for t >= 0 (the segments' terms computed
    at once, summed in order)."""
    t0, ta, tb = grid_window(gc, o, d)
    seg0, w = _grid_segs(gc, t0, ta, tb)
    rho = grid_pc_eval(gc, _ray(o, d, seg0 + 0.5 * w))
    terms = rho * torch.clamp(t - seg0, torch.zeros_like(w), w)
    acc = torch.zeros_like(o[0])
    for term in terms:
        acc = acc + term
    h2 = (tb - ta) * gc.inv_m2
    rho_head = grid_pc_eval(gc, [o[j] + 0.5 * t0 * d[j] for j in range(3)])
    d_inf = grid_pc_eval(gc, _ray(o, d, tb + h2))
    return sigma_t * (rho_head * torch.minimum(t, t0) + acc
                      + d_inf * torch.clamp_min(t - tb, 0.0))


def grid_tau(gc: GridConsts, sigma_t, o, d, t, nonneg=False):
    """Signed model optical depth: tau(t < 0) = -tau_reverse(-t) (equi-
    angular samples behind the origin); nonneg=True skips the reverse
    march."""
    pos = grid_tau_nonneg(gc, sigma_t, o, d, torch.clamp_min(t, 0.0))
    if nonneg:
        return pos
    neg = grid_tau_nonneg(gc, sigma_t, o, [-d[0], -d[1], -d[2]],
                          torch.clamp_min(-t, 0.0))
    return torch.where(t >= 0.0, pos, -neg)


def grid_sample_free_and_tau(gc: GridConsts, sigma_t, o, d, u, t_cap):
    """One march gives the free-flight distance (the exact inversion of the
    model's tau at -log1p(-u)) and tau(t_cap). Returns (d_s, tau_at_cap);
    d_s == BIG when the flight escapes."""
    t0, ta, tb = grid_window(gc, o, d)
    tau_star = -torch.log1p(-u)
    rho_head = grid_pc_eval(gc, [o[j] + 0.5 * t0 * d[j] for j in range(3)])
    tau_head = sigma_t * rho_head * t0
    cum = tau_head
    tau_cap = torch.zeros_like(o[0])
    d_found = tau_cap - 1.0
    # the segments' densities and terms at once; the sums and the crossing
    # in order
    segs, ws = _grid_segs(gc, t0, ta, tb)
    rhos = grid_pc_eval(gc, _ray(o, d, segs + 0.5 * ws))
    dtaus = sigma_t * rhos * ws
    caps = rhos * torch.clamp(t_cap - segs, torch.zeros_like(ws), ws)
    rates = torch.clamp_min(sigma_t * rhos, 1e-30)
    for seg0, dtau, cap, rate in zip(segs, dtaus, caps, rates):
        tau_cap = tau_cap + cap
        cross = (d_found < 0.0) & (cum + dtau > tau_star)
        d_i = seg0 + (tau_star - cum) / rate
        d_found = torch.where(cross, d_i, d_found)
        cum = cum + dtau
    h2 = (tb - ta) * gc.inv_m2
    in_head = tau_star < tau_head
    d_head = torch.minimum(
        tau_star / torch.clamp_min(sigma_t * rho_head, 1e-30), t0)
    d_inf = grid_pc_eval(gc, _ray(o, d, tb + h2))
    rate = sigma_t * d_inf
    d_tail = tb + (tau_star - cum) / torch.clamp_min(rate, 1e-30)
    d_nf = torch.where(rate > 1e-20, torch.clamp_max(d_tail, BIG), BIG)
    d_s = torch.where(in_head, d_head,
                      torch.where(d_found >= 0.0, d_found, d_nf))
    tau_at_cap = sigma_t * (rho_head * torch.minimum(t_cap, t0) + tau_cap
                            + d_inf * torch.clamp_min(t_cap - tb, 0.0))
    return d_s, tau_at_cap


def grid_pc_point(gc: GridConsts, o, d, t):
    """(x, rho): the model's sample point at ray parameter t >= 0 and its
    density (the sampling pdf's density, grid_pc_density)."""
    t0, ta, tb = grid_window(gc, o, d)
    h1 = (ta - t0) * gc.inv_m1
    h2 = (tb - ta) * gc.inv_m2
    kA = torch.clamp(torch.floor((t - t0) / h1), 0.0, gc.m1 - 1.0)
    kB = torch.clamp(torch.floor((t - ta) / h2), 0.0,
                     gc.n_march - gc.m1 - 1.0)
    t_mid = torch.where(t < ta, t0 + (kA + 0.5) * h1, ta + (kB + 0.5) * h2)
    t_s = torch.where(t < t0, 0.5 * t0, torch.where(t > tb, tb + h2, t_mid))
    x = _ray(o, d, t_s)
    return x, grid_pc_eval(gc, x)


def grid_pc_density(gc: GridConsts, o, d, t):
    """The model's own density at ray parameter t >= 0."""
    return grid_pc_point(gc, o, d, t)[1]


def grid_scatter_point(gc: GridConsts, x, w, gacc, gabs=None, interp=None):
    """gacc (T,) += w * d(interp(x))/d(voxels), summed over the lanes
    (each term rounded to f32, then added in gacc's dtype); gabs, if given,
    gains the absolute value of each added term. interp None is the grid's
    transport interpolant; "tri" scatters a trilinear appearance factor in
    a nearest-transport grid. Only nonzero terms are added."""
    nz = gc.dims[2]
    snx = gc.dims[1] * nz
    nearest = gc.nearest if interp is None else interp == "nearest"
    if nearest:
        base, fz = grid_cell_nearest(gc, x)
        terms = [(0, w * (1.0 - fz)), (1, w * fz)]
    else:
        base, fx, fy, fz = grid_cell(gc, x)
        terms = []
        for a in (0, 1):
            wa = fx if a else 1.0 - fx
            for b in (0, 1):
                wb = fy if b else 1.0 - fy
                for c in (0, 1):
                    wc = fz if c else 1.0 - fz
                    terms.append((a * snx + b * nz + c, w * wa * wb * wc))
    for off, v in terms:
        v = v.reshape(-1)
        keep = v != 0.0
        idx = (base + off).reshape(-1)[keep]
        v = v[keep].to(gacc.dtype)
        gacc.index_add_(0, idx, v)
        if gabs is not None:
            gabs.index_add_(0, idx, torch.abs(v))


def grid_march_scatter(gc: GridConsts, o, d, wA, tA, wB, tB, gacc,
                       gabs=None):
    """gacc += d/dv of (wA I(tA) + wB I(tB)), I the model's optical path per
    unit sigma along (o, d): each segment's overlap with [0, t] at its
    midpoint, then the constant head and tail. The segments are stacked
    into one scatter (each term the loop's f32 value, added in another
    order)."""
    t0, ta, tb = grid_window(gc, o, d)
    seg0, w = _grid_segs(gc, t0, ta, tb)
    zw = torch.zeros_like(w)
    cm = (wA * torch.clamp(tA - seg0, zw, w)
          + wB * torch.clamp(tB - seg0, zw, w))
    xm = _ray(o, d, seg0 + 0.5 * w)
    h2 = (tb - ta) * gc.inv_m2
    ch = wA * torch.minimum(tA, t0) + wB * torch.minimum(tB, t0)
    xh = [o[j] + 0.5 * t0 * d[j] for j in range(3)]
    ct = (wA * torch.clamp_min(tA - tb, 0.0)
          + wB * torch.clamp_min(tB - tb, 0.0))
    xt = _ray(o, d, tb + h2)
    x = [torch.cat([xm[j], xh[j][None], xt[j][None]]) for j in range(3)]
    grid_scatter_point(gc, x, torch.cat([cm, ch[None], ct[None]]), gacc,
                       gabs)
