"""Forward-mode dual numbers for the geometric-gradient kernel's plain version.

Counterpart of ``vpt/kernels/dual.py``, restricted to what kernels/geom.py
uses in a homogeneous medium (every estimator, a baked HG g, material-3
shells). `D` carries a primal value
(a lane tensor or a 0-dim tensor) and a tuple of K tangent components, one
per simultaneous directional derivative.

The conventions are vpt's, and they decide the f32 rounding of the primal
as well as the tangents:
  - `None` is a structural zero: a tuple entry, or the whole tuple, that is
    None carries no arithmetic at all;
  - comparisons read only the primal (event masks are detached);
  - `maximum`/`minimum` send the tangent to the winning side, a tie goes to
    the first argument, so eps-guards freeze tangents as jax.grad does;
  - a division with a D on either side takes ONE reciprocal and multiplies
    by it (value and every tangent plane); a division of two plain values
    stays a true division. The primal of a D therefore rounds differently
    from the same expression on plain tensors, which is why the kernel's
    primal plane is not bit-equal to the forward kernel's image.

Python floats keep python semantics (they fold in float64 and are rounded
to f32 where they meet a tensor), as in vpt. The scene helpers at the
bottom take the packed scene `pk` (kernels/wavefront.Packed: r*r and the
per-sphere epsilon folded in float64, as vpt folds them) and `ctr_tab`, the
per-sphere centres: python floats for baked spheres, 0-dim tensors or D
for the sphere whose centre comes from theta.

Not here yet (ROADMAP Queue 1 item 5.3): the dual field_* forms of a
density field.
"""
from __future__ import annotations

import math

import torch

from . import prims as pr
from .prims import F32EPS, GLASS_ETA_I, GLASS_ETA_T, TWO_PI

__all__ = ["D", "val", "tan", "where", "sqrt", "rsqrt", "exp", "absd",
           "sin", "cos", "maximum", "minimum", "clip", "log1p", "atan_poly",
           "atan2_posx", "tan_sc", "hg_phase", "hg_dir"]


def val(x):
    return x.v if isinstance(x, D) else x


def tan(x):
    return x.t if isinstance(x, D) else None


def _addt(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return tuple(
        y if x is None else (x if y is None else x + y)
        for x, y in zip(a, b)
    )


def _negt(a):
    if a is None:
        return None
    return tuple(None if x is None else -x for x in a)


def _scalet(t, k):
    """t * k where k is a PRIMAL value (tensor or float)."""
    if t is None:
        return None
    return tuple(None if x is None else x * k for x in t)


def _sel(m, a, b):
    """jnp.where for tensors or python floats on either side."""
    return torch.where(m, a, b)


def _wheret(m, a, b):
    if a is None and b is None:
        return None
    if a is None:
        return tuple(None if y is None else _sel(m, 0.0, y) for y in b)
    if b is None:
        return tuple(None if x is None else _sel(m, x, 0.0) for x in a)
    return tuple(
        (None if x is None and y is None else
         _sel(m, 0.0 if x is None else x, 0.0 if y is None else y))
        for x, y in zip(a, b)
    )


class D:
    """Dual value: primal `v` plus tangent tuple `t` (or None == zero)."""

    __slots__ = ("v", "t")

    def __init__(self, v, t=None):
        self.v = v
        self.t = t

    def __add__(self, o):
        return D(self.v + val(o), _addt(self.t, tan(o)))

    __radd__ = __add__

    def __sub__(self, o):
        return D(self.v - val(o), _addt(self.t, _negt(tan(o))))

    def __rsub__(self, o):
        return D(val(o) - self.v, _addt(tan(o), _negt(self.t)))

    def __mul__(self, o):
        ov, ot = val(o), tan(o)
        return D(self.v * ov,
                 _addt(_scalet(self.t, ov), _scalet(ot, self.v)))

    __rmul__ = __mul__

    def __truediv__(self, o):
        # one reciprocal serves the value and every tangent plane
        ov, ot = val(o), tan(o)
        inv = 1.0 / ov
        v = self.v * inv
        t = _scalet(self.t, inv)
        if ot is not None:
            t = _addt(t, _scalet(ot, -v * inv))
        return D(v, t)

    def __rtruediv__(self, o):
        ov, ot = val(o), tan(o)
        inv = 1.0 / self.v
        v = ov * inv
        t = _scalet(self.t, -v * inv)
        if ot is not None:
            t = _addt(t, _scalet(ot, inv))
        return D(v, t)

    def __neg__(self):
        return D(-self.v, _negt(self.t))

    # comparisons: primal-valued, tangent-detached
    def __lt__(self, o):
        return self.v < val(o)

    def __le__(self, o):
        return self.v <= val(o)

    def __gt__(self, o):
        return self.v > val(o)

    def __ge__(self, o):
        return self.v >= val(o)

    def __ne__(self, o):          # noqa: D105 — value comparison by design
        return self.v != val(o)

    def __eq__(self, o):          # noqa: D105
        return self.v == val(o)

    __hash__ = None


def where(m, a, b):
    """Select with detached condition; a/b may be D or plain."""
    av, bv = val(a), val(b)
    v = _sel(m, av, bv)
    t = _wheret(m, tan(a), tan(b))
    return D(v, t) if t is not None else v if not (
        isinstance(a, D) or isinstance(b, D)) else D(v, None)


def sqrt(a):
    if not isinstance(a, D):
        return torch.sqrt(a)
    s = torch.sqrt(a.v)
    # tangent frozen where v == 0 (all call sites clamp first)
    inv2s = 0.5 / torch.where(s > 0.0, s, 1.0)
    return D(s, _scalet(a.t, torch.where(s > 0.0, inv2s, 0.0))
             if a.t is not None else None)


def rsqrt(a):
    if not isinstance(a, D):
        return torch.rsqrt(a)
    r = torch.rsqrt(a.v)
    return D(r, _scalet(a.t, -0.5 * r * r * r))


def exp(a):
    if not isinstance(a, D):
        return torch.exp(a)
    e = torch.exp(a.v)
    return D(e, _scalet(a.t, e))


def absd(a):
    if not isinstance(a, D):
        return torch.abs(a)
    return D(torch.abs(a.v),
             _scalet(a.t, torch.where(a.v >= 0.0, 1.0, -1.0)))


def sin(a):
    if not isinstance(a, D):
        return torch.sin(a)
    return D(torch.sin(a.v), _scalet(a.t, torch.cos(a.v)))


def cos(a):
    if not isinstance(a, D):
        return torch.cos(a)
    return D(torch.cos(a.v), _scalet(a.t, -torch.sin(a.v)))


def log1p(a):
    if not isinstance(a, D):
        return torch.log1p(a)
    return D(torch.log1p(a.v), _scalet(a.t, 1.0 / (1.0 + a.v)))


def _max(a, b):
    """jnp.maximum on tensors or a tensor and a python float (NaN wins)."""
    if not isinstance(b, torch.Tensor):
        return torch.clamp_min(a, b)
    if not isinstance(a, torch.Tensor):
        return torch.clamp_min(b, a)
    return torch.maximum(a, b)


def _min(a, b):
    if not isinstance(b, torch.Tensor):
        return torch.clamp_max(a, b)
    if not isinstance(a, torch.Tensor):
        return torch.clamp_max(b, a)
    return torch.minimum(a, b)


def maximum(a, b):
    """max with the tangent of the winner (ties -> first argument)."""
    av, bv = val(a), val(b)
    m = av >= bv
    v = _max(av, bv)
    t = _wheret(m, tan(a), tan(b))
    if t is None and not (isinstance(a, D) or isinstance(b, D)):
        return v
    return D(v, t)


def minimum(a, b):
    av, bv = val(a), val(b)
    m = av <= bv
    v = _min(av, bv)
    t = _wheret(m, tan(a), tan(b))
    if t is None and not (isinstance(a, D) or isinstance(b, D)):
        return v
    return D(v, t)


def clip(a, lo, hi):
    return minimum(maximum(a, lo), hi)


# ---------------------------------------------------------------------------
# vec3 helpers over dual-or-plain components (vpt/kernels/dual.py:249-540)
# ---------------------------------------------------------------------------

def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def norm3(a):
    return sqrt(maximum(dot3(a, a), 1e-20))


def normalize3(a):
    inv = rsqrt(maximum(dot3(a, a), 1e-20))
    return [a[0] * inv, a[1] * inv, a[2] * inv]


def sel3(m, a, b):
    return [where(m, a[i], b[i]) for i in range(3)]


def scale3(a, k):
    return [a[0] * k, a[1] * k, a[2] * k]


def add3(a, b):
    return [a[0] + b[0], a[1] + b[1], a[2] + b[2]]


def cross3(a, b):
    return [a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _zeros(x):
    return torch.zeros_like(val(x))


def onb(n):
    """Branch-free coordinateSystem (mathUtilities.h:10-19)."""
    cond = absd(n[0]) > absd(n[1])
    inv_a = rsqrt(maximum(n[0] * n[0] + n[2] * n[2], 1e-20))
    inv_b = rsqrt(maximum(n[1] * n[1] + n[2] * n[2], 1e-20))
    z = _zeros(n[0])
    t = [where(cond, n[2] * inv_a, z),
         where(cond, z, n[2] * inv_b),
         where(cond, -n[0] * inv_a, -n[1] * inv_b)]
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


def cone_dir(wc, cos_max, u1, u2):
    """Cone sample around a dual axis with a dual aperture; detached
    uniforms."""
    ct = clip((1.0 - u1) + u1 * cos_max, -1.0, 1.0)
    st = sqrt(maximum(1.0 - ct * ct, 1e-12))
    phi = TWO_PI * u2
    local = [st * torch.cos(phi), st * torch.sin(phi), ct]
    return normalize3(from_local(wc, local))


def cosine_hemi(n, u1, u2):
    ct = torch.sqrt(torch.clamp_min(1.0 - u1, 0.0))
    st = torch.sqrt(torch.clamp_min(u1, 0.0))
    phi = TWO_PI * u2
    return normalize3(from_local(
        n, [st * torch.cos(phi), st * torch.sin(phi), ct]))


def uniform_sphere(u1, u2):
    return pr.uniform_sphere(u1, u2)


def hg_phase(ps, cos_t):
    """Henyey-Greenstein phase value at the scene's baked g != 0 for a dual
    cos_t (vpt dual.py:327-334). vpt's g is a python float: 1 + g^2, 2g and
    (1/4pi)(1 - g^2) fold in float64 and meet the lanes rounded to f32,
    which are the packed ps.hg_1pg2, ps.hg_2g and ps.hg_phase."""
    den = maximum(ps.hg_1pg2 - ps.hg_2g * cos_t, 1e-12)
    rs = rsqrt(den)
    return ps.hg_phase * rs * rs * rs


def hg_dir(ps, d, u1, u2):
    """A Henyey-Greenstein direction around the dual propagation direction
    d at the baked g != 0 (vpt dual.py:337-347): the local angles are
    plain (detached uniforms; prims.hg_dir's f32 arithmetic on the float64
    folds 1 - g^2, 1 - g, 2g, 1 + g^2 and 1/(2g)), the frame rotates with
    d."""
    den = ps.hg_1mg + ps.hg_2g * u1
    s = torch.full_like(den, ps.hg_1mg2) / den     # true division, as vpt
    cos_t = torch.clamp((ps.hg_1pg2 - s * s) * ps.hg_inv2g, -1.0, 1.0)
    sin_t = torch.sqrt(torch.clamp_min(1.0 - cos_t * cos_t, 0.0))
    phi = TWO_PI * u2
    local = [sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t]
    return normalize3(from_local(d, local))


def beckmann_wh(alpha, u1, u2):
    """Local-frame Beckmann wh: alpha plain, uniforms detached -> plain."""
    return pr.beckmann_wh(alpha, u1, u2)


def ndf_beckmann(cosine, alpha):
    c2 = cosine * cosine
    inv_c2 = 1.0 / maximum(c2, 1e-4)
    inv_a2 = 1.0 / torch.clamp_min(alpha * alpha, 1e-8)
    tan2 = maximum(1.0 - c2, 0.0) * inv_c2
    v = exp(-tan2 * inv_a2) * (inv_a2 * (1.0 / math.pi)) * (inv_c2 * inv_c2)
    return where(val(cosine) >= 0.0, v, _zeros(cosine))


def g1(n, wv, wh, alpha):
    cos = dot3(n, wv)
    sin_ = sqrt(maximum(1.0 - cos * cos, 1e-12))
    cos_g = where(cos != 0.0, cos, 1e-12 + _zeros(cos))
    a = cos_g / (torch.clamp_min(alpha, 1e-6)
                 * where(sin_ != 0.0, sin_, 1e-12 * cos_g))
    rational = (3.535 * a + 2.181 * a * a) / (1.0 + 2.276 * a + 2.577 * a * a)
    g = where(val(a) < 1.6, rational, torch.ones_like(val(cos)))
    same = val(dot3(wv, wh) * cos_g) > 0.0
    return where(same, g, _zeros(cos))


def fresnel_cond(cos_wh, eta, kappa):
    """Per-channel conductor Fresnel; eta/kappa plain per-lane tensors."""
    cos_ = cos_wh
    sin2 = maximum(1.0 - cos_ * cos_, 1e-12)
    out = []
    for e, k in zip(eta, kappa):
        e2k2 = e * e - k * k - sin2
        a2b2 = sqrt(maximum(e2k2 * e2k2 + 4.0 * e * e * k * k, 1e-12))
        a = sqrt(maximum(0.5 * (a2b2 + e * e - k * k - sin2), 1e-12))
        c2 = cos_ * cos_
        pn = a2b2 + c2 - 2.0 * a * cos_
        pd = a2b2 + c2 + 2.0 * a * cos_
        sin4 = sin2 * sin2
        qn = a2b2 * c2 + sin4 - 2.0 * a * cos_ * sin2
        qd = a2b2 * c2 + sin4 + 2.0 * a * cos_ * sin2
        out.append(0.5 * pn * (qn + qd) / (pd * qd))
    return out


def _ior(at):
    return (at["er"], at["eg"], at["eb"]), (at["kr"], at["kg"], at["kb"])


def fr_microfacet(at, wi_l, wh_l, wo_l):
    """Cook-Torrance in the LOCAL frame (n = +z)."""
    one = torch.ones_like(val(wi_l[0]))
    z = _zeros(wi_l[0])
    nz = [z, z, one]
    den = 4.0 * maximum(absd(wi_l[2]) * absd(wo_l[2]), 1e-12)
    f = fresnel_cond(dot3(wi_l, wh_l), *_ior(at))
    dg = ndf_beckmann(wh_l[2], at["alpha"]) * g1(nz, wi_l, wh_l, at["alpha"]) \
        * g1(nz, wo_l, wh_l, at["alpha"]) / den
    return [f[0] * dg, f[1] * dg, f[2] * dg]


def fr_microfacet_global(at, wi, wh, wo, n):
    den = 4.0 * maximum(absd(dot3(n, wi)) * absd(dot3(n, wo)), 1e-12)
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
    """Reference refraction incl. the stray -1 (microFacetUtilities.h:133)."""
    wo_l = to_local(n, wo)
    cos_i = dot3(wo, n)
    inv_ratio = GLASS_ETA_I / GLASS_ETA_T
    s2 = maximum(1.0 - inv_ratio * inv_ratio * (1.0 - cos_i * cos_i), 1e-12)
    cos_t = sqrt(s2)
    ratio = -(GLASS_ETA_T / GLASS_ETA_I)
    wt_l = [wo_l[0] * ratio, wo_l[1] * ratio, cos_t - 1.0]
    return normalize3(from_local(n, wt_l)), cos_t


def sample_bsdf(rng, at, d, n):
    """bdsf (vptShadeMethods.h:16-59) with a dual normal: (fs, wi, pdf).
    Takes three draws."""
    wo = [-d[0], -d[1], -d[2]]
    u1, u2, u_choice = rng(), rng(), rng()
    z = torch.zeros_like(u1)
    # lambert
    wi_l = cosine_hemi(n, u1, u2)
    cos_l = dot3(n, wi_l)
    pdf_l = cos_l * (1.0 / math.pi)
    fs_l = [at["ar"] * (1.0 / math.pi), at["ag"] * (1.0 / math.pi),
            at["ab"] * (1.0 / math.pi)]
    # dielectric
    wt, _ = refract_quirk(wo, n)
    fres = fresnel_die(dot3(n, wt), dot3(n, wo))
    refl = u_choice < val(fres)
    ndotwo = dot3(n, wo)
    wr = normalize3([2.0 * ndotwo * n[i] - wo[i] for i in range(3)])
    wi_d = sel3(refl, wr, wt)
    cos_d = dot3(n, wi_d)
    inv_cos = 1.0 / where(cos_d != 0.0, cos_d, 1e-12 + z)
    fs_d_s = where(refl, inv_cos * fres,
                   inv_cos * (1.0 - fres) * (GLASS_ETA_T * GLASS_ETA_T))
    pdf_d = where(refl, fres, 1.0 - fres)
    # microfacet
    wh = from_local(n, beckmann_wh(at["alpha"], u1, u2))
    wh_dot_wo = dot3(wh, wo)
    wi_m = [2.0 * wh_dot_wo * wh[i] - wo[i] for i in range(3)]
    fs_m = fr_microfacet_global(at, wi_m, wh, wo, n)
    pdf_m = ndf_beckmann(dot3(wh, n), at["alpha"]) * dot3(wh, n) / (
        4.0 * maximum(absd(wh_dot_wo), 1e-12))
    is_m, is_d = at["is_mic"], at["is_die"]
    fs = sel3(is_m, fs_m, sel3(is_d, [fs_d_s] * 3, fs_l))
    wi = sel3(is_m, wi_m, sel3(is_d, wi_d, wi_l))
    pdf = where(is_m, pdf_m, where(is_d, pdf_d, pdf_l))
    return fs, wi, pdf


def eval_fr_nee(at, n, wray, wi):
    wi_l = to_local(n, wi)
    wo_l = to_local(n, [-wray[0], -wray[1], -wray[2]])
    wh = normalize3(add3(wi_l, wo_l))
    fr_m = fr_microfacet(at, wi_l, wh, wo_l)
    fr_lam = [at["ar"] * (1.0 / math.pi), at["ag"] * (1.0 / math.pi),
              at["ab"] * (1.0 / math.pi)]
    zero = torch.zeros_like(val(fr_lam[0]) + val(wi[0]) * 0.0)
    return [where(at["is_mic"], fr_m[i],
                  where(at["is_die"], zero, fr_lam[i])) for i in range(3)]


def eval_fr_nee_plight(at, n, wray, wi):
    wi_l = to_local(n, wi)
    wo_l = to_local(n, [-wray[0], -wray[1], -wray[2]])
    wh = normalize3(add3(wi_l, wo_l))
    fr_m = fr_microfacet(at, wi_l, wh, wo_l)
    fr_lam = [at["ar"] * (1.0 / math.pi), at["ag"] * (1.0 / math.pi),
              at["ab"] * (1.0 / math.pi)]
    return sel3(at["is_mic"], fr_m, fr_lam)


def bsdf_pdf_for_dir(at, n, wo, wi, u_flip):
    pdf_l = dot3(n, wi) * (1.0 / math.pi)
    wt, _ = refract_quirk(wo, n)
    fres = fresnel_die(dot3(n, wt), dot3(n, wo))
    pdf_d = where(u_flip > val(fres), 1.0 - fres, fres)
    wh = normalize3(add3(wi, wo))
    pdf_m = ndf_beckmann(dot3(wh, n), at["alpha"]) * dot3(wh, n) / (
        4.0 * maximum(absd(dot3(wo, wh)), 1e-12))
    return where(at["is_mic"], pdf_m, where(at["is_die"], pdf_d, pdf_l))


def power_h(f, g):
    fc = clip(f, 0.0, 1e12)
    gc = clip(g, 0.0, 1e12)
    pos = val(fc) > 0.0
    one = torch.ones_like(val(fc))
    z = _zeros(fc)
    ratio = gc / where(pos, fc, one)
    return where(pos, 1.0 / (1.0 + ratio * ratio), z)


def power_h_invf(f_inv, g):
    """power_h(1/f_inv, g) = 1/(1 + (g*f_inv)^2); f_inv > 0."""
    r = clip(g, 0.0, 1e12) * f_inv
    return 1.0 / (1.0 + r * r)


def power_h_invg(f, g_inv):
    """power_h(f, 1/g_inv) = (f*g_inv)^2/((f*g_inv)^2 + 1); g > 0."""
    r = clip(f, 0.0, 1e12) * g_inv
    r2 = r * r
    z = _zeros(r)
    return where(val(f) > 0.0, r2 / (r2 + 1.0), z)


# ---------------------------------------------------------------------------
# equi-angular trig (vpt dual.py:546-565; the plain forms are prims.py's)
# ---------------------------------------------------------------------------

def atan_poly(zz):
    z2 = zz * zz
    return zz * (0.99997726 + z2 * (-0.33262347 + z2 * (
        0.19354346 + z2 * (-0.11643287 + z2 * (
            0.05265332 + z2 * -0.01172120)))))


def atan2_posx(y, x):
    """atan2(y, x) for x > 0, dual through the polynomial and the
    reciprocal: y / x and 1 / zq take one reciprocal each (D division)."""
    zq = y / x
    inv = absd(zq) > 1.0
    one = torch.ones_like(val(zq))
    zz = where(inv, 1.0 / where(zq != 0.0, zq, one), zq)
    p = atan_poly(zz)
    sgn = torch.where(val(zq) >= 0.0, 1.0, -1.0)
    return where(inv, sgn * (math.pi / 2.0) - p, p)


def tan_sc(t):
    return sin(t) / cos(t)


# ---------------------------------------------------------------------------
# scene intersection with dual-capable sphere centres (dual.py:578-668)
# ---------------------------------------------------------------------------

def sphere_first_t(pk, ctr_tab, o, d, s):
    """Nearest-root t with the Sphere.h:27-37 rescue, dual origin,
    direction and centre. pk.r2 / pk.eps hold vpt's float64 folds."""
    ctr = ctr_tab[s]
    r2 = pk.r2[s]
    oc = [o[0] - ctr[0], o[1] - ctr[1], o[2] - ctr[2]]
    b = dot3(oc, d)
    ococ = dot3(oc, oc)
    c0 = ococ - r2
    disc = r2 - (ococ - b * b)
    pos = val(disc) > 0.0
    one = torch.ones_like(val(disc))
    sq = sqrt(where(pos, disc, one)) * pos.to(torch.float32)
    sgn = torch.where(val(b) >= 0.0, 1.0, -1.0)
    qq = -(b + sgn * sq)
    other = c0 / where(qq != 0.0, qq, one)
    t1 = minimum(qq, other)
    t2 = maximum(qq, other)
    eps = pk.eps[s]
    t = where((t1 < 0.0) | (absd(t1) < eps), t2, t1)
    valid = pos & (val(t) > 0.0) & (torch.abs(val(t)) > eps)
    return t, valid


def nearest_id_t(pk, ctr_tab, o, d):
    """(hit, t, sid) with dual centres; t is 0 on a miss."""
    z = _zeros(o[0])
    t_min = z + math.inf
    sid = torch.full(val(o[0]).shape, -1, dtype=torch.int64,
                     device=val(o[0]).device)
    for s in range(pk.S):
        t, valid = sphere_first_t(pk, ctr_tab, o, d, s)
        closer = valid & (t < t_min)
        t_min = where(closer, t, t_min)
        sid = torch.where(closer, s, sid)
    hit = sid >= 0
    return hit, where(hit, t_min, z), sid


def centre_of(pk, ctr_tab, sid):
    """The centre of sphere `sid` per lane (zeros where sid == -1), dual
    where the centre comes from theta."""
    rows = pr.per_sphere(torch.tensor(pk.c, dtype=torch.float32,
                                      device=sid.device), sid)
    c = [rows[:, 0], rows[:, 1], rows[:, 2]]
    for s, ctr in enumerate(ctr_tab):
        if not all(isinstance(x, float) for x in ctr):
            m = sid == s
            c = [where(m, ctr[i], c[i]) for i in range(3)]
    return c


def nearest(pk, ctr_tab, o, d):
    """prims.nearest with dual centres; albedo/radiance baked from pk.
    Returns (hit, t, attrs); attrs cx/cy/cz carry the theta centre's
    tangents."""
    hit, t, sid = nearest_id_t(pk, ctr_tab, o, d)
    at = pr.attrs(pk, sid)
    at["cx"], at["cy"], at["cz"] = centre_of(pk, ctr_tab, sid)
    return hit, t, at


def visibility_from(pk, ctr_tab, light, x):
    """Reference visibility (light -> x, pathTracingUtilities.h:39-53) with
    dual endpoints; the boolean is detached, the distance is dual."""
    lx = [x[0] - light[0], x[1] - light[1], x[2] - light[2]]
    dist = norm3(lx)
    d = scale3(lx, 1.0 / dist)
    hit, t, _ = nearest_id_t(pk, ctr_tab, light, d)
    vis = (val(t) > val(dist) * (1.0 - 1024.0 * F32EPS)) | ~hit
    return vis, dist, d
