"""vpt_torch.kernels.prims against vpt.kernels.prims on the same inputs.

The vpt primitives run eagerly here (op by op, as plain jnp calls), the
port's as torch ops on the CPU; inputs come from numpy seeds. Tolerances:
  - PCG and LD draws are integer arithmetic plus a mantissa bitcast, so
    they must be bit-equal;
  - intersection ids must agree on >= 99.9% of rays (an ulp of difference
    may flip a grazing hit), t within rtol 1e-5 where they agree;
  - the shading primitives within rtol 1e-5 / atol 1e-6: the f32 operation
    order is the same, but XLA's and torch's exp, log, log1p, sin, cos, sqrt
    and rsqrt differ by an ulp on some inputs (5-36% of them). Two families
    of lanes amplify that ulp, and are held to a measured looser bound:
      * microfacet lanes (rtol 1e-3): the Beckmann NDF forms 1 - cos^2 of a
        half-vector cosine near 1, so one ulp there is ~2e-4 relative in
        tan^2 and in exp(-tan^2/alpha^2). Both packages' f32 results sit
        about that far (q99 ~2e-4) from a float64 evaluation of the same
        formulas, so that is the agreement f32 allows;
      * dielectric lanes at grazing incidence, cos(wo) < 0.3 (rtol 1e-2):
        refract_quirk takes cos_t - 1 and the Fresnel quotient is steep
        there.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vpt
from vpt.kernels import prims as jp
from vpt.kernels.wavefront import _scene_consts
from vpt.scene.io import scene_to_dict

from vpt_torch.kernels import prims as tp
from vpt_torch.kernels.wavefront import pack_scene
from vpt_torch.scene.io import scene_from_dict

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

N = 4096
RTOL, ATOL = 1e-5, 1e-6

SCENE = vpt.cornell_vpt()
SC = _scene_consts(SCENE)
PK = pack_scene(*scene_from_dict(scene_to_dict(SCENE, vpt.default_camera())),
                32, 16, 4)


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _unit(rs, n):
    v = rs.normal(size=(3, n))
    return (v / np.linalg.norm(v, axis=0)).astype(np.float32)


def _inputs(seed):
    """Random shading inputs: normals, incoming directions on the front side,
    light directions, uniforms and a per-lane material mix."""
    rs = np.random.RandomState(seed)
    n = _unit(rs, N)
    d = _unit(rs, N)
    d = np.where((d * n).sum(0) > 0, -d, d).astype(np.float32)
    wi = _unit(rs, N)
    u = rs.uniform(0, 1, size=(4, N)).astype(np.float32)
    kind = rs.randint(0, 3, size=N)
    at = {
        "ar": rs.uniform(0, 1, N), "ag": rs.uniform(0, 1, N),
        "ab": rs.uniform(0, 1, N),
        "er": rs.uniform(0.1, 1.7, N), "eg": rs.uniform(0.1, 1.7, N),
        "eb": rs.uniform(0.1, 1.7, N),
        "kr": rs.uniform(1.5, 9.5, N), "kg": rs.uniform(1.5, 9.5, N),
        "kb": rs.uniform(1.5, 9.5, N),
        "alpha": rs.uniform(0.02, 0.3, N),
    }
    at = {k: v.astype(np.float32) for k, v in at.items()}
    at["is_mic"] = kind == 1
    at["is_die"] = kind == 2
    return n, d, wi, u, at


def _both(arrays):
    """(jax list, torch list) of the rows of an array, or of a dict."""
    if isinstance(arrays, dict):
        return ({k: _j(v) for k, v in arrays.items()},
                {k: _t(v) for k, v in arrays.items()})
    return [_j(a) for a in arrays], [_t(a) for a in arrays]


@pytest.mark.parametrize("seed", [0, 3, -7, 2**31 - 1])
@pytest.mark.parametrize("stream", ["pcg", "ld_offsets"])
def test_pcg_draws_bit_equal(stream, seed):
    lane = np.arange(N, dtype=np.int32)
    if stream == "pcg":
        rj = jp.Pcg(jp.pcg_seed(_j(lane), jnp.int32(seed)))
        rt = tp.Pcg(tp.pcg_seed(_t(lane), seed))
        a = [np.asarray(rj()) for _ in range(6)]
        b = [rt().numpy() for _ in range(6)]
    else:
        a = [np.asarray(x) for x in jp.ld_offsets(_j(lane), jnp.int32(seed))]
        b = [x.numpy() for x in tp.ld_offsets(_t(lane), seed)]
    assert all(x.dtype == np.float32 for x in b)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
        assert (y >= 0).all() and (y < 1).all()


def _rays(seed):
    """Rays from inside the Cornell box (and a few from outside) in random
    directions; float32."""
    rs = np.random.RandomState(seed)
    o = np.stack([rs.uniform(-48, 48, N), rs.uniform(-40, 40, N),
                  rs.uniform(-80, 200, N)]).astype(np.float32)
    return o, _unit(rs, N)


@pytest.mark.parametrize("fn", ["sphere_first_t", "nearest_id_t", "nearest"])
def test_intersection(fn):
    o, d = _rays(11)
    (oj, ot), (dj, dt) = _both(o), _both(d)
    if fn == "sphere_first_t":
        for s in range(PK.S):
            tj, vj = jp.sphere_first_t(SC, oj, dj, s)
            tt, vt = tp.sphere_first_t(PK, ot, dt, s)
            agree = np.asarray(vj) == vt.numpy()
            assert agree.mean() >= 0.999, (s, agree.mean())
            m = agree & vt.numpy()
            np.testing.assert_allclose(tt.numpy()[m], np.asarray(tj)[m],
                                       rtol=1e-5)
        return
    if fn == "nearest_id_t":
        hj, tj, sj = jp.nearest_id_t(SC, oj, dj)
        ht, tt, st = tp.nearest_id_t(PK, ot, dt)
    else:
        hj, tj, aj = jp.nearest(SC, oj, dj, SC["alb"], SC["rad"])
        ht, tt, at = tp.nearest(PK, ot, dt)
        sj, st = aj["sid"], at["sid"]
    same = np.asarray(sj) == st.numpy()
    assert same.mean() >= 0.999, same.mean()
    assert np.array_equal(np.asarray(hj)[same], ht.numpy()[same])
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same],
                               rtol=1e-5)
    if fn == "nearest":
        for k in ("cx", "cy", "cz", "ar", "ag", "ab", "rr", "rg", "rb",
                  "er", "eg", "eb", "kr", "kg", "kb", "alpha", "is_em",
                  "is_mic", "is_die"):
            assert np.array_equal(np.asarray(aj[k])[same],
                                  at[k].numpy()[same]), k


def _run_primitive(mod, name, n, d, wi, u, at, rng_state):
    """Call primitive `name` of module `mod` (vpt's or the port's prims)."""
    wo = [-d[0], -d[1], -d[2]]
    if name == "sample_bsdf":
        fs, w, pdf = mod.sample_bsdf(mod.Pcg(rng_state), at, d, n)
        return [*fs, *w, pdf]
    if name == "eval_fr_nee":
        return mod.eval_fr_nee(at, n, d, wi)
    if name == "eval_fr_nee_plight":
        return mod.eval_fr_nee_plight(at, n, d, wi)
    if name == "bsdf_pdf_for_dir":
        return [mod.bsdf_pdf_for_dir(at, n, wo, wi, u[0])]
    if name == "cone_dir":
        return mod.cone_dir(n, u[2], u[0], u[1])
    if name == "cosine_hemi":
        return mod.cosine_hemi(n, u[0], u[1])
    if name == "uniform_sphere":
        return mod.uniform_sphere(u[0], u[1])
    if name == "beckmann_wh":
        return mod.beckmann_wh(at["alpha"], u[0], u[1])
    if name == "power_h_invf":
        return [mod.power_h_invf(u[0] + 0.01, 100.0 * u[1] - 10.0)]
    if name == "power_h_invg":
        return [mod.power_h_invg(100.0 * u[1] - 10.0, u[0] + 0.01)]
    raise KeyError(name)


@pytest.mark.parametrize("name", [
    "sample_bsdf", "eval_fr_nee", "eval_fr_nee_plight", "bsdf_pdf_for_dir",
    "cone_dir", "cosine_hemi", "uniform_sphere", "beckmann_wh",
    "power_h_invf", "power_h_invg"])
def test_shading_primitive(name):
    n, d, wi, u, at = _inputs(5)
    rng0 = np.random.RandomState(9).randint(0, 2**31 - 1, N).astype(np.int32)
    (nj, dj, wj, uj, atj), (nt, dt, wt, ut, att) = zip(
        _both(n), _both(d), _both(wi), _both(u), _both(at))
    a = _run_primitive(jp, name, nj, dj, wj, uj, atj, _j(rng0))
    b = _run_primitive(tp, name, nt, dt, wt, ut, att,
                       _t(rng0.astype(np.int64) & 0xFFFFFFFF))
    strict = np.ones(N, bool)
    loose = []
    if name in ("sample_bsdf", "eval_fr_nee", "eval_fr_nee_plight",
                "bsdf_pdf_for_dir"):
        grazing_die = at["is_die"] & ((-d * n).sum(0) < 0.3)
        strict = ~(at["is_mic"] | grazing_die)
        loose = [(at["is_mic"], 1e-3), (grazing_die, 1e-2)]
    for x, y in zip(a, b):
        x, y = _np(x), _np(y)
        assert y.dtype == np.float32 and np.isfinite(y).all()
        np.testing.assert_allclose(y[strict], x[strict], rtol=RTOL, atol=ATOL)
        for m, rtol in loose:
            np.testing.assert_allclose(y[m], x[m], rtol=rtol, atol=ATOL)
            # the bulk of these lanes still agrees to rtol 1e-5
            assert np.isclose(y[m], x[m], rtol=RTOL, atol=ATOL).mean() > 0.8


def test_plight_le_scale():
    """Light-to-point visibility from each of cornell_vpt's emitters to
    random points in the box."""
    rs = np.random.RandomState(2)
    xs = np.stack([rs.uniform(-48, 48, N), rs.uniform(-40, 40, N),
                   rs.uniform(-80, 200, N)]).astype(np.float32)
    e = np.asarray(SCENE.emitter_idx)[rs.randint(0, 3, N)]
    lc = np.asarray(SCENE.center, np.float32)[e].T.copy()
    (xj, xt), (lj, lt) = _both(xs), _both(lc)
    sj, dj, vj = jp.plight_le_scale(SC, lj, xj)
    st, dt, vt = tp.plight_le_scale(PK, lt, xt)
    vis_j, vis_t = np.asarray(sj) > 0, st.numpy() > 0
    assert (vis_j == vis_t).mean() >= 0.999
    m = vis_j == vis_t
    np.testing.assert_allclose(st.numpy()[m], np.asarray(sj)[m], rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=RTOL)
    for x, y in zip(vj, vt):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=RTOL,
                                   atol=ATOL)


# ---- the equi-angular trig, Henyey-Greenstein and the material-3 cascade
# (the variants of the render kernel)

def _ea_hg(mod, name, ps, z, n, u):
    if name == "atan_poly":
        return [mod.atan_poly(2.0 * z - 1.0)]
    if name == "atan2_posx":
        return [mod.atan2_posx(40.0 * z - 20.0, u[0] * 10.0 + 1e-3)]
    if name == "tan_sc":
        return [mod.tan_sc(2.8 * z - 1.4)]
    g = 0.5 if ps is None else ps.g
    if name == "hg_phase_const":
        cos_t = 2.0 * z - 1.0
        return [mod.hg_phase_const(cos_t, g) if ps is None
                else mod.hg_phase_const(ps, cos_t)]
    if name == "hg_dir":
        if ps is None:
            return mod.hg_dir(n, g, u[0], u[1])[0]
        return mod.hg_dir(ps, n, u[0], u[1])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["atan_poly", "atan2_posx", "tan_sc",
                                  "hg_phase_const", "hg_dir"])
def test_equiangular_and_hg_primitive(name):
    """atan_poly and atan2_posx are plain f32 arithmetic (bit-equal); tan_sc
    and the HG forms go through sin, cos and rsqrt (rtol 1e-5). The HG
    constants are the ones pack_scene folds in float64 for g = 0.5."""
    rs = np.random.RandomState(4)
    z = rs.uniform(0, 1, N).astype(np.float32)
    n, _, _, u, _ = _inputs(6)
    g_scene = scene_to_dict(SCENE, vpt.default_camera())
    g_scene["g"] = 0.5
    ps = pack_scene(*scene_from_dict(g_scene), 8, 4, 1)
    a = _ea_hg(jp, name, None, _j(z), _both(n)[0], _both(u)[0])
    b = _ea_hg(tp, name, ps, _t(z), _both(n)[1], _both(u)[1])
    for x, y in zip(a, b):
        x, y = _np(x), _np(y)
        assert y.dtype == np.float32 and np.isfinite(y).all()
        if name in ("atan_poly", "atan2_posx"):
            assert np.array_equal(x, y)
        else:
            np.testing.assert_allclose(y, x, rtol=RTOL, atol=ATOL)


def test_shell_cascade_primitives():
    """medium_shell's material-3 shell: both roots of every sphere, the
    scan that skips the shell, and pLight's cascade through it."""
    shell = vpt.SCENES["medium_shell"]()
    sc = _scene_consts(shell)
    ps = pack_scene(*scene_from_dict(scene_to_dict(shell,
                                                   vpt.default_camera())),
                    8, 4, 1)
    assert ps.vol == sc["vol"] != ()
    o, d = _rays(13)
    (oj, ot), (dj, dt) = _both(o), _both(d)
    for s in range(ps.S):
        t1j, t2j = jp.sphere_both_roots(sc, oj, dj, s)
        t1t, t2t = tp.sphere_both_roots(ps, ot, dt, s)
        for x, y in ((t1j, t1t), (t2j, t2t)):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=1e-5,
                                       atol=1e-3)
    hj, tj, sj = jp.nearest_id_t(sc, oj, dj, skip=sc["vol"])
    ht, tt, st = tp.nearest_id_t(ps, ot, dt, skip=ps.vol)
    same = np.asarray(sj) == st.numpy()
    assert same.mean() >= 0.999 and not np.isin(st.numpy(), ps.vol).any()
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same],
                               rtol=1e-5)
    rs = np.random.RandomState(8)
    xs = np.stack([rs.uniform(-48, 48, N), rs.uniform(-40, 40, N),
                   rs.uniform(-80, 200, N)]).astype(np.float32)
    e = np.asarray(shell.emitter_idx)[rs.randint(0, len(shell.emitter_idx),
                                                 N)]
    lc = np.asarray(shell.center, np.float32)[e].T.copy()
    (xj, xt), (lj, lt) = _both(xs), _both(lc)
    scale_j = np.asarray(jp.plight_le_scale(sc, lj, xj)[0])
    scale_t = tp.plight_le_scale(ps, lt, xt)[0].numpy()
    # lanes attenuated by the shell, fully visible and dark all occur
    full = 1.0 / np.sum((xs - lc) ** 2, axis=0)
    assert ((scale_j > 0) & (scale_j < 0.99 * full)).mean() > 0.01
    m = (scale_j > 0) == (scale_t > 0)
    assert m.mean() >= 0.999
    np.testing.assert_allclose(scale_t[m], scale_j[m], rtol=RTOL, atol=ATOL)
