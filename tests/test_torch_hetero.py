"""K1 in vpt's analytic density fields: the plain version against vpt's
render kernel, the field primitives against vpt's, and the density JSON
round trip.

  - render: render_tile_plain against vpt.kernels.wavefront's
    build_tile_renderer in interpret mode (one subprocess, XLA:CPU capped
    at AVX: see tests/test_torch_wavefront.py) at 32x16x4, 8 bounces, seed
    3, on foggy_cornell (exp_height) and blob_cloud (blobs) under four jobs
    that reach every field branch: free flight with NEE (the closed-form
    inversion and delta tracking), equi-angular with NEE (Bernoulli(Tr),
    the explicit T and sigma_s(xt)) and implicit free flight (1 - Tr).
    The scenes keep max_null = 64, so the draw contract runs at its real
    count (2 * 64 draws per blob flight). Criterion: quantile(|a-b| /
    max(1, |ref|max), 0.99) < 1e-4.
  - primitives: vpt.kernels.prims' field functions run eagerly on seeded
    inputs beside the port's: rtol 1e-5 / atol 1e-6 of each output's
    scale, as tests/test_torch_prims.py (XLA's and torch's exp and log1p
    differ by an ulp on some inputs). Delta tracking must take the same
    draws (the streams' states after it bit-equal) and agree on >= 99.9 %
    of lanes (an ulp can flip an acceptance test).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import vpt
from vpt.kernels import prims as jp
from vpt.kernels.wavefront import _scene_consts
from vpt.scene.io import scene_from_dict as vpt_scene_from_dict
from vpt.scene.io import scene_to_dict as vpt_scene_to_dict

import vpt_torch
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import prims as tp
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

from test_torch_wavefront import Q99_TOL, jax_reference, q99_rel

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

W, H, SPP, MB, SEED = 32, 16, 4, 8, 3
# (scene, integrator, sampler)
JOBS = [("foggy_cornell", "explicit_free", "ld"),
        ("blob_cloud", "explicit_free", "random"),
        ("foggy_cornell", "explicit_equiangular", "random"),
        ("blob_cloud", "implicit_free", "random")]
FIELDS = ("foggy_cornell", "blob_cloud")
N = 4096
RTOL, ATOL = 1e-5, 1e-6


def _vpt_dict(name):
    return vpt_scene_to_dict(vpt.SCENES[name](), vpt.default_camera())


@pytest.fixture(scope="module")
def vpt_images():
    jobs = []
    for name, integrator, sampler in JOBS:
        nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
        jobs.append(dict(scene=_vpt_dict(name), width=W, height=H, spp=SPP,
                         max_bounces=MB, sampler=sampler, nee=nee,
                         distance=distance, physical=physical, seed=SEED))
    return dict(zip(JOBS, jax_reference(jobs)))


@pytest.mark.parametrize("job", JOBS, ids=["-".join(j) for j in JOBS])
def test_render_plain_matches_vpt(vpt_images, job):
    name, integrator, sampler = job
    scene, cam = scene_from_dict(_vpt_dict(name))
    assert scene.medium.density.max_null == 64
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(scene, cam, W, H, SPP, max_bounces=MB,
                       sampler=sampler, nee=nee, distance=distance,
                       physical=physical)
    stats = {}
    out = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32),
                               stats).numpy()
    ref = vpt_images[job].reshape(-1, 3)
    assert np.isfinite(out).all() and (out >= 0).all()
    assert q99_rel(out, ref) < Q99_TOL, q99_rel(out, ref)
    # the field's work: optical depths everywhere, null steps for blobs'
    # free flight only
    assert stats["taus"] > 0
    assert (stats["null_steps"] > 0) == (name == "blob_cloud"
                                         and distance == "free")


@pytest.mark.parametrize("name", FIELDS)
def test_density_scene_round_trip(name):
    """vpt's scene dict with its "density" entry -> the port's scene ->
    back: the same dict, the port's built-in scene gives it too, and vpt
    rebuilds the same scene from the port's dict."""
    d_vpt = _vpt_dict(name)
    scene, cam = scene_from_dict(d_vpt)
    assert scene_to_dict(scene, cam) == d_vpt
    assert scene_to_dict(vpt_torch.SCENES[name](),
                         vpt_torch.default_camera()) == d_vpt
    s2, c2 = vpt_scene_from_dict(scene_to_dict(scene, cam))
    assert vpt_scene_to_dict(s2, c2) == d_vpt
    fld, vfld = scene.medium.density, vpt.SCENES[name]().medium.density
    assert fld.kind == vfld.kind and fld.majorant == vfld.majorant
    assert np.array_equal(fld.params.numpy(), np.asarray(vfld.params))


def test_blobs_default_majorant_is_vpts():
    rows = [(0.0, 1.0, 2.0, 3.0, 0.3), (1.0, 0.0, 0.0, 2.0, 0.7),
            (0.0, 0.0, 1.0, 1.0, 0.1)]
    assert vpt_torch.media.blobs(rows).majorant == \
        vpt.media.density.blobs(rows).majorant


def _field_inputs(name, seed):
    """Rays through the field's region: origins (some far below the fog
    plane, where the exponent clips), directions (some near-horizontal:
    the |k d_y| < 1e-6 limit), signed distances (tau is odd in t)."""
    rs = np.random.RandomState(seed)
    if name == "foggy_cornell":
        o = np.stack([rs.uniform(-48, 48, N), rs.uniform(-45, 45, N),
                      rs.uniform(-80, 60, N)])
        o[1, :N // 16] = rs.uniform(-3000, -1500, N // 16)
        t = rs.uniform(-60, 300, N)
    else:
        o = np.stack([rs.uniform(-30, 30, N), rs.uniform(-30, 30, N),
                      rs.uniform(130, 220, N)])
        t = rs.uniform(-20, 200, N)
    d = rs.normal(size=(3, N))
    d[1, N // 16:N // 8] = rs.uniform(-1e-8, 1e-8, N // 16)
    d = d / np.linalg.norm(d, axis=0)
    u = rs.uniform(0, 1, N)
    return (o.astype(np.float32), d.astype(np.float32), t.astype(np.float32),
            u.astype(np.float32))


def _fields(name):
    """(vpt's baked fc, the port's Packed) for the scene's field."""
    scene = vpt.SCENES[name]()
    pk = wf.pack_scene(vpt_torch.SCENES[name](), vpt_torch.default_camera(),
                       8, 4, 1)
    return _scene_consts(scene), pk


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    np.testing.assert_allclose(b, a, rtol=RTOL,
                               atol=ATOL * max(1.0, np.abs(a).max()),
                               err_msg=what)


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("fn", ["field_density", "field_tau",
                                "field_tr_toward", "field_sample_free"])
def test_baked_field_primitive(name, fn):
    """K1's forms: the field's constants folded in float64 (vpt bakes
    python floats; the port's pack_scene folds the same)."""
    sc, pk = _fields(name)
    fc, st = sc["field"], sc["sigma_a"] + sc["sigma_s"]
    o, d, t, u = _field_inputs(name, 7)
    oj, ot = [jnp.asarray(v) for v in o], [torch.from_numpy(v) for v in o]
    dj, dt = [jnp.asarray(v) for v in d], [torch.from_numpy(v) for v in d]
    tj, tt = jnp.asarray(t), torch.from_numpy(t)
    if fn == "field_density":
        x = [o[i] + t * d[i] for i in range(3)]
        _close(jp.field_density(fc, [jnp.asarray(v) for v in x]),
               tp.field_density(pk.field, [torch.from_numpy(v) for v in x]),
               fn)
    elif fn == "field_tau":
        a = np.asarray(jp.field_tau(fc, st, oj, dj, tj))
        b = tp.field_tau(pk.field, pk.sigma_t, ot, dt, tt).numpy()
        _close(a, b, fn)
        # tau takes the sign of t (vpt's odd-in-t convention: |tau| is the
        # segment's depth behind the origin too)
        assert ((b >= 0) == (t >= 0)).all()
    elif fn == "field_tr_toward":
        ta = np.abs(t)
        _close(jp.field_tr_toward(fc, st, oj, dj, jnp.asarray(ta)),
               tp.field_tr_toward(pk.field, pk.sigma_t, ot, dt,
                                  torch.from_numpy(ta)), fn)
    else:
        lane = np.arange(N, dtype=np.int32)
        rj = jp.Pcg(jp.pcg_seed(jnp.asarray(lane), jnp.int32(5)))
        rt = tp.Pcg(tp.pcg_seed(torch.from_numpy(lane), 5))
        t_cap = np.where(np.arange(N) % 3 == 0, 1e8, np.abs(t)).astype(
            np.float32)
        a = np.asarray(jp.field_sample_free(fc, st, oj, dj, jnp.asarray(u),
                                            rj, jnp.asarray(t_cap)))
        b = tp.field_sample_free(pk.field, pk.sigma_t, pk.inv_maj_rate, ot,
                                 dt, torch.from_numpy(u), rt,
                                 torch.from_numpy(t_cap)).numpy()
        # the same draws: 2 * max_null per lane for blobs, none for fog
        assert np.array_equal(np.asarray(rj.s).astype(np.int64) & 0xFFFFFFFF,
                              rt.s.numpy())
        if name == "blob_cloud":
            assert (a == 1e8).any() and (a < 1e8).any()
        same = (a == 1e8) == (b == 1e8)
        close = np.isclose(b, a, rtol=RTOL, atol=ATOL)
        assert same.mean() >= 0.999 and close.mean() >= 0.999, \
            (same.mean(), close.mean())


@pytest.mark.parametrize("name", FIELDS)
def test_traced_field_derivatives(name):
    """The pair's traced forms: vpt's field_tau_dk / field_blob_tau_grads /
    field_blob_dens_grads on traced (f32) parameters against the port's on
    the FieldConsts diff.traced_field computes from the parameter
    vector."""
    sc, _ = _fields(name)
    scene = vpt_torch.SCENES[name]()
    kw = ({"diff_field": True} if name == "foggy_cornell"
          else {"diff_blobs": True})
    dp = df.pack_diff(scene, vpt_torch.default_camera(), 8, 4, 1, **kw)
    pvec = df._flatten(df.pack_params(
        scene, with_field=name == "foggy_cornell",
        with_blobs=name == "blob_cloud"), scene.count)
    fc_t = df.traced_field(dp, pvec)
    fc = sc["field"]
    o, d, t, _ = _field_inputs(name, 11)
    oj, ot = [jnp.asarray(v) for v in o], [torch.from_numpy(v) for v in o]
    dj, dt = [jnp.asarray(v) for v in d], [torch.from_numpy(v) for v in d]
    if name == "foggy_cornell":
        k = jnp.float32(np.float32(fc["params"][0]))
        fck = dict(fc, params=(k, fc["params"][1]))
        _close(jp.field_tau_dk(fck, oj, dj, jnp.asarray(t)),
               tp.field_tau_dk(fc_t, ot, dt, torch.from_numpy(t)),
               "field_tau_dk")
        _close(jp.field_tau(fck, 1.0, oj, dj, jnp.asarray(t)),
               tp.field_tau(fc_t, 1.0, ot, dt, torch.from_numpy(t)),
               "field_tau traced")
        return
    params = tuple(tuple(jnp.float32(np.float32(v)) for v in row)
                   for row in fc["params"])
    fck = dict(fc, params=params)
    ta = np.abs(t)
    _, dIj = jp.field_blob_tau_grads(params, oj, dj, jnp.asarray(ta))
    dIt = tp.field_blob_tau_grads(fc_t.blobs, ot, dt, torch.from_numpy(ta))
    for b, (tj_, tt_) in enumerate(zip(dIj, dIt)):
        for j in range(5):
            _close(tj_[j], tt_[j].numpy(), f"blob {b} dI/dtheta {j}")
    x = [o[i] + ta * d[i] for i in range(3)]
    densj, ddj = jp.field_blob_dens_grads(params, [jnp.asarray(v) for v in x])
    denst, ddt = tp.field_blob_dens_grads(fc_t.blobs,
                                          [torch.from_numpy(v) for v in x])
    _close(densj, denst.numpy(), "dens")
    for b, (tj_, tt_) in enumerate(zip(ddj, ddt)):
        for j in range(5):
            _close(tj_[j], tt_[j].numpy(), f"blob {b} d dens/dtheta {j}")
    _close(jp.field_tau(fck, 1.0, oj, dj, jnp.asarray(ta)),
           tp.field_tau(fc_t, 1.0, ot, dt, torch.from_numpy(ta)),
           "field_tau traced")
    _close(jp.field_density(fck, [jnp.asarray(v) for v in x]),
           tp.field_density(fc_t, [torch.from_numpy(v) for v in x]),
           "field_density traced")
