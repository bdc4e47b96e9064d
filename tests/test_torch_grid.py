"""Voxel-grid density fields in the port against vpt: the packed table, the
grid primitives, the voxel scatter, the field constructor and density(),
scene files, and K1's plain version on a grid.

  - the table: vpt_torch.kernels.prims.grid_table's words equal vpt's
    grid_table words bit for bit (bf16 rounded to nearest even), on random
    values and on grid_cloud;
  - the primitives: vpt's prims grid functions on the CPU outside any
    pallas_call against the port's on seeded rays through the grid (both
    transport interpolants). grid_density, grid_density_nearest,
    grid_window and grid_pc_point run op by op and agree within one ulp:
    no transcendental enters and the operations are the same (jitted, XLA
    here contracts a*b+c into FMA). The marches run jitted: grid_tau (both
    signs of t), grid_sample_free_and_tau's tau and the model's density
    within rtol 1e-5 of each output's scale (XLA folds vpt's
    i * ((ta - t0) * (1/M1)) into (ta - t0) * (i/M1), which moves some
    segment starts by an ulp); its free-flight distance within rtol 1e-5
    on >= 99.9 % of the lanes and escaping on the same lanes (log1p enters,
    and the tail's inversion divides a difference of two sums by a small
    rate);
  - the scatter: grid_scatter_point and grid_march_scatter equal w times
    the derivative of vpt's media.density.density (trilinear) and of its
    _grid_tau_nonneg (the transport interpolant), taken by jax.grad, within
    rtol 1e-6 of the gradient's scale; both interpolants, and the "tri"
    override of a nearest grid (its appearance factor);
  - K1: render_tile_plain against vpt's build_tile_renderer in interpret
    mode (one subprocess, XLA:CPU capped at AVX: see
    tests/test_torch_wavefront.py) on grid_cloud (tests/test_diff_kernel.py:
    blob_cloud rasterized onto an 8^3 grid, n_march 8), explicit_free,
    "ld", 16x12x4, 8 bounces, seed 3: image q99 relative error <= 1e-5;
    the lanes more than 1e-4 of their own scale apart are the flip lanes
    (none at this seed).
The other integrators on a grid are held to the plain version by the host
build (tests/test_torch_path_host.py) and on the card (chip_smoke.py).
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import vpt
from vpt.kernels import prims as jp
from vpt.kernels.wavefront import _scene_consts
from vpt.kernels.wavefront import grid_table as vpt_grid_table
from vpt.media import density as vdf
from vpt.scene.io import scene_from_dict as vpt_scene_from_dict
from vpt.scene.io import scene_to_dict as vpt_scene_to_dict
from vpt.scene.scene import Medium as VptMedium

import vpt_torch
from vpt_torch.kernels import prims as tp
from vpt_torch.kernels import wavefront as wf
from vpt_torch.media import density as tdf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

from test_torch_wavefront import jax_reference

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

W, H, SPP, MB, SEED = 16, 12, 4, 8, 3
Q99_TOL = 1e-5
FLIP_TOL = 1e-4
N = 4096
INTERPS = ("tri", "nearest")


def vpt_grid_cloud(interp="tri"):
    """tests/test_diff_kernel.py's grid_cloud: blob_cloud rasterized onto
    an 8^3 grid, n_march 8."""
    base = vpt.scene.scene.blob_cloud()
    n = 8
    xs = np.linspace(-40, 40, n)
    zs = np.linspace(130, 220, n)
    gx, gy, gz = np.meshgrid(xs, xs, zs, indexing="ij")
    pts = jnp.asarray(np.stack([gx, gy, gz], -1))
    vals = np.asarray(vdf.density(base.medium.density, pts))
    sx, sz = 80 / (n - 1), 90 / (n - 1)
    f = dataclasses.replace(
        vdf.grid(vals, origin=(-40 - sx / 2, -40 - sx / 2, 130 - sz / 2),
                 spacing=(sx, sx, sz), transport_interp=interp), n_march=8)
    return dataclasses.replace(
        base, medium=VptMedium(base.medium.sigma_a, base.medium.sigma_s, 0.0,
                               f))


def port_scene(interp="tri"):
    """The same scene through vpt's scene file (which does not store the
    transport interpolant)."""
    scene, cam = scene_from_dict(vpt_scene_to_dict(vpt_grid_cloud(interp),
                                                   vpt.default_camera()))
    fld = dataclasses.replace(scene.medium.density, transport_interp=interp)
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, density=fld)), cam


def consts(interp):
    """(vpt's fc with its table, the port's GridConsts)."""
    sc = vpt_grid_cloud(interp)
    fc = dict(_scene_consts(sc)["field"])
    fc["tab"] = vpt_grid_table(sc.medium.density.params)
    scene, _ = port_scene(interp)
    return fc, tp.grid_consts(scene.medium.density)


def _rays(seed):
    """Rays from inside and around the grid's box (some axis-parallel: the
    window's non-moving axes), signed distances, uniforms."""
    rs = np.random.RandomState(seed)
    o = np.stack([rs.uniform(-70, 70, N), rs.uniform(-70, 70, N),
                  rs.uniform(90, 260, N)])
    d = rs.normal(size=(3, N))
    d[:, :N // 32] = [[1.0], [0.0], [0.0]]
    d[:, N // 32:N // 16] = [[0.0], [0.0], [-1.0]]
    d = d / np.linalg.norm(d, axis=0)
    t = rs.uniform(-120, 250, N)
    u = rs.uniform(0, 1, N)
    return (o.astype(np.float32), d.astype(np.float32), t.astype(np.float32),
            u.astype(np.float32))


def _j(v):  # (3, N) -> vpt's lane tiles (32, 128)
    return [jnp.asarray(v[i].reshape(32, 128)) for i in range(3)]


def _t(v):
    return [torch.from_numpy(np.ascontiguousarray(v[i])) for i in range(3)]


def _flat(a):
    return np.asarray(a, np.float64).reshape(-1)


def _close(a, b, what, rtol=1e-5):
    a, b = _flat(a), _flat(b)
    assert np.isfinite(a).all() and np.isfinite(b).all(), what
    np.testing.assert_allclose(b, a, rtol=rtol,
                               atol=rtol * max(1e-30, np.abs(a).max()),
                               err_msg=what)


def _ulp1(a, b, what):
    """Elementwise within one f32 ulp."""
    a = np.asarray(a, np.float32).reshape(-1)
    b = np.asarray(b, np.float32).reshape(-1)
    ok = (a == b) | (np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                            np.abs(b))))
    assert ok.all(), (what, np.flatnonzero(~ok)[:8], a[~ok][:8], b[~ok][:8])


# ---- the table, the field, scene files -----------------------------------

@pytest.mark.parametrize("values", ["random", "grid_cloud"])
def test_grid_table_bit_exact(values):
    if values == "random":
        rs = np.random.RandomState(0)
        v = (rs.lognormal(0.0, 2.0, (5, 6, 7))
             * rs.choice([0.0, 1.0], (5, 6, 7), p=[0.1, 0.9]))
        v = v.astype(np.float32)
        # halfway cases: bf16's round to nearest even
        v.reshape(-1)[:4] = np.array([0x3F808000, 0x3F818000, 0x40008000,
                                      0x3F80FFFF], np.uint32).view(np.float32)
    else:
        v = np.array(vpt_grid_cloud().medium.density.params, np.float32)
    want = np.asarray(jax.lax.bitcast_convert_type(
        vpt_grid_table(jnp.asarray(v)), jnp.int32)).reshape(-1)[:v.size]
    got = tp.grid_table(torch.from_numpy(v))
    assert got.dtype == torch.int32 and got.shape == (v.size,)
    assert np.array_equal(got.numpy(), want)


def test_grid_field_defaults_are_vpts():
    rs = np.random.RandomState(1)
    v = rs.uniform(0.0, 2.0, (4, 5, 6)).astype(np.float32)
    ours = tdf.grid(v, origin=(-1.0, 2.0, 3.0), spacing=(0.5, 0.25, 2.0))
    theirs = vdf.grid(v, origin=(-1.0, 2.0, 3.0), spacing=(0.5, 0.25, 2.0))
    for key in ("kind", "majorant", "max_null", "grid_origin", "grid_spacing",
                "n_march", "march_extent", "transport_interp"):
        assert getattr(ours, key) == getattr(theirs, key), key
    assert np.array_equal(ours.params.numpy(), np.asarray(theirs.params))
    assert tdf.grid_rails(ours) == vdf._grid_rails(theirs)
    with pytest.raises(ValueError, match="transport_interp"):
        tdf.grid(v, (0, 0, 0), (1, 1, 1), transport_interp="cubic")
    with pytest.raises(ValueError, match="every axis >= 2"):
        tdf.grid(v[:1], (0, 0, 0), (1, 1, 1))


@pytest.mark.parametrize("kind", ["grid", "exp_height", "blobs"])
def test_density_matches_vpt(kind):
    """media.density.density on points in and around each field: a grid's
    within one ulp, the analytic fields' (exp enters) within rtol 1e-5."""
    rs = np.random.RandomState(2)
    if kind == "grid":
        fv, ft = vpt_grid_cloud().medium.density, \
            port_scene()[0].medium.density
    else:
        name = "foggy_cornell" if kind == "exp_height" else "blob_cloud"
        fv = vpt.SCENES[name]().medium.density
        ft = vpt_torch.SCENES[name]().medium.density
    x = np.stack([rs.uniform(-60, 60, 2048), rs.uniform(-60, 60, 2048),
                  rs.uniform(110, 240, 2048)], -1).astype(np.float32)
    a = np.asarray(vdf.density(fv, jnp.asarray(x)))
    b = tdf.density(ft, torch.from_numpy(x)).numpy()
    if kind == "grid":
        _ulp1(a, b, kind)
    else:
        _close(a, b, kind)


def test_grid_scene_file_round_trip(tmp_path):
    """vpt's scene file with a grid loads in the port and back, and the
    port's file loads in vpt: the same dict, the same voxel values."""
    d_vpt = vpt_scene_to_dict(vpt_grid_cloud(), vpt.default_camera())
    assert d_vpt["density"]["kind"] == "grid"
    path = tmp_path / "grid.json"
    path.write_text(json.dumps(d_vpt))
    scene, cam = vpt_torch.scene.io.load_scene(str(path))
    assert scene_to_dict(scene, cam) == d_vpt
    fld = scene.medium.density
    assert fld.kind == "grid" and fld.n_march == 8 and fld.params.shape == \
        (8, 8, 8)
    s2, c2 = vpt_scene_from_dict(scene_to_dict(scene, cam))
    assert vpt_scene_to_dict(s2, c2) == d_vpt
    assert np.array_equal(fld.params.numpy(),
                          np.asarray(s2.medium.density.params))


# ---- the primitives ------------------------------------------------------

PRIMS = ["grid_density", "grid_density_nearest", "grid_window", "grid_tau",
         "grid_sample_free_and_tau", "grid_pc_point", "grid_pc_density"]


@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("fn", PRIMS)
def test_grid_primitive(interp, fn):
    fc, gc = consts(interp)
    o, d, t, u = _rays(5)
    st = np.float32(0.044)
    ta = np.abs(t)
    oj, dj, ot, dt = _j(o), _j(d), _t(o), _t(d)
    tj = jnp.asarray(t.reshape(32, 128))
    taj, tat = jnp.asarray(ta.reshape(32, 128)), torch.from_numpy(ta)
    if fn in ("grid_density", "grid_density_nearest"):
        x = (o + ta * d).astype(np.float32)
        a = getattr(jp, fn)(fc, _j(x))
        _ulp1(a, getattr(tp, fn)(gc, _t(x)), fn)
    elif fn == "grid_window":
        a = jp.grid_window(fc, oj, dj)
        for k, (x, y) in enumerate(zip(a, tp.grid_window(gc, ot, dt))):
            _ulp1(x, y, f"window {k}")
    elif fn == "grid_tau":
        a = jax.jit(lambda o_, d_, t_: jp.grid_tau(fc, st, o_, d_, t_))(
            oj, dj, tj)
        b = tp.grid_tau(gc, st, ot, dt, torch.from_numpy(t))
        _close(a, b, fn)
        assert ((b.numpy() >= 0) == (t >= 0)).all()   # odd in t
    elif fn == "grid_sample_free_and_tau":
        cap = np.where(np.arange(N) % 4 == 0, 1e8, ta).astype(np.float32)
        a = jax.jit(lambda o_, d_, u_, c_: jp.grid_sample_free_and_tau(
            fc, st, o_, d_, u_, c_))(oj, dj, jnp.asarray(u.reshape(32, 128)),
                                     jnp.asarray(cap.reshape(32, 128)))
        b = tp.grid_sample_free_and_tau(gc, st, ot, dt, torch.from_numpy(u),
                                        torch.from_numpy(cap))
        ds_a, ds_b = _flat(a[0]), b[0].numpy()
        assert (ds_a == 1e8).any() and (ds_a < 1e8).any()
        assert np.array_equal(ds_a == 1e8, ds_b == 1e8)
        close = np.isclose(ds_b, ds_a, rtol=1e-5, atol=0.0)
        assert close.mean() >= 0.999, close.mean()
        _close(a[1], b[1], "tau(t_cap)")
    elif fn == "grid_pc_point":
        x, rho = jp.grid_pc_point(fc, oj, dj, taj)
        xt, rt = tp.grid_pc_point(gc, ot, dt, tat)
        for k in range(3):
            _ulp1(x[k], xt[k], f"point {k}")
        _ulp1(rho, rt, "rho")
    else:
        a = jax.jit(lambda o_, d_, t_: jp.grid_pc_density(fc, o_, d_, t_))(
            oj, dj, taj)
        _close(a, tp.grid_pc_density(gc, ot, dt, tat), fn)


# ---- the scatter against autodiff -----------------------------------------

# (function, interpolant): the march scatters the transport interpolant only
SCATTERS = [("grid_scatter_point", "tri"), ("grid_scatter_point", "nearest"),
            ("grid_scatter_point", "tri_override"),
            ("grid_march_scatter", "tri"), ("grid_march_scatter", "nearest")]


@pytest.mark.parametrize("fn,interp", SCATTERS)
def test_grid_scatter_matches_autodiff(fn, interp):
    """The port's plain scatters (the kernel's is the same arithmetic,
    csrc/grid.cuh, held to them on the card) against w times vpt's
    autodiff of its density model with respect to the voxel values."""
    transport = "tri" if interp == "tri" else "nearest"
    fc, gc = consts(transport)
    field = vpt_grid_cloud(transport).medium.density
    o, d, t, _ = _rays(9)
    n = 512
    o, d, ta = o[:, :n], d[:, :n], np.abs(t[:n])
    w = np.random.RandomState(3).normal(size=n).astype(np.float32)
    g = torch.zeros(int(np.prod(gc.dims)), dtype=torch.float32)
    if fn == "grid_scatter_point":
        x = (o + ta * d).astype(np.float32)
        tp.grid_scatter_point(gc, _t(x), torch.from_numpy(w), g,
                              interp="tri" if interp == "tri_override"
                              else None)
        if interp == "nearest":
            def f(p):
                fld = dataclasses.replace(field, params=p)
                return jnp.sum(jnp.asarray(w) * vdf._pc_eval(
                    fld, jnp.asarray(x.T)))
        else:
            def f(p):
                fld = dataclasses.replace(field, params=p)
                return jnp.sum(jnp.asarray(w) * vdf.density(
                    fld, jnp.asarray(x.T)))
    else:
        t2 = (ta * np.random.RandomState(4).uniform(0, 2, n)).astype(
            np.float32)
        w2 = np.random.RandomState(5).normal(size=n).astype(np.float32)
        tp.grid_march_scatter(gc, _t(o), _t(d), torch.from_numpy(w),
                              torch.from_numpy(ta), torch.from_numpy(w2),
                              torch.from_numpy(t2), g)

        def f(p):
            fld = dataclasses.replace(field, params=p)
            oo, dd = jnp.asarray(o.T), jnp.asarray(d.T)
            return (jnp.sum(jnp.asarray(w) * vdf._grid_tau_nonneg(
                fld, 1.0, oo, dd, jnp.asarray(ta)))
                + jnp.sum(jnp.asarray(w2) * vdf._grid_tau_nonneg(
                    fld, 1.0, oo, dd, jnp.asarray(t2))))
    want = np.asarray(jax.grad(f)(jnp.asarray(field.params, jnp.float32)))
    _close(want, g.numpy().reshape(gc.dims), fn, rtol=1e-6)
    assert np.abs(want).max() > 0


# ---- K1 on a grid --------------------------------------------------------

@pytest.fixture(scope="module")
def vpt_image():
    scene = vpt_scene_to_dict(vpt_grid_cloud(), vpt.default_camera())
    job = dict(scene=scene, width=W, height=H, spp=SPP, max_bounces=MB,
               sampler="ld", nee=True, distance="free", physical=False,
               seed=SEED)
    return jax_reference([job])[0]


def test_render_plain_matches_vpt(vpt_image):
    scene, cam = port_scene()
    pk = wf.pack_scene(scene, cam, W, H, SPP, max_bounces=MB, sampler="ld")
    stats = {}
    out = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32),
                               stats).numpy()
    ref = vpt_image.reshape(-1, 3)
    assert np.isfinite(out).all() and (out >= 0).all() and ref.max() > 0
    rel = np.abs(out - ref) / max(1.0, float(np.abs(ref).max()))
    assert np.quantile(rel, 0.99) <= Q99_TOL, np.quantile(rel, 0.99)
    flips = np.flatnonzero(np.abs(out - ref).max(-1)
                           / np.maximum(1.0, np.abs(ref).max(-1)) > FLIP_TOL)
    assert flips.size == 0, flips
    assert stats["taus"] > 0     # the marches the threads run
