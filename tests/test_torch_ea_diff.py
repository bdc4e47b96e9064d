"""vpt_torch.kernels.diff against vpt's differentiable pair in the
estimators beyond free-flight NEE: equi-angular distances (homogeneous, in
an analytic field with the traced g and falloff, and under diff_grid), the
physical credit, the implicit estimator (nee=False) and material-3 shells;
one equi-angular make_grid_train_step step; and port-only checks of the
same paths.

vpt's four pairs run in interpret mode in ONE subprocess (XLA:CPU capped
at AVX, no Eigen pool: tests/test_torch_wavefront.reference_env), seed 3,
6 bounces, 4 spp:
  1. "ea": cornell_vpt, distance="equiangular" with NEE, isotropic, "ld",
     16x8;
  2. "fog": foggy_cornell at g = 0.5, equi-angular with NEE and
     physical=True, diff_g + diff_field, "random", 16x8: the field's
     equi-angular chains, the traced HG g under equi-angular, the physical
     credit;
  3. "grid": grid_cloud (tests/test_torch_grid.port_scene: 8^3, n_march 8,
     trilinear) at a baked g = 0.5, equi-angular with diff_grid, "ld",
     16x8: the Bernoulli voxel scores, the t_xt chain with its reversed
     march, the 1/pSuccess chain, the trilinear sigma_s(xt) scatter, HG in
     a grid;
  4. "shell": medium_shell with its radius-2 lamp made a radius-25 dome in
     the ceiling (an implicit estimator credits emitters only where a path
     hits one: the scene's own lamps are a point and a radius-2 sphere,
     which no path of a small frame hits), nee=False, physical=True, free
     flight, "random", at 32x32: vpt's tile is 1024 lanes at tile_rows 8,
     so this frame costs its compile and run no more than 16x8.
vpt's make_diff_renderer is memoized on its arguments in the subprocess:
the equi-angular make_grid_train_step (two views that share the default
camera) reuses pair 3.

Criteria (tests/test_torch_grid_diff.py's and test_torch_hg_diff.py's):
  - image: a lane more than 1e-4 of its own scale, max(1, |ref lane|max),
    apart took another branch of a discrete event (a flip lane: an ulp of
    an XLA transcendental against torch's decides a Bernoulli, visibility
    or Fresnel choice); at most MAX_FLIPS of them, named in the messages,
    their cotangent zeroed on both sides; over the other lanes
    quantile(|a - b| / max(1, |ref|max), 0.99) <= 1e-5;
  - the P-vector: every entry within GRAD_TOL of sum_lanes |G_lane, k|;
  - the voxel gradient: every voxel within 1e-5 of the sum of the absolute
    values of the terms the port's plain version adds to it plus 1e-5 of
    the largest such sum (test_torch_grid_diff.py says why the second
    term);
  - the step: test_torch_grid_diff.py's bounds.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

import vpt_torch
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import prims as tp
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

from test_torch_grid import port_scene
from test_torch_wavefront import REFERENCE_TIMEOUT_S, reference_env

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPP, MB, SEED = 4, 6, 3
Q99_TOL = 1e-5
FLIP_TOL = 1e-4
GRAD_TOL = 1e-5         # of sum_lanes |G_lane, k| and of a voxel's sum |terms|
MAX_FLIPS = 4           # measured: ea [73], fog [65 73 89 106], none else
V = 2                   # views of the grid step
LR, REG_L1, REG_TV = 3e-2, 2e-3, 1e-3
BASE_KEYS = ("sigma_a", "sigma_s", "albedo", "radiance")


def with_g(scene, g):
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(g)))


def shell_scene():
    """medium_shell with its radius-2 lamp (sphere 8) a radius-25 dome
    centred on the ceiling."""
    d = scene_to_dict(vpt_torch.scene.scene.medium_shell())
    d["spheres"][8].update(radius=25.0, center=[0.0, 40.8, 20.0])
    return scene_from_dict(d)[0]


# name -> (scene factory, traced flags, estimator, sampler, width, height)
JOBS = {
    "ea": (vpt_torch.cornell_vpt, {}, dict(distance="equiangular"), "ld",
           16, 8),
    "fog": (lambda: with_g(vpt_torch.SCENES["foggy_cornell"](), 0.5),
            dict(diff_g=True, diff_field=True),
            dict(distance="equiangular", physical=True), "random", 16, 8),
    "grid": (lambda: with_g(port_scene()[0], 0.5), dict(diff_grid=True),
             dict(distance="equiangular"), "ld", 16, 8),
    "shell": (shell_scene, {}, dict(nee=False, physical=True), "random",
              32, 32),
}


def job_inputs(name):
    """(scene, camera, packed, params, P-vector, table or None)."""
    make, traced, est, sampler, w, h = JOBS[name]
    scene = make()
    cam = port_scene()[1] if name == "grid" else vpt_torch.default_camera()
    dp = df.pack_diff(scene, cam, w, h, SPP, max_bounces=MB, sampler=sampler,
                      **traced, **est)
    params = df.pack_params(scene, with_g=traced.get("diff_g", False),
                            with_field=traced.get("diff_field", False),
                            with_grid=traced.get("diff_grid", False))
    tab = tp.grid_table(params["grid"]) if "grid" in params else None
    return scene, cam, dp, params, df._flatten(params, scene.count), tab


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


def _gbar(npix):
    return np.random.default_rng(0).standard_normal((npix, 3)).astype(
        np.float32)


def _step_inputs():
    w, h = JOBS["grid"][4:]
    rng = np.random.default_rng(1)
    targets = (0.5 * rng.random((V, w * h, 3))).astype(np.float32)
    weights = (1.0 / (targets.mean(-1, keepdims=True) + 0.05) ** 2).astype(
        np.float32)
    return targets, weights


_JAX_REF = r"""
import inspect, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import optax
import vpt.dist.tomography as vtomo
import vpt.kernels.diff as vd
from vpt.kernels.diff import pack_params
from vpt.scene.io import scene_from_dict
with open(sys.argv[1]) as f:
    job = json.load(f)
inp = np.load(job["inputs"])
# vpt's make_diff_renderer memoized on its arguments (defaults filled in):
# the grid step's views reuse the grid pair below
made, make = {}, vd.make_diff_renderer
sig = inspect.signature(make)

def make_diff_renderer(*args, **kw):
    bound = sig.bind(*args, **kw)
    bound.apply_defaults()
    key = tuple(id(v) if k in ("scene", "camera") else v
                for k, v in bound.arguments.items())
    if key not in made:
        made[key] = make(*args, **kw)
    return made[key]

vd.make_diff_renderer = make_diff_renderer
out = {}
scenes = {}
for name, spec in job["jobs"].items():
    scenes[name] = scene, cam = scene_from_dict(spec["scene"])
    tr = spec["traced"]
    render = make_diff_renderer(scene, cam, spec["width"], spec["height"],
                                job["spp"], max_bounces=job["max_bounces"],
                                sampler=spec["sampler"], tile_rows=8,
                                interpret=True, **tr, **spec["est"])
    params = pack_params(scene, with_g=tr.get("diff_g", False),
                         with_field=tr.get("diff_field", False),
                         with_grid=tr.get("diff_grid", False))
    img, vjp = jax.vjp(render, params, jnp.int32(job["seed"]))
    img = np.asarray(img)
    rel = (np.abs(img - inp[name + "_port_img"]).max(-1)
           / np.maximum(1.0, np.abs(img).max(-1)))
    flip = np.flatnonzero(rel > job["flip_tol"])
    gbar = inp[name + "_gbar"].copy()
    gbar[flip] = 0.0
    g = vjp(jnp.asarray(gbar))[0]
    out[name + "_img"] = img
    out[name + "_flip"] = flip
    out[name + "_grad"] = np.concatenate(
        [np.asarray(g[k]).reshape(-1) for k in spec["keys"]])
    if "grid" in g:
        out[name + "_grid_grad"] = np.asarray(g["grid"])

# one equi-angular grid step, two views on the grid pair's camera
scene, cam = scenes["grid"]
spec = job["jobs"]["grid"]
keep = optax.GradientTransformation(
    lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
    lambda g, s, p=None: (g, g))
opt = optax.chain(keep, optax.adam(job["lr"]))
V, W, H = job["views"], spec["width"], spec["height"]
step = vtomo.make_grid_train_step(
    scene, [cam] * V, W, H, job["spp"], opt, max_bounces=job["max_bounces"],
    backend="kernel", sampler="ld", reg_l1=job["reg_l1"],
    reg_tv=job["reg_tv"], distance="equiangular", interpret=True)
renders = inspect.getclosurevars(step.__wrapped__).nonlocals["renders"]
assert all(r is renders[0] for r in renders)
params = pack_params(scene, with_grid=True)
weights = inp["weights"].copy()
s = job["seed"]
for v in range(V):
    for j in range(2):
        r = np.asarray(renders[v](params, jnp.int32(s * 2 * V + 2 * v + j)))
        rl = (np.abs(r - inp["step_imgs"][v, j]).max(-1)
              / np.maximum(1.0, np.abs(r).max(-1)))
        weights[v, rl > job["flip_tol"]] = 0.0
vals = params["grid"]
new, state, loss = step.__wrapped__(vals, opt.init(vals),
                                    jnp.asarray(inp["targets"]),
                                    jnp.asarray(weights), jnp.int32(s))
out.update(step_loss=np.float32(loss), step_grad=np.asarray(state[0]),
           step_new=np.asarray(new), step_weights=weights)
np.savez(job["out"], **out)
"""


def _keys(traced):
    keys = list(BASE_KEYS)
    if traced.get("diff_g"):
        keys.append("g")
    if traced.get("diff_field"):
        keys.append("fog_k")
    return keys


@pytest.fixture(scope="module")
def ref():
    """vpt's images, flip lanes, gradients and grid step, from one
    subprocess."""
    arrays, jobs = {}, {}
    for name, (_, traced, est, sampler, w, h) in JOBS.items():
        scene, cam, dp, _, pvec, tab = job_inputs(name)
        arrays[name + "_port_img"] = df.diff_fwd_plain(
            dp, pvec, _seed(SEED), tab=tab).numpy()
        arrays[name + "_gbar"] = _gbar(dp.npix)
        jobs[name] = dict(scene=scene_to_dict(scene, cam), traced=traced,
                          est=est, sampler=sampler, width=w, height=h,
                          keys=_keys(traced))
    _, _, dp, _, pvec, tab = job_inputs("grid")
    arrays["step_imgs"] = np.stack([np.stack([
        df.diff_fwd_plain(dp, pvec, _seed(SEED * 2 * V + 2 * v + j),
                          tab=tab).numpy() for j in range(2)])
        for v in range(V)])
    arrays["targets"], arrays["weights"] = _step_inputs()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, **arrays)
        job = dict(inputs=inputs, out=os.path.join(tmp, "out.npz"),
                   jobs=jobs, spp=SPP, max_bounces=MB, seed=SEED,
                   flip_tol=FLIP_TOL, views=V, lr=LR, reg_l1=REG_L1,
                   reg_tv=REG_TV)
        spec = os.path.join(tmp, "job.json")
        with open(spec, "w") as f:
            json.dump(job, f)
        # at the normal priority, unlike the other reference subprocesses:
        # its worker waits for it, and at the lowest one it waited 927 s
        # instead of about 250 s in a tier-1 run, holding a worker slot
        # the suite's last files need (its four compiles are its CPU)
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec],
                             cwd=REPO, env=reference_env(),
                             capture_output=True, text=True,
                             timeout=REFERENCE_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(job["out"]) as z:
            return {k: z[k] for k in z.files}


@pytest.mark.parametrize("job", list(JOBS))
def test_fwd_plain_matches_vpt(ref, job):
    _, _, dp, _, pvec, tab = job_inputs(job)
    out = df.diff_fwd_plain(dp, pvec, _seed(SEED), tab=tab).numpy()
    img = ref[job + "_img"]
    assert np.isfinite(out).all() and np.abs(img).max() > 0
    rel = np.abs(out - img) / max(1.0, float(np.abs(img).max()))
    flip = ref[job + "_flip"]
    keep = np.ones(len(img), bool)
    keep[flip] = False
    q = np.quantile(rel[keep], 0.99)
    assert q <= Q99_TOL, (q, f"flip lanes {flip}")
    assert len(flip) <= MAX_FLIPS, f"flip lanes {flip}"


def _port_grads(ref, job):
    _, _, dp, _, pvec, tab = job_inputs(job)
    gbar = _gbar(dp.npix)
    gbar[ref[job + "_flip"]] = 0.0
    out = df.diff_bwd_plain(dp, pvec, _seed(SEED), torch.from_numpy(gbar),
                            per_lane=True, tab=tab, voxel_abs=True)
    return dp, out


@pytest.mark.parametrize("job", list(JOBS))
def test_bwd_plain_matches_vpt_per_entry(ref, job):
    dp, out = _port_grads(ref, job)
    G = (out[0] if dp.diff_grid else out).numpy()
    assert G.shape == (dp.npix, dp.P) and np.isfinite(G).all()
    g = G.sum(0, dtype=np.float64)
    scale = np.abs(G).sum(0, dtype=np.float64)
    want = ref[job + "_grad"]
    err = np.abs(g - want)
    bad = np.flatnonzero(err > GRAD_TOL * scale)
    assert bad.size == 0, (f"flip lanes {ref[job + '_flip']}", bad, err[bad],
                           scale[bad])
    assert np.array_equal(scale == 0.0, want == 0.0)
    assert scale[0] > 0 and scale[1] > 0      # the sigma slots carry one
    if dp.hg_mode == df.HG_TRACED:
        assert scale[dp.IG] > 0 and scale[dp.IK] > 0


def test_ea_voxel_grad_matches_vpt(ref):
    _, (_, gg, gabs) = _port_grads(ref, "grid")
    gg, gabs = gg.numpy(), gabs.numpy()
    want = ref["grid_grid_grad"]
    assert gg.shape == want.shape == (8, 8, 8)
    assert np.isfinite(gg).all() and np.abs(want).max() > 0
    err = np.abs(gg - want)
    bad = np.argwhere(err > GRAD_TOL * (gabs + gabs.max()))
    assert bad.size == 0, (f"flip lanes {ref['grid_flip']}", bad[:8],
                           err[tuple(bad[:8].T)], gabs[tuple(bad[:8].T)])


def test_ea_grid_train_step_matches_vpt(ref):
    """One make_grid_train_step step with distance="equiangular" against
    vpt's own step (its __wrapped__ body; a pass-through chained before
    Adam keeps the gradient), the weights zeroed on each view's flip
    lanes: loss, voxel gradient and updated values at
    test_torch_grid_diff.py's bounds."""
    scene, cam, _, _, _, _ = job_inputs("grid")
    w, h = JOBS["grid"][4:]
    targets, _ = _step_inputs()
    values = scene.medium.density.params.clone().requires_grad_()
    opt = vpt_torch.dist.adam({"grid": values}, LR)
    step = vpt_torch.dist.make_grid_train_step(
        scene, [cam] * V, w, h, SPP, opt, max_bounces=MB, sampler="ld",
        reg_l1=REG_L1, reg_tv=REG_TV, distance="equiangular", device="cpu")
    start = values.detach().clone()
    loss = float(step(values, torch.from_numpy(targets),
                      torch.from_numpy(ref["step_weights"]), SEED))
    ref_loss = float(ref["step_loss"])
    assert abs(loss - ref_loss) <= 1e-3 * abs(ref_loss), (loss, ref_loss)
    grad = values.grad.numpy()
    ref_g = ref["step_grad"]
    assert np.isfinite(grad).all() and np.abs(ref_g).max() > 0
    err = np.abs(grad - ref_g)
    bad = np.argwhere(err > np.maximum(2e-2 * np.abs(ref_g),
                                       1e-2 * np.abs(ref_g).max()))
    assert bad.size == 0, (bad[:8], grad[tuple(bad[:8].T)],
                           ref_g[tuple(bad[:8].T)])
    new = values.detach().numpy()
    sure = np.abs(ref_g) > 1e-3 * np.abs(ref_g).max()
    assert np.abs(new - ref["step_new"])[sure].max() <= 1e-6
    assert np.abs(new - start.numpy()).max() <= LR * 1.001


# ---- port-only ---------------------------------------------------------

# every estimator the pair now takes beyond free-flight NEE: (scene, g,
# traced, estimator, sampler)
VARIANTS = [
    ("cornell_vpt", 0.0, {}, dict(distance="equiangular"), "random"),
    ("cornell_vpt", 0.5, {}, dict(distance="equiangular"), "ld"),
    ("cornell_vpt", 0.0, {}, dict(physical=True), "ld"),
    ("shell", 0.0, {}, dict(nee=False, physical=True), "ld"),
    ("shell", 0.0, {}, dict(nee=False, physical=True,
                            distance="equiangular"), "random"),
    ("medium_shell", 0.0, {}, {}, "random"),
    ("foggy_cornell", 0.0, dict(diff_field=True),
     dict(distance="equiangular"), "ld"),
    ("blob_cloud", 0.5, dict(diff_blobs=True),
     dict(nee=False, physical=True, distance="equiangular"), "random"),
    ("grid", 0.0, dict(diff_grid=True), dict(distance="equiangular"),
     "random"),
    ("grid", 0.5, dict(diff_grid=True), {}, "ld"),
    ("grid", 0.0, {}, dict(nee=False, physical=True), "ld"),
]


def variant_inputs(case, w=16, h=8):
    name, g, traced, est, sampler = case
    if name == "grid":
        scene, cam = port_scene()
    elif name == "shell":
        scene, cam = shell_scene(), vpt_torch.default_camera()
    else:
        scene, cam = vpt_torch.SCENES[name](), vpt_torch.default_camera()
    scene = with_g(scene, g) if g else scene
    dp = df.pack_diff(scene, cam, w, h, SPP, max_bounces=MB, sampler=sampler,
                      **traced, **est)
    params = df.pack_params(scene, with_g=False,
                            with_field=traced.get("diff_field", False),
                            with_blobs=traced.get("diff_blobs", False),
                            with_grid=traced.get("diff_grid", False))
    tab = tp.grid_table(params["grid"]) if "grid" in params else None
    return scene, cam, dp, df._flatten(params, scene.count), tab


def _case_id(c):
    return "-".join([c[0], f"g{c[1]}", *c[2], *(f"{k}={v}" for k, v in
                                                c[3].items()), c[4]])


@pytest.mark.parametrize("case", VARIANTS, ids=[_case_id(c) for c in
                                                VARIANTS])
def test_pair_image_matches_k1(case):
    """vpt's contract 1: the pair's image is K1's under the same estimator
    (K1's plain version; the two round the traced sigma, g and field
    constants differently) within 1e-5 of its scale."""
    _, _, dp, pvec, tab = variant_inputs(case)
    assert dp.ext and dp.entries[0].endswith("_ext")
    img = df.diff_fwd_plain(dp, pvec, _seed(SEED), tab=tab)
    k1 = wf.render_tile_plain(dp.pk, _seed(SEED))
    assert torch.isfinite(img).all()
    scale = max(1.0, float(k1.abs().max()))
    assert float((img - k1).abs().max()) <= 1e-5 * scale


def test_ea_diff_grid_fwd_equals_baked_ea_fwd():
    """The table rebuilt from the "grid" leaf gives the baked grid's
    equi-angular image bit for bit."""
    case = ("grid", 0.5, dict(diff_grid=True), dict(distance="equiangular"),
            "ld")
    _, _, dp, pvec, tab = variant_inputs(case)
    _, _, dpb, pvb, _ = variant_inputs((*case[:2], {}, *case[3:]))
    assert dp.diff_grid and not dpb.diff_grid
    assert torch.equal(df.diff_fwd_plain(dp, pvec, _seed(SEED), tab=tab),
                       df.diff_fwd_plain(dpb, pvb, _seed(SEED)))


def test_physical_credits_emission_times_inv_cp():
    """physical=True multiplies each credited emission and its radiance
    gradient by 1/cp: one emitter filling the view in a near-vacuum, where
    every sample that survives its first roulette ends on it."""
    white = (0.0, 0.0, 0.0)
    scene = vpt_torch.make_scene(
        [(150.0, (0.0, 0.0, 0.0), white, (1.0, 2.0, 3.0), 0, white, white,
          0.0)], sigma_a=1e-7, sigma_s=1e-7)
    cam = vpt_torch.default_camera()
    pvec = df._flatten(df.pack_params(scene), scene.count)
    gbar = torch.from_numpy(_gbar(32))
    out = {}
    for phys in (False, True):
        dp = df.pack_diff(scene, cam, 8, 4, SPP, max_bounces=MB,
                          sampler="random", physical=phys)
        out[phys] = (df.diff_fwd_plain(dp, pvec, _seed(SEED)),
                     df.diff_bwd_plain(dp, pvec, _seed(SEED), gbar))
    inv_cp = dp.pk.inv_cp
    img0, img1 = out[False][0], out[True][0]
    assert float(img0.max()) > 0.0
    assert torch.allclose(img1, img0 * inv_cp, rtol=1e-6, atol=0.0)
    rad = slice(2 + 3, 2 + 6)
    g0, g1 = out[False][1][rad], out[True][1][rad]
    assert float(g0.abs().min()) > 0.0
    assert torch.allclose(g1, g0 * inv_cp, rtol=1e-6, atol=0.0)


# the PCG draws one iteration of a lane takes: "random" draws the camera's
# u, v; free flight u_rr, u_pick, u_dist; equi-angular u_ev too; with NEE
# 3 per MIS light and 3 more, and the medium NEE cone's 2; always the
# BSDF's 3 and the phase's 2
@pytest.mark.parametrize("sampler,distance,draws", [
    ("ld", "free", 8), ("random", "free", 10), ("ld", "equiangular", 9),
    ("random", "equiangular", 11)])
def test_implicit_draw_count(monkeypatch, sampler, distance, draws):
    """nee=False takes no pLight, MISv2 or medium-NEE draw, as K1's
    implicit variants (vpt/kernels/diff.py:854, 972); cornell_vpt takes
    20 ("ld") and 22 ("random") per iteration with equi-angular NEE."""
    calls = []
    real = tp.Pcg.__call__

    def counted(self):
        calls.append(1)
        return real(self)

    monkeypatch.setattr(tp.Pcg, "__call__", counted)
    scene = vpt_torch.cornell_vpt()
    for nee, n in ((False, draws), (True, draws + 3 * 2 + 3 + 2)):
        dp = df.pack_diff(scene, vpt_torch.default_camera(), 1, 1, 2,
                          max_bounces=2, sampler=sampler, nee=nee,
                          physical=True, distance=distance)
        calls.clear()
        stats = {}
        df.diff_fwd_plain(dp, df._flatten(df.pack_params(scene),
                                          scene.count), _seed(SEED), stats)
        # "ld" also draws its 5 Cranley-Patterson offsets once per lane,
        # from another stream
        offsets = 5 if sampler == "ld" else 0
        assert len(calls) == offsets + n * stats["thread_iters"], (nee, n)
    assert len(scene.mis_light_idx) == 2


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_non_physical_implicit_is_refused(device):
    """vpt's own refusal (vpt/kernels/diff.py:227-232), before any device
    check."""
    with pytest.raises(NotImplementedError, match="physical=True or "
                                                  "nee=True"):
        df.make_diff_renderer(vpt_torch.cornell_vpt(),
                              vpt_torch.default_camera(), 8, 4, 1, nee=False,
                              physical=False, device=device)


def test_diff_params_layout():
    """DiffParams (csrc/diff_path.cuh) after VptParams' 616 words: cp and
    1/spp, then P, the albedo and lambert masks, n_fp, fp_kind, hg_mode,
    diff_grid, and the estimator's distance, nee and physical: 628 words.
    Any distance other than "free" packs vpt's equi-angular branch."""
    scene = vpt_torch.cornell_vpt()
    cam = vpt_torch.default_camera()
    for kw, tail in ((dict(), [0, 1, 0]),
                     (dict(distance="equiangular"), [1, 1, 0]),
                     (dict(distance="ea_clamped", nee=False, physical=True),
                      [1, 0, 1])):
        dp = df.pack_diff(scene, cam, 8, 4, 1, **kw)
        words = dp.words()
        assert words.dtype == np.int32 and words.size == 616 + 2 + 10
        assert list(words[-3:]) == tail
        assert dp.ext == bool(kw)
    assert df.pack_diff(scene, cam, 8, 4, 1).entries == ("vpt_diff_fwd",
                                                         "vpt_diff_bwd")


def test_fog_k_derivative_guard():
    """field_tau_dk's overflow guard (the extended instantiations): far
    below the fog plane, where an equi-angular path that left the box
    scatters (1024x1024x64 on foggy_cornell: 81 of 2^20 lanes), a0 d0 and
    a1 d1 overflow f32 and vpt's form gives NaN; guarded, it is finite, and
    on ordinary rays the two agree bit for bit."""
    fc = vpt_torch.kernels.wavefront.pack_scene(
        vpt_torch.SCENES["foggy_cornell"](), vpt_torch.default_camera(), 8,
        4, 1).field
    far = ([torch.tensor([0.0])] + [torch.tensor([-12653.4])]
           + [torch.tensor([5.0e4])])
    d = [torch.tensor([0.9]), torch.tensor([-0.41444719]),
         torch.tensor([0.1])]
    t = torch.tensor([33699.7])
    assert torch.isnan(tp.field_tau_dk(fc, far, d, t)).all()
    assert torch.isfinite(tp.field_tau_dk(fc, far, d, t, guard=True)).all()
    rng = np.random.default_rng(0)
    o = [torch.from_numpy(rng.uniform(-40, 40, 256).astype(np.float32))
         for _ in range(3)]
    dd = [torch.from_numpy(x.astype(np.float32))
          for x in rng.normal(size=(3, 256))]
    n = torch.sqrt(dd[0] ** 2 + dd[1] ** 2 + dd[2] ** 2)
    dd = [x / n for x in dd]
    tt = torch.from_numpy(rng.uniform(-100, 300, 256).astype(np.float32))
    assert torch.equal(tp.field_tau_dk(fc, o, dd, tt),
                       tp.field_tau_dk(fc, o, dd, tt, guard=True))
