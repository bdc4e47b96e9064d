"""vpt_torch.kernels.diff against vpt's differentiable pair with the
Henyey-Greenstein anisotropy: foggy_cornell at g = 0.5 with diff_g and
diff_field (examples/recover_fog_multiview.py's pair), and cornell_vpt at a
baked g = 0.5 (no g leaf), sampler "ld"; one two-view
make_multiview_train_step step against vpt's; and the traced HG
primitives against vpt's.

vpt's pairs run in interpret mode in ONE subprocess, with XLA's CPU code
generation capped at AVX (no FMA) and its Eigen pool off (see
tests/test_torch_wavefront.reference_env), at 16x8, 4 spp, max_bounces 6,
seed 3. The criteria are tests/test_torch_hetero_diff.py's:
  - image: quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4;
  - flip lanes: a lane more than 1e-4 of ITS OWN scale, max(1, |ref
    lane|max), apart took another branch of a discrete event (an ulp of an
    XLA transcendental against torch's). Measured: lanes 74 and 89 (6.1e-4
    of their own scale apart, image q99 1.0e-7 over the rest); the test
    allows at most 3 and names them in its message;
  - gradient (the packed P + 2 vector of sum(image * gbar): g at 2 + 6S,
    fog_k after it; gbar from np.random.default_rng(0)): vpt zeroes gbar on
    the flip lanes, the port sums its per-lane rows over the other lanes,
    and each entry must agree within 2e-4 of sum_lanes |G_lane, k|. The g
    slot folds its phase-draw scores as A_g L - B_g and cancels like
    sigma's, which is why the flips are flagged per lane. Measured: every
    entry within 1.4e-5 of its scale. The baked-g pair is held to the
    same criteria (measured: no flip lane, image q99 5.7e-7, every entry
    within 2.7e-6 of its scale).

The multi-view step: vpt's make_multiview_train_step (jitted as vpt
builds it) and the port's, on the fog with diff_g + diff_field and the
log-space medium, over two cameras at 16x8, 8 spp per view (two renders
of 4), seed 3 (view seeds 12-15), the same random targets and fixed
relMSE weights, from the same start. vpt's optimizer is
optax.chain(a pass-through that keeps the gradient in its state,
optax.adam(LR)), the port's torch.optim.Adam(LR), so the step's gradient
(in optimizer space) is compared as well as its loss and its updated
leaves. The pixel weights are zeroed on each view's flip lanes (vpt's
step's own renderers at its seeds against the port's; measured: 4 lanes
per view, up to 0.15 apart, which alone moved the loss by 2.3e-3). Bounds:
loss 1e-5 relative; gradient 1e-3 relative or 1e-4 of its leaf's largest
entry, exact zeros exact; the updated leaves (optimizer space) within
MV_PARAM_TOL where the gradient is sure (above 1e-3 of its leaf's
largest), elsewhere moved by at most LR. Measured: loss 7.8e-7 apart,
gradient 3.5e-5 (fog_k), updated leaves 1.9e-9.

The primitives (hg_phase_traced, hg_dir_traced, dlog_hg_dg) run eagerly
in this process against vpt's hg_phase_const (at a traced g),
hg_dir_traced and dlog_hg_dg, with tests/test_torch_prims.py's tolerances
(rtol 1e-5, atol 1e-6): the same f32 operations, XLA's and torch's sqrt,
rsqrt, sin and cos an ulp apart on some inputs.
"""
import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vpt.kernels import prims as jp

import vpt_torch
from vpt_torch.dist import train_fast as tf
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import prims as tp
from vpt_torch.scene.camera import look_at
from vpt_torch.scene.io import scene_to_dict
from test_torch_wavefront import REFERENCE_TIMEOUT_S, reference_env

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB, SEED, G = 16, 8, 4, 6, 3, 0.5
Q99_TOL = 1e-4
FLIP_TOL = 1e-4         # a lane above this image error took another branch
GRAD_TOL = 2e-4         # of sum_lanes |G_lane, k|
KEYS = ("sigma_a", "sigma_s", "albedo", "radiance", "g", "fog_k")
BAKED_KEYS = ("sigma_a", "sigma_s", "albedo", "radiance")
LR = 1e-2               # the multi-view step's Adam rate
MV_PARAM_TOL = 1e-6     # updated leaves in optimizer space, where g is sure

# vpt's pairs: for each job (the fog with diff_g + diff_field, the baked g)
# the image and the gradient of sum(image * gbar) with gbar zeroed on the
# flip lanes; then one multi-view step
_JAX_REF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import inspect
import optax
import vpt.dist.train_fast as vtf
import vpt.kernels.diff as vd
from vpt.dist.train_fast import make_multiview_train_step
from vpt.kernels.diff import pack_params
from vpt.scene.io import scene_from_dict
with open(sys.argv[1]) as f:
    job = json.load(f)
# vpt's make_diff_renderer memoized on its arguments (defaults filled in):
# the multi-view step's first view is the fog pair below, whose kernels
# then compile once
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

vd.make_diff_renderer = vtf.make_diff_renderer = make_diff_renderer
inp = np.load(job["inputs"])
W, H, MB = job["width"], job["height"], job["max_bounces"]
flat = lambda g, keys: np.concatenate([np.asarray(g[k]).reshape(-1)
                                       for k in keys])
out = {}
scenes, pairs = {}, {}
for name, traced in (("fog", True), ("baked", False)):
    scenes[name] = scene, cam = scene_from_dict(job[name])
    render = make_diff_renderer(scene, cam, W, H, job["spp"],
                                max_bounces=MB, sampler="ld", tile_rows=8,
                                diff_g=traced, diff_field=traced,
                                interpret=True)
    pairs[name] = render
    params = pack_params(scene, with_g=traced, with_field=traced)
    img, vjp = jax.vjp(render, params, jnp.int32(job["seed"]))
    img = np.asarray(img)
    rel = (np.abs(img - inp[name + "_port_img"]).max(-1)
           / np.maximum(1.0, np.abs(img).max(-1)))
    flip = np.flatnonzero(rel > job["flip_tol"])
    gbar = inp["gbar"].copy()
    gbar[flip] = 0.0
    keys = job["keys"] if traced else job["baked_keys"]
    out.update({name + "_img": img, name + "_flip": flip,
                name + "_grad": flat(vjp(jnp.asarray(gbar))[0], keys)})

# one two-view step on the fog; the pass-through keeps the step's gradient
keep = optax.GradientTransformation(
    lambda p: jax.tree.map(jnp.zeros_like, p), lambda g, s, p=None: (g, g))
opt = optax.chain(keep, optax.adam(job["lr"]))
scene, cam = scenes["fog"]
cam2 = scene_from_dict(job["fog_cam2"])[1]
step = make_multiview_train_step(
    scene, [cam, cam2], W, H, 2 * job["spp"], opt, max_bounces=MB,
    tile_rows=8, sampler="ld", diff_g=True, diff_field=True,
    log_medium=True, interpret=True)
qp = step.to_opt(pack_params(scene, with_g=True, with_field=True))
# the weights are zeroed on each view's flip lanes, found by the step's own
# renderers at its seeds against the port's renders
renders = inspect.getclosurevars(step.__wrapped__).nonlocals["renders"]
assert renders[0] is pairs["fog"]
weights = inp["weights"].copy()
for v, render in enumerate(renders):
    for j in range(2):
        img = np.asarray(render(step.from_opt(qp),
                                jnp.int32(4 * job["seed"] + 2 * v + j)))
        rel = (np.abs(img - inp["mv_port_img"][v, j]).max(-1)
               / np.maximum(1.0, np.abs(img).max(-1)))
        weights[v, rel > job["flip_tol"]] = 0.0
# the step's body as vpt builds it, without its outer jit (each kernel
# stays jitted; as tests/test_torch_diff.py calls vpt's loss unjitted)
qp, state, loss = step.__wrapped__(
    qp, opt.init(qp), jnp.asarray(inp["targets"]), jnp.asarray(weights),
    jnp.int32(job["seed"]))
out.update(mv_loss=np.float32(loss), mv_grad=flat(state[0], job["keys"]),
           mv_new=flat(qp, job["keys"]), mv_weights=weights)
np.savez(job["out"], **out)
"""

CAM2 = look_at((35.0, 30.0, 180.0), (0.0, -10.0, 0.0))


def with_g(scene):
    return dataclasses.replace(scene, medium=dataclasses.replace(
        scene.medium, g=torch.tensor(G)))


def fog_scene():
    return with_g(vpt_torch.SCENES["foggy_cornell"]())


def baked_scene():
    return with_g(vpt_torch.cornell_vpt())


def packed(name="fog"):
    """(scene, packed, P-vector) of a job: "fog" traces g and the falloff,
    "baked" bakes g = 0.5 into cornell_vpt."""
    traced = name == "fog"
    scene = fog_scene() if traced else baked_scene()
    dp = df.pack_diff(scene, vpt_torch.default_camera(), W, H, SPP,
                      max_bounces=MB, sampler="ld", diff_g=traced,
                      diff_field=traced)
    pvec = df._flatten(df.pack_params(scene, with_g=traced,
                                      with_field=traced), scene.count)
    return scene, dp, pvec


def _gbar():
    return np.random.default_rng(0).standard_normal((W * H, 3)).astype(
        np.float32)


def _mv_inputs():
    """Two random targets and their fixed relMSE weights."""
    t = (0.5 * np.random.default_rng(1).random((2, W * H, 3))).astype(
        np.float32)
    return t, (1.0 / (t.mean(-1, keepdims=True) + 0.05) ** 2).astype(
        np.float32)


@pytest.fixture(scope="module")
def ref():
    """vpt's images, flip lanes, gradients and multi-view step, from one
    subprocess."""
    cam = vpt_torch.default_camera()
    port = {}
    for name in ("fog", "baked"):
        _, dp, pvec = packed(name)
        port[name + "_port_img"] = df.diff_fwd_plain(
            dp, pvec, torch.tensor([SEED], dtype=torch.int32)).numpy()
    targets, weights = _mv_inputs()
    # the two renders of each view of the multi-view step, at its seeds
    scene = fog_scene()
    p0 = tf._from_log(tf._to_log(df.pack_params(scene, with_g=True,
                                                with_field=True)))
    mv = np.zeros((2, 2, W * H, 3), np.float32)
    for v, c in enumerate((cam, CAM2)):
        r = df.make_diff_renderer(scene, c, W, H, SPP, max_bounces=MB,
                                  sampler="ld", diff_g=True, diff_field=True,
                                  device="cpu")
        with torch.no_grad():
            for j in range(2):
                mv[v, j] = r(p0, 4 * SEED + 2 * v + j).numpy()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, gbar=_gbar(), targets=targets, weights=weights,
                 mv_port_img=mv, **port)
        job = dict(inputs=inputs, out=os.path.join(tmp, "out.npz"),
                   fog=scene_to_dict(fog_scene(), cam),
                   fog_cam2=scene_to_dict(fog_scene(), CAM2),
                   baked=scene_to_dict(baked_scene(), cam),
                   width=W, height=H, spp=SPP, max_bounces=MB, seed=SEED,
                   flip_tol=FLIP_TOL, keys=KEYS, baked_keys=BAKED_KEYS,
                   lr=LR)
        spec = os.path.join(tmp, "job.json")
        with open(spec, "w") as f:
            json.dump(job, f)
        # at the normal priority, as test_torch_ea_diff.py's: at the lowest
        # one its worker waited 1043.5 s in a tier-1 run instead of 465.6 s,
        # and the file's 23 tests with it (the suite is CPU-bound, so the
        # priority moves no total time, only which tests finish first)
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec],
                             cwd=REPO, env=reference_env(),
                             capture_output=True, text=True,
                             timeout=REFERENCE_TIMEOUT_S)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(job["out"]) as z:
            return {k: z[k] for k in z.files}


@pytest.mark.parametrize("job", ["fog", "baked"])
def test_fwd_plain_matches_vpt(ref, job):
    _, dp, pvec = packed(job)
    if job == "fog":
        assert dp.hg_mode == df.HG_TRACED and dp.P == dp.IG + 2
    else:
        assert dp.hg_mode == df.HG_BAKED and dp.P == dp.IG
    out = df.diff_fwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32))
    assert out.shape == (W * H, 3) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    img = ref[job + "_img"]
    rel = np.abs(out - img) / max(1.0, float(np.abs(img).max()))
    assert np.quantile(rel, 0.99) < Q99_TOL, np.quantile(rel, 0.99)
    assert len(ref[job + "_flip"]) <= 3, f"flip lanes {ref[job + '_flip']}"


@pytest.mark.parametrize("job", ["fog", "baked"])
def test_bwd_plain_matches_vpt_per_entry(ref, job):
    """The P (+ 2) gradient: with diff_g the g and fog_k slots included."""
    _, dp, pvec = packed(job)
    G_ = df.diff_bwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32),
                           torch.from_numpy(_gbar()), per_lane=True).numpy()
    assert G_.shape == (W * H, dp.P) and np.isfinite(G_).all()
    flip, grad = ref[job + "_flip"], ref[job + "_grad"]
    keep = np.ones(W * H, bool)
    keep[flip] = False
    g = G_[keep].sum(0, dtype=np.float64)
    scale = np.abs(G_).sum(0, dtype=np.float64)
    err = np.abs(g - grad)
    bad = np.flatnonzero(err > GRAD_TOL * scale)
    assert bad.size == 0, (f"flip lanes {flip}", bad, err[bad], scale[bad])
    assert np.array_equal(scale == 0.0, grad == 0.0)
    if job == "fog":    # the g and fog_k slots carry a gradient
        assert scale[dp.IG] > 0 and scale[dp.IK] > 0


def _flat(d):
    return np.concatenate([d[k].detach().numpy().reshape(-1) for k in KEYS])


def test_multiview_step_matches_vpt(ref):
    """One make_multiview_train_step step, two views, log-space medium,
    diff_g + diff_field, fixed relMSE weights, torch.optim.Adam: loss,
    gradient in optimizer space and updated leaves against vpt's step
    (see the module docstring for the bounds)."""
    scene = fog_scene()
    targets, weights = _mv_inputs()
    flip = np.argwhere(ref["mv_weights"][..., 0] != weights[..., 0])
    assert len(flip) <= 12, f"flip lanes (view, lane) {flip.tolist()}"
    init = df.pack_params(scene, with_g=True, with_field=True)
    qp = {k: v.clone().requires_grad_()
          for k, v in tf._to_log(init).items()}
    start = _flat(qp)
    opt = torch.optim.Adam(list(qp.values()), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = tf.make_multiview_train_step(
        scene, [vpt_torch.default_camera(), CAM2], W, H, 2 * SPP, opt,
        max_bounces=MB, sampler="ld", diff_g=True, diff_field=True,
        log_medium=True, device="cpu")
    loss = float(step(qp, torch.from_numpy(targets),
                      torch.from_numpy(ref["mv_weights"]), SEED))
    ref_loss = float(ref["mv_loss"])
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
    grad = np.concatenate([qp[k].grad.numpy().reshape(-1) for k in KEYS])
    new = _flat(qp)
    ref_g, ref_new = ref["mv_grad"], ref["mv_new"]
    assert np.isfinite(grad).all() and np.isfinite(new).all()
    assert np.array_equal(grad == 0.0, ref_g == 0.0)
    sizes = [init[k].numel() for k in KEYS]
    leaf_max = np.concatenate([np.full(n, np.abs(part).max()) for n, part in
                               zip(sizes, np.split(np.abs(ref_g),
                                                   np.cumsum(sizes)[:-1]))])
    err = np.abs(grad - ref_g)
    bad = np.flatnonzero(err > np.maximum(1e-3 * np.abs(ref_g),
                                          1e-4 * leaf_max))
    assert bad.size == 0, (bad, grad[bad], ref_g[bad])
    sure = np.abs(ref_g) > 1e-3 * leaf_max
    assert np.abs(new - ref_new)[sure].max() <= MV_PARAM_TOL, np.abs(
        new - ref_new)[sure].max()
    assert np.abs(new - start)[~sure].max(initial=0.0) <= LR * 1.001


# ---- the traced HG primitives against vpt's --------------------------------

GS = [0.5, -0.3, 0.95, -0.95, 5e-4, 0.0]
N = 4096


def _inputs(seed):
    rng = np.random.default_rng(seed)
    u = rng.random((2, N)).astype(np.float32)
    d = rng.standard_normal((3, N))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    cos_t = rng.uniform(-1.0, 1.0, N).astype(np.float32)
    return u, d, cos_t


def _close(a, b, rtol=1e-5, atol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("g", GS)
def test_hg_phase_traced_matches_vpt(g):
    _, _, cos_t = _inputs(1)
    ours = tp.hg_phase_traced(torch.from_numpy(cos_t),
                              torch.tensor(g, dtype=torch.float32))
    theirs = jp.hg_phase_const(jnp.asarray(cos_t), jnp.float32(g))
    _close(ours.numpy(), theirs)


@pytest.mark.parametrize("g", GS)
def test_dlog_hg_dg_matches_vpt(g):
    _, _, cos_t = _inputs(2)
    ours = tp.dlog_hg_dg(torch.from_numpy(cos_t),
                         torch.tensor(g, dtype=torch.float32))
    theirs = jp.dlog_hg_dg(jnp.asarray(cos_t), jnp.float32(g))
    _close(ours.numpy(), theirs)
    if g == 0.0:        # exactly 3 cos at g == 0
        assert np.array_equal(ours.numpy(), (3.0 * torch.from_numpy(
            cos_t)).numpy())


@pytest.mark.parametrize("g", GS)
def test_hg_dir_traced_matches_vpt(g):
    u, d, _ = _inputs(3)
    gt = torch.tensor(g, dtype=torch.float32)
    ours = tp.hg_dir_traced([torch.from_numpy(c) for c in d], gt,
                            torch.from_numpy(u[0]), torch.from_numpy(u[1]))
    theirs = jp.hg_dir_traced([jnp.asarray(c) for c in d], jnp.float32(g),
                              jnp.asarray(u[0]), jnp.asarray(u[1]))
    for a, b in zip(ours, theirs):
        _close(a.numpy(), b, atol=1e-5)
    wi = np.stack([a.numpy() for a in ours])
    assert np.allclose(np.linalg.norm(wi, axis=0), 1.0, atol=1e-5)
    if abs(g) <= 1e-3:   # the isotropic snap draws uniform_sphere
        iso = tp.uniform_sphere(torch.from_numpy(u[0]),
                                torch.from_numpy(u[1]))
        for a, b in zip(ours, iso):
            assert torch.equal(a, b)
    else:                # the mean cosine to d is g
        cos = (wi * d).sum(0)
        assert abs(float(cos.mean()) - g) < 0.05
