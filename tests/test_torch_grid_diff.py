"""The differentiable pair on a voxel grid against vpt: diff_grid's image,
P-vector gradient and voxel gradient, one make_grid_train_step step, and
the port's guards and trainer.

vpt's side runs in ONE subprocess (XLA:CPU capped at AVX, no Eigen pool:
tests/test_torch_wavefront.reference_env) on grid_cloud (test_torch_grid:
blob_cloud rasterized onto an 8^3 grid, n_march 8, trilinear), 16x12, 4
spp per render, max_bounces 8, sampler "ld". It builds vpt's own
make_grid_train_step (backend "kernel", two views, L1 and TV priors) and
takes the pair from it (the step's first renderer): the image and the VJP
at seed 3, then one call of the step's body (its __wrapped__, so the
renderers' kernels stay jitted and compile once), with a pass-through
chained before Adam that keeps the gradient. The two views share the
default camera, and vpt's make_diff_renderer is memoized on its arguments
in the subprocess, so both views share one renderer and the pair compiles
once (the views still take their own seeds, seed * 2V + 2i and + 1).

Criteria:
  - image: quantile(|a - b| / max(1, |ref|max), 0.99) <= 1e-5; a lane more
    than 1e-4 of its own scale, max(1, |ref lane|max), apart took another
    branch (a flip lane: an ulp of an XLA transcendental against torch's
    decides an event; none at this seed). The cotangent is zeroed on both
    sides on the flip lanes and on VOXEL_FLIPS: lane 89, whose image and
    P-vector row agree but whose voxel terms differ by 3.6e-3 of their own
    scale (measured lane by lane; every other lane within 1.5e-3, most
    within 1e-4), the mark of one discrete choice of the scatter;
  - the P-vector: every entry within 1e-5 of sum_lanes |G_lane, k|;
  - the voxel gradient: every voxel within 1e-5 of the sum of the absolute
    values of the terms the port's plain version adds to it plus 1e-5 of
    the largest such sum. The second term is there because XLA folds vpt's
    i * ((ta - t0) * (1/M1)) into (ta - t0) * (i/M1) (tests/test_torch_grid.py),
    which moves some segment starts by an ulp: a segment's overlap with a
    distance then differs by about 1e-5 of the term, and a voxel fed by
    such terms alone sees it as its whole sum (measured without it: 6 of
    512 voxels over, the largest error 1.2e-4 of the largest voxel's sum
    with lane 89, 3.9e-6 without). On the card the kernel and the plain
    version compute the same terms and agree per voxel within 1e-5 of the
    voxel's own sum (chip_smoke.py phase 16);
  - the step: the loss within 1e-3 of vpt's, every voxel's gradient within
    2e-2 of its value or 1e-2 of the largest, and the updated values within
    1e-6 where vpt's gradient is clear of zero (elsewhere within the rate),
    the weights zeroed on each view's flip lanes.
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
from vpt_torch.scene.io import scene_to_dict

from test_torch_grid import port_scene
from test_torch_wavefront import (REFERENCE_TIMEOUT_S, lowest_priority,
                                 reference_env)

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB, SEED = 16, 12, 4, 8, 3
V = 2                   # views of the train step
LR, REG_L1, REG_TV = 3e-2, 2e-3, 1e-3
Q99_TOL = 1e-5
FLIP_TOL = 1e-4
GRAD_TOL = 1e-5         # of sum_lanes |G_lane, k| and of a voxel's sum |terms|
VOXEL_FLIPS = (89,)     # lanes whose voxel terms differ discretely
KEYS = ("sigma_a", "sigma_s", "albedo", "radiance")

_JAX_REF = r"""
import inspect, json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import optax
import vpt.kernels.diff as vd
from vpt.dist.tomography import make_grid_train_step
from vpt.kernels.diff import pack_params
from vpt.scene.io import scene_from_dict
with open(sys.argv[1]) as f:
    job = json.load(f)
inp = np.load(job["inputs"])
scene, cam = scene_from_dict(job["scene"])
made, make = {}, vd.make_diff_renderer

def memo(*args, **kw):   # the views share one camera: one renderer
    key = (tuple(id(a) for a in args), tuple(sorted(kw.items())))
    if key not in made:
        made[key] = make(*args, **kw)
    return made[key]

vd.make_diff_renderer = memo

def keep():              # a pass-through that keeps the gradient
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (g, g))

opt = optax.chain(keep(), optax.adam(job["lr"]))
V, W, H, spp = job["views"], job["width"], job["height"], job["spp"]
step = make_grid_train_step(scene, [cam] * V, W, H, spp, opt,
                            max_bounces=job["max_bounces"], backend="kernel",
                            sampler="ld", reg_l1=job["reg_l1"],
                            reg_tv=job["reg_tv"], interpret=True)
renders = inspect.getclosurevars(step.__wrapped__).nonlocals["renders"]
render = renders[0]
assert all(r is render for r in renders)
keys = ("sigma_a", "sigma_s", "albedo", "radiance")
params = pack_params(scene, with_grid=True)
img, vjp = jax.vjp(render, params, jnp.int32(job["seed"]))
img = np.asarray(img)
rel = (np.abs(img - inp["port_img"]).max(-1)
       / np.maximum(1.0, np.abs(img).max(-1)))
flip = np.flatnonzero(rel > job["flip_tol"])
gbar = inp["gbar"].copy()
gbar[flip] = 0.0
gbar[job["voxel_flips"]] = 0.0
g = vjp(jnp.asarray(gbar))[0]
out = dict(img=img, flip=flip,
           grad=np.concatenate([np.asarray(g[k]).reshape(-1) for k in keys]),
           grid_grad=np.asarray(g["grid"]))
# the step's renders at its own seeds: zero the weights on their flip lanes
weights = inp["weights"].copy()
s = job["train_seed"]
for v in range(V):
    for j in range(2):
        r = np.asarray(render(params, jnp.int32(s * 2 * V + 2 * v + j)))
        rl = (np.abs(r - inp["step_imgs"][v, j]).max(-1)
              / np.maximum(1.0, np.abs(r).max(-1)))
        weights[v, rl > job["flip_tol"]] = 0.0
vals = params["grid"]
new, state, loss = step.__wrapped__(vals, opt.init(vals),
                                    jnp.asarray(inp["targets"]),
                                    jnp.asarray(weights), jnp.int32(s))
out.update(loss=np.float32(loss), train_grad=np.asarray(state[0]),
           train_new=np.asarray(new), weights=weights)
np.savez(job["out"], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    gbar = rng.standard_normal((W * H, 3)).astype(np.float32)
    targets = (0.5 * rng.random((V, W * H, 3))).astype(np.float32)
    weights = (1.0 / (targets.mean(-1, keepdims=True) + 0.05) ** 2).astype(
        np.float32)
    return gbar, targets, weights


def packed(diff_grid=True):
    scene, cam = port_scene()
    dp = df.pack_diff(scene, cam, W, H, SPP, max_bounces=MB, sampler="ld",
                      diff_grid=diff_grid)
    params = df.pack_params(scene, with_grid=diff_grid)
    return scene, cam, dp, params, df._flatten(params, scene.count)


def _seed(s):
    return torch.tensor([s], dtype=torch.int32)


@pytest.fixture(scope="module")
def ref():
    """vpt's outputs, from one subprocess."""
    scene, cam, dp, params, pvec = packed()
    tab = tp.grid_table(params["grid"])
    gbar, targets, weights = _inputs()
    step_imgs = np.stack([np.stack([
        df.diff_fwd_plain(dp, pvec, _seed(SEED * 2 * V + 2 * v + j),
                          tab=tab).numpy() for j in range(2)])
        for v in range(V)])
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, port_img=df.diff_fwd_plain(dp, pvec, _seed(SEED),
                                                    tab=tab).numpy(),
                 gbar=gbar, targets=targets, weights=weights,
                 step_imgs=step_imgs)
        job = dict(inputs=inputs, out=os.path.join(tmp, "out.npz"),
                   scene=scene_to_dict(scene, cam), width=W, height=H,
                   spp=SPP, max_bounces=MB, seed=SEED, train_seed=SEED,
                   views=V, lr=LR, reg_l1=REG_L1, reg_tv=REG_TV,
                   flip_tol=FLIP_TOL, voxel_flips=list(VOXEL_FLIPS))
        spec = os.path.join(tmp, "job.json")
        with open(spec, "w") as f:
            json.dump(job, f)
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec], cwd=REPO,
                             env=reference_env(), capture_output=True,
                             text=True, timeout=REFERENCE_TIMEOUT_S,
                             preexec_fn=lowest_priority)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(job["out"]) as z:
            return {k: z[k] for k in z.files}


def test_fwd_plain_matches_vpt(ref):
    _, _, dp, params, pvec = packed()
    out = df.diff_fwd_plain(dp, pvec, _seed(SEED),
                            tab=tp.grid_table(params["grid"])).numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref["img"]) / max(1.0, float(np.abs(ref["img"]).max()))
    assert np.quantile(rel, 0.99) <= Q99_TOL, np.quantile(rel, 0.99)
    assert len(ref["flip"]) <= 2, ref["flip"]


def test_diff_grid_fwd_equals_baked_fwd():
    """The table rebuilt from the "grid" leaf gives the baked grid's image
    bit for bit (the same words), and the pair's image is K1's within vpt's
    1e-5 of its scale."""
    scene, cam, dp, params, pvec = packed()
    _, _, dpb, _, pvb = packed(diff_grid=False)
    a = df.diff_fwd_plain(dp, pvec, _seed(SEED),
                          tab=tp.grid_table(params["grid"]))
    b = df.diff_fwd_plain(dpb, pvb, _seed(SEED))
    assert torch.equal(a, b)
    pk = wf.pack_scene(scene, cam, W, H, SPP, max_bounces=MB, sampler="ld")
    k1 = wf.render_tile_plain(pk, _seed(SEED))
    assert float((a - k1).abs().max()) <= 1e-5 * max(1.0,
                                                      float(k1.abs().max()))


def _port_grads(ref):
    _, _, dp, params, pvec = packed()
    gbar, _, _ = _inputs()
    gbar = gbar.copy()
    gbar[ref["flip"]] = 0.0
    gbar[list(VOXEL_FLIPS)] = 0.0
    return dp, df.diff_bwd_plain(dp, pvec, _seed(SEED), torch.from_numpy(gbar),
                                 per_lane=True,
                                 tab=tp.grid_table(params["grid"]),
                                 voxel_abs=True)


def test_bwd_plain_matches_vpt_per_entry(ref):
    dp, (G, _, _) = _port_grads(ref)
    G = G.numpy()
    assert G.shape == (W * H, dp.P) and np.isfinite(G).all()
    g = G.sum(0, dtype=np.float64)
    scale = np.abs(G).sum(0, dtype=np.float64)
    err = np.abs(g - ref["grad"])
    bad = np.flatnonzero(err > GRAD_TOL * scale)
    assert bad.size == 0, (bad, err[bad], scale[bad])
    assert np.array_equal(scale == 0.0, ref["grad"] == 0.0)


def test_voxel_grad_matches_vpt(ref):
    _, (_, gg, gabs) = _port_grads(ref)
    gg, gabs = gg.numpy(), gabs.numpy()
    want = ref["grid_grad"]
    assert gg.shape == want.shape == (8, 8, 8)
    assert np.isfinite(gg).all() and np.abs(want).max() > 0
    err = np.abs(gg - want)
    bad = np.argwhere(err > GRAD_TOL * (gabs + gabs.max()))
    assert bad.size == 0, (bad[:8], err[tuple(bad[:8].T)],
                           gabs[tuple(bad[:8].T)])


def test_train_step_matches_vpt(ref):
    scene, cam, _, _, _ = packed()
    _, targets, _ = _inputs()
    values = scene.medium.density.params.clone().requires_grad_()
    opt = vpt_torch.dist.adam({"grid": values}, LR)
    step = vpt_torch.dist.make_grid_train_step(
        scene, [cam] * V, W, H, SPP, opt, max_bounces=MB, sampler="ld",
        reg_l1=REG_L1, reg_tv=REG_TV, device="cpu")
    start = values.detach().clone()
    loss = float(step(values, torch.from_numpy(targets),
                      torch.from_numpy(ref["weights"]), SEED))
    assert abs(loss - float(ref["loss"])) <= 1e-3 * abs(float(ref["loss"]))
    grad = values.grad.numpy()
    ref_g = ref["train_grad"]
    assert np.isfinite(grad).all() and np.abs(ref_g).max() > 0
    err = np.abs(grad - ref_g)
    bad = np.argwhere(err > np.maximum(2e-2 * np.abs(ref_g),
                                       1e-2 * np.abs(ref_g).max()))
    assert bad.size == 0, (bad[:8], grad[tuple(bad[:8].T)],
                           ref_g[tuple(bad[:8].T)])
    new = values.detach().numpy()
    sure = np.abs(ref_g) > 1e-3 * np.abs(ref_g).max()
    assert np.abs(new - ref["train_new"])[sure].max() <= 1e-6
    assert np.abs(new - start.numpy()).max() <= LR * 1.001
    # the projection onto [0, majorant / 1.001]
    assert new.min() >= 0.0
    assert new.max() <= scene.medium.density.majorant / 1.001


# ---- port-only: the guards, autograd, the trainer -------------------------

def test_diff_grid_guards():
    """vpt's guards (tests/test_diff_kernel.py:460-486) in the port's form:
    diff_grid needs a grid, the renderer needs the "grid" leaf iff it
    traces it, and pack_params(with_grid) needs a grid. (vpt's tile_rows
    guard is a TPU layout rule, ROADMAP item 10.)"""
    scene, cam, _, params, _ = packed()
    with pytest.raises(ValueError, match="voxel-grid"):
        df.make_diff_renderer(vpt_torch.cornell_vpt(), cam, W, H, SPP,
                              diff_grid=True, device="cpu")
    r = df.make_diff_renderer(scene, cam, W, H, SPP, diff_grid=True,
                              device="cpu")
    with pytest.raises(ValueError, match="grid"):
        r(df.pack_params(scene), 3)               # the leaf is missing
    with pytest.raises(ValueError, match="grid"):
        df.make_diff_renderer(scene, cam, W, H, SPP, device="cpu")(params, 3)
    with pytest.raises(ValueError, match="grid"):
        df.pack_params(vpt_torch.cornell_vpt(), with_grid=True)
    with pytest.raises(ValueError, match="shape"):
        r({**params, "grid": params["grid"][:4]}, 3)


def test_autograd_returns_the_grid_leaf():
    """render(params, seed) through torch autograd: the "grid" leaf's
    gradient is K3's voxel gradient (its plain version here), the other
    leaves' its P-vector."""
    scene, cam, dp, params, pvec = packed()
    r = df.make_diff_renderer(scene, cam, W, H, SPP, max_bounces=MB,
                              sampler="ld", diff_grid=True, device="cpu")
    p = {k: v.clone().requires_grad_() for k, v in params.items()}
    img = r(p, SEED)
    gbar = torch.from_numpy(_inputs()[0])
    (img * gbar).sum().backward()
    gvec, gg = df.diff_bwd_plain(dp, pvec, _seed(SEED), gbar,
                                 tab=tp.grid_table(params["grid"]))
    assert torch.equal(p["grid"].grad, gg)
    got = df._flatten({k: p[k].grad for k in KEYS}, scene.count)
    assert torch.equal(got, gvec)


def _tiny_fit(**kw):
    scene, cam, _, _, _ = packed()
    targets = [torch.rand(3, 4, 3, generator=torch.Generator().manual_seed(v))
               for v in range(2)]
    return scene, vpt_torch.dist.fit_grid(
        scene, [cam, cam], targets, spp=1, max_bounces=2, device="cpu", **kw)


def test_fit_grid_polyak_tail_and_schedule():
    """fit_grid's iterates under a schedule, its Polyak tail (the mean of
    the projected iterates from polyak_from on) and its projection."""
    steps, lr = 3, vpt_torch.dist.exponential_decay(0.5, 3, 0.1)
    scene, (last, losses) = _tiny_fit(steps=steps, learning_rate=lr,
                                      reg_l1=1e-2, reg_tv=1e-2)
    _, (avg, losses2) = _tiny_fit(steps=steps, learning_rate=lr,
                                  reg_l1=1e-2, reg_tv=1e-2, polyak_from=2)
    assert len(losses) == steps and losses == losses2
    vmax = scene.medium.density.majorant / 1.001
    assert last.min() >= 0.0 and last.max() <= vmax
    # the same run cut one step short gives the second iterate
    _, (second, _) = _tiny_fit(steps=2, learning_rate=lr, reg_l1=1e-2,
                               reg_tv=1e-2)
    assert torch.allclose(avg, (second + last) / 2, rtol=0, atol=1e-6)
    assert not torch.equal(second, last)


@pytest.mark.parametrize("polyak_from", [-1, 4])
def test_fit_grid_refuses_polyak_out_of_range(polyak_from):
    with pytest.raises(ValueError, match="polyak_from"):
        _tiny_fit(steps=3, polyak_from=polyak_from)
