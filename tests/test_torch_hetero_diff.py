"""vpt_torch.kernels.diff against vpt's differentiable pair in analytic
density fields: foggy_cornell with the exp_height falloff traced
(diff_field, sampler "ld": the image, the P + 1 gradient and one
make_kernel_train_step step) and blob_cloud with every blob parameter
traced (diff_blobs, sampler "random": the image, the P + 15 gradient and
one fit_kernel step as examples/recover_blobs.py takes it).

vpt's pair runs in interpret mode in ONE subprocess, with XLA's CPU code
generation capped at AVX (no FMA) and its Eigen pool off (see
tests/test_torch_wavefront.reference_env), at
32x16, 4 spp, max_bounces 8, seed 3. The criteria are
tests/test_torch_diff.py's:
  - image: quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4;
  - flip lanes: a lane whose path took the other branch of a discrete
    event (an ulp of an XLA transcendental against torch's decides a
    visibility, a free-flight inversion near its log1p pole or a
    delta-tracking comparison). In the fog the image scale is 37.6 (a light
    seen directly), and lanes that flipped differ by 1.6e-4 to 2.5e-3
    (lanes 129, 403 and 471 of the fog job), under 1e-4 of that scale but
    5 % of their own value. So here a lane flips when it is more than 1e-4
    of ITS OWN scale, max(1, |ref lane|max), apart: an absolute 1e-4 on
    every lane of these images. Measured: lanes 129, 300, 332, 403, 471
    (fog), 481, 482 (blobs);
  - gradient (the packed vector of sum(image * gbar), gbar from
    np.random.default_rng(0)): vpt zeroes gbar on the flip lanes, the port
    sums its per-lane rows over the other lanes, and each entry must agree
    within 2e-4 of sum_lanes |G_lane, k|;
  - the train steps: test_torch_diff.test_train_step_matches_vpt's bounds.
    The blob step is vpt's optax.multi_transform (Adam 0.15 on "blobs",
    set_to_zero elsewhere) against fit_kernel at learning_rate 0.15 with a
    param_filter that keeps only the updated "blobs".
"""
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
from vpt_torch.scene.io import scene_to_dict
from test_torch_wavefront import (REFERENCE_TIMEOUT_S, lowest_priority,
                                 reference_env)

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB, SEED = 32, 16, 4, 8, 3
LR = 1.5e-3             # the fog step: Adam over every leaf
BLOB_LR = 0.15          # the blob step: examples/recover_blobs.py's rate
Q99_TOL = 1e-4
FLIP_TOL = 1e-4         # a lane above this image error took another branch
GRAD_TOL = 2e-4         # of sum_lanes |G_lane, k|
# (scene, sampler, traced field): with_field / with_blobs of pack_params
JOBS = {"fog": ("foggy_cornell", "ld", dict(with_field=True)),
        "blobs": ("blob_cloud", "random", dict(with_blobs=True))}
KEYS = ("sigma_a", "sigma_s", "albedo", "radiance", "fog_k", "blobs")

# vpt's pair per job: image, the gradient of sum(image * gbar) with gbar
# zeroed on the flip lanes, and one A/B train step: optax.adam over every
# leaf (fog) or examples/recover_blobs.py's multi_transform (blobs)
_JAX_REF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import optax
from vpt.dist.train import project_params
from vpt.kernels.diff import make_diff_renderer, pack_params
from vpt.scene.io import scene_from_dict
with open(sys.argv[1]) as f:
    jobs = json.load(f)
keys = ("sigma_a", "sigma_s", "albedo", "radiance", "fog_k", "blobs")
flat = lambda g: np.concatenate([np.asarray(g[k]).reshape(-1) for k in keys
                                 if k in g])
for job in jobs:
    inp = np.load(job["inputs"])
    scene, cam = scene_from_dict(job["scene"])
    wf, wb = job["with_field"], job["with_blobs"]
    render = make_diff_renderer(scene, cam, job["width"], job["height"],
                                job["spp"], max_bounces=job["max_bounces"],
                                sampler=job["sampler"], tile_rows=8,
                                diff_field=wf, diff_blobs=wb, interpret=True)
    params = pack_params(scene, with_field=wf, with_blobs=wb)
    seed = jnp.int32(job["seed"])
    img, vjp = jax.vjp(render, params, seed)
    img = np.asarray(img)
    rel = (np.abs(img - inp["port_img"]).max(-1)
           / np.maximum(1.0, np.abs(img).max(-1)))
    flip = np.flatnonzero(rel > job["flip_tol"])
    gbar = inp["gbar"].copy()
    gbar[flip] = 0.0
    out = dict(img=img, flip=flip, grad=flat(vjp(jnp.asarray(gbar))[0]))
    if job["train"]:
        target = jnp.asarray(inp["target"])
        def loss_fn(p, s):          # dist/train_fast.py:59-62, not jitted
            a = render(p, s * 2)
            b = render(p, s * 2 + 1)
            return jnp.mean((a - target) * (b - target))
        loss, g = jax.value_and_grad(loss_fn)(params, seed)
        if job["train"] == "blobs":
            labels = {k: "blob" if k == "blobs" else "frozen" for k in params}
            opt = optax.multi_transform({"blob": optax.adam(job["lr"]),
                                         "frozen": optax.set_to_zero()},
                                        labels)
        else:
            opt = optax.adam(job["lr"])
        upd, _ = opt.update(g, opt.init(params), params)
        new = project_params(optax.apply_updates(params, upd))
        out.update(loss=np.float32(loss), train_grad=flat(g),
                   train_new=flat(new))
    np.savez(job["out"], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    gbar = rng.standard_normal((W * H, 3)).astype(np.float32)
    target = (2.0 * rng.random((W * H, 3))).astype(np.float32)
    return gbar, target


def packed(job):
    name, sampler, kw = JOBS[job]
    scene = vpt_torch.SCENES[name]()
    dp = df.pack_diff(scene, vpt_torch.default_camera(), W, H, SPP,
                      max_bounces=MB, sampler=sampler,
                      diff_field=kw.get("with_field", False),
                      diff_blobs=kw.get("with_blobs", False))
    return scene, dp, df._flatten(df.pack_params(scene, **kw), dp.pk.S)


@pytest.fixture(scope="module")
def ref():
    """vpt's outputs for every job, from one subprocess."""
    gbar, target = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        jobs = []
        for job, (name, sampler, kw) in JOBS.items():
            scene, dp, pvec = packed(job)
            img = df.diff_fwd_plain(dp, pvec, torch.tensor(
                [SEED], dtype=torch.int32))
            inputs = os.path.join(tmp, f"{job}_in.npz")
            np.savez(inputs, port_img=img.numpy(), gbar=gbar, target=target)
            jobs.append(dict(
                inputs=inputs, out=os.path.join(tmp, f"{job}_out.npz"),
                scene=scene_to_dict(scene, vpt_torch.default_camera()),
                width=W, height=H, spp=SPP, max_bounces=MB, sampler=sampler,
                seed=SEED, flip_tol=FLIP_TOL,
                lr=LR if job == "fog" else BLOB_LR,
                train="all" if job == "fog" else "blobs",
                with_field=kw.get("with_field", False),
                with_blobs=kw.get("with_blobs", False)))
        spec = os.path.join(tmp, "jobs.json")
        with open(spec, "w") as f:
            json.dump(jobs, f)
        env = reference_env()
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=REFERENCE_TIMEOUT_S,
                             preexec_fn=lowest_priority)
        assert res.returncode == 0, res.stderr[-4000:]
        out = {}
        for job, spec_j in zip(JOBS, jobs):
            with np.load(spec_j["out"]) as z:
                out[job] = {k: z[k] for k in z.files}
        return out


@pytest.mark.parametrize("job", list(JOBS))
def test_fwd_plain_matches_vpt(ref, job):
    _, dp, pvec = packed(job)
    out = df.diff_fwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32))
    assert out.shape == (W * H, 3) and out.dtype == torch.float32
    out = out.numpy()
    r = ref[job]
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - r["img"]) / max(1.0, float(np.abs(r["img"]).max()))
    assert np.quantile(rel, 0.99) < Q99_TOL, np.quantile(rel, 0.99)
    # the lanes that took another branch: few, and named in the docstring
    assert len(r["flip"]) <= 5, r["flip"]


@pytest.mark.parametrize("job", list(JOBS))
def test_bwd_plain_matches_vpt_per_entry(ref, job):
    """The P + n_fp gradient, the field slots included."""
    _, dp, pvec = packed(job)
    gbar, _ = _inputs()
    G = df.diff_bwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32),
                          torch.from_numpy(gbar), per_lane=True).numpy()
    assert G.shape == (W * H, dp.P) and np.isfinite(G).all()
    assert dp.n_fp == (1 if job == "fog" else 15)
    r = ref[job]
    keep = np.ones(W * H, bool)
    keep[r["flip"]] = False
    g = G[keep].sum(0, dtype=np.float64)
    scale = np.abs(G).sum(0, dtype=np.float64)
    err = np.abs(g - r["grad"])
    bad = np.flatnonzero(err > GRAD_TOL * scale)
    assert bad.size == 0, (bad, err[bad], scale[bad])
    assert np.array_equal(scale == 0.0, r["grad"] == 0.0)
    # the field slots carry a gradient
    assert (scale[-dp.n_fp:] > 0).all()


def test_train_step_matches_vpt(ref):
    """One make_kernel_train_step step with the fog falloff traced
    (torch.optim.Adam over every leaf) against vpt's A/B loss, optax.adam
    and project_params; the bounds of test_torch_diff's train test."""
    scene, dp, _ = packed("fog")
    S = scene.count
    _, target = _inputs()
    params = {k: v.requires_grad_() for k, v in
              df.pack_params(scene, with_field=True).items()}
    init = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = vpt_torch.dist.make_kernel_train_step(
        scene, vpt_torch.default_camera(), W, H, 2 * SPP, opt,
        max_bounces=MB, sampler="ld", diff_field=True, device="cpu")
    r = ref["fog"]
    loss = float(step(params, torch.from_numpy(target), SEED))
    assert abs(loss - float(r["loss"])) <= 1e-3 * abs(float(r["loss"]))
    grad = df._flatten({k: v.grad for k, v in params.items()}, S).numpy()
    new = df._flatten({k: v.detach() for k, v in params.items()}, S).numpy()
    ref_g, ref_new = r["train_grad"], r["train_new"]
    assert np.isfinite(grad).all()
    assert np.array_equal(grad == 0.0, ref_g == 0.0)
    leaf = df.unpack_params(torch.from_numpy(np.abs(ref_g)), S,
                            with_field=True)
    leaf_max = df._flatten({k: torch.full_like(v, float(v.max()))
                            for k, v in leaf.items()}, S).numpy()
    err = np.abs(grad - ref_g)
    bad = np.flatnonzero(err > np.maximum(2e-2 * np.abs(ref_g),
                                          1e-2 * leaf_max))
    assert bad.size == 0, (bad, grad[bad], ref_g[bad])
    sure = np.abs(ref_g) > 1e-3 * leaf_max
    assert np.abs(new - ref_new)[sure].max() <= 1e-6
    moved = np.abs(new - df._flatten(init, S).numpy())
    assert moved[~sure].max(initial=0.0) <= LR * 1.001


def test_blob_fit_step_matches_vpt(ref):
    """One fit_kernel step on blob_cloud as chip_smoke drives
    examples/recover_blobs.py (Adam at 0.15, only "blobs" kept) against
    vpt's multi_transform step: the same loss, the other leaves unchanged,
    and the blob rows moved as vpt moves them."""
    scene, _, _ = packed("blobs")
    S = scene.count
    _, target = _inputs()
    init = df.pack_params(scene, with_blobs=True)
    new, losses = vpt_torch.dist.fit_kernel(
        scene, vpt_torch.default_camera(), target.reshape(H, W, 3),
        steps=1, spp=2 * SPP, learning_rate=BLOB_LR, max_bounces=MB,
        sampler="random", seed=SEED, diff_blobs=True,
        param_filter=lambda upd, ini: {**ini, "blobs": upd["blobs"]},
        device="cpu")
    r = ref["blobs"]
    assert abs(losses[0] - float(r["loss"])) <= 1e-3 * abs(float(r["loss"]))
    for k, v in init.items():
        if k != "blobs":
            assert torch.equal(new[k], v), k
    n_b = init["blobs"].numel()
    ref_g, ref_new = r["train_grad"][-n_b:], r["train_new"][-n_b:]
    assert np.isfinite(ref_g).all() and (ref_g != 0.0).all()
    got = new["blobs"].numpy().reshape(-1)
    start = init["blobs"].numpy().reshape(-1)
    # the first Adam step moves each entry by BLOB_LR * g / (|g| + eps):
    # where vpt's gradient is clear of zero both steps agree to f32
    # rounding; elsewhere the port's entry moved by at most the rate
    sure = np.abs(ref_g) > 1e-3 * np.abs(ref_g).max()
    assert np.abs(got - ref_new)[sure].max() <= 1e-6 * max(
        1.0, float(np.abs(ref_new).max()))
    assert np.abs(got - start).max() <= BLOB_LR * 1.001
    assert np.array_equal(r["train_new"][:-n_b], df._flatten(
        {k: v for k, v in init.items() if k != "blobs"}, S).numpy())
