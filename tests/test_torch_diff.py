"""vpt_torch.kernels.diff and vpt_torch.dist against vpt's differentiable
pair, sampler "ld" (the bench's). tests/test_torch_diff_random.py runs the
same checks with "random"; both files share the helpers here.

vpt's make_diff_renderer runs in interpret mode in ONE subprocess per file,
with XLA's CPU code generation capped at AVX (no FMA; see
tests/test_torch_wavefront.py), at 32x16, 4 spp, max_bounces 8, seed 3. Its
renderer is built once with a traced seed, so every further call reuses the
compiled forward and backward (about 80 s in all for the first pair).

Criteria, each measured on these inputs:
  - image: quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4, as the forward
    kernel's tests. A lane whose path takes the other branch of a discrete
    event (an ulp of difference in a transcendental decides a visibility or
    a free-flight comparison) differs by far more than rounding; such lanes
    are the ones above 1e-4 of the image scale. Measured: one each, lane
    403 with "ld" and lane 402 with "random".
  - gradient (P-vector of sum(image * gbar), gbar from
    np.random.default_rng(0)): the vpt side zeroes gbar on those flip
    lanes, the port sums its per-lane contributions over the other lanes,
    and each entry must agree within 2e-4 of sum_lanes |G_lane, k| (the
    entry's scale: the score terms A*L - B cancel within a lane, so an ulp
    in a lane's terms moves the entry relative to the lanes' magnitudes,
    not to the sum). Measured: at most 6.9e-5 ("ld") and 3.9e-5 ("random").
  - one train step ("ld"): see test_train_step_matches_vpt.
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
from test_torch_wavefront import (REFERENCE_TIMEOUT_S, lowest_priority,
                                 reference_env)

torch.set_num_threads(1)  # one intra-op thread: see test_torch_wavefront.py

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP, MB, SEED = 32, 16, 4, 8, 3
LR = 1.5e-3
Q99_TOL = 1e-4
FLIP_TOL = 1e-4         # a lane above this image error took another branch
GRAD_TOL = 2e-4         # of sum_lanes |G_lane, k|

# vpt's pair for one sampler: image, the gradient of sum(image * gbar) with
# gbar zeroed on the lanes where vpt's image and the port's (passed in)
# differ by more than FLIP_TOL, and optionally one A/B train step
_JAX_REF = r"""
import json, sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)     # as tests/conftest.py
import jax.numpy as jnp
import optax
import vpt
from vpt.dist.train import project_params
from vpt.kernels.diff import make_diff_renderer, pack_params
with open(sys.argv[1]) as f:
    job = json.load(f)
inp = np.load(job["inputs"])
W, H = job["width"], job["height"]
render = make_diff_renderer(vpt.cornell_vpt(), vpt.default_camera(), W, H,
                            job["spp"], max_bounces=job["max_bounces"],
                            sampler=job["sampler"], tile_rows=8,
                            interpret=True)
params = pack_params(vpt.cornell_vpt())
seed = jnp.int32(job["seed"])
img, vjp = jax.vjp(render, params, seed)
img = np.asarray(img)
rel = (np.abs(img - inp["port_img"]).max(-1)
       / max(1.0, float(np.abs(img).max())))
flip = np.flatnonzero(rel > job["flip_tol"])
gbar = inp["gbar"].copy()
gbar[flip] = 0.0
flat = lambda g: np.concatenate([np.asarray(g[k]).reshape(-1) for k in
                                 ("sigma_a", "sigma_s", "albedo", "radiance")])
grad = flat(vjp(jnp.asarray(gbar))[0])
out = dict(img=img, flip=flip, grad=grad)
if job["train"]:
    target = jnp.asarray(inp["target"])
    def loss_fn(p, s):          # dist/train_fast.py:59-62, not jitted
        a = render(p, s * 2)
        b = render(p, s * 2 + 1)
        return jnp.mean((a - target) * (b - target))
    loss, g = jax.value_and_grad(loss_fn)(params, seed)
    opt = optax.adam(job["lr"])
    upd, _ = opt.update(g, opt.init(params), params)
    new = project_params(optax.apply_updates(params, upd))
    out.update(loss=np.float32(loss), train_grad=flat(g), train_new=flat(new))
np.savez(job["out"], **out)
"""


def _inputs():
    rng = np.random.default_rng(0)
    gbar = rng.standard_normal((W * H, 3)).astype(np.float32)
    target = (2.0 * rng.random((W * H, 3))).astype(np.float32)
    return gbar, target


def packed(sampler):
    scene = vpt_torch.cornell_vpt()
    dp = df.pack_diff(scene, vpt_torch.default_camera(), W, H, SPP,
                      max_bounces=MB, sampler=sampler)
    return dp, df._flatten(df.pack_params(scene), dp.pk.S)


def vpt_reference(sampler, train):
    """Run vpt's pair in a subprocess; returns its outputs (numpy)."""
    dp, pvec = packed(sampler)
    port_img = df.diff_fwd_plain(dp, pvec, torch.tensor([SEED],
                                                        dtype=torch.int32))
    gbar, target = _inputs()
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "in.npz")
        np.savez(inputs, port_img=port_img.numpy(), gbar=gbar, target=target)
        job = dict(inputs=inputs, out=os.path.join(tmp, "out.npz"),
                   width=W, height=H, spp=SPP, max_bounces=MB,
                   sampler=sampler, seed=SEED, flip_tol=FLIP_TOL, lr=LR,
                   train=train)
        spec = os.path.join(tmp, "job.json")
        with open(spec, "w") as f:
            json.dump(job, f)
        env = reference_env()
        res = subprocess.run([sys.executable, "-c", _JAX_REF, spec], cwd=REPO,
                             env=env, capture_output=True, text=True,
                             timeout=REFERENCE_TIMEOUT_S,
                             preexec_fn=lowest_priority)
        assert res.returncode == 0, res.stderr[-4000:]
        with np.load(job["out"]) as z:
            return {k: z[k] for k in z.files}


def check_image(ref, sampler):
    dp, pvec = packed(sampler)
    out = df.diff_fwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32))
    assert out.shape == (W * H, 3) and out.dtype == torch.float32
    out = out.numpy()
    assert np.isfinite(out).all() and (out >= 0).all()
    rel = np.abs(out - ref["img"]) / max(1.0, float(np.abs(ref["img"]).max()))
    assert np.quantile(rel, 0.99) < Q99_TOL, np.quantile(rel, 0.99)
    # the lanes that took another branch: few, and named in the docstring
    assert len(ref["flip"]) <= 2, ref["flip"]


def check_gradient(ref, sampler):
    dp, pvec = packed(sampler)
    gbar, _ = _inputs()
    G = df.diff_bwd_plain(dp, pvec, torch.tensor([SEED], dtype=torch.int32),
                          torch.from_numpy(gbar), per_lane=True).numpy()
    assert G.shape == (W * H, dp.P) and np.isfinite(G).all()
    keep = np.ones(W * H, bool)
    keep[ref["flip"]] = False
    g = G[keep].sum(0, dtype=np.float64)
    scale = np.abs(G).sum(0, dtype=np.float64)
    err = np.abs(g - ref["grad"])
    bad = np.flatnonzero(err > GRAD_TOL * scale)
    assert bad.size == 0, (bad, err[bad], scale[bad])
    # the structural zeros (emitter albedo, non-emitter radiance) agree
    assert np.array_equal(scale == 0.0, ref["grad"] == 0.0)


@pytest.fixture(scope="module")
def ref():
    return vpt_reference("ld", train=True)


def test_fwd_plain_matches_vpt(ref):
    check_image(ref, "ld")


def test_bwd_plain_matches_vpt_per_entry(ref):
    check_gradient(ref, "ld")


def test_train_step_matches_vpt(ref):
    """One make_kernel_train_step step (torch.optim.Adam) against vpt's
    A/B loss, optax.adam and project_params, from the same params, target
    and seed. Measured: loss 1.2e-4 apart, gradients within 5.4e-3 of
    each entry (sigma; the A/B renders keep their flip lanes) and 3e-3 of
    the largest entry of their leaf (albedo), updated params within 1.1e-8.
    Bounds: loss 1e-3 relative; gradient 2e-2 relative or 1e-2 of the
    leaf's largest entry; exact zeros exact. Adam's first step moves an
    entry by lr * g / (|g| + eps), about +-lr whatever |g|, so an entry
    whose gradient is within rounding of 0 may move either way: entries
    with |g| below 1e-3 of their leaf's largest are excluded from the
    parameter check (and are zero or move by at most lr)."""
    scene = vpt_torch.cornell_vpt()
    _, target = _inputs()
    params = {k: v.requires_grad_() for k, v in df.pack_params(scene).items()}
    init = {k: v.detach().clone() for k, v in params.items()}
    opt = torch.optim.Adam(list(params.values()), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = vpt_torch.dist.make_kernel_train_step(
        scene, vpt_torch.default_camera(), W, H, 2 * SPP, opt,
        max_bounces=MB, sampler="ld", device="cpu")
    loss = float(step(params, torch.from_numpy(target), SEED))
    assert abs(loss - float(ref["loss"])) <= 1e-3 * abs(float(ref["loss"]))
    S = scene.count
    grad = df._flatten({k: v.grad for k, v in params.items()}, S).numpy()
    new = df._flatten({k: v.detach() for k, v in params.items()}, S).numpy()
    ref_g, ref_new = ref["train_grad"], ref["train_new"]
    assert np.isfinite(grad).all()
    assert np.array_equal(grad == 0.0, ref_g == 0.0)
    leaf = df.unpack_params(torch.from_numpy(np.abs(ref_g)), S)
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
