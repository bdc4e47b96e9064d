"""Port-only checks of kernels/geom.py and the geometric trainers, on the
plain version (no vpt subprocess):

  - fixed-seed central FD of the plain version against its own tangents,
    mirroring tests/test_geom_kernel.py:101-137 (rtol 8e-2): the area
    light's y on cornell_vpt; camera origin y, fov and cam_dir.x on the
    one-sphere medium scene (camera motion in the Cornell box is dominated
    by the boundary terms the estimator drops by design);
  - the K = 0 primal equals the K = 7 primal plane bit for bit (a D's primal
    does not depend on the tangent count), and the K = 7 primal matches the
    port's forward kernel K1 at q99 < 1e-4 (vpt's own contract,
    tests/test_geom_kernel.py:70-83);
  - grad_render under autograd, pack_theta, exponential_decay against
    optax's, the refusals, and fit_geom / fit_geom_fd for 2 steps on the CPU.
"""
import dataclasses

import numpy as np
import optax
import pytest
import torch

import vpt
import vpt.kernels.geom as vpt_geom
import vpt_torch
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf

from test_torch_geom import MEDIUM, MEDIUM_SIGMA, make

SCENE = vpt_torch.cornell_vpt()
CAM = vpt_torch.default_camera()
MEDIUM_SCENE = make(MEDIUM, MEDIUM_SIGMA)
W, H, SPP, MB, SEED = 12, 8, 2, 5, 3
LIGHT = 9           # the (75, 75, 60) area light


def _fd(render, theta, key, index, eps, k):
    def bump(e):
        th = {kk: v.clone() for kk, v in theta.items()}
        if index is None:
            th[key] = theta[key] + np.float32(e)
        else:
            th[key][index] = theta[key][index] + np.float32(e)
        return float(render(th, SEED)[0].mean())

    _, tang = render(theta, SEED)
    return float(tang[k].mean()), (bump(eps) - bump(-eps)) / (2 * eps)


FD_CASES = {
    "light_y": (SCENE, dict(sphere=LIGHT, cam_grads=False), "center", 1,
                1e-2, 1),
    "cam_origin_y": (MEDIUM_SCENE, dict(sphere=None), "cam_origin", 1, 1e-2,
                     1),
    "fov": (MEDIUM_SCENE, dict(sphere=None), "fov", None, 1e-4, 3),
    "cam_dir_x": (MEDIUM_SCENE, dict(sphere=None, cam_grads=False,
                                     dir_grads=True), "cam_dir", 0, 2e-3, 0),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_tangent_matches_fixed_seed_fd(case):
    scene, kw, key, index, eps, k = FD_CASES[case]
    render = gm.make_geom_renderer(scene, CAM, W, H, SPP, max_bounces=MB,
                                   device="cpu", **kw)
    theta = gm.pack_theta(scene, CAM, kw["sphere"])
    g, fd = _fd(render, theta, key, index, eps, k)
    assert np.isfinite(g) and np.isfinite(fd)
    assert np.isclose(g, fd, rtol=8e-2, atol=1e-6), (g, fd)


def test_primal_does_not_depend_on_k_and_matches_k1():
    theta = gm.pack_theta(SCENE, CAM, 8)
    imgs = {}
    for name, kw in (("k0", dict(primal_only=True)), ("k3", dict(
            cam_grads=False)), ("k7", {}), ("k10", dict(dir_grads=True))):
        render = gm.make_geom_renderer(SCENE, CAM, 16, 8, 2, sphere=8,
                                       max_bounces=MB, device="cpu", **kw)
        imgs[name], tang = render(theta, SEED)
        assert torch.isfinite(tang).all()
    for name in ("k3", "k7", "k10"):
        assert torch.equal(imgs["k0"], imgs[name]), name
    pk = wf.pack_scene(SCENE, CAM, 16, 8, 2, max_bounces=MB)
    ref = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    rel = (imgs["k7"] - ref).abs() / max(1.0, float(ref.abs().max()))
    assert float(torch.quantile(rel.flatten(), 0.99)) < 1e-4


def test_grad_render_contracts_tangents_on_cpu():
    render = gm.make_geom_renderer(SCENE, CAM, 8, 4, 2, sphere=8,
                                   dir_grads=True, max_bounces=4,
                                   device="cpu")
    theta = {k: v.requires_grad_() for k, v in
             gm.pack_theta(SCENE, CAM, 8).items()}
    before = gm.LAUNCHES
    img = render.grad_render(theta, 5)
    gbar = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (32, 3)).astype(np.float32))
    (img * gbar).sum().backward()
    assert gm.LAUNCHES == before                   # no kernel on the CPU
    img2, tang = render(theta, 5)
    assert torch.equal(img.detach(), img2)
    want = torch.einsum("kpc,pc->k", tang, gbar)
    got = gm.flatten_theta({k: v.grad for k, v in theta.items()})
    slots = [0, 1, 2, 3, 4, 5, 6, 9, 10, 11]
    assert torch.allclose(got[slots], want, rtol=1e-6, atol=0.0)
    assert torch.all(got[7:9] == 0.0)


def test_pack_theta_takes_vpt_dicts():
    ours = gm.pack_theta(SCENE, CAM, 8)
    theirs = gm.pack_theta({k: np.asarray(v) for k, v in vpt_geom.pack_theta(
        vpt.cornell_vpt(), vpt.default_camera(), 8).items()})
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    assert torch.equal(gm.pack_theta(SCENE, CAM, None)["center"],
                       torch.zeros(3))
    assert gm.flatten_theta(ours).shape == (12,)


def test_exponential_decay_matches_optax():
    ours = vpt_torch.dist.exponential_decay(0.8, 12, 0.75)
    theirs = optax.exponential_decay(0.8, 12, 0.75)
    for count in range(0, 81, 7):
        assert np.isclose(ours(count), float(theirs(count)), rtol=1e-6)


REFUSED = {
    # the analytic fields render and train on K1-K3; K4's dual field forms
    # are item 5.3 (the estimators, a baked HG g and material-3 shells run:
    # tests/test_torch_geom_ext.py)
    "density_field": lambda: gm.make_geom_renderer(
        vpt_torch.scene.scene.foggy_cornell(), CAM, 8, 4, 1, sphere=8,
        device="cpu"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unsupported_raises_not_implemented(case):
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item"):
        REFUSED[case]()


@pytest.mark.parametrize("kw,match", [
    (dict(sphere=None, cam_grads=False), "no differentiated block"),
    (dict(sphere=8, sampler="sobol"), "unknown sampler")])
def test_invalid_arguments_raise_value_error(kw, match):
    with pytest.raises(ValueError, match=match):
        gm.make_geom_renderer(SCENE, CAM, 8, 4, 1, device="cpu", **kw)


def test_cuda_renderer_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py "
                    "covers the kernel")
    with pytest.raises(RuntimeError, match="cuda"):
        gm.make_geom_renderer(SCENE, CAM, 8, 4, 1, sphere=8, device="cuda")


def _target_and_wrong(offset):
    pk = wf.pack_scene(SCENE, CAM, 8, 6, 8, max_bounces=4)
    target = wf.render_tile_plain(
        pk, torch.tensor([99], dtype=torch.int32)).reshape(6, 8, 3)
    center = SCENE.center.clone()
    center[8, 1] += offset
    return target, dataclasses.replace(SCENE, center=center)


def test_fit_geom_cpu_moves_theta():
    target, wrong = _target_and_wrong(3.0)
    theta, losses = vpt_torch.dist.fit_geom(
        wrong, CAM, target, sphere=8, steps=2, spp=4, max_bounces=4,
        device="cpu")
    start = gm.pack_theta(wrong, CAM, 8)
    assert len(losses) == 2 and np.isfinite(losses).all()
    # Adam's first two steps move each entry with a gradient by up to 2 lr
    moved = (gm.flatten_theta(theta) - gm.flatten_theta(start)).abs()
    assert 0.0 < float(moved[:7].max()) <= 2 * 0.2 * 1.001
    assert torch.equal(moved[7:], torch.zeros(5))    # sigma, cam_dir: no duals


def test_fit_geom_fd_cpu_moves_only_the_light():
    target, wrong = _target_and_wrong(3.0)
    schedule = vpt_torch.dist.exponential_decay(0.8, 12, 0.75)
    theta, losses = vpt_torch.dist.fit_geom_fd(
        wrong, CAM, target, sphere=8, cam_grads=False, steps=2, spp=4,
        max_bounces=4, learning_rate=schedule, device="cpu")
    start = gm.pack_theta(wrong, CAM, 8)
    assert len(losses) == 2 and np.isfinite(losses).all()
    moved = (gm.flatten_theta(theta) - gm.flatten_theta(start)).abs()
    assert 0.0 < float(moved[:3].max()) <= (0.8 + schedule(1)) * 1.001
    assert torch.equal(moved[3:], torch.zeros(9))
