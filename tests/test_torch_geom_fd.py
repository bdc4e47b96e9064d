"""vpt_torch's K4 plain version in its primal_only mode (the substrate of
CRN finite differences), one make_fd_geom_train_step step, and the camera
origin + fov and look-direction blocks, against vpt's geom kernel.

One vpt subprocess (interpret mode, XLA:CPU capped at AVX; see
tests/test_torch_geom.py), two compiles, sampler "ld", 32x16 at 4 spp,
max_bounces 8, seed 3:
  - cornell_vpt with primal_only=True (K = 0, theta traced): the image, and
    one FD step over the point light's centre and sigma (dims 0-2 and
    7-8), replicating vpt's train_fast.py:268-300 on run_vec;
  - tests/test_geom_kernel.py's one-sphere MEDIUM_SCENE with
    cam_grads=True, dir_grads=True (K = 7): the image and every tangent
    plane.

Criteria as in tests/test_torch_geom.py (image q99 < 1e-4 of the image
scale; tangent planes q99 < 1e-4 of each plane's scale outside the flip
lanes). The FD step: see test_fd_step_matches_vpt. Measured (my CPU runs):
primal_only image q99 1.3e-7, flip lanes 403 and 453; camera + direction
image q99 3.5e-7, no flip lane, tangent planes at most 1.2e-6.
"""
import numpy as np
import pytest
import torch

import vpt_torch
from vpt_torch.kernels import geom as gm
from vpt_torch.scene.scene import CORNELL_VPT_SPHERES

from test_torch_geom import (MEDIUM, MEDIUM_SIGMA, SIGMA, check_image,
                             check_tangents, port_render, vpt_reference)

# optax.multi_transform on vpt's side, param groups on the port's: the
# light moves at 0.2 per step, sigma at 1e-4
LRS = {"center": 0.2, "sigma_a": 1e-4, "sigma_s": 1e-4}
PRIMAL = dict(name="primal", spheres=list(CORNELL_VPT_SPHERES), sigma=SIGMA,
              width=32, height=16, spp=4, seed=3,
              kw=dict(sphere=8, cam_grads=False, primal_only=True,
                      max_bounces=8, sampler="ld"),
              fd=dict(cam_grads=False, sigma=True), lrs=LRS, train_seed=9)
CAMDIR = dict(name="camdir", spheres=MEDIUM, sigma=MEDIUM_SIGMA, width=32,
              height=16, spp=4, seed=3,
              kw=dict(sphere=None, cam_grads=True, dir_grads=True,
                      max_bounces=8, sampler="ld"))


@pytest.fixture(scope="module")
def ref():
    _, _, img_p, _ = port_render(PRIMAL)
    _, _, img_c, _ = port_render(CAMDIR)
    target = (0.2 * np.random.default_rng(1).random((32 * 16, 3))).astype(
        np.float32)
    out = vpt_reference([dict(PRIMAL), dict(CAMDIR)],
                        {"primal.port_img": img_p, "primal.target": target,
                         "camdir.port_img": img_c})
    out["target"] = target
    return out


def test_primal_only_image_matches_vpt(ref):
    render, _, img, tang = port_render(PRIMAL)
    assert render.K == 0 and tang.shape == (0, 32 * 16, 3)
    assert not hasattr(render, "grad_render")    # vpt: primal_only has none
    flip = check_image(img, ref["primal.img"])
    assert np.array_equal(flip, ref["primal.flip"])
    assert len(flip) <= 2, flip


def test_fd_step_matches_vpt(ref):
    """One CRN-FD step at train seed 9 (A/B seeds 18 and 19). At this size
    2-4 lanes of a render take another branch in the port than in vpt
    (their pixels differ by 2e-4 to 1e-2 of the image scale), and a flip
    lane in A or B shifts a probe loss (by 2e-3 relative at train seed 3);
    of train seeds 3-14 only 9 has none in A and B at theta itself. The
    probes at theta - h_sigma (sigma_t 0.0095 in both) still have one: they
    differ by 4e-4 relative, the other probes by 1e-6. Bounds: the 2 x 5
    probe losses (l+, l-) within 1e-3 relative, the FD gradient within
    1e-3 of |l+| / h per entry (an ulp in a loss is ~1e-7 of it; the flip
    lane moves the sigma entries by 0.2 of it), and the updated
    theta: Adam's first step moves each entry by about its lr, so entries
    agree within 1e-6 relative, or move by at most their lr where |g| is
    below 1e-3 of the largest of its block. Measured: probes within
    2.5e-6 relative but the two at theta - h_sigma (4.0e-4, 3.8e-4); FD
    gradient at most 0.2 of its bound (the sigma entries), 1.1e-4 of it
    for the centre; updated theta within 7.5e-8 relative."""
    scene = vpt_torch.cornell_vpt()
    cam = vpt_torch.default_camera()
    theta = gm.pack_theta(scene, cam, 8)
    init = gm.flatten_theta(theta).numpy()
    opt = torch.optim.Adam([{"params": [theta[k]], "lr": lr}
                            for k, lr in LRS.items()],
                           betas=(0.9, 0.999), eps=1e-8)
    step = vpt_torch.dist.make_fd_geom_train_step(
        scene, cam, 32, 16, 2 * PRIMAL["spp"], opt, sphere=8,
        cam_grads=False, sigma=True, max_bounces=8, sampler="ld",
        device="cpu")
    loss = float(step(theta, torch.from_numpy(ref["target"]),
                      PRIMAL["train_seed"]))
    probes = np.asarray([[float(a), float(b)] for a, b in step.probe_losses],
                        np.float32).reshape(-1)
    ref_probes = ref["primal.fd_probes"]
    assert np.allclose(probes, ref_probes, rtol=1e-3, atol=0.0), (
        probes, ref_probes)
    assert abs(loss - float(ref["primal.fd_loss"])) <= 1e-3 * abs(loss)
    hs = np.asarray([0.5] * 6 + [2e-3, 5e-4, 5e-4] + [1e-3] * 3)
    grad = gm.flatten_theta({k: v.grad for k, v in theta.items()}).numpy()
    ref_g = ref["primal.fd_grad"]
    dims = [0, 1, 2, 7, 8]
    assert np.all(grad[[i for i in range(12) if i not in dims]] == 0.0)
    tol = 1e-3 * np.abs(probes[0]) / hs[dims]
    assert np.all(np.abs(grad[dims] - ref_g[dims]) <= tol), (grad, ref_g)
    new = gm.flatten_theta(theta).numpy()
    ref_new = ref["primal.fd_new"]
    lr = np.asarray([0.2] * 3 + [1e-4] * 2)
    for sl, idx in ((slice(0, 3), [0, 1, 2]), (slice(3, 5), [7, 8])):
        g = ref_g[idx]
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        err = np.abs(new[idx] - ref_new[idx])
        assert np.all(err[sure] <= 1e-6 * np.abs(ref_new[idx])[sure]), (
            new[idx], ref_new[idx])
        assert np.all(np.abs(new[idx] - init[idx])[~sure]
                      <= lr[sl][~sure] * 1.001)
    assert np.all(new[[3, 4, 5, 6, 9, 10, 11]] == init[[3, 4, 5, 6, 9, 10,
                                                        11]])


def test_camera_and_direction_blocks_match_vpt(ref):
    render, _, img, tang = port_render(CAMDIR)
    assert render.K == 7
    assert render.basis_names == ("cam_origin.x", "cam_origin.y",
                                  "cam_origin.z", "fov", "cam_dir.x",
                                  "cam_dir.y", "cam_dir.z")
    flip = check_image(img, ref["camdir.img"])
    assert np.array_equal(flip, ref["camdir.flip"])
    check_tangents(tang, ref["camdir.tang"], flip)
