"""vpt_torch's K4 plain version in its primal_only mode (the substrate of
CRN finite differences), one make_fd_geom_train_step step, and the camera
origin + fov and look-direction blocks, against vpt's geom kernel.

One vpt subprocess (interpret mode, XLA:CPU capped at AVX; see
tests/test_torch_geom.py), two compiles, sampler "ld", 32x16 at 4 spp,
max_bounces 8, seed 3:
  - cornell_vpt with primal_only=True (K = 0, theta traced): the image, and
    one FD step over the point light's centre and sigma (dims 0-2 and
    7-8), replicating vpt's train_fast.py:268-300 on run_vec; and one step
    of examples/recover_camera.py's direction block through vpt's own
    make_fd_geom_train_step, and one of its origin + fov block, whose
    renderer is this one (memoized: no further compile);
  - tests/test_geom_kernel.py's one-sphere MEDIUM_SCENE with
    cam_grads=True, dir_grads=True (K = 7): the image and every tangent
    plane.

Criteria as in tests/test_torch_geom.py (image q99 < 1e-4 of the image
scale; tangent planes q99 < 1e-4 of each plane's scale outside the flip
lanes). The FD step: see test_fd_step_matches_vpt. Measured (my CPU runs):
primal_only image q99 1.3e-7, flip lanes 403 and 453; camera + direction
image q99 3.5e-7, no flip lane, tangent planes at most 1.2e-6.
"""
import functools

import numpy as np
import pytest
import torch

import vpt_torch
from vpt_torch.dist import train_fast
from vpt_torch.dist.train_fast import _optimizer_step
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.scene import CORNELL_VPT_SPHERES

from test_torch_geom import (MEDIUM, MEDIUM_SIGMA, SIGMA, check_image,
                             check_tangents, port_render, vpt_reference)

# optax.multi_transform on vpt's side, param groups on the port's: the
# light moves at 0.2 per step, sigma at 1e-4
LRS = {"center": 0.2, "sigma_a": 1e-4, "sigma_s": 1e-4}
# examples/recover_camera.py --cpu's start (:38-51): the camera origin +
# (1.5, -1, 2), its direction + (0.004, -0.003, 0), fov x 1.06, the target a
# render at the true camera (seed 99); its first round's two blocks, every
# other leaf frozen: the direction block (optax.exponential_decay(0.002, 15,
# 0.75) on cam_dir) at its second step's seed (1000 r + i = 1: at seed 0 a
# firefly in the A/B pair makes the loss 100x larger and the direction
# secants fall to 5e-5 of it, a few ulps), and the origin + fov block
# (exponential_decay(0.5, ...) on cam_origin, (0.004, ...) on fov) at its
# first step's seed (5000 r + 17 + i = 17): (rates, seed, the block's theta
# dims, the renderer's blocks)
RC_OFF, RC_DIR_OFF, RC_FOV = (1.5, -1.0, 2.0), (0.004, -0.003, 0.0), 1.06
# lanes of an FD probe's render further apart than this share of the image
# scale carry the whole of the probe losses' difference (check_rc_step)
SPLICE_TOL = 1e-5
RC_BLOCKS = {
    "dir": ({"cam_dir": (0.002, 15, 0.75)}, 1, [9, 10, 11],
            dict(sphere=8, cam_grads=False, dir_grads=True)),
    "origin_fov": ({"cam_origin": (0.5, 15, 0.75), "fov": (0.004, 15, 0.75)},
                   17, [3, 4, 5, 6],
                   dict(sphere=8, cam_grads=True, dir_grads=False))}
PRIMAL = dict(name="primal", spheres=list(CORNELL_VPT_SPHERES), sigma=SIGMA,
              width=32, height=16, spp=4, seed=3,
              kw=dict(sphere=8, cam_grads=False, primal_only=True,
                      max_bounces=8, sampler="ld"),
              fd=dict(cam_grads=False, sigma=True), lrs=LRS, train_seed=9,
              fd_steps={tag: dict(rates=rates, seed=seed, blocks=blocks)
                        for tag, (rates, seed, _, blocks)
                        in RC_BLOCKS.items()})
CAMDIR = dict(name="camdir", spheres=MEDIUM, sigma=MEDIUM_SIGMA, width=32,
              height=16, spp=4, seed=3,
              kw=dict(sphere=None, cam_grads=True, dir_grads=True,
                      max_bounces=8, sampler="ld"))


def rc_start():
    """cornell_vpt's theta at recover_camera --cpu's starting camera."""
    scene = vpt_torch.cornell_vpt()
    cam = vpt_torch.default_camera()
    cam_w = vpt_torch.Camera(
        origin=cam.origin + torch.tensor(RC_OFF),
        direction=cam.direction + torch.tensor(RC_DIR_OFF),
        fov_scale=cam.fov_scale * RC_FOV)
    return scene, cam_w, gm.pack_theta(scene, cam_w, 8)


@functools.lru_cache(maxsize=1)
def rc_target():
    """K1's plain version at the true camera: 32x16 at 16 spp, "random"
    (made once: read only)."""
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       32, 16, 16, max_bounces=8)
    return wf.render_tile_plain(pk, torch.tensor([99], dtype=torch.int32))


@pytest.fixture(scope="module")
def ref():
    _, _, img_p, _ = port_render(PRIMAL)
    _, _, img_c, _ = port_render(CAMDIR)
    target = (0.2 * np.random.default_rng(1).random((32 * 16, 3))).astype(
        np.float32)
    out = vpt_reference([dict(PRIMAL), dict(CAMDIR)],
                        {"primal.port_img": img_p, "primal.target": target,
                         "primal.fd_step_theta": gm.flatten_theta(
                             rc_start()[2]).numpy(),
                         "primal.fd_step_target": rc_target().numpy(),
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


def rc_step(tag, monkeypatch):
    """One step of recover_camera's block `tag` (RC_BLOCKS) through
    make_fd_geom_train_step with dist.adam's per-leaf schedule, on the
    PRIMAL renderer's frame (32x16 at 4 spp per render, "ld", 8 bounces,
    sphere 8: the centre is probed and frozen), whose compile vpt's step
    reuses; at the example's --cpu frame (40x30, "random", 16 bounces,
    sphere None) it would be another compile. Returns (theta before, after,
    the probe losses (l+, l-) per dim, the A/B renders of each probe in the
    step's order, the loss)."""
    rates, seed, dims, blocks = RC_BLOCKS[tag]
    scene, cam_w, theta = rc_start()
    init = gm.flatten_theta(theta).numpy()
    renders, make = [], train_fast.make_geom_renderer

    def recording(*args, **kw):
        render = make(*args, **kw)
        run = render.run_vec

        def run_vec(v, s):
            out = run(v, s)
            renders.append(out[0].numpy().copy())
            return out
        render.run_vec = run_vec
        return render
    monkeypatch.setattr(train_fast, "make_geom_renderer", recording)
    opt = vpt_torch.dist.adam(theta, {
        k: vpt_torch.dist.exponential_decay(*r) for k, r in rates.items()})
    step = vpt_torch.dist.make_fd_geom_train_step(
        scene, cam_w, 32, 16, 2 * PRIMAL["spp"], opt, max_bounces=8,
        sampler="ld", device="cpu", **blocks)
    loss = float(step(theta, rc_target(), seed))
    probes = np.asarray([[float(a), float(b)] for a, b in step.probe_losses],
                        np.float32)
    assert probes.shape == (3 + len(dims), 2)
    return (init, gm.flatten_theta(theta).numpy(), probes,
            np.stack(renders).reshape(2 * len(probes), 2, 32 * 16, 3), loss)


def adam_first_step(rates: dict, grad: np.ndarray) -> np.ndarray:
    """theta after the port's optimizer (dist.adam's per-leaf schedule,
    every other leaf frozen) takes one step on the flat gradient `grad`,
    from recover_camera --cpu's start."""
    _, _, theta = rc_start()
    opt = vpt_torch.dist.adam(theta, {
        k: vpt_torch.dist.exponential_decay(*r) for k, r in rates.items()})
    off = 0
    for key, n in gm.THETA_KEYS:
        theta[key].grad = torch.from_numpy(
            grad[off:off + n].copy()).reshape(theta[key].shape)
        off += n
    _optimizer_step(opt)
    return gm.flatten_theta(theta).numpy()


def fd_grad(probes: np.ndarray, dims: list) -> np.ndarray:
    """The flat FD gradient of the probes (l+, l-) of [0, 1, 2] + dims, in
    f32 as the step computes it."""
    hs = np.asarray([0.5] * 6 + [2e-3, 5e-4, 5e-4] + [1e-3] * 3, np.float32)
    g = np.zeros(12, np.float32)
    all_dims = [0, 1, 2] + dims
    g[all_dims] = (probes[:, 0] - probes[:, 1]) / (np.float32(2.0)
                                                   * hs[all_dims])
    return g


def check_rc_step(ref, tag, monkeypatch):
    """One step of recover_camera's block `tag` against vpt's own
    make_fd_geom_train_step with optax.multi_transform (adam
    (exponential_decay) on the block's leaves, set_to_zero elsewhere) on the
    same theta and target, taken apart:
      - each A/B render of each probe (2 x 2 x (3 + |block|)) against
        vpt's at the step's seeds, by tests/test_torch_geom.py's image
        criterion (q99 below 1e-4 of the image scale; flip lanes, more than
        1e-4 of it apart, reported);
      - the probe losses: vpt's, from its renders, are the port's renders'
        with vpt's values on the lanes more than SPLICE_TOL of the image
        scale apart, within SPLICE_TOL relative; so those few lanes are
        the whole of any difference (at seed 17 lane 308 of A moves the
        origin x and y probes' losses by 2.5e-3 relative);
      - the update: the port's theta is the port's optimizer on its own FD
        gradient, and the port's optimizer on vpt's gradient is vpt's theta,
        both within 1e-6 relative; every frozen leaf stays as it was; the
        two thetas within 1e-6 relative plus what the gradients' difference
        moves Adam's first step;
      - the loss within 1e-3 relative (test_fd_step_matches_vpt's bound)."""
    rates, _, dims, _ = RC_BLOCKS[tag]
    init, new, probes, renders, loss = rc_step(tag, monkeypatch)
    want = float(ref[f"primal.fd_step_{tag}_loss"])
    ref_new = ref[f"primal.fd_step_{tag}_new"]
    ref_probes = ref[f"primal.fd_step_{tag}_probes"].reshape(-1, 2)
    ref_imgs = ref[f"primal.fd_step_{tag}_imgs"]
    assert ref_imgs.shape == renders.shape, (ref_imgs.shape, renders.shape)
    target = rc_target().numpy()
    flips, spliced = [], []
    for mine, theirs in zip(renders.reshape(-1, 32 * 16, 3),
                            ref_imgs.reshape(-1, 32 * 16, 3)):
        flips.append(check_image(mine, theirs).tolist())
        rel = np.abs(mine - theirs).max(-1) / max(1.0, float(
            np.abs(theirs).max()))
        far = rel > SPLICE_TOL
        mixed = mine.copy()
        mixed[far] = theirs[far]
        spliced.append(mixed)
    spliced = np.stack(spliced).reshape(renders.shape)
    mine_l = np.mean((renders[:, 0] - target) * (renders[:, 1] - target),
                     axis=(1, 2)).reshape(-1, 2)
    spliced_l = np.mean((spliced[:, 0] - target) * (spliced[:, 1] - target),
                        axis=(1, 2)).reshape(-1, 2)
    assert np.allclose(mine_l, probes, rtol=1e-5, atol=0.0), (mine_l, probes)
    assert np.allclose(spliced_l, ref_probes, rtol=SPLICE_TOL, atol=0.0), (
        spliced_l, ref_probes)
    g, g_ref = fd_grad(probes, dims), fd_grad(ref_probes, dims)
    mine_new = adam_first_step(rates, g)
    replay = adam_first_step(rates, g_ref)
    assert np.allclose(new, mine_new, rtol=1e-6, atol=0.0), (new, mine_new)
    assert np.allclose(replay, ref_new, rtol=1e-6, atol=0.0), (replay,
                                                                ref_new)
    frozen = [i for i in range(12) if i not in dims]
    assert np.array_equal(new[frozen], init[frozen])
    assert np.array_equal(ref_new[frozen], init[frozen])
    # and the two thetas directly: Adam's first step lr g / (|g| + eps)
    # moves by lr eps |g - g_vpt| / ((|g| + eps)(|g_vpt| + eps)) between
    # two gradients of one sign
    lr = np.asarray([r[0] for k, r in rates.items()
                     for _ in range(3 if k != "fov" else 1)])
    gd, gr = g[dims], g_ref[dims]
    assert np.all(np.sign(gd) == np.sign(gr)), (gd, gr)
    slack = lr * 1e-8 * np.abs(gd - gr) / (np.abs(gd) * np.abs(gr))
    assert np.all(np.abs(new[dims] - ref_new[dims])
                  <= 1e-6 * np.abs(ref_new[dims]) + slack), (
        new[dims], ref_new[dims], slack)
    assert abs(loss - want) <= 1e-3 * abs(want), (loss, want)
    print(f"recover_camera {tag} step: flip lanes per render {flips}; loss "
          f"{abs(loss - want) / want:.2e} relative, probes "
          f"{np.abs(probes / ref_probes - 1).max():.2e} (spliced "
          f"{np.abs(spliced_l / ref_probes - 1).max():.2e}), block theta "
          f"{np.abs(new[dims] / ref_new[dims] - 1).max():.2e} relative")


def test_recover_camera_direction_step_matches_vpt(ref, monkeypatch):
    """examples/recover_camera.py's direction block (its --cpu start, its
    first round's rate and seed): check_rc_step."""
    check_rc_step(ref, "dir", monkeypatch)


def test_recover_camera_origin_fov_step_matches_vpt(ref, monkeypatch):
    """examples/recover_camera.py's origin + fov block (its --cpu start,
    its first round's rates and seed, cam_grads=True: dims 3-6 probed, two
    per-leaf rates): check_rc_step."""
    check_rc_step(ref, "origin_fov", monkeypatch)
