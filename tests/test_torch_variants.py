"""The rest of the render kernel's surface against vpt: equi-angular and
clamped equi-angular distance sampling, the implicit and physical
integrators, a baked Henyey-Greenstein g, material-3 shells, the
scatter-tile raw mode, and the entry points on it (render_adaptive,
render_to_noise).

The plain versions are held against vpt's kernel in interpret mode, run once
for the whole file in one AVX-capped subprocess
(test_torch_wavefront.jax_reference), with the criterion of the other parity
tests: quantile(|a-b| / max(1, |ref|max), 0.99) < 1e-4. The equi-angular
families push sin/cos through tan, where XLA:CPU and torch differ by an ulp
on some inputs, so these images agree to the quantile, not bit for bit.
The implicit jobs render "cornell_lit" (cornell_vpt with an emitting back
wall and a thinner medium): in cornell_vpt itself an implicit path almost
never reaches a light, and its image is nearly all zeros.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import vpt
from vpt.scene.io import scene_to_dict

import vpt_torch
from vpt_torch.api.adaptive import select_tiles
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.camera import Camera
from vpt_torch.scene.io import scene_from_dict

from test_torch_wavefront import Q99_TOL, jax_reference, q99_rel

W, H, SPP, MB, SEED = 32, 16, 4, 8, 3


def _scene_dict(name, g=None):
    if name == "cornell_lit":
        d = scene_to_dict(vpt.cornell_vpt(), vpt.default_camera())
        d["spheres"][2]["radiance"] = [0.5, 0.5, 0.5]
        d["sigma_a"], d["sigma_s"] = 0.0005, 0.003
    else:
        d = scene_to_dict(vpt.SCENES[name](), vpt.default_camera())
    if g is not None:
        d["g"] = g
    return d


# (integrator, scene, g, sampler)
K1_JOBS = [("explicit_equiangular", "cornell_vpt", 0.5, "ld"),
           ("implicit_equiangular", "cornell_lit", None, "random"),
           ("implicit_free", "cornell_lit", -0.3, "random"),
           ("explicit_free_physical", "medium_shell", None, "random"),
           ("implicit_free_physical", "cornell_lit", None, "random"),
           ("explicit_free", "medium_shell", None, "ld")]
# adaptive: 2 tiles of 4096 lanes, the top one boosted
ADAPTIVE_CFG = dict(width=128, height=64, spp=4, max_bounces=6, seed=7)
ADAPTIVE_KW = dict(boost=2.0, frac=0.5)
NOISE_CFG = dict(width=16, height=8, spp=8, max_bounces=6, seed=5,
                 integrator="explicit_equiangular", sampler="ld")
NOISE_KW = dict(target_rel_se=0.6, max_spp=64)


@pytest.fixture(scope="module")
def vpt_out():
    jobs = []
    for integrator, name, g, sampler in K1_JOBS:
        nee, distance, physical = vpt.kernels.wavefront.PALLAS_INTEGRATORS[
            integrator]
        jobs.append(dict(scene=_scene_dict(name, g), width=W, height=H,
                         spp=SPP, max_bounces=MB, sampler=sampler,
                         jitter=True, seed=SEED, nee=nee, distance=distance,
                         physical=physical))
    jobs.append(dict(kind="adaptive", scene=_scene_dict("cornell_vpt"),
                     cfg=ADAPTIVE_CFG, **ADAPTIVE_KW))
    jobs.append(dict(kind="noise", scene=_scene_dict("cornell_vpt"),
                     cfg=dict(NOISE_CFG, renderer="pallas"), **NOISE_KW))
    return jax_reference(jobs, full=True)


@pytest.mark.parametrize("i", range(len(K1_JOBS)),
                         ids=["-".join(map(str, j)) for j in K1_JOBS])
def test_plain_variant_matches_vpt_kernel(vpt_out, i):
    integrator, name, g, sampler = K1_JOBS[i]
    nee, distance, physical = wf.KERNEL_INTEGRATORS[integrator]
    pk = wf.pack_scene(*scene_from_dict(_scene_dict(name, g)), W, H, SPP,
                       max_bounces=MB, sampler=sampler, nee=nee,
                       distance=distance, physical=physical)
    assert (pk.nee, pk.distance, pk.physical) == (nee, distance, physical)
    out = wf.render_tile_plain(pk, torch.tensor([SEED], dtype=torch.int32))
    out = out.numpy()
    ref = vpt_out[str(i)]
    assert ref.shape == out.shape and np.isfinite(out).all()
    assert (ref != 0).mean() > 0.05        # the image carries signal
    assert q99_rel(out, ref) < Q99_TOL, q99_rel(out, ref)


def test_render_adaptive_matches_vpt(vpt_out):
    ref = vpt_out[str(len(K1_JOBS))]
    img = vpt_torch.render_adaptive(
        vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
        vpt_torch.RenderConfig(**ADAPTIVE_CFG), device="cpu", **ADAPTIVE_KW)
    assert img.shape == ref.shape == (64, 128, 3)
    img = img.numpy()
    assert np.isfinite(img).all() and (img >= 0).all()
    assert q99_rel(img, ref) < Q99_TOL, q99_rel(img, ref)
    # the boosted tile carries 4 + 4 samples per pixel, the other 4: the
    # combination is not the plain 4-spp image
    plain = vpt_torch.render(vpt_torch.cornell_vpt(),
                             vpt_torch.default_camera(),
                             vpt_torch.RenderConfig(**ADAPTIVE_CFG),
                             device="cpu").numpy()
    assert q99_rel(plain, ref) > 1e-3


def test_render_to_noise_matches_vpt(vpt_out):
    i = len(K1_JOBS) + 1
    ref, (spp_ref, se_ref) = vpt_out[str(i)], vpt_out[f"{i}_meta"]
    img, spp, se = vpt_torch.render_to_noise(
        vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
        vpt_torch.RenderConfig(**NOISE_CFG), device="cpu", **NOISE_KW)
    assert spp == int(spp_ref) and 8 * 3 <= spp < NOISE_KW["max_spp"]
    assert img.dtype == torch.float64 and img.shape == ref.shape
    assert q99_rel(img.numpy(), ref) < Q99_TOL, q99_rel(img.numpy(), ref)
    # the median over 128 pixels moves a little with a flip lane's pixel
    assert abs(se - se_ref) <= 1e-2 * se_ref, (se, se_ref)


def test_select_tiles_orders_ties_as_vpt():
    var = torch.tensor([0.0, 2.0, 0.0, 5.0, 2.0, 0.0, 0.0])
    for k in range(1, 8):
        want = np.asarray(jax.lax.top_k(jax.numpy.asarray(var.numpy()), k)[1])
        assert select_tiles(var, k).tolist() == want.tolist()


def test_scatter_plain_bit_equal_to_raw_in_any_tile_order():
    """tests/test_pallas.py::test_scatter_tiles_bit_exact on the plain
    version: tiles from a list of bases, forward and reversed, equal the
    contiguous raw sums bit for bit (streams are keyed by lane id)."""
    pk = wf.pack_scene(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                       96, 64, 2, max_bounces=4, distance="equiangular")
    seed = torch.tensor([3], dtype=torch.int32)
    n, lanes = pk.num_tiles, wf.LANES_PER_TILE
    assert n == 2 and pk.npix < n * lanes       # a partial last tile
    full = wf.render_raw_plain(pk, seed)
    bases = torch.arange(n, dtype=torch.int32) * lanes
    assert torch.equal(full, wf.render_raw_plain(pk, seed, bases))
    rev = wf.render_raw_plain(pk, seed, bases.flip(0))
    assert torch.equal(full, rev.reshape(n, lanes, 3).flip(0).reshape(-1, 3))
    # the frame is the raw sums of its real lanes over spp
    assert torch.equal(full[:pk.npix] / torch.tensor(2.0),
                       wf.render_tile_plain(pk, seed))
    # on the CPU the wrapper is the plain version and launches nothing
    before = wf.LAUNCHES
    assert torch.equal(wf.render_raw(pk, seed, bases), full)
    assert wf.LAUNCHES == before
    with pytest.raises(ValueError, match="bases"):
        wf.render_raw(pk, seed, bases.to(torch.int64))


# ---- closed forms (tests/test_furnace.py:188-257) on the plain version ----
# an emitting sphere of radius R around the camera, absorbing medium only:
# every camera ray's answer is Le * exp(-sigma_a * t)
R, SIGMA_A, LE_A = 50.0, 0.01, (2.0, 1.0, 0.5)


def _shell_abs():
    return vpt_torch.make_scene(
        [(R, (0.0, 0.0, 0.0), (0, 0, 0), LE_A, 0, (0, 0, 0), (0, 0, 0),
          0.0)], sigma_a=SIGMA_A, sigma_s=0.0)


def _camera(origin, look):
    d = torch.tensor(look, dtype=torch.float32)
    return Camera(origin=torch.tensor(origin, dtype=torch.float32),
                  direction=d * (1.0 / torch.sqrt((d * d).sum())),
                  fov_scale=torch.tensor(0.5095))


def test_clamped_equiangular_closed_form():
    """implicit_equiangular with sigma_s = 0: only the surface-event
    Bernoulli credit survives, whose expectation is Le exp(-sigma_a t) per
    pixel whatever the EA distance pdf (off-centre camera, cp = 1)."""
    cam = _camera((0.3 * R, 0.1 * R, 0.2 * R), (-0.1, 0.05, -1.0))
    pk = wf.pack_scene(_shell_abs(), cam, 16, 16, 192, max_bounces=8,
                       continue_prob=1.0, jitter=False, nee=False,
                       distance="ea_clamped")
    img = wf.render_tile_plain(pk, torch.tensor([0], dtype=torch.int32))
    ids = np.arange(256)
    sx = (ids % 16 + 0.5 - 0.5) / 16 - 0.5
    sy = (15 - ids // 16 + 0.5 - 0.5) / 16 - 0.5
    d = (np.outer(sx, pk.cx) + np.outer(sy, pk.cy)
         + np.asarray(pk.cam_d)[None, :])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = np.asarray(pk.cam_o, np.float64)
    od = d @ o
    t = -od + np.sqrt(od ** 2 + R ** 2 - o @ o)
    want = np.asarray(LE_A)[None, :] * np.exp(-SIGMA_A * t)[:, None]
    ratio = (img.numpy() / want).mean(0)
    np.testing.assert_allclose(ratio, 1.0, rtol=0.04)


def test_physical_mode_at_rr_closed_form():
    """implicit_free_physical at cp = 0.6: the credit's 1/cp cancels the
    terminal Russian roulette, back to the closed form; without it the
    image is cp-dark (vpt's quirk 1)."""
    cam = _camera((0.0, 0.0, 0.0), (0.0, 0.0, -1.0))
    want = np.asarray(LE_A) * np.exp(-SIGMA_A * R)
    seed = torch.tensor([0], dtype=torch.int32)
    for physical, factor in ((True, 1.0), (False, 0.6)):
        pk = wf.pack_scene(_shell_abs(), cam, 16, 16, 192, max_bounces=8,
                           continue_prob=0.6, nee=False, physical=physical)
        img = wf.render_tile_plain(pk, seed).numpy()
        np.testing.assert_allclose(img.mean(0) / want, factor, rtol=0.05)
