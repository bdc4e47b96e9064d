"""The CUDA kernels on the card (marked `cuda`; skipped without one): the
render kernel K1, the differentiable pair K2/K3 and the dual kernel K4.

Run on a machine with an NVIDIA GPU (--noconftest: tests/conftest.py
imports jax, which the port's machines need not have):
    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Whether there is a card is decided inside the tests, never at import.
"""
import pytest
import torch

import numpy as np

import vpt_torch
from vpt_torch.kernels import diff as df
from vpt_torch.kernels import geom as gm
from vpt_torch.kernels import wavefront as wf
from vpt_torch.scene.io import scene_from_dict, scene_to_dict

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


def _glass_cornell():
    """cornell_vpt with its blue sphere made dielectric (no built-in scene
    has one)."""
    d = scene_to_dict(vpt_torch.cornell_vpt())
    d["spheres"][6]["material"] = 2
    return scene_from_dict(d)[0]


@pytest.mark.parametrize("scene,sampler", [
    ("cornell_vpt", "random"), ("cornell_vpt", "ld"),
    ("one_primitive_infinite", "random"), ("cornell_glass", "ld")])
def test_kernel_matches_plain_on_card(cuda, scene, sampler):
    """The kernel against its plain version on the same device and seed:
    99th percentile of |a-b| / max(1, |ref|max) below 1e-4 (the card's
    transcendentals may differ from torch's by an ulp)."""
    sc = _glass_cornell() if scene == "cornell_glass" else \
        vpt_torch.SCENES[scene]()
    pk = wf.pack_scene(sc, vpt_torch.default_camera(),
                       64, 32, 8, max_bounces=8, sampler=sampler)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    before = wf.LAUNCHES
    k = wf.render_tile(pk, seed)
    assert wf.LAUNCHES == before + 1
    p = wf.render_tile_plain(pk, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    rel = (k - p).abs() / max(1.0, float(p.abs().max()))
    assert float(torch.quantile(rel.flatten().double(), 0.99)) < 1e-4


def test_render_on_card_goes_through_the_kernel(cuda):
    cfg = vpt_torch.RenderConfig(width=48, height=32, spp=4, max_bounces=6,
                                 sampler="ld")
    before = wf.LAUNCHES
    img = vpt_torch.render(vpt_torch.cornell_vpt(), vpt_torch.default_camera(),
                           cfg, device="cuda")
    torch.cuda.synchronize()
    assert wf.LAUNCHES == before + 1
    assert img.shape == (32, 48, 3) and img.device.type == "cuda"
    assert torch.isfinite(img).all() and (img >= 0).all()


def _q99(a, ref):
    rel = (a - ref).abs() / max(1.0, float(ref.abs().max()))
    return float(torch.quantile(rel.flatten().double(), 0.99))


@pytest.mark.parametrize("scene,sampler", [
    ("cornell_vpt", "random"), ("cornell_vpt", "ld"), ("cornell_glass", "ld")])
def test_diff_pair_matches_plain_on_card(cuda, scene, sampler):
    """K2's image by the q99 criterion; K3's per-pixel gradient vectors
    (the kernel's per_lane output) per entry column by the same criterion,
    and its block-summed P-vector within 1e-5 of sum_lanes |G_lane, k| (the
    same f32 values summed in another order)."""
    sc = _glass_cornell() if scene == "cornell_glass" else \
        vpt_torch.SCENES[scene]()
    dp = df.pack_diff(sc, vpt_torch.default_camera(), 64, 32, 8,
                      max_bounces=8, sampler=sampler)
    pvec = df._flatten(df.pack_params(sc), sc.count).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    gen = np.random.default_rng(0)
    gbar = torch.from_numpy(gen.standard_normal((dp.npix, 3)).astype(
        np.float32)).to(cuda)
    before = (df.LAUNCHES_FWD, df.LAUNCHES_BWD)
    k = df.diff_fwd(dp, pvec, seed)
    g = df.diff_bwd(dp, pvec, seed, gbar)
    G = df.diff_bwd(dp, pvec, seed, gbar, per_lane=True)
    assert (df.LAUNCHES_FWD, df.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 2)
    p = df.diff_fwd_plain(dp, pvec, seed)
    Gp = df.diff_bwd_plain(dp, pvec, seed, gbar, per_lane=True)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all() and torch.isfinite(G).all()
    assert _q99(k, p) < 1e-4
    rel = ((G - Gp).abs() / Gp.abs().amax(0).clamp_min(1.0)).amax(1)
    assert float(torch.quantile(rel.double(), 0.99)) < 1e-4
    scale = Gp.abs().sum(0)
    assert bool(((g - Gp.sum(0)).abs() <= 1e-5 * scale).all())


def test_diff_renderer_backward_goes_through_the_kernels(cuda):
    render = df.make_diff_renderer(vpt_torch.cornell_vpt(),
                                   vpt_torch.default_camera(), 48, 32, 4,
                                   max_bounces=6, sampler="ld", device="cuda")
    params = {k: v.to(cuda).requires_grad_()
              for k, v in df.pack_params(vpt_torch.cornell_vpt()).items()}
    before = (df.LAUNCHES_FWD, df.LAUNCHES_BWD)
    loss = render(params, 7).mean()
    loss.backward()
    torch.cuda.synchronize()
    assert (df.LAUNCHES_FWD, df.LAUNCHES_BWD) == (before[0] + 1,
                                                  before[1] + 1)
    for k, v in params.items():
        assert v.grad is not None and torch.isfinite(v.grad).all(), k
    # the same gradient from the plain pair on the card
    dp = render.packed
    pvec = df._flatten({k: v.detach() for k, v in params.items()}, 10)
    seed = torch.tensor([7], dtype=torch.int32, device=cuda)
    gp = df.diff_bwd_plain(dp, pvec, seed, torch.full(
        (dp.npix, 3), 1.0 / (3 * dp.npix), device=cuda), per_lane=True)
    got = df._flatten({k: v.grad for k, v in params.items()}, 10)
    assert bool(((got - gp.sum(0)).abs() <= 1e-5 * gp.abs().sum(0)).all())


@pytest.mark.parametrize("kw,sampler", [
    (dict(sphere=8, primal_only=True), "random"), (dict(sphere=8), "random"),
    (dict(sphere=8), "ld")], ids=["K0-random", "K7-random", "K7-ld"])
def test_geom_kernel_matches_plain_on_card(cuda, kw, sampler):
    """K4's planes against its plain version: the image planes by the q99
    criterion, each tangent plane by q99 of |a-b| below 1e-4 of its scale
    (zero planes exactly zero)."""
    sc, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    gp = gm.pack_geom(sc, cam, 64, 32, 8, max_bounces=8, sampler=sampler,
                      **kw)
    theta = gm.flatten_theta(gm.pack_theta(sc, cam, 8)).to(cuda)
    seed = torch.tensor([3], dtype=torch.int32, device=cuda)
    before = gm.LAUNCHES
    k = gm.geom_fwd(gp, theta, seed)
    assert gm.LAUNCHES == before + 1
    p = gm.geom_fwd_plain(gp, theta, seed)
    torch.cuda.synchronize()
    assert torch.isfinite(k).all()
    for j in range(gp.planes):
        if j % (1 + gp.K) == 0:
            assert _q99(k[j], p[j]) < 1e-4, j
        else:
            scale = float(p[j].abs().max())
            if scale == 0.0:
                assert bool((k[j] == 0.0).all()), j
                continue
            q = torch.quantile((k[j] - p[j]).abs().double(), 0.99)
            assert float(q) < 1e-4 * scale, j


def test_geom_renderer_goes_through_the_kernel(cuda):
    sc, cam = vpt_torch.cornell_vpt(), vpt_torch.default_camera()
    render = gm.make_geom_renderer(sc, cam, 48, 32, 4, sphere=8,
                                   max_bounces=6, device="cuda")
    theta = {k: v.to(cuda).requires_grad_()
             for k, v in gm.pack_theta(sc, cam, 8).items()}
    before = gm.LAUNCHES
    img, tang = render(theta, 7)
    render.grad_render(theta, 7).mean().backward()
    torch.cuda.synchronize()
    assert gm.LAUNCHES == before + 2
    assert img.shape == (48 * 32, 3) and tang.shape == (7, 48 * 32, 3)
    assert torch.isfinite(img).all() and torch.isfinite(tang).all()
    got = gm.flatten_theta({k: v.grad for k, v in theta.items()})
    want = tang.sum((1, 2)) / (3 * 48 * 32)
    assert torch.allclose(got[:7], want, rtol=1e-5, atol=1e-9)
