"""The CUDA render kernel on the card (marked `cuda`; skipped without one).

Run on a machine with an NVIDIA GPU (--noconftest: tests/conftest.py
imports jax, which the port's machines need not have):
    python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest

Whether there is a card is decided inside the tests, never at import.
"""
import pytest
import torch

import vpt_torch
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
