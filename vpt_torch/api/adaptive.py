"""Two-pass variance-guided adaptive sampling on the render kernel
(counterpart of ``vpt/api/adaptive.py``).

pass 1   two independent half-budget renders A, B of the whole frame; the
         variance per pixel is estimated by (A-B)^2 / 2 and averaged per
         tile of LANES_PER_TILE lanes (vpt's tile at its default tile_rows,
         so both select the same tiles)
pass 2   the top `frac` tiles by variance render `boost * spp/2` extra
         samples, gathered into ONE kernel launch (wavefront.render_raw with
         a device array of tile bases: vpt's scatter-tile mode)
combine  per-pixel sample-count-weighted mean of the pass sums

Conditional on the selection every retained sample mean is unbiased; the
selection reuses the pass-1 samples, which leaves a small positive bias of
order 1/(samples per tile) on selected tiles (vpt/api/adaptive.py's
docstring has the derivation).

`device` decides which version runs: "cuda" launches the kernel (three
launches per frame) or raises, "cpu" runs its plain torch version.
"""
from __future__ import annotations

import torch

from ..kernels import wavefront as wf
from ..scene.camera import Camera
from ..scene.scene import Scene

__all__ = ["make_adaptive_renderer", "render_adaptive", "select_tiles"]


def _i32(x: int) -> int:
    """x wrapped to int32, as vpt's traced int32 seed arithmetic wraps."""
    return (int(x) + 2**31) % 2**32 - 2**31


def select_tiles(var: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest tile variances, largest first and equal
    variances in tile order (jax.lax.top_k's order; all-black tiles tie at
    0), by a stable descending sort."""
    return torch.sort(var, descending=True, stable=True).indices[:k]


def make_adaptive_renderer(scene: Scene, camera: Camera, cfg, *,
                           boost: float = 3.0, frac: float = 0.25,
                           device="cuda"):
    """Build go(seed: int) -> (H, W, 3) float32 on `device`.

    The base pass renders 2*(cfg.spp//2) samples per pixel (cfg.spp must
    be even and >= 2: the A/B halves must be equal); the top `frac` of
    tiles get round(boost*spp/2) extra samples. cfg.integrator must be a
    render-kernel integrator (wavefront.KERNEL_INTEGRATORS)."""
    if cfg.spp < 2 or cfg.spp % 2:
        raise ValueError(f"adaptive sampling needs even spp >= 2 "
                         f"(A/B halves), got {cfg.spp}")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_adaptive_renderer(device='cuda'): "
                           "torch.cuda.is_available() is False")
    half = cfg.spp // 2
    pk1 = wf.pack_config(scene, camera, cfg, spp=half)
    lanes = wf.LANES_PER_TILE
    n_tiles = pk1.num_tiles
    npix = pk1.npix
    k = min(max(int(round(frac * n_tiles)), 1), n_tiles)
    spp2 = max(int(round(boost * half)), 1)
    pk2 = wf.pack_config(scene, camera, cfg, spp=spp2)
    valid = (torch.arange(n_tiles * lanes, device=dev) < npix)[:, None]
    # real (non-padding) lanes per tile: the last tile may be partial and
    # its variance must not be diluted by the zeroed padding lanes
    real = torch.clamp(npix - torch.arange(n_tiles) * lanes, 1, lanes)
    inv_real = (1.0 / real.to(torch.float32)).to(dev)

    def seed_t(s: int) -> torch.Tensor:
        return torch.tensor([_i32(s)], dtype=torch.int32, device=dev)

    def first_pass(s: int):
        """Pass 1 at seed s: the A and B sums, (n_tiles*lanes, 3) each,
        and the selected tiles, largest variance first."""
        a = wf.render_raw(pk1, seed_t(s * 2))
        b = wf.render_raw(pk1, seed_t(s * 2 + 1))
        resid = torch.where(valid, (a - b) * (1.0 / half), 0.0)
        var = torch.sum(resid * resid, dim=-1).reshape(n_tiles, lanes)
        var = torch.sum(var, dim=-1) * inv_real   # per-tile variance proxy
        return a, b, select_tiles(var, k)

    def go(s: int) -> torch.Tensor:
        a, b, sel = first_pass(s)
        bases = (sel * lanes).to(torch.int32)
        extra = wf.render_raw(pk2, seed_t(s * 2 + 0x5E11), bases)
        sums = (a + b).reshape(n_tiles, lanes, 3)
        sums[sel] = sums[sel] + extra.reshape(k, lanes, 3)
        counts = torch.full((n_tiles, 1, 1), 2.0 * half, device=dev)
        counts[sel] = counts[sel] + float(spp2)
        img = (sums / counts).reshape(n_tiles * lanes, 3)[:npix]
        return img.reshape(cfg.height, cfg.width, 3)

    go.packed = (pk1, pk2)
    go.k = k
    go.first_pass = first_pass
    return go


def render_adaptive(scene: Scene, camera: Camera, cfg, *,
                    boost: float = 3.0, frac: float = 0.25,
                    seed: int | None = None, device="cuda") -> torch.Tensor:
    """One-shot adaptive render (use make_adaptive_renderer for repeated
    frames). Returns (H, W, 3) float32 on `device`."""
    go = make_adaptive_renderer(scene, camera, cfg, boost=boost, frac=frac,
                                device=device)
    return go(cfg.seed if seed is None else seed)
