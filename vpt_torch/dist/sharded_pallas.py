"""Sharded forward rendering on the render kernel K1.

Counterpart of ``vpt/dist/sharded_pallas.py``. Each rank of the (data,
sample) mesh (dist/mesh.py) renders its contiguous range of K1's tiles
(kernels/wavefront.make_raw):

  data   — rank di renders the tiles [di T, (di + 1) T); no communication
           until the frame is gathered;
  sample — each sample rank renders spp / S samples at a decorrelated seed
           seed + si * 0x9E37; an all-reduce over the sample group divided
           by S averages them (vpt's pmean).

The per-lane PCG streams are keyed by the global lane, so the result for a
fixed (mesh shape, seed) does not depend on which rank renders what, and a
mesh with one sample rank reproduces the single-device render.
"""
from __future__ import annotations

import torch

from ..kernels import wavefront as wf
from .mesh import SAMPLE_AXIS, Mesh

__all__ = ["build_sharded_pallas", "render_pallas_sharded"]


def build_sharded_pallas(scene, camera, cfg, mesh: Mesh):
    """Build go(seed: int) -> (npix, 3) on mesh.device, every rank the
    whole frame. cfg.integrator must be one of the render kernel's
    (wavefront.KERNEL_INTEGRATORS)."""
    if cfg.spp % mesh.n_sample:
        raise ValueError(
            f"spp={cfg.spp} not divisible by sample shards={mesh.n_sample}")
    spp_local = cfg.spp // mesh.n_sample
    pk = wf.pack_config(scene, camera, cfg, spp=spp_local)
    npix = pk.npix
    lanes = wf.LANES_PER_TILE
    tiles_per_shard = -(-npix // (lanes * mesh.n_data))
    raw = wf.make_raw(pk, tiles_per_shard)
    shard_pixels = tiles_per_shard * lanes
    dev = mesh.device
    # a device scalar: CUDA divides by a host scalar through its reciprocal
    spp_t = torch.tensor(float(spp_local), device=dev)

    def go(seed: int) -> torch.Tensor:
        # decorrelate the sample ranks (same lanes, other draws); the data
        # ranks are decorrelated by the lane-keyed streams
        seed_t = torch.tensor([seed + mesh.si * 0x9E37], dtype=torch.int32,
                              device=dev)
        est = raw(seed_t, mesh.di * shard_pixels) / spp_t
        if mesh.n_sample > 1:
            est = mesh.all_reduce(est, SAMPLE_AXIS) / mesh.n_sample
        return mesh.gather_data(est)[:npix]

    return go


def render_pallas_sharded(scene, camera, cfg, mesh: Mesh,
                          seed: int | None = None) -> torch.Tensor:
    """Render an (H, W, 3) frame with K1 sharded over `mesh`; every rank
    returns the whole frame. See build_sharded_pallas."""
    go = build_sharded_pallas(scene, camera, cfg, mesh)
    flat = go(cfg.seed if seed is None else seed)
    return flat.reshape(cfg.height, cfg.width, 3)
