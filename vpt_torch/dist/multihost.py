"""Process-group start-up and cross-rank image assembly.

Counterpart of ``vpt/dist/multihost.py``. vpt brings up JAX's
multi-controller runtime (`jax.distributed.initialize`) and a global mesh
over every device; here each rank is a process that joins a
torch.distributed process group, as `torchrun` starts them, and the mesh
is dist/mesh.py's over the group's world.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

__all__ = ["initialize", "global_mesh", "assemble_image"]


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None) -> None:
    """Join the process group (idempotent). With no arguments it reads
    torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)
    and, where that is absent, stays single-process. Explicit arguments are
    a manual start (tests, a bare machine): e.g. init_method
    "tcp://127.0.0.1:<port>", world_size and rank; a failure there raises.
    backend: "nccl" when a card is present, else "gloo", unless given."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and world_size is None and rank is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            return                  # no cluster environment: one process
        dist.init_process_group(backend=backend, init_method="env://")
        return
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def global_mesh(sample_shards: int | None = None, device="cuda") -> Mesh:
    """The (data, sample) mesh over every rank of the process group (a
    (1, 1) mesh without one); pass it to dist.render_sharded and the
    sharded train steps."""
    return make_mesh(sample_shards=sample_shards, device=device)


def assemble_image(flat: torch.Tensor, cfg, mesh: Mesh) -> torch.Tensor:
    """Gather a pixel-sharded render into the full (H, W, 3) image on
    every rank: flat is this rank's (shard_pixels, 3) rows of the frame's
    lanes (its data index's contiguous range, every rank's the same
    length); the data axis' shards are all-gathered in order and cut to
    the frame."""
    npix = cfg.width * cfg.height
    return mesh.gather_data(flat)[:npix].reshape(cfg.height, cfg.width, 3)
