"""Sharded forward rendering over the (data, sample) mesh.

Counterpart of ``vpt/dist/sharded.py``. vpt's render_sharded takes the
fused kernel per device (dist/sharded_pallas.py) or traces its XLA engine
under shard_map; here the kernel path is dist/sharded_pallas.py on K1, and
the engine is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import torch

from ..kernels.wavefront import KERNEL_INTEGRATORS
from .mesh import Mesh
from .sharded_pallas import render_pallas_sharded

__all__ = ["render_sharded"]


def render_sharded(scene, camera, cfg, mesh: Mesh,
                   backend: str = "auto") -> torch.Tensor:
    """Render an (H, W, 3) frame sharded over `mesh`, on mesh.device; every
    rank returns the whole frame. backend "auto" and "pallas" (vpt's name
    for its kernel path) run the render kernel per rank; "engine", and
    "auto" for an integrator the kernel does not have, would run vpt's XLA
    engine, which is not ported (ROADMAP Queue 1 item 9)."""
    if backend not in ("auto", "engine", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "engine" or cfg.integrator not in KERNEL_INTEGRATORS:
        raise NotImplementedError(
            f"render_sharded(backend={backend!r}, integrator="
            f"{cfg.integrator!r}): vpt's sharded XLA engine is not ported "
            "(ROADMAP Queue 1 item 9); the kernel path takes "
            f"{sorted(KERNEL_INTEGRATORS)}")
    return render_pallas_sharded(scene, camera, cfg, mesh)
