"""Pinhole camera (counterpart of ``vpt/scene/camera.py``).

Reproduces the reference camera model (src/rt.cpp:755-759, 787):
  camera ray   o = (0, 11.2, 214), look dir d = normalize(0, -0.042612, -1)
  cx = (w * 0.5095 / h, 0, 0)
  cy = normalize(cx x d) * 0.5095
  per-sample dir = cx*((x + u - .5)/w - .5) + cy*((y + v - .5)/h - .5) + d

Primary rays are generated inside the render kernel (kernels/wavefront.py),
which takes the screen basis from `screen_basis`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Camera", "default_camera", "look_at", "screen_basis"]


@dataclasses.dataclass(frozen=True)
class Camera:
    origin: torch.Tensor     # (3,)
    direction: torch.Tensor  # (3,) unit look direction
    fov_scale: torch.Tensor  # scalar — the 0.5095 screen half-extent factor


def _normalize(a: torch.Tensor) -> torch.Tensor:
    # same f32 op sequence as vpt.core.vecmath.normalize, so the default
    # camera's direction is bit-identical to vpt's
    n2 = (a * a).sum(-1)
    return a * (1.0 / torch.sqrt(n2))


def default_camera(dtype=torch.float32, device="cpu") -> Camera:
    return Camera(
        origin=torch.tensor([0.0, 11.2, 214.0], dtype=dtype, device=device),
        direction=_normalize(
            torch.tensor([0.0, -0.042612, -1.0], dtype=dtype, device=device)),
        fov_scale=torch.tensor(0.5095, dtype=dtype, device=device),
    )


def look_at(origin, target, fov_scale: float = 0.5095,
            dtype=torch.float32, device="cpu") -> Camera:
    """Camera at `origin` looking at `target`."""
    o = torch.as_tensor(origin, device=device).to(dtype)
    t = torch.as_tensor(target, device=device).to(dtype)
    return Camera(origin=o, direction=_normalize(t - o),
                  fov_scale=torch.tensor(fov_scale, dtype=dtype,
                                         device=device))


def screen_basis(camera: Camera, width: int, height: int):
    """(cx, cy) screen-plane basis, float64 numpy (3,) each, per
    src/rt.cpp:758-759. Folded in double on the host exactly as the vpt
    render kernel folds it (vpt/kernels/wavefront.py:211-218); the render
    kernels round it to f32."""
    fov = float(camera.fov_scale)
    cx = np.array([width * fov / height, 0.0, 0.0])
    cy = np.cross(cx, camera.direction.detach().cpu().numpy().astype(np.float64))
    cy = cy / np.linalg.norm(cy) * fov
    return cx, cy
