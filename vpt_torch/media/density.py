"""Heterogeneous participating media: spatially varying density fields.

Counterpart of ``vpt/media/density.py:60-135``. A field d(x) >= 0 scales
the medium: sigma_a(x) = sigma_a d(x) and sigma_s(x) = sigma_s d(x), so the
single-scattering albedo stays sigma_s / sigma_t. Two analytic kinds have
closed-form line integrals, and the kernels bake their formulas
(kernels/prims.py field_*, csrc/path.cuh):

  - "exp_height": d(x) = exp(-k (x_y - y0)), ground fog; params (2,)
    [k, y0]. Free-flight distances invert in closed form.
  - "blobs": d(x) = sum_i w_i exp(-|x - c_i|^2 / (2 r_i^2)), smoke puffs;
    params (K, 5) rows [cx, cy, cz, r, w]. Free-flight distances come from
    delta (Woodcock) tracking against the majorant, at most max_null null
    collisions per flight.

Voxel grids (kind "grid") are ROADMAP Queue 1 item 7; vpt's engine-side
functions of the module (optical_depth, sample_distance,
transmittance_between, the grid helpers) wait for its engine, item 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DensityField", "exp_height", "blobs", "grid", "EXP_HEIGHT",
           "BLOBS", "GRID"]

EXP_HEIGHT = "exp_height"
BLOBS = "blobs"
GRID = "grid"

_GRID_TODO = ("voxel-grid density fields (kind 'grid') are ROADMAP Queue 1 "
              "item 7")


@dataclasses.dataclass(frozen=True)
class DensityField:
    """Spatially varying density multiplier d(x) >= 0.

    params:   exp_height (2,) [k, y0]; blobs (K, 5) [cx, cy, cz, r, w].
    kind:     "exp_height" or "blobs".
    majorant: an upper bound of d(x) over the region rays traverse (delta
              tracking's null-collision rate; sum(w) is always safe for
              blobs).
    max_null: the cap on delta-tracking null collisions per flight."""

    params: torch.Tensor
    kind: str = EXP_HEIGHT
    majorant: float = 1.0
    max_null: int = 64

    def __post_init__(self):
        if self.kind == GRID:
            raise NotImplementedError(_GRID_TODO)
        if self.kind not in (EXP_HEIGHT, BLOBS):
            raise ValueError(f"unknown density field kind {self.kind!r}")


def exp_height(k: float, y0: float, majorant: float,
               dtype=torch.float32) -> DensityField:
    return DensityField(params=torch.tensor([k, y0], dtype=torch.float64)
                        .to(dtype), kind=EXP_HEIGHT, majorant=float(majorant))


def blobs(rows, majorant: float | None = None,
          dtype=torch.float32) -> DensityField:
    """rows: (K, 5) [cx, cy, cz, radius, weight]. The default majorant is
    the sum of the weights, folded in float64 as vpt folds it."""
    p = torch.as_tensor(np.asarray(rows, np.float64)).to(dtype).reshape(-1, 5)
    if majorant is None:
        majorant = float(np.sum(p[:, 4].to(torch.float64).numpy()))
    return DensityField(params=p, kind=BLOBS, majorant=float(majorant))


def grid(*args, **kwargs) -> DensityField:
    """vpt's voxel-grid field: not ported yet."""
    raise NotImplementedError(_GRID_TODO)
