"""Heterogeneous participating media: spatially varying density fields.

Counterpart of ``vpt/media/density.py:60-207, 302-316``. A field d(x) >= 0
scales the medium: sigma_a(x) = sigma_a d(x) and sigma_s(x) = sigma_s d(x),
so the single-scattering albedo stays sigma_s / sigma_t. Three kinds, whose
formulas the kernels bake (kernels/prims.py field_* and grid_*,
csrc/field.cuh, csrc/grid.cuh):

  - "exp_height": d(x) = exp(-k (x_y - y0)), ground fog; params (2,)
    [k, y0]. Free-flight distances invert in closed form.
  - "blobs": d(x) = sum_i w_i exp(-|x - c_i|^2 / (2 r_i^2)), smoke puffs;
    params (K, 5) rows [cx, cy, cz, r, w]. Free-flight distances come from
    delta (Woodcock) tracking against the majorant, at most max_null null
    collisions per flight.
  - "grid": voxel values (nx, ny, nz) at the voxel centres origin + (i +
    1/2) spacing, trilinear, clamp-to-edge. Transport follows vpt's
    canonical piecewise-constant ray model: n_march midpoint segments over
    a window of at most march_extent grid diagonals, a constant head and
    a constant tail; the optical depth, the free-flight inversion and every
    transmittance derive from that one model. transport_interp "nearest"
    evaluates the model's densities xy-nearest / z-linear (one table word
    instead of four); appearance densities stay trilinear.

vpt's engine-side functions of the module (optical_depth, sample_distance,
transmittance_between) wait for its engine, ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["DensityField", "exp_height", "blobs", "grid", "density",
           "EXP_HEIGHT", "BLOBS", "GRID"]

EXP_HEIGHT = "exp_height"
BLOBS = "blobs"
GRID = "grid"


@dataclasses.dataclass(frozen=True)
class DensityField:
    """Spatially varying density multiplier d(x) >= 0.

    params:   exp_height (2,) [k, y0]; blobs (K, 5) [cx, cy, cz, r, w];
              grid (nx, ny, nz) voxel values.
    kind:     "exp_height", "blobs" or "grid".
    majorant: an upper bound of d(x) over the region rays traverse (delta
              tracking's null-collision rate; sum(w) is always safe for
              blobs; a grid's trainer clips its values to it).
    max_null: the cap on delta-tracking null collisions per flight.
    grid_origin, grid_spacing: a grid's world-space min corner and voxel
              size per axis.
    n_march:  a grid's marched segments per ray; march_extent caps the
              marched window, in grid diagonals.
    transport_interp: a grid's transport interpolant, "tri" or
              "nearest"."""

    params: torch.Tensor
    kind: str = EXP_HEIGHT
    majorant: float = 1.0
    max_null: int = 64
    grid_origin: tuple = ()
    grid_spacing: tuple = ()
    n_march: int = 32
    march_extent: float = 4.0
    transport_interp: str = "tri"

    def __post_init__(self):
        if self.kind not in (EXP_HEIGHT, BLOBS, GRID):
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


def grid(values, origin, spacing, majorant: float | None = None,
         max_null: int = 64, n_march: int = 32,
         transport_interp: str = "tri", dtype=torch.float32) -> DensityField:
    """Voxel-grid density: values (nx, ny, nz) at the voxel centres,
    trilinear, clamp-to-edge; origin the world min corner, spacing the
    voxel size per axis. The default majorant is max(values) * 1.001,
    folded in float64 as vpt folds it."""
    v64 = np.asarray(values.detach().cpu() if isinstance(values, torch.Tensor)
                     else values, np.float64)
    if v64.ndim != 3 or min(v64.shape) < 2:
        raise ValueError(f"grid needs (nx, ny, nz) with every axis >= 2; "
                         f"got {v64.shape}")
    if majorant is None:
        majorant = float(np.max(v64)) * 1.001
    if transport_interp not in ("tri", "nearest"):
        raise ValueError(f"transport_interp must be 'tri' or 'nearest', "
                         f"got {transport_interp!r}")
    vals = (values.detach().to(dtype) if isinstance(values, torch.Tensor)
            else torch.as_tensor(v64).to(dtype))
    return DensityField(
        params=vals, kind=GRID, majorant=float(majorant), max_null=max_null,
        grid_origin=tuple(float(x) for x in origin),
        grid_spacing=tuple(float(x) for x in spacing), n_march=n_march,
        transport_interp=transport_interp)


def grid_rails(field: DensityField):
    """World-space clamp rails of the trilinear lattice (vpt's _grid_rails):
    the clamp engages at origin + spacing / 2 (low) and origin + (n - 1/2)
    spacing (high), folded in float64."""
    org = tuple(float(v) for v in field.grid_origin)
    spc = tuple(float(v) for v in field.grid_spacing)
    lo = tuple(org[i] + 0.5 * spc[i] for i in range(3))
    hi = tuple(org[i] + (n - 0.5) * spc[i]
               for i, n in enumerate(field.params.shape))
    return lo, hi


def density(field: DensityField, x: torch.Tensor) -> torch.Tensor:
    """d(x) for x (..., 3) -> (...), differentiable in field.params."""
    p = field.params
    if field.kind == EXP_HEIGHT:
        return torch.exp(torch.clamp(-p[0] * (x[..., 1] - p[1]), -80.0, 80.0))
    if field.kind == BLOBS:
        c, r, w = p[:, :3], p[:, 3], p[:, 4]
        dx = x[..., None, :] - c
        d2 = torch.sum(dx * dx, dim=-1)
        return torch.sum(w * torch.exp(-0.5 * d2 / (r * r)), dim=-1)
    nx, ny, nz = p.shape
    org = torch.tensor(field.grid_origin, dtype=p.dtype, device=p.device)
    spc = torch.tensor(field.grid_spacing, dtype=p.dtype, device=p.device)
    top = torch.tensor([nx - 1, ny - 1, nz - 1], dtype=p.dtype,
                       device=p.device)
    u = torch.minimum(torch.clamp_min((x - org) / spc - 0.5, 0.0), top)
    i0 = torch.minimum(torch.clamp_min(torch.floor(u).to(torch.int64), 0),
                       torch.tensor([nx - 2, ny - 2, nz - 2],
                                    device=p.device))
    f = torch.clamp(u - i0.to(p.dtype), 0.0, 1.0)
    flat = p.reshape(-1)

    def corner(a, b, c):
        return flat[((i0[..., 0] + a) * ny + (i0[..., 1] + b)) * nz
                    + (i0[..., 2] + c)]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = corner(0, 0, 0) * (1 - fz) + corner(0, 0, 1) * fz
    c01 = corner(0, 1, 0) * (1 - fz) + corner(0, 1, 1) * fz
    c10 = corner(1, 0, 0) * (1 - fz) + corner(1, 0, 1) * fz
    c11 = corner(1, 1, 0) * (1 - fz) + corner(1, 1, 1) * fz
    return ((c00 * (1 - fy) + c01 * fy) * (1 - fx)
            + (c10 * (1 - fy) + c11 * fy) * fx)
