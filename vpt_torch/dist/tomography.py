"""Multi-view voxel tomography on the differentiable render pair.

Counterpart of ``vpt/dist/tomography.py:49-135, 186-246``: recover a
voxel-grid density field (media.density.grid) from V target views through
K2/K3 with diff_grid (kernels/diff.py), the voxel gradient coming from K3's
two-phase replay and voxel scatter.

The estimator is vpt's (and dist/train_fast.py's multi-view step's):
  * the A/B MSE: two independent renders per view, loss mean((A - t)(B -
    t)), whose expectation is (E[render] - t)^2, so the Monte-Carlo variance
    does not bias the gradient;
  * fixed target-relMSE pixel weights, 1 / (mean_rgb(target) + eps)^2;
  * an L1 prior lam * mean(|v|) (zero-signal voxels random-walk under Adam
    without it) and an anisotropic total-variation prior;
  * a projection after each Adam step onto [0, majorant / 1.001]: the
    majorant is the grid's static bound.

vpt's engine backend (backend="engine", its default) trains through its
XLA engine, ROADMAP Queue 1 item 9; here backend="kernel" is the default
and the only one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.diff import make_diff_renderer, pack_params
from ..scene.scene import Medium, Scene
from .train_fast import _optimizer_step, adam

__all__ = ["make_grid_train_step", "fit_grid"]


def _grid_scene(scene: Scene, values: torch.Tensor) -> Scene:
    """The scene with its grid's voxel values replaced."""
    field = dataclasses.replace(scene.medium.density,
                                params=values.detach().cpu().float())
    return dataclasses.replace(
        scene, medium=Medium(scene.medium.sigma_a, scene.medium.sigma_s,
                             scene.medium.g, field))


def _tv(v: torch.Tensor) -> torch.Tensor:
    """Anisotropic total variation: the mean absolute forward difference
    along each grid axis, averaged over the three axes."""
    dx = torch.abs(v[1:, :, :] - v[:-1, :, :])
    dy = torch.abs(v[:, 1:, :] - v[:, :-1, :])
    dz = torch.abs(v[:, :, 1:] - v[:, :, :-1])
    return (torch.mean(dx) + torch.mean(dy) + torch.mean(dz)) / 3.0


def make_grid_train_step(scene: Scene, cameras, width: int, height: int,
                         spp: int, optimizer: torch.optim.Optimizer, *,
                         max_bounces: int = 8, backend: str = "kernel",
                         sampler: str = "ld", reg_l1: float = 0.0,
                         reg_tv: float = 0.0, distance: str = "free",
                         device="cuda"):
    """step(values, targets_flat, weights, seed) -> loss.

    values: the (nx, ny, nz) voxel values, a leaf tensor on `device` that
    requires grad and that `optimizer` holds; the step updates it in place
    (Adam, the group's schedule advanced) and clips it to [0, majorant /
    1.001]. targets_flat: (V, width * height, 3); weights: None or (V,
    npix, 1). spp is the sample count of each render (each step renders two
    per view, view i at seeds seed * 2V + 2i and + 1). The loss comes back
    detached, without a synchronisation."""
    fld = scene.medium.density
    if fld is None or fld.kind != "grid":
        raise ValueError("make_grid_train_step needs a voxel-grid scene "
                         "(scene.medium.density.kind == 'grid')")
    if backend == "engine":
        raise NotImplementedError(
            "make_grid_train_step(backend='engine') trains through vpt's XLA "
            "engine, ROADMAP Queue 1 item 9; backend='kernel' runs K2/K3")
    if backend != "kernel":
        raise ValueError(f"unknown backend {backend!r}")
    V = len(cameras)
    vmax = float(fld.majorant) / 1.001
    renders = [make_diff_renderer(scene, c, width, height, spp,
                                  max_bounces=max_bounces, sampler=sampler,
                                  distance=distance, diff_grid=True,
                                  device=device)
               for c in cameras]
    dev = torch.device(device)
    base = {k: v.to(dev)
            for k, v in pack_params(scene, with_grid=True).items()}

    def step(values: torch.Tensor, targets_flat: torch.Tensor, weights,
             seed: int) -> torch.Tensor:
        values.grad = None
        p = dict(base)
        p["grid"] = values
        tot = 0.0
        for i, render in enumerate(renders):
            a = render(p, seed * 2 * V + 2 * i)
            b = render(p, seed * 2 * V + 2 * i + 1)
            e = (a - targets_flat[i]) * (b - targets_flat[i])
            if weights is not None:
                e = e * weights[i]
            tot = tot + torch.mean(e)
        reg = reg_l1 * torch.mean(torch.abs(values)) + reg_tv * _tv(values)
        loss = tot / V + reg
        loss.backward()
        _optimizer_step(optimizer)
        with torch.no_grad():
            values.clamp_(0.0, vmax)
        return loss.detach()

    step.renders = renders
    return step


def fit_grid(scene: Scene, cameras, targets, *, steps: int = 100,
             spp: int = 4, learning_rate=2e-2, max_bounces: int = 8,
             seed: int = 0, relmse_weights: bool = True,
             relmse_eps: float = 0.05, log_every: int = 0,
             backend: str = "kernel", sampler: str = "ld",
             reg_l1: float = 0.0, reg_tv: float = 0.0,
             distance: str = "free", polyak_from: int = 0, device="cuda"):
    """Recover scene.medium.density.params, the voxel values, from V target
    views (targets: (H, W, 3) each, one per camera). The scene carries the
    initial grid; its shape, origin, spacing and majorant are the
    reconstruction's fixed geometry. learning_rate is a float or a schedule
    count -> lr (train_fast.exponential_decay). Step i uses seed + i.

    polyak_from > 0 also averages the iterates from step polyak_from on
    (counted from 1, after each projection) and returns that average; 0
    returns the last iterate. A polyak_from past `steps` or below 0 raises:
    vpt returns the last iterate for the first without a word, and for the
    second averages every step.

    Returns (values, losses)."""
    if len(cameras) != len(targets):
        raise ValueError("one target image per camera")
    if polyak_from < 0 or polyak_from > steps:
        raise ValueError(f"polyak_from={polyak_from} must be in [0, steps="
                         f"{steps}] (0: no averaging)")
    dev = torch.device(device)
    tg = [torch.as_tensor(t, dtype=torch.float32) for t in targets]
    height, width = tg[0].shape[:2]
    values = torch.as_tensor(scene.medium.density.params, dtype=torch.float32
                             ).detach().clone().to(dev).requires_grad_()
    optimizer = adam({"grid": values}, learning_rate)
    step = make_grid_train_step(scene, cameras, width, height, spp,
                                optimizer, max_bounces=max_bounces,
                                backend=backend, sampler=sampler,
                                reg_l1=reg_l1, reg_tv=reg_tv,
                                distance=distance, device=dev)
    targets_flat = torch.stack([t.reshape(width * height, 3)
                                for t in tg]).to(dev)
    weights = (1.0 / (torch.mean(targets_flat, dim=-1, keepdim=True)
                      + relmse_eps) ** 2 if relmse_weights else None)
    losses = []
    avg, n_avg = None, 0
    for i in range(steps):
        loss = step(values, targets_flat, weights, seed + i)
        losses.append(float(loss))              # waits for the step
        if polyak_from and i + 1 >= polyak_from:
            n_avg += 1
            v = values.detach()
            avg = v.clone() if avg is None else avg + (v - avg) / n_avg
        if log_every and i % log_every == 0:
            print(f"step {i:4d}  loss {losses[-1]:.6g}", flush=True)
    return (avg if avg is not None else values.detach()), losses
