"""Inverse-rendering training on the differentiable render pair.

Counterpart of ``make_kernel_train_step``, ``_fit_loop`` and ``fit_kernel``
in ``vpt/dist/train_fast.py``. The step optimizes the medium and material
set {sigma_a, sigma_s, albedo, radiance} through kernels/diff.py: K2 renders,
K3 replays the paths for the gradient.

The loss is vpt's A/B unbiased MSE: two independent half-budget renders A
and B give E[(A-t)(B-t)] = (E[est]-t)^2 exactly, so low-spp steps do not
descend on estimator variance.

optax.adam becomes torch.optim.Adam with optax's defaults, and the
optimizer keeps its own state: the step updates the params dict in place
and returns the loss. The geometric, multi-view and sharded trainers of
vpt's module are ROADMAP Queue 1 items 5 and 8.
"""
from __future__ import annotations

import time

import torch

from ..kernels.diff import make_diff_renderer, pack_params
from ..scene.camera import Camera
from ..scene.scene import Scene
from .train import project_params

__all__ = ["make_kernel_train_step", "fit_kernel"]


def make_kernel_train_step(scene: Scene, camera: Camera, width: int,
                           height: int, spp: int,
                           optimizer: torch.optim.Optimizer, *,
                           distance: str = "free", max_bounces: int = 32,
                           sampler: str = "random", diff_g: bool = False,
                           diff_field: bool = False, diff_blobs: bool = False,
                           diff_grid: bool = False, device="cuda"):
    """Build step(params, target_flat, seed) -> loss. `params` is the
    pack_params dict whose tensors `optimizer` holds (leaves on `device`
    that require grad); target_flat is (npix, 3) on `device`. One step
    renders A and B at spp // 2 with seeds 2*seed and 2*seed + 1, takes
    the gradient of mean((A - t)(B - t)), updates the params in place and
    projects them onto their domain. The loss comes back detached, without
    a synchronisation."""
    render = make_diff_renderer(
        scene, camera, width, height, max(spp // 2, 1), distance=distance,
        max_bounces=max_bounces, sampler=sampler, diff_g=diff_g,
        diff_field=diff_field, diff_blobs=diff_blobs, diff_grid=diff_grid,
        device=device)

    def step(params: dict, target_flat: torch.Tensor, seed: int):
        optimizer.zero_grad(set_to_none=True)
        a = render(params, 2 * seed)
        b = render(params, 2 * seed + 1)
        loss = torch.mean((a - target_flat) * (b - target_flat))
        loss.backward()
        optimizer.step()
        project_params(params)
        return loss.detach()

    return step


def _fit_loop(step, params, target, width, height, steps, seed,
              param_filter, log_every, device):
    """Shared training loop: per-step seed, optional freeze filter, loss
    log. Returns (params, losses)."""
    dev = torch.device(device)
    init = {k: v.detach().clone() for k, v in params.items()}
    target_flat = torch.as_tensor(target, dtype=torch.float32).to(
        dev).reshape(width * height, 3)
    losses = []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(params, target_flat, seed + i)
        if param_filter is not None:
            kept = param_filter(params, init)
            with torch.no_grad():
                for k, v in kept.items():
                    if v is not params[k]:
                        params[k].copy_(v)
        losses.append(float(loss))          # waits for the step
        if log_every and i % log_every == 0:
            print(f"step {i:4d}  loss {losses[-1]:.6g}  "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
    return {k: v.detach() for k, v in params.items()}, losses


def fit_kernel(scene: Scene, camera: Camera, target, *, steps: int = 100,
               spp: int = 16, learning_rate=1.5e-3, distance: str = "free",
               max_bounces: int = 32, sampler: str = "random", seed: int = 0,
               diff_g: bool = False, diff_field: bool = False,
               diff_blobs: bool = False, diff_grid: bool = False,
               param_filter=None, log_every: int = 0, device="cuda"):
    """Recover {sigma_a, sigma_s, albedo, radiance} from a target (H, W, 3)
    image with the render pair on `device` ("cuda": K2/K3 or raise; "cpu":
    their plain versions). `param_filter(updated, initial) -> params` can
    freeze entries (e.g. keep everything but sigma_s fixed). Returns
    (params, losses). diff_g, diff_field, diff_blobs and diff_grid raise
    NotImplementedError naming their ROADMAP item."""
    height, width = target.shape[:2]
    dev = torch.device(device)
    params = {k: v.to(dev).requires_grad_()
              for k, v in pack_params(scene, with_g=diff_g,
                                      with_field=diff_field,
                                      with_blobs=diff_blobs,
                                      with_grid=diff_grid).items()}
    optimizer = torch.optim.Adam(list(params.values()), lr=learning_rate,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = make_kernel_train_step(scene, camera, width, height, spp,
                                  optimizer, distance=distance,
                                  max_bounces=max_bounces, sampler=sampler,
                                  device=dev)
    return _fit_loop(step, params, target, width, height, steps, seed,
                     param_filter, log_every, dev)
