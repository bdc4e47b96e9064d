"""Inverse-rendering training on the differentiable render pair.

Counterpart of ``make_kernel_train_step``, ``_fit_loop`` and ``fit_kernel``
in ``vpt/dist/train_fast.py``. The step optimizes the medium and material
set {sigma_a, sigma_s, albedo, radiance}, and in a density field the fog
falloff "fog_k" (diff_field) or the blob rows "blobs" (diff_blobs), through
kernels/diff.py: K2 renders, K3 replays the paths for the gradient.

The loss is vpt's A/B unbiased MSE: two independent half-budget renders A
and B give E[(A-t)(B-t)] = (E[est]-t)^2 exactly, so low-spp steps do not
descend on estimator variance.

The geometric trainers run on the dual kernel K4 (kernels/geom.py):
make_geom_train_step / fit_geom take the A/B loss's gradient from the
tangent planes (grad_render); make_fd_geom_train_step / fit_geom_fd take
common-random-number central differences of the A/B loss on K4's
primal_only mode (4 launches per differentiated dimension), which keeps the
boundary terms the dual estimator drops.

optax.adam becomes torch.optim.Adam with optax's defaults, and the
optimizer keeps its own state: the step updates the params dict in place
and returns the loss. Param groups stand in for optax.multi_transform: a
leaf outside the optimizer stays frozen (fit_kernel's param_filter does
the same: examples/recover_blobs.py's Adam at 0.15 on "blobs" and
set_to_zero elsewhere is learning_rate=0.15 with a filter that keeps only
the updated "blobs"; Adam is per element). A learning rate may be a float or
a schedule count -> lr (exponential_decay). The multi-view and sharded
trainers of vpt's module are ROADMAP Queue 1 items 5 and 8.
"""
from __future__ import annotations

import time

import torch

from ..kernels.diff import make_diff_renderer, pack_params
from ..kernels.geom import (THETA_KEYS, flatten_theta, make_geom_renderer,
                            pack_theta)
from ..scene.camera import Camera
from ..scene.scene import Scene
from .train import project_params

__all__ = ["make_kernel_train_step", "fit_kernel", "exponential_decay",
           "make_geom_train_step", "fit_geom", "make_fd_geom_train_step",
           "fit_geom_fd"]


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
    """Recover {sigma_a, sigma_s, albedo, radiance}, plus the fog falloff
    "fog_k" when diff_field=True or the blob rows "blobs" (K, 5) when
    diff_blobs=True, from a target (H, W, 3) image with the render pair on
    `device` ("cuda": K2/K3 or raise; "cpu": their plain versions).
    `param_filter(updated, initial) -> params` can freeze entries (e.g. keep
    everything but sigma_s fixed). Returns (params, losses). diff_g and
    diff_grid raise NotImplementedError naming their ROADMAP item."""
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
                                  diff_g=diff_g, diff_field=diff_field,
                                  diff_blobs=diff_blobs, diff_grid=diff_grid,
                                  device=dev)
    return _fit_loop(step, params, target, width, height, steps, seed,
                     param_filter, log_every, dev)


# ---------------------------------------------------------------------------
# geometric inverse rendering on K4 (vpt/dist/train_fast.py:155-188,
# 210-302, 411-458)
# ---------------------------------------------------------------------------

def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float):
    """optax.exponential_decay (no staircase, no delay): the learning rate
    of update `count` (0 for the first) is
    init_value * decay_rate ** (count / transition_steps)."""
    def schedule(count: int) -> float:
        return init_value * decay_rate ** (count / transition_steps)

    return schedule


def _adam(theta: dict, learning_rate) -> torch.optim.Adam:
    """optax.adam(learning_rate) over every leaf of theta; a schedule rides
    in the param group (see _optimizer_step)."""
    schedule = learning_rate if callable(learning_rate) else None
    lr0 = float(schedule(0)) if schedule else float(learning_rate)
    return torch.optim.Adam(
        [{"params": list(theta.values()), "lr": lr0, "schedule": schedule,
          "count": 0}], lr=lr0, betas=(0.9, 0.999), eps=1e-8)


def _optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """optimizer.step(), first setting each group's learning rate from its
    schedule for this update, where the group has one."""
    for group in optimizer.param_groups:
        if group.get("schedule") is not None:
            group["lr"] = float(group["schedule"](group["count"]))
            group["count"] += 1
    optimizer.step()


def make_geom_train_step(scene: Scene, camera: Camera, width: int,
                         height: int, spp: int,
                         optimizer: torch.optim.Optimizer, *,
                         sphere: int | None, cam_grads: bool = True,
                         dir_grads: bool = False, distance: str = "free",
                         max_bounces: int = 32, device="cuda"):
    """Build step(theta, target_flat, seed) -> loss: the A/B unbiased MSE
    of two spp // 2 renders (seeds 2*seed, 2*seed + 1) through K4's
    grad_render, whose gradient contracts the tangent planes. theta is the
    pack_theta dict whose tensors `optimizer` holds (on `device`,
    requiring grad); it is updated in place. The loss comes back detached,
    without a synchronisation."""
    render = make_geom_renderer(
        scene, camera, width, height, max(spp // 2, 1), sphere=sphere,
        cam_grads=cam_grads, dir_grads=dir_grads, distance=distance,
        max_bounces=max_bounces, device=device)
    gr = render.grad_render

    def step(theta: dict, target_flat: torch.Tensor, seed: int):
        optimizer.zero_grad(set_to_none=True)
        a = gr(theta, 2 * seed)
        b = gr(theta, 2 * seed + 1)
        loss = torch.mean((a - target_flat) * (b - target_flat))
        loss.backward()
        _optimizer_step(optimizer)
        return loss.detach()

    return step


def _fd_dims(sphere, cam_grads, sigma, dir_grads=False):
    dims = (([0, 1, 2] if sphere is not None else [])
            + ([3, 4, 5, 6] if cam_grads else [])
            + ([7, 8] if sigma else [])
            + ([9, 10, 11] if dir_grads else []))
    if not dims:
        raise ValueError("no differentiated block enabled")
    return dims


def _phys_probe(v: torch.Tensor) -> torch.Tensor:
    """Clamp an FD probe's sigma block (dims 7-8) to >= 1e-6: theta stays
    there after each update, but theta - h_sigma can cross zero (a negative
    extinction). At the floor lp == lm: a zero gradient, projected gradient
    descent's boundary behaviour. The cam_dir block is unconstrained."""
    v = v.clone()
    v[7:9] = torch.clamp_min(v[7:9], 1e-6)
    return v


def make_fd_geom_train_step(scene: Scene, camera: Camera, width: int,
                            height: int, spp: int,
                            optimizer: torch.optim.Optimizer, *,
                            sphere: int | None, cam_grads: bool = True,
                            sigma: bool = False, dir_grads: bool = False,
                            h: float = 0.5, h_fov: float = 2e-3,
                            h_sigma: float = 5e-4, h_dir: float = 1e-3,
                            distance: str = "free", max_bounces: int = 32,
                            sampler: str = "random", device="cuda"):
    """Build step(theta, target_flat, seed) -> loss from common-random-
    number CENTRAL differences of the A/B loss on K4's primal_only mode:
    for each enabled dimension k, the A/B pair at theta + h_k e_k and at
    theta - h_k e_k with the same seeds (4 launches through
    render.run_vec), g_k = (l+ - l-) / (2 h_k). Seed-matched noise cancels
    to O(h); the event flips between the two probes are the boundary terms
    the dual estimator drops. The gradient goes to the leaves' .grad and
    `optimizer` updates theta in place; with sigma=True, sigma_a and
    sigma_s are then clamped to >= 1e-6. The loss is (l+ + l-) / 2 of the
    first dimension; step.probe_losses holds every (l+, l-) pair."""
    render = make_geom_renderer(
        scene, camera, width, height, max(spp // 2, 1), sphere=sphere,
        cam_grads=cam_grads, distance=distance, max_bounces=max_bounces,
        sampler=sampler, primal_only=True, device=device)
    run = render.run_vec
    dev = torch.device(device)
    dims = _fd_dims(sphere, cam_grads, sigma, dir_grads)
    hs = [h, h, h, h, h, h, h_fov, h_sigma, h_sigma, h_dir, h_dir, h_dir]

    def loss_of(v, s, target_flat):
        a, _ = run(_phys_probe(v), 2 * s)
        b, _ = run(_phys_probe(v), 2 * s + 1)
        return torch.mean((a - target_flat) * (b - target_flat))

    def step(theta: dict, target_flat: torch.Tensor, seed: int):
        probes = []
        with torch.no_grad():
            vec = flatten_theta(theta).to(dev)
            g = torch.zeros(12, dtype=torch.float32, device=dev)
            loss = None
            for k in dims:
                e = torch.zeros(12, dtype=torch.float32, device=dev)
                e[k] = hs[k]
                lp = loss_of(vec + e, seed, target_flat)
                lm = loss_of(vec - e, seed, target_flat)
                probes.append((lp, lm))
                # a device scalar: CUDA divides by a host scalar as a
                # multiply by its reciprocal
                g[k] = (lp - lm) / torch.tensor(2.0 * hs[k], device=dev)
                if loss is None:
                    loss = 0.5 * (lp + lm)
        optimizer.zero_grad(set_to_none=True)
        off = 0
        for key, n in THETA_KEYS:
            theta[key].grad = g[off:off + n].reshape(theta[key].shape).clone()
            off += n
        _optimizer_step(optimizer)
        if sigma:
            with torch.no_grad():
                for key in ("sigma_a", "sigma_s"):
                    theta[key].clamp_(min=1e-6)
        step.probe_losses = probes
        return loss

    return step


def _theta_on(scene, camera, sphere, device, requires_grad):
    dev = torch.device(device)
    return {k: v.to(dev).requires_grad_(requires_grad)
            for k, v in pack_theta(scene, camera, sphere).items()}


def fit_geom(scene: Scene, camera: Camera, target, *, sphere: int | None,
             cam_grads: bool = True, dir_grads: bool = False,
             steps: int = 60, spp: int = 16, learning_rate=2e-1,
             distance: str = "free", max_bounces: int = 32, seed: int = 0,
             param_filter=None, log_every: int = 0, device="cuda"):
    """Recover a sphere (light) centre and/or the camera pose from a target
    (H, W, 3) image with the dual kernel on `device` ("cuda": K4 or raise;
    "cpu": its plain version). Adam over every theta leaf; learning_rate a
    float or a schedule. Returns (theta, losses)."""
    height, width = target.shape[:2]
    theta = _theta_on(scene, camera, sphere, device, True)
    optimizer = _adam(theta, learning_rate)
    step = make_geom_train_step(scene, camera, width, height, spp, optimizer,
                                sphere=sphere, cam_grads=cam_grads,
                                dir_grads=dir_grads, distance=distance,
                                max_bounces=max_bounces, device=device)
    return _fit_loop(step, theta, target, width, height, steps, seed,
                     param_filter, log_every, device)


def fit_geom_fd(scene: Scene, camera: Camera, target, *,
                sphere: int | None, cam_grads: bool = True,
                sigma: bool = False, dir_grads: bool = False,
                steps: int = 60, spp: int = 16, learning_rate=2e-1,
                h: float = 0.5, h_fov: float = 2e-3, h_sigma: float = 5e-4,
                h_dir: float = 1e-3, distance: str = "free",
                max_bounces: int = 32, sampler: str = "random",
                seed: int = 0, param_filter=None, log_every: int = 0,
                device="cuda"):
    """fit_geom with boundary-aware CRN finite-difference gradients
    (make_fd_geom_train_step). sigma=True also recovers sigma_a / sigma_s;
    build the step with a per-group optimizer when sigma needs its own
    rate. Returns (theta, losses)."""
    height, width = target.shape[:2]
    theta = _theta_on(scene, camera, sphere, device, False)
    optimizer = _adam(theta, learning_rate)
    step = make_fd_geom_train_step(
        scene, camera, width, height, spp, optimizer, sphere=sphere,
        cam_grads=cam_grads, sigma=sigma, dir_grads=dir_grads, h=h,
        h_fov=h_fov, h_sigma=h_sigma, h_dir=h_dir, distance=distance,
        max_bounces=max_bounces, sampler=sampler, device=device)
    return _fit_loop(step, theta, target, width, height, steps, seed,
                     param_filter, log_every, device)
