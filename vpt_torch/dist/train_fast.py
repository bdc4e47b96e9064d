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
boundary terms the dual estimator drops. Both take any medium K4 takes: in
an analytic density field the dual field forms, in a voxel grid only the
FD path (K4 refuses a grid's tangent planes with vpt's reason).

make_multiview_train_step / fit_multiview run V pairs, one per camera,
that share one parameter dict and average their A/B losses, optionally
with the medium block in log space and target-relMSE pixel weights.

optax.adam becomes torch.optim.Adam with optax's defaults (adam()), and
the optimizer keeps its own state: the step updates the params dict in
place and returns the loss. A learning rate may be a float, a schedule
count -> lr (exponential_decay), or a dict {leaf: rate} that stands in for
optax.multi_transform: one param group per leaf with its own rate or
schedule, and a leaf absent from the dict or mapped to None
(optax.set_to_zero) is not in the optimizer and never moves.

The sharded steps (make_sharded_kernel_train_step,
make_sharded_fd_geom_train_step) run one process per rank of a (data,
sample) mesh (dist/mesh.py) over torch.distributed: each rank renders its
contiguous range of tiles, the losses are summed over the data group, and
the gradients are all-reduced before every rank takes the same update.
"""
from __future__ import annotations

import time

import torch

from ..kernels.diff import make_diff_renderer, pack_params
from ..kernels.geom import (THETA_KEYS, flatten_theta, make_geom_renderer,
                            pack_theta)
from ..kernels.prims import f32
from ..scene.camera import Camera
from ..scene.scene import Scene
from .mesh import DATA_AXIS, SAMPLE_AXIS
from .train import project_params

__all__ = ["adam", "exponential_decay", "make_kernel_train_step",
           "fit_kernel", "make_multiview_train_step", "fit_multiview",
           "make_geom_train_step", "fit_geom", "make_fd_geom_train_step",
           "fit_geom_fd", "make_sharded_kernel_train_step",
           "make_sharded_fd_geom_train_step"]


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float):
    """optax.exponential_decay (no staircase, no delay): the learning rate
    of update `count` (0 for the first) is
    init_value * decay_rate ** (count / transition_steps)."""
    def schedule(count: int) -> float:
        return init_value * decay_rate ** (count / transition_steps)

    return schedule


def adam(params: dict, learning_rate) -> torch.optim.Adam:
    """optax.adam(learning_rate) over every leaf of params; a dict
    {leaf: rate} is optax.multi_transform with one adam per leaf (each its
    own param group) and set_to_zero for the leaves it leaves out or maps
    to None. A rate is a float or a schedule count -> lr, which rides in
    its group and is advanced by _optimizer_step."""
    def group(leaves, rate):
        schedule = rate if callable(rate) else None
        lr0 = float(schedule(0)) if schedule else float(rate)
        return {"params": leaves, "lr": lr0, "schedule": schedule,
                "count": 0}

    if isinstance(learning_rate, dict):
        unknown = set(learning_rate) - set(params)
        if unknown:
            raise ValueError(f"rates for leaves {sorted(unknown)} that the "
                             f"params do not have")
        groups = [group([params[k]], r) for k, r in learning_rate.items()
                  if r is not None]
    else:
        groups = [group(list(params.values()), learning_rate)]
    if not groups:
        raise ValueError("every leaf is frozen: no rate to optimize with")
    return torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)


def _optimizer_step(optimizer: torch.optim.Optimizer) -> None:
    """optimizer.step(), first setting each group's learning rate from its
    schedule for this update, where the group has one."""
    for group in optimizer.param_groups:
        if group.get("schedule") is not None:
            group["lr"] = float(group["schedule"](group["count"]))
            group["count"] += 1
    optimizer.step()


def make_kernel_train_step(scene: Scene, camera: Camera, width: int,
                           height: int, spp: int,
                           optimizer: torch.optim.Optimizer, *,
                           distance: str = "free", max_bounces: int = 32,
                           sampler: str = "random", diff_g: bool = False,
                           diff_field: bool = False, diff_blobs: bool = False,
                           diff_grid: bool = False, device="cuda"):
    """Build step(params, target_flat, seed) -> loss. `params` is the
    pack_params dict (leaves on `device` that require grad) whose tensors
    `optimizer` holds, all or some (adam()); target_flat is (npix, 3) on
    `device`. One step renders A and B at spp // 2 with seeds 2*seed and
    2*seed + 1, takes the gradient of mean((A - t)(B - t)), updates the
    params in place (each group's schedule advanced) and projects them onto
    their domain. The loss comes back detached, without a
    synchronisation."""
    render = make_diff_renderer(
        scene, camera, width, height, max(spp // 2, 1), distance=distance,
        max_bounces=max_bounces, sampler=sampler, diff_g=diff_g,
        diff_field=diff_field, diff_blobs=diff_blobs, diff_grid=diff_grid,
        device=device)

    def step(params: dict, target_flat: torch.Tensor, seed: int):
        for v in params.values():       # frozen leaves included
            v.grad = None
        a = render(params, 2 * seed)
        b = render(params, 2 * seed + 1)
        loss = torch.mean((a - target_flat) * (b - target_flat))
        loss.backward()
        _optimizer_step(optimizer)
        project_params(params)
        return loss.detach()

    return step


def _all_reduce_grads(leaves, mesh, axis: str) -> None:
    """Sum the .grad of every leaf over the mesh axis in one collective,
    in place. Every rank holds the same leaves in the same order."""
    grads = [v.grad for v in leaves if v.grad is not None]
    if not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].reshape(g.shape))
        off += g.numel()


def _shard_rows(mesh, npix: int, shard_pixels: int):
    """This rank's lane range of the frame: (base, the mask of its lanes
    within the frame, (shard_pixels, 1))."""
    base = mesh.di * shard_pixels
    lane = base + torch.arange(shard_pixels, device=mesh.device)
    return base, (lane < npix)[:, None]


def _shard_target(target_flat: torch.Tensor, npix: int, base: int,
                  shard_pixels: int) -> torch.Tensor:
    """The rows base .. base + shard_pixels - 1 of the (npix, 3) target,
    zero-padded past the frame (vpt's jnp.pad of the target)."""
    pad = max(0, base + shard_pixels - npix)
    return torch.nn.functional.pad(target_flat, (0, 0, 0, pad))[
        base:base + shard_pixels]


def make_sharded_kernel_train_step(scene: Scene, camera: Camera, width: int,
                                   height: int, spp: int,
                                   optimizer: torch.optim.Optimizer, mesh, *,
                                   distance: str = "free",
                                   max_bounces: int = 32, tile_rows: int = 32,
                                   sampler: str = "random",
                                   diff_g: bool = False,
                                   diff_field: bool = False,
                                   diff_blobs: bool = False,
                                   diff_grid: bool = False):
    """Multi-rank kernel training (vpt's make_sharded_kernel_train_step):
    each rank of `mesh` (dist/mesh.py) runs K2/K3 over its contiguous range
    of tiles (render.make_shard; K3 masks the lanes past the frame) on
    mesh.device. step(params, target_flat, seed) -> loss, as
    make_kernel_train_step's: target_flat is the whole (npix, 3) frame on
    every rank, the loss the A/B product summed over the data group and
    divided by npix * 3. diff_grid sets tile_rows to 8, as vpt does.

    The loss's backward runs on each rank's own partial loss, then every
    gradient leaf (the voxel table included) is all-reduced over the data
    group before the update, as DDP does. That is vpt's fix of 64acf9b:
    under shard_map the transpose of the psum'd loss did not re-reduce the
    cotangents, each device applied its own shard's gradient and the
    replicas diverged. The sample ranks compute the same step, as in vpt."""
    if diff_grid:
        tile_rows = 8       # vpt's unit of the split with diff_grid
    render = make_diff_renderer(
        scene, camera, width, height, max(spp // 2, 1), distance=distance,
        max_bounces=max_bounces, sampler=sampler, diff_g=diff_g,
        diff_field=diff_field, diff_blobs=diff_blobs, diff_grid=diff_grid,
        tile_rows=tile_rows, device=mesh.device)
    npix = render.npix
    tiles_per_shard = -(-render.num_tiles // mesh.n_data)
    shard_pixels = tiles_per_shard * render.lanes_per_tile
    render_shard = render.make_shard(tiles_per_shard)
    base, valid = _shard_rows(mesh, npix, shard_pixels)
    # a device scalar: CUDA divides by a host scalar through its reciprocal
    n_terms = torch.tensor(float(npix * 3), device=mesh.device)

    def step(params: dict, target_flat: torch.Tensor, seed: int):
        for v in params.values():       # frozen leaves included
            v.grad = None
        t = _shard_target(target_flat, npix, base, shard_pixels)
        a = render_shard(params, 2 * seed, base)
        b = render_shard(params, 2 * seed + 1, base)
        err = torch.where(valid, (a - t) * (b - t), 0.0)
        part = err.sum() / n_terms
        part.backward()
        _all_reduce_grads(params.values(), mesh, DATA_AXIS)
        _optimizer_step(optimizer)
        project_params(params)
        return mesh.all_reduce(part.detach(), DATA_AXIS)

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
    everything but sigma_s fixed). Returns (params, losses). `distance`
    is the pair's: "free", or any other for its equi-angular branch."""
    height, width = target.shape[:2]
    dev = torch.device(device)
    params = {k: v.to(dev).requires_grad_()
              for k, v in pack_params(scene, with_g=diff_g,
                                      with_field=diff_field,
                                      with_blobs=diff_blobs,
                                      with_grid=diff_grid).items()}
    optimizer = adam(params, learning_rate)
    step = make_kernel_train_step(scene, camera, width, height, spp,
                                  optimizer, distance=distance,
                                  max_bounces=max_bounces, sampler=sampler,
                                  diff_g=diff_g, diff_field=diff_field,
                                  diff_blobs=diff_blobs, diff_grid=diff_grid,
                                  device=dev)
    return _fit_loop(step, params, target, width, height, steps, seed,
                     param_filter, log_every, dev)


# ---------------------------------------------------------------------------
# multi-view training on the pair (vpt/dist/train_fast.py:460-600)
# ---------------------------------------------------------------------------

# the leaves fit_multiview(log_medium=True) optimizes as logs: Adam's
# unit-scale steps become multiplicative for the positive medium block, and
# cannot throw a sigma of 1e-3 across orders of magnitude in one step
_LOG_LEAVES = ("sigma_a", "sigma_s", "fog_k")


def _to_log(p: dict) -> dict:
    q = dict(p)
    for k in _LOG_LEAVES:
        if k in q:
            q[k] = torch.log(torch.clamp_min(q[k], 1e-8))
    return q


def _from_log(q: dict) -> dict:
    p = dict(q)
    for k in _LOG_LEAVES:
        if k in p:
            p[k] = torch.exp(p[k])
    return p


def make_multiview_train_step(scene: Scene, cameras, width: int,
                              height: int, spp: int,
                              optimizer: torch.optim.Optimizer, *,
                              distance: str = "free", max_bounces: int = 32,
                              sampler: str = "random", diff_g: bool = False,
                              diff_field: bool = False,
                              log_medium: bool = False, device="cuda"):
    """Build step(qparams, targets_flat, weights, seed) -> loss: one pair
    per camera (V renderers at spp // 2) sharing one parameter dict, the
    loss the mean over views of mean((A - t)(B - t) w) with view v's seeds
    seed * 2V + 2v and + 1. qparams is the dict in optimizer space (the
    medium block as logs with log_medium=True) whose leaves `optimizer`
    holds; targets_flat is (V, npix, 3), weights None or (V, npix, 1),
    fixed (they must not depend on the renders). The step updates qparams
    in place, then projects them in raw space: to_opt(project_params(
    from_opt(q))). step.to_opt / step.from_opt convert."""
    renders = [make_diff_renderer(
        scene, c, width, height, max(spp // 2, 1), distance=distance,
        max_bounces=max_bounces, sampler=sampler, diff_g=diff_g,
        diff_field=diff_field, device=device) for c in cameras]
    V = len(renders)
    to_opt = _to_log if log_medium else dict
    from_opt = _from_log if log_medium else dict

    def step(qp: dict, targets_flat: torch.Tensor, weights, seed: int):
        for v in qp.values():
            v.grad = None
        p = from_opt(qp)
        tot = 0.0
        for v, render in enumerate(renders):
            a = render(p, seed * (2 * V) + 2 * v)
            b = render(p, seed * (2 * V) + 2 * v + 1)
            e = (a - targets_flat[v]) * (b - targets_flat[v])
            if weights is not None:
                e = e * weights[v]
            tot = tot + torch.mean(e)
        loss = tot / V
        loss.backward()
        _optimizer_step(optimizer)
        with torch.no_grad():
            raw = project_params(from_opt({k: v.detach().clone()
                                           for k, v in qp.items()}))
            for k, v in to_opt(raw).items():
                qp[k].copy_(v)
        return loss.detach()

    step.to_opt = to_opt
    step.from_opt = from_opt
    return step


def fit_multiview(scene: Scene, cameras, targets, *, steps: int = 200,
                  spp: int = 16, learning_rate=6e-3, distance: str = "free",
                  max_bounces: int = 32, sampler: str = "random",
                  seed: int = 0, diff_g: bool = False,
                  diff_field: bool = False, log_medium: bool = True,
                  relmse_weights: bool = True, relmse_eps: float = 0.05,
                  polyak_tail: int = 0, param_filter=None,
                  log_every: int = 0, device="cuda"):
    """Recover the medium and material dict (with "g" when diff_g, "fog_k"
    when diff_field) from V target (H, W, 3) images, one per camera, with
    the pair on `device`. Pixel weights 1 / (mean_c(t) + relmse_eps)^2
    from the targets (relmse_weights); `param_filter(updated, initial)`
    works in raw space against the raw initial params; polyak_tail > 0
    returns the mean of the last N raw iterates. learning_rate: a float, a
    schedule or a per-leaf dict (adam()). Returns (params, losses)."""
    if len(cameras) != len(targets):
        raise ValueError("one target image per camera")
    dev = torch.device(device)
    height, width = targets[0].shape[:2]
    init = {k: v.to(dev) for k, v in pack_params(
        scene, with_g=diff_g, with_field=diff_field).items()}
    to_opt = _to_log if log_medium else dict
    qp = {k: v.clone().requires_grad_() for k, v in to_opt(init).items()}
    optimizer = adam(qp, learning_rate)
    step = make_multiview_train_step(
        scene, cameras, width, height, spp, optimizer, distance=distance,
        max_bounces=max_bounces, sampler=sampler, diff_g=diff_g,
        diff_field=diff_field, log_medium=log_medium, device=dev)
    targets_flat = torch.stack([
        torch.as_tensor(t, dtype=torch.float32).to(dev).reshape(
            width * height, 3) for t in targets])
    weights = (1.0 / (targets_flat.mean(-1, keepdim=True) + relmse_eps) ** 2
               if relmse_weights else None)
    losses, tail = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        loss = step(qp, targets_flat, weights, seed + i)
        if param_filter is not None:
            with torch.no_grad():
                raw = step.from_opt({k: v.detach().clone()
                                     for k, v in qp.items()})
                for k, v in step.to_opt(param_filter(raw, init)).items():
                    qp[k].copy_(v)
        losses.append(float(loss))          # waits for the step
        if polyak_tail and i >= steps - polyak_tail:
            tail.append(step.from_opt({k: v.detach().clone()
                                       for k, v in qp.items()}))
        if log_every and i % log_every == 0:
            print(f"step {i:4d}  loss {losses[-1]:.6g}  "
                  f"({time.perf_counter() - t0:.3f} s)", flush=True)
    out = step.from_opt({k: v.detach() for k, v in qp.items()})
    if tail:
        out = {k: sum(t[k] for t in tail) / len(tail) for k in out}
    return out, losses


# ---------------------------------------------------------------------------
# geometric inverse rendering on K4 (vpt/dist/train_fast.py:155-188,
# 210-302, 411-458)
# ---------------------------------------------------------------------------

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


def _fd_update(theta: dict, probes: list, dims: list, hs: list,
               optimizer: torch.optim.Optimizer, sigma: bool):
    """The FD steps' update from their probe losses, one (l+, l-) pair for
    each enabled dimension: g_k = (l+ - l-) / (2 h_k) into the .grad of the
    THETA_KEYS leaves, the optimizer's step, and with sigma=True sigma_a
    and sigma_s clamped to >= 1e-6. Returns the loss, (l+ + l-) / 2 of the
    first dimension."""
    dev = probes[0][0].device
    with torch.no_grad():
        g = torch.zeros(12, dtype=torch.float32, device=dev)
        for k, (lp, lm) in zip(dims, probes):
            # a device scalar: CUDA divides by a host scalar as a multiply
            # by its reciprocal
            g[k] = (lp - lm) / torch.tensor(2.0 * hs[k], device=dev)
        loss = 0.5 * (probes[0][0] + probes[0][1])
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
    return loss


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
            for k in dims:
                e = torch.zeros(12, dtype=torch.float32, device=dev)
                e[k] = hs[k]
                probes.append((loss_of(vec + e, seed, target_flat),
                               loss_of(vec - e, seed, target_flat)))
        step.probe_losses = probes
        return _fd_update(theta, probes, dims, hs, optimizer, sigma)

    return step


def make_sharded_fd_geom_train_step(scene: Scene, camera: Camera,
                                    width: int, height: int, spp: int,
                                    optimizer: torch.optim.Optimizer, mesh,
                                    *, sphere: int | None,
                                    cam_grads: bool = True,
                                    sigma: bool = False,
                                    dir_grads: bool = False, h: float = 0.5,
                                    h_fov: float = 2e-3,
                                    h_sigma: float = 5e-4,
                                    h_dir: float = 1e-3,
                                    distance: str = "free",
                                    max_bounces: int = 32,
                                    tile_rows: int = 8,
                                    sampler: str = "random"):
    """Multi-rank CRN finite-difference training (vpt's
    make_sharded_fd_geom_train_step): each rank of `mesh` runs K4's
    primal_only mode over its contiguous range of tiles (render.make_raw)
    on mesh.device; the A/B product losses at theta +- h_k e_k are summed
    over the data group and divided by npix * 3, then averaged over the
    sample group, whose ranks draw decorrelated seeds (s + si * 0x9E37:
    n_sample independent CRN secants, averaged). Every rank forms the same
    FD gradient and takes the same update. With one sample rank the loss
    equals make_fd_geom_train_step's up to the order of the sum (the
    streams are keyed by the global lane). step(theta, target_flat, seed)
    -> loss, as make_fd_geom_train_step's (step.probe_losses too)."""
    render = make_geom_renderer(
        scene, camera, width, height, max(spp // 2, 1), sphere=sphere,
        cam_grads=cam_grads, distance=distance, max_bounces=max_bounces,
        sampler=sampler, primal_only=True, tile_rows=tile_rows,
        device=mesh.device)
    dev = mesh.device
    npix = render.npix
    tiles_per_shard = -(-render.num_tiles // mesh.n_data)
    shard_pixels = tiles_per_shard * render.lanes_per_tile
    raw = render.make_raw(tiles_per_shard)
    base, valid = _shard_rows(mesh, npix, shard_pixels)
    scale = f32(1.0 / max(spp // 2, 1))
    dims = _fd_dims(sphere, cam_grads, sigma, dir_grads)
    hs = [h, h, h, h, h, h, h_fov, h_sigma, h_sigma, h_dir, h_dir, h_dir]
    n_terms = torch.tensor(float(npix * 3), device=dev)

    def part_of(v, s, t):
        # the sample ranks draw decorrelated seeds; CRN holds within each
        # (the same s at v + e and v - e)
        s = s + mesh.si * 0x9E37
        a, _ = raw(_phys_probe(v), 2 * s, base)
        b, _ = raw(_phys_probe(v), 2 * s + 1, base)
        err = torch.where(valid, (a * scale - t) * (b * scale - t), 0.0)
        return err.sum()

    def step(theta: dict, target_flat: torch.Tensor, seed: int):
        with torch.no_grad():
            t = _shard_target(target_flat, npix, base, shard_pixels)
            vec = flatten_theta(theta).to(dev)
            parts = []
            for k in dims:
                e = torch.zeros(12, dtype=torch.float32, device=dev)
                e[k] = hs[k]
                parts += [part_of(vec + e, seed, t), part_of(vec - e, seed, t)]
            # every probe's loss: a data sum over npix * 3, a sample mean
            losses = mesh.all_reduce(torch.stack(parts), DATA_AXIS) / n_terms
            if mesh.n_sample > 1:
                losses = mesh.all_reduce(losses, SAMPLE_AXIS) / mesh.n_sample
        probes = [(losses[2 * i], losses[2 * i + 1])
                  for i in range(len(dims))]
        step.probe_losses = probes
        return _fd_update(theta, probes, dims, hs, optimizer, sigma)

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
    optimizer = adam(theta, learning_rate)
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
    optimizer = adam(theta, learning_rate)
    step = make_fd_geom_train_step(
        scene, camera, width, height, spp, optimizer, sphere=sphere,
        cam_grads=cam_grads, sigma=sigma, dir_grads=dir_grads, h=h,
        h_fov=h_fov, h_sigma=h_sigma, h_dir=h_dir, distance=distance,
        max_bounces=max_bounces, sampler=sampler, device=device)
    return _fit_loop(step, theta, target, width, height, steps, seed,
                     param_filter, log_every, device)
