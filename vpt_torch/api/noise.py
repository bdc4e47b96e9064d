"""Render to a noise target on the render kernel (counterpart of
``vpt/api/noise.py``): accumulate batches of samples until the image's
Monte-Carlo error estimate falls below the requested level.

Batches of `batch_spp` samples are rendered with independent seeds through
one packed kernel launch each; a Welford accumulator over the batch means
(float64, on the host) gives the per-pixel standard error of the running
mean, and rendering stops when the median relative SE (luminance SE /
luminance) reaches the target — vpt's stopping rule.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels import wavefront as wf

__all__ = ["render_to_noise"]


def render_to_noise(scene, camera, cfg, *, target_rel_se: float = 0.02,
                    batch_spp: int | None = None, max_spp: int = 4096,
                    min_batches: int = 3, log=None, device="cuda"):
    """Render until the median per-pixel relative standard error of the
    mean is <= target_rel_se, in batches of batch_spp (default cfg.spp).

    Returns (image (H, W, 3) float64 on the CPU, spp_used, achieved_rel_se).
    Stops at max_spp total samples per pixel even if the target is not
    reached. device="cuda" launches the kernel once per batch or raises;
    "cpu" runs its plain version."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render_to_noise(device='cuda'): "
                           "torch.cuda.is_available() is False")
    b = int(batch_spp or cfg.spp)
    pk = wf.pack_config(scene, camera, cfg, spp=b)
    npix = pk.npix

    def batch(k: int) -> np.ndarray:
        # a distinct PCG seed space per batch (vpt's hash; `+` binds before
        # `&`)
        s = cfg.seed + 0x9E3779B1 * (k + 1) & 0x7FFFFFFF
        img = wf.render_tile(pk, torch.tensor([s], dtype=torch.int32,
                                              device=dev))
        return img.cpu().numpy().reshape(npix, 3)

    n = 0
    mean = np.zeros((npix, 3), np.float64)
    m2 = np.zeros((npix, 3), np.float64)
    achieved = np.inf
    while n * b < max_spp:
        x = np.asarray(batch(n), np.float64)
        n += 1
        delta = x - mean
        mean += delta / n
        m2 += delta * (x - mean)
        if n >= max(min_batches, 2):
            se = np.sqrt(m2.mean(axis=1) / (n - 1) / n)   # luminance SE
            lum = mean.mean(axis=1)
            achieved = float(np.median(se / np.maximum(lum, 1e-4)))
            if log:
                log(f"render_to_noise: {n * b} spp, median rel SE "
                    f"{achieved:.4f} (target {target_rel_se})")
            if achieved <= target_rel_se:
                break
    img = torch.from_numpy(mean.reshape(cfg.height, cfg.width, 3))
    return img, n * b, achieved
