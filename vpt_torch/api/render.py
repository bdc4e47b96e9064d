"""Top-level rendering API (counterpart of ``vpt/api/render.py``).

vpt picks between its XLA engine renderers and the fused kernel; this
package has the kernel only so far, for every integrator of vpt's kernel
(wavefront.KERNEL_INTEGRATORS); vpt's engine integrators raise (ROADMAP
Queue 1 item 9). `device` decides which version of the kernel runs: "cuda"
launches the hand-written CUDA kernel or raises, "cpu" runs its plain torch
version. There is no automatic choice and no fallback.
"""
from __future__ import annotations

import torch

from ..kernels.wavefront import render_kernel
from ..scene.camera import Camera
from ..scene.scene import Scene
from .config import RenderConfig

__all__ = ["render"]


def render(scene: Scene, camera: Camera, cfg: RenderConfig,
           device="cuda") -> torch.Tensor:
    """Render an (H, W, 3) float32 linear-radiance image on `device`,
    averaged over cfg.spp samples per pixel (tone mapping lives in
    vpt_torch.io)."""
    if cfg.dtype != "float32":
        raise NotImplementedError(
            f"dtype={cfg.dtype!r}: the render kernel is float32; vpt's "
            "float64 oracle runs are its engine's (ROADMAP Queue 1 item 9)")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render(device='cuda'): torch.cuda.is_available() "
                           "is False")
    return render_kernel(scene, camera, cfg, device=dev)
