"""Render configuration (counterpart of ``vpt/api/config.py``): the same
fields and defaults, so a config written for vpt renders here unchanged."""
from __future__ import annotations

import dataclasses

__all__ = ["RenderConfig"]


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024            # reference default 1024x768 (src/rt.cpp:752)
    height: int = 768
    spp: int = 16                # argv[1] in the reference (src/rt.cpp:784)
    integrator: str = "explicit_free"   # the active iterativeVPTracerFree
    max_bounces: int = 32
    continue_prob: float = 0.6
    seed: int = 0
    scene: str = "cornell_vpt"
    sigma_a: float = 0.001       # src/rt.cpp:794
    sigma_s: float = 0.009
    # pixels per dispatch chunk of vpt's engine renderers; the kernel
    # renders the whole frame in one launch and ignores it
    chunk_pixels: int = 65536
    dtype: str = "float32"
    jitter: bool = True
    # "random": pure PCG; "ld": low-discrepancy first-5-dimension
    # stratification (pixel jitter u,v; depth-0 distance, RR and light-pick
    # draws) via a Cranley-Patterson-rotated R5 Kronecker sequence
    sampler: str = "random"
    # "kernel" (or "auto"): the hand-written render kernel. "pallas" is
    # vpt's name for the same fused kernel and is read as "kernel".
    renderer: str = "auto"

    def __post_init__(self):
        if self.renderer == "pallas":
            object.__setattr__(self, "renderer", "kernel")
        if self.renderer in ("persistent", "scan"):
            raise NotImplementedError(
                f"renderer={self.renderer!r} is vpt's XLA engine family, "
                "not ported yet (ROADMAP Queue 1 item 9)")
        if self.renderer not in ("auto", "kernel"):
            raise ValueError(f"unknown renderer {self.renderer!r}")
