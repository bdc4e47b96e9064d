"""Image IO: ASCII PPM (P3) writer bit-compatible with the reference, and its
reader (counterpart of ``vpt/io/ppm.py``, numpy only).

The reference writes `P3\\n<w> <h>\\n255\\n` followed by space-separated
gamma-2.2-quantized ints, one trailing space after each triple
(src/rt.cpp:812-820), with the pixel buffer stored top row first. Images
here are already top-down.
"""
from __future__ import annotations

import numpy as np

__all__ = ["tonemap", "write_ppm", "read_ppm"]


def _np(image) -> np.ndarray:
    if hasattr(image, "detach"):          # torch tensor, any device
        image = image.detach().cpu().numpy()
    return np.asarray(image)


def tonemap(image) -> np.ndarray:
    """Linear (H, W, 3) float -> uint8-range ints via clamp + gamma 2.2
    (mathUtilities.h:43-45 applied at src/rt.cpp:817)."""
    img = np.ascontiguousarray(_np(image).astype(np.float64))
    return (np.power(np.clip(img, 0.0, 1.0), 1.0 / 2.2) * 255.0 + 0.5).astype(np.int32)


def write_ppm(path: str, image, already_quantized: bool = False) -> None:
    """Write an ASCII P3 PPM matching the reference byte format."""
    q = _np(image).astype(np.int32) if already_quantized else tonemap(image)
    h, w, _ = q.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        flat = q.reshape(-1, 3)
        f.write("".join(f"{r} {g} {b} " for r, g, b in flat))


def read_ppm(path: str) -> np.ndarray:
    """Read an ASCII P3 PPM into an (H, W, 3) int array."""
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"not a P3 ppm: {path}")
    w, h = int(tokens[1]), int(tokens[2])
    data = np.array(tokens[4: 4 + w * h * 3], dtype=np.int32)
    return data.reshape(h, w, 3)
