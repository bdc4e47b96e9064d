"""Display quantizer (the part of ``vpt/core/vecmath.py`` the port needs)."""
from __future__ import annotations

import torch

__all__ = ["clamp01", "to_display_value"]


def clamp01(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 1] (reference include/mathUtilities.h:34-40)."""
    return torch.clamp(x, 0.0, 1.0)


def to_display_value(x: torch.Tensor) -> torch.Tensor:
    """Gamma-2.2 quantizer to [0, 255] ints
    (reference include/mathUtilities.h:43-45)."""
    return (torch.pow(clamp01(x), 1.0 / 2.2) * 255.0 + 0.5).to(torch.int32)
