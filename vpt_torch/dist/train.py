"""Parameter domains for inverse-rendering training.

Counterpart of ``_DOMAIN`` and ``project_params`` in ``vpt/dist/train.py``.
The engine SPMD training step there (``make_train_step``, ``fit``) runs on
vpt's XLA engine, which is ROADMAP Queue 1 item 9.
"""
from __future__ import annotations

import torch

__all__ = ["project_params"]

# physical-domain bounds applied after each optimizer update; keys absent
# from a params dict are not constrained
_DOMAIN = {
    # strictly positive: the score-function sigma estimator differentiates
    # log(sigma_t), and free-flight sampling assumes a non-negative
    # extinction; one Adam step with lr ~ 1e-2 from sigma ~ 1e-3 otherwise
    # lands negative and every later gradient is NaN
    "sigma_a": (1e-6, None),
    "sigma_s": (1e-6, None),
    "albedo": (0.0, 1.0),
    "radiance": (0.0, None),
    # HG anisotropy: the score noise grows as |g| -> 1 and the HG inversion
    # degenerates at |g| == 1
    "g": (-0.95, 0.95),
    # exp_height falloff: fits assume ground fog decaying upward
    "fog_k": (1e-6, None),
}


def project_params(params: dict) -> dict:
    """Clamp a params dict onto its physical domain (see _DOMAIN), in place
    and outside autograd; returns the same dict.

    Applied inside every train step (projected gradient descent): an
    unconstrained update can leave the domain in one step, after which the
    loss may stay finite while the gradients are NaN."""
    with torch.no_grad():
        for k, (lo, hi) in _DOMAIN.items():
            if k in params:
                params[k].clamp_(min=lo, max=hi)
        if "blobs" in params:
            # (K, 5) [cx, cy, cz, r, w]: centers free; radius strictly
            # positive (every term carries 1/r); weight non-negative
            params["blobs"][:, 3].clamp_(min=1e-2)
            params["blobs"][:, 4].clamp_(min=0.0)
        if "grid" in params:
            params["grid"].clamp_(min=0.0)
    return params
