"""Angle wrapping as masked elementwise ops (port of timeopt_tpu/ops/wrap.py).

The wrap set is a boolean mask over the state vector, so the op is one
branchless `torch.where` that broadcasts over any leading batch axes.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def angle_normalize(a: torch.Tensor) -> torch.Tensor:
    """Map angles to (-pi, pi]. Floored modulo (`torch.remainder`, as `%` in
    JAX and NumPy), never `torch.fmod`, which differs for negative angles."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def wrap_error(e: torch.Tensor, wrap_mask: torch.Tensor | None) -> torch.Tensor:
    """Wrap the angular components of an error vector.

    e: (..., n); wrap_mask: boolean mask broadcastable to e (or None)."""
    if wrap_mask is None:
        return e
    return torch.where(wrap_mask.to(torch.bool), angle_normalize(e), e)


def wrap_mask_from_idx(wrap_idx, n: int) -> np.ndarray:
    """Host-side: list of angular state indices -> (n,) boolean mask."""
    mask = np.zeros(n, dtype=bool)
    for i in wrap_idx or ():
        mask[int(i)] = True
    return mask
