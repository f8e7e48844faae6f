"""Full float32 products on the card (port of timeopt_tpu/ops/precision.py).

A float32 matrix product may run in TF32 on the H100's tensor cores, with
10 mantissa bits, if `torch.backends.cuda.matmul.allow_tf32` (or
`torch.backends.cudnn.allow_tf32`, for cuDNN) is on, or bfloat16 where
`torch.get_float32_matmul_precision()` is "medium"; the caller's process
may have turned either on. On the float32 path the trajectory-wide
products (the stage-cost einsums, the block assembly's `@`, the products
that `jacfwd` of the dynamics forms) must keep float32's 24 bits, as the
JAX package forces float32 precision on every dot of its f32 path. Float64
products never touch TF32, so the float64 path is unaffected.

`full_matmul_precision` turns both switches off for the duration of a call
and restores the caller's settings afterwards; `solve_batch` wraps its body
in it.
"""

from __future__ import annotations

import functools
from contextlib import contextmanager

import torch


@contextmanager
def no_tf32():
    """TF32 off for matmuls and cuDNN inside the block, the caller's
    settings restored after it."""
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    # "highest" is allow_tf32 = False; saving the precision by name also
    # restores a caller's "medium" (bfloat16), which allow_tf32 cannot say
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def full_matmul_precision(fn):
    """Run `fn` with TF32 off (no_tf32)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with no_tf32():
            return fn(*args, **kwargs)

    return wrapped
