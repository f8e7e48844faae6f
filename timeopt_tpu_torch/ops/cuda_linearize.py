"""The Jacobians of a registry system's Euler step: hand-written CUDA kernel.

The port's own kernel (csrc/linearize.cu): it replaces no TPU kernel, since
the JAX package leaves `jacfwd` to XLA (timeopt_tpu/solver/linearize.py).
On the card it takes the place of solver/linearize.py::linearize_ad
(vmap(jacfwd), an elementwise launch per primitive of xdot) for a step that
carries a `device_id` (models/base.py::euler_step_fn): it evaluates that
system's xdot of csrc/systems.cuh, the formulas the line search integrates,
on dual numbers, one thread per (step, column). Its bound is the bytes of
A and B (ops/work.py::linearize); the header of the .cu says how the design
meets it. Float32 or float64 X and U, double arithmetic, each entry rounded
once to the storage dtype. There is no plain version here: on a CPU tensor
solver/linearize.py runs linearize_ad, which the kernel is held to.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset


def jacobians(device_id: int, dt: float, X: torch.Tensor, U: torch.Tensor):
    """X (B, N+1, n), U (B, N, m) on the card, float64 or float32 -> A (B, N,
    n, n), B (B, N, n, m) of x + dt xdot(x, u) at (X[:, k], U[:, k]), for
    the registry system `device_id` (the entry `linearize_jacobians[_f32]`).
    Each problem's rows must be contiguous; the problems may lie a batch
    stride apart (a view such as X_ext[:, :S + 1]). Raises on a CPU tensor,
    another dtype, or shapes that are not the system's."""
    if not _build.on_card(X, "linearize"):
        raise ValueError("linearize kernel: X is on the CPU (solver/linearize.py runs linearize_ad there)")
    global LAUNCHES
    Bsz, Np1, n = X.shape
    N, m = Np1 - 1, U.shape[-1]
    for t, shape, name in ((X, (Bsz, N + 1, n), "X"), (U, (Bsz, N, m), "U")):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != X.dtype or t.device != X.device:
            raise TypeError(f"{name}: {t.dtype} on {t.device}, expected {X.dtype} on {X.device}")
        if Bsz and not t[0].is_contiguous():
            raise ValueError(f"{name}: each problem's rows must be contiguous")
    A = torch.empty((Bsz, N, n, n), dtype=X.dtype, device=X.device)
    Bm = torch.empty((Bsz, N, n, m), dtype=X.dtype, device=X.device)
    entry = "linearize_jacobians" + ("" if X.dtype == torch.float64 else "_f32")
    fn = _build.bind(_build.load("linearize"), entry, 4,
                     [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_double])
    rc = fn(X.data_ptr(), U.data_ptr(), A.data_ptr(), Bm.data_ptr(), Bsz, N, n, m, X.stride(0), U.stride(0),
            int(device_id), float(dt), _build.stream_ptr(X.device))
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    return A, Bm
