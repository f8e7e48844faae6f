"""The all-alphas line search: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_forward.py::linesearch_lanes_df and
::linesearch_dense_df (kernel body _fwd_kernel). Kernel: the template of
csrc/linesearch_kernel.cuh, sm_90a, float64 arithmetic on float64 or
float32 data, on a system's dynamics (xdot, guard, extra stage cost). A
system with a `device_id` runs its hand-tuned struct of csrc/systems.cuh
through csrc/linesearch.cu (the seven registry systems; the JAX package kept PointMass off its TPU
kernel for want of a layout twin of its xdot, which this kernel does not
need). A system without one runs a struct generated from its own Python
functions (ops/dyngen.py: traced with make_fx, built with nvcc at its first
launch), as the JAX package traces a system's xdot_rows into its Pallas
kernel; its launches count on dyngen.LAUNCHES. The header says what bounds
the kernel on the H100 and how the design answers that. The
first-improving selection stays in torch
(solver/forward.py::select_first_improving).

`linesearch` returns the per-alpha rollouts Xs (B, A, N+1, n),
Us (B, A, N, m) and costs Js (B, A). Each rollout starts at X[:, 0], or at
`x_start` (B, n), whose rows may lie a batch stride apart (a view such as
X_ext[:, S]); the one-pass method's shifted-gain rollout starts there. On a
CPU tensor it runs the plain version; on a CUDA float64 or float32 tensor
it launches the kernel; any other dtype raises, and so does a system the
generator refuses (dyngen.check_system, an op it does not take). On
float32 data both carry each rollout's state in float64 across all N
steps and store its rounding (Xs, Us, Js in float32): the counterpart of
the TPU kernel's df32 rollout, which lets only the high word leave.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build, dyngen

LAUNCHES = 0  # kernel launches since the last reset


def linesearch_plain(system, prob, X, U, K, kappa, T_star, alphas, x_start=None):
    """Plain PyTorch version of the kernel (solver/forward.py), in float64
    on float32 data (_build.in_f64)."""
    from timeopt_tpu_torch.solver.forward import linesearch_plain as plain

    return _build.in_f64(plain, system, prob, X, U, K, kappa, T_star, alphas, x_start)


def linesearch(system, prob, X, U, K, kappa, T_star, alphas, x_start=None):
    """X (B, N+1, n), U (B, N, m), K (B, N, m, n), kappa (B, N, m),
    T_star (B,) int64, problem data from `prob`, alphas a sequence of A
    floats, x_start None or (B, n) with unit stride along n -> (Xs, Us, Js).
    Without x_start the kernel's entry `linesearch_rollout` starts at
    X[:, 0]; with it, `linesearch_rollout_from` (each with a `_f32` twin
    for float32 data): those of csrc/linesearch.cu, with the system's
    device_id, or of the system's generated library (dyngen.library),
    without. The alphas are float64 on both paths."""
    if not _build.on_card(X, "line search"):
        return linesearch_plain(system, prob, X, U, K, kappa, T_star, alphas, x_start)
    global LAUNCHES
    Bsz, Np1, n = X.shape
    N, m, A = Np1 - 1, U.shape[-1], len(alphas)
    f64, dtype, dev = torch.float64, X.dtype, X.device
    for t, shape, name in (
        (X, (Bsz, N + 1, n), "X"), (U, (Bsz, N, m), "U"), (K, (Bsz, N, m, n), "K"),
        (kappa, (Bsz, N, m), "kappa"), (prob.xg, (Bsz, n), "xg"), (prob.u_ref, (Bsz, m), "u_ref"),
        (prob.Q, (Bsz, n, n), "Q"), (prob.R, (Bsz, m, m), "R"), (prob.Qf, (Bsz, n, n), "Qf"),
        (prob.w, (Bsz,), "w"),
    ):
        _build.check(t, shape, dtype, dev, name)
    _build.check(T_star, (Bsz,), torch.int64, dev, "T_star")
    _build.check(prob.wrap_mask, (Bsz, n), torch.bool, dev, "wrap_mask")
    if x_start is not None:
        # rows a batch stride apart, each row contiguous
        _build.check(x_start[0], (n,), dtype, dev, "x_start")
        if tuple(x_start.shape) != (Bsz, n):
            raise ValueError(f"x_start: shape {tuple(x_start.shape)}, expected {(Bsz, n)}")
    a_vec = _build.constant(tuple(float(a) for a in alphas), f64, dev)
    Xs = torch.empty((Bsz, A, N + 1, n), dtype=dtype, device=dev)
    Us = torch.empty((Bsz, A, N, m), dtype=dtype, device=dev)
    Js = torch.empty((Bsz, A), dtype=dtype, device=dev)
    wrap_bits = sum(1 << int(i) for i in system.wrap_idx)
    generated = system.device_id is None
    lib = dyngen.library(system) if generated else _build.load("linesearch")
    ptrs = [X.data_ptr(), U.data_ptr(), K.data_ptr(), kappa.data_ptr(), T_star.data_ptr(),
            prob.xg.data_ptr(), prob.u_ref.data_ptr(), prob.Q.data_ptr(), prob.R.data_ptr(),
            prob.Qf.data_ptr(), prob.w.data_ptr(), prob.wrap_mask.data_ptr(), a_vec.data_ptr(),
            Xs.data_ptr(), Us.data_ptr(), Js.data_ptr()]
    tail = [Bsz, N, n, m, A] + ([] if generated else [int(system.device_id)]) + [float(system.dt), wrap_bits]
    tail_types = [ctypes.c_int] * (len(tail) - 2) + [ctypes.c_double, ctypes.c_int]
    suffix = "" if dtype == f64 else "_f32"
    if x_start is None:
        entry = "linesearch_rollout" + suffix
        fn = _build.bind(lib, entry, 16, tail_types)
    else:
        entry = "linesearch_rollout_from" + suffix
        fn = _build.bind(lib, entry, 17, tail_types + [ctypes.c_longlong])
        ptrs.append(x_start.data_ptr())
        tail.append(x_start.stride(0))
    rc = fn(*ptrs, *tail, _build.stream_ptr(dev))
    _build.raise_on_error(rc, entry)
    if generated:
        dyngen.LAUNCHES += 1
    else:
        LAUNCHES += 1
    return Xs, Us, Js
