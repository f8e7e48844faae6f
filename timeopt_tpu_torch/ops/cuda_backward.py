"""The truncated backward pass: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_backward.py::backward_lanes_df and
::backward_dense_df (kernel body _backward_kernel -> _backward_step_body).
Kernel: csrc/backward.cu, sm_90a, float64 arithmetic on float64 or float32
inputs; its header says what bounds it on the H100 and how the design
answers that.

`backward_truncated_core` has the contract of the JAX `_backward_arrays`
with a leading batch axis. On a CPU tensor it runs the plain version; on a
CUDA float64 or float32 tensor it launches the kernel; any other dtype
raises. kappa and K come out in the inputs' dtype: on float32 inputs both
run the Riccati recursion in float64 and round the gains once, as the TPU
kernel (df32 inside) writes them in float32.

The kernel takes n <= 12 with m <= 8 at run time, and compiles the
registry's shapes alone, the 6-DoF lander's (14, 3) among them, the one
shape past n = 12 (`tier`); any other shape raises before a launch. A
traced build counts each launch's tier (utils/trace.py::count,
`backward.tier<n>`).
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build
from timeopt_tpu_torch.utils import trace

LAUNCHES = 0  # kernel launches since the last reset
N_MAX, M_MAX = 12, 8  # any shape at run time
COMPILED = ((2, 1), (4, 1), (4, 2), (12, 4), (14, 3))  # the (n, m) compiled alone in csrc/backward.cu


def tier(n: int, m: int) -> int:
    """The size tier of csrc/backward.cu that (n, m) takes, named by the n
    bound of its register tiles: n for a shape compiled alone, else N_MAX
    (the kernel's dispatch, the same rule); raises for a shape it does not
    take, naming it and the kernel's limits."""
    if (n, m) in COMPILED:
        return n
    if not (1 <= n <= N_MAX and 1 <= m <= M_MAX):
        raise ValueError(f"backward kernel: (n, m) = ({n}, {m}); csrc/backward.cu takes n <= {N_MAX} with "
                         f"m <= {M_MAX}, or (n, m) = (14, 3)")
    return N_MAX


def backward_plain(A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok, Qf, R, T_star, lm):
    """Plain PyTorch version of the kernel (solver/backward.py), in float64
    on float32 inputs (_build.in_f64)."""
    from timeopt_tpu_torch.solver.backward import _backward_arrays

    return _build.in_f64(_backward_arrays, A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok, Qf, R, T_star, lm)


def backward_truncated_core(A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok, Qf, R, T_star, lm):
    """A (B, N, n, n), B (B, N, n, m), lx (B, N, n), lu (B, N, m),
    Qstage (B, N, n, n), QfeT (B, N, n), eT_ok/step_ok (B, N), Qf (B, n, n),
    R (B, m, m), T_star (B,) int64, lm (B,) -> kappa (B, N, m),
    K (B, N, m, n), ok (B,) bool."""
    if not _build.on_card(A, "backward pass"):
        return backward_plain(A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok, Qf, R, T_star, lm)
    global LAUNCHES
    Bsz, N, n, _ = A.shape
    m = B.shape[-1]
    dtype, dev = A.dtype, A.device
    for t, shape, name in (
        (A, (Bsz, N, n, n), "A"), (B, (Bsz, N, n, m), "B"), (lx, (Bsz, N, n), "lx"),
        (lu, (Bsz, N, m), "lu"), (Qstage, (Bsz, N, n, n), "Qstage"), (QfeT, (Bsz, N, n), "QfeT"),
        (eT_ok, (Bsz, N), "eT_ok"), (step_ok, (Bsz, N), "step_ok"), (Qf, (Bsz, n, n), "Qf"),
        (R, (Bsz, m, m), "R"), (lm, (Bsz,), "lm"),
    ):
        _build.check(t, shape, dtype, dev, name)
    _build.check(T_star, (Bsz,), torch.int64, dev, "T_star")
    bound = tier(n, m)
    kappa = torch.empty((Bsz, N, m), dtype=dtype, device=dev)
    K = torch.empty((Bsz, N, m, n), dtype=dtype, device=dev)
    ok = torch.empty((Bsz,), dtype=torch.bool, device=dev)
    entry = "backward_truncated" if dtype == torch.float64 else "backward_truncated_f32"
    fn = _build.bind(_build.load("backward"), entry, 15, [ctypes.c_int] * 4)
    rc = fn(
        A.data_ptr(), B.data_ptr(), lx.data_ptr(), lu.data_ptr(), Qstage.data_ptr(),
        QfeT.data_ptr(), eT_ok.data_ptr(), step_ok.data_ptr(), Qf.data_ptr(), R.data_ptr(),
        T_star.data_ptr(), lm.data_ptr(), kappa.data_ptr(), K.data_ptr(), ok.data_ptr(),
        Bsz, N, n, m, _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    trace.count(f"backward.tier{bound}")
    return kappa, K, ok
