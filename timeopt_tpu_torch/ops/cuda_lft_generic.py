"""The generic propagator select: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_lft.py::propagator_select_lanes_df and
::propagator_select_dense_df (kernel body _df_select_kernel ->
_df_select_step + _df_compose_query). Kernel: csrc/lft_select_generic.cu,
sm_90a, float64 arithmetic on float64 or float32 inputs; its header says
what bounds it on the H100 and how the design answers that.

`propagator_select_generic` takes the AugmentedBlocks of
solver/augmented.py (Q_aug varies with the step, as an extra stage cost
makes it) and the terminal factors C, with a leading batch axis, and
returns J (B, N) in the inputs' dtype, unscaled (the caller multiplies by
s_0^2). On a CPU tensor it runs the plain version (which evaluates every
horizon); on a CUDA float64 or float32 tensor it launches the kernel, which
writes +inf below T_min; any other dtype raises. On float32 inputs both
compute in float64 and round J once, as the TPU kernel returns float32.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset
N_MAX, M_MAX = 12, 8  # csrc/lft_select_generic.cu's bounds


def select_generic_plain(A_aug, B_aug, Q_aug, R_inv, C) -> torch.Tensor:
    """Plain PyTorch version of the kernel (solver/horizon.py), in float64
    on float32 inputs (_build.in_f64)."""
    from timeopt_tpu_torch.solver.horizon import select_generic_plain as plain

    return _build.in_f64(plain, A_aug, B_aug, Q_aug, R_inv, C)


def propagator_select_generic(A_aug, B_aug, Q_aug, R_inv, C, *, t_min: int, jitter: float = 1e-9):
    """A_aug, Q_aug (B, N, p, p), B_aug (B, N, p, m), R_inv (B, m, m),
    C (B, N, n, p) with p = n + 1 -> J (B, N)."""
    if not _build.on_card(A_aug, "generic propagator select"):
        return select_generic_plain(A_aug, B_aug, Q_aug, R_inv, C)
    global LAUNCHES
    Bsz, N, p, _ = A_aug.shape
    n, m = p - 1, B_aug.shape[-1]
    dtype, dev = A_aug.dtype, A_aug.device
    for t, shape, name in (
        (A_aug, (Bsz, N, p, p), "A_aug"), (B_aug, (Bsz, N, p, m), "B_aug"),
        (Q_aug, (Bsz, N, p, p), "Q_aug"), (R_inv, (Bsz, m, m), "R_inv"), (C, (Bsz, N, n, p), "C"),
    ):
        _build.check(t, shape, dtype, dev, name)
    if not (1 <= n <= N_MAX and 1 <= m <= M_MAX):
        raise ValueError(f"generic select kernel: n = {n}, m = {m}; csrc/lft_select_generic.cu takes n <= {N_MAX} "
                         f"and m <= {M_MAX}")
    J = torch.empty((Bsz, N), dtype=dtype, device=dev)
    entry = "lft_select_generic" if dtype == torch.float64 else "lft_select_generic_f32"
    fn = _build.bind(_build.load("lft_select_generic"), entry, 6, [ctypes.c_int] * 5 + [ctypes.c_double])
    rc = fn(
        A_aug.data_ptr(), B_aug.data_ptr(), Q_aug.data_ptr(), R_inv.data_ptr(), C.data_ptr(), J.data_ptr(),
        Bsz, N, n, m, int(t_min), float(jitter), _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    return J
