"""The fused propagator select: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_lft.py::propagator_select_lanes_df_fused and
::propagator_select_dense_df_fused (kernel body _df_select_fused_kernel).
Kernel: csrc/lft_select.cu, sm_90a, float64 arithmetic on float64 or
float32 inputs; its header says what bounds it on the H100 and how the
design answers that.

`propagator_select_fused` takes the FusedInputs of solver/augmented.py with
a leading batch axis and returns J (B, N) in the inputs' dtype, unscaled
(the caller multiplies by s_0^2). On a CPU tensor it runs the plain version
(which evaluates every horizon); on a CUDA float64 or float32 tensor it
launches the kernel, which writes +inf below T_min; any other dtype raises.
On float32 inputs both compute in float64 and round J once, on the way
out: the TPU kernel computes in df32 and returns float32.

The kernel's shared memory is sized for the largest n of its size tier
(`tier`): the registry's tier holds n <= 12 (n <= 4 in a narrower register
tile), the wide tier n <= 14 (the 6-DoF lander). Past it the wrapper
raises before any launch. A traced build counts each launch's tier
(utils/trace.py::count, `select.tier<n>`).
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build
from timeopt_tpu_torch.ops.linalg import gj_inv, sym
from timeopt_tpu_torch.utils import trace

LAUNCHES = 0  # kernel launches since the last reset
TIERS = (4, 12, 14)  # the n bound of each size tier of csrc/lft_select.cu
M_MAX = 8


def tier(n: int, m: int) -> int:
    """The size tier of csrc/lft_select.cu that n states and m inputs
    take, named by its n bound (the kernel's dispatch, the same rule);
    raises past the widest, naming n, m and the kernel's limits."""
    if not (1 <= n <= TIERS[-1] and 1 <= m <= M_MAX):
        raise ValueError(f"fused select kernel: n = {n}, m = {m}; csrc/lft_select.cu takes 1 <= n <= {TIERS[-1]} "
                         f"and 1 <= m <= {M_MAX}")
    return next(t for t in TIERS if n <= t)


def select_fused_plain(A, Bm, vecs, scal, Qq, R_inv, Lt) -> torch.Tensor:
    """Plain PyTorch version of the kernel (solver/horizon.py), in float64
    on float32 inputs (_build.in_f64)."""
    from timeopt_tpu_torch.solver.horizon import select_fused_plain as plain

    return _build.in_f64(plain, A, Bm, vecs, scal, Qq, R_inv, Lt)


def propagator_select_fused(A, Bm, vecs, scal, Qq, R_inv, Lt, *, t_min: int, jitter: float = 1e-9):
    """A (B, N, n, n), Bm (B, N, n, m), vecs (B, N, 4, n), scal (B, N, 4),
    Qq/Lt (B, n, n), R_inv (B, m, m) -> J (B, N)."""
    if not _build.on_card(A, "propagator select"):
        return select_fused_plain(A, Bm, vecs, scal, Qq, R_inv, Lt)
    global LAUNCHES
    Bsz, N, n, _ = A.shape
    m = Bm.shape[-1]
    f64, dtype, dev = torch.float64, A.dtype, A.device
    for t, shape, name in (
        (A, (Bsz, N, n, n), "A"), (Bm, (Bsz, N, n, m), "Bm"), (vecs, (Bsz, N, 4, n), "vecs"),
        (scal, (Bsz, N, 4), "scal"), (Qq, (Bsz, n, n), "Qq"), (R_inv, (Bsz, m, m), "R_inv"),
        (Lt, (Bsz, n, n), "Lt"),
    ):
        _build.check(t, shape, dtype, dev, name)
    bound = tier(n, m)
    # k-constant inverses, computed once outside the kernel in float64 (on
    # float32 inputs too; the JAX wrapper forms them in df32): iQq =
    # (Qq + jitter I)^-1, W0 = (Lt' Lt)^-1 = (Qf + rho I)^-1, and R^-1
    Qq, R_inv, Lt = (t.to(f64) for t in (Qq, R_inv, Lt))
    eye = torch.eye(n, dtype=f64, device=dev)
    iQq = sym(gj_inv(Qq + jitter * eye)).contiguous()
    W0 = sym(gj_inv(Lt.transpose(-1, -2) @ Lt)).contiguous()
    J = torch.empty((Bsz, N), dtype=dtype, device=dev)
    entry = "lft_select_fused" if dtype == f64 else "lft_select_fused_f32"
    fn = _build.bind(_build.load("lft_select"), entry, 8, [ctypes.c_int] * 5 + [ctypes.c_double])
    rc = fn(
        A.data_ptr(), Bm.data_ptr(), vecs.data_ptr(), scal.data_ptr(), iQq.data_ptr(),
        R_inv.data_ptr(), W0.data_ptr(), J.data_ptr(),
        Bsz, N, n, m, int(t_min), float(jitter), _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    trace.count(f"select.tier{bound}")
    return J
