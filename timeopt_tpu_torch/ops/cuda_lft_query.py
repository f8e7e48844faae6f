"""The factored terminal queries: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_lft.py::lft_query_lanes (kernel body
_query_kernel). Kernel: csrc/lft_query.cu, sm_90a, float64 arithmetic on
float64 or float32 C; its header says what bounds it on the H100 and how the
design answers that: persistent warps, each walking its own stride of (b, t)
pairs with the next query's inputs in flight by cp.async, one query a warp
in registers (the sweeps of csrc/warpmat.cuh), no block barrier. J equals
the first (block-per-query) design's bit for bit (`chip_smoke.py --ab`).

`lft_query` takes the prefixes (E, F, G) of ops/cuda_lft_scan.py (float64)
and the terminal factors C of solver/augmented.py::build_terminal_factors
(float64 or float32), with a leading batch axis, and returns J (B, N) for
every horizon in C's dtype, unscaled (the caller multiplies by s_0^2). On a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel's float64 entry, or for float32 C its float32 entry `lft_query_f32`
(float32 C read from device memory, float64 arithmetic, J rounded to
float32 once). Prefixes of another dtype than float64, or C of another than
float64 or float32, raise on every device.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset
N_MAX = 12  # csrc/lft_query.cu's bound


def lft_query_plain(E, F, G, C, *, jitter: float = 1e-9, levels: int):
    """Plain PyTorch version of the kernel (solver/horizon.py::
    propagator_J_curve_factored) in float64, J in C's dtype: on float32 C,
    C upcast and J rounded once."""
    from timeopt_tpu_torch.solver.horizon import LFTElements, propagator_J_curve_factored

    J = propagator_J_curve_factored(LFTElements(E, F, G), C.double(), psd_levels=levels, jitter=jitter)
    return J.to(C.dtype)


def lft_query(E, F, G, C, *, jitter: float = 1e-9, levels: int):
    """E, F, G (B, N, p, p) float64, C (B, N, n, p) float64 or float32
    with p = n + 1 -> J (B, N) in C's dtype. `levels` (1 or 2 on the card)
    is the jitter ladder of the X0 solve; the S solve has jitter 0, so its
    rungs are one matrix."""
    for t, name in ((E, "E"), (F, "F"), (G, "G")):
        if t.dtype != torch.float64:
            raise TypeError(f"terminal query: prefix {name} has dtype {t.dtype}; the prefixes are float64")
    if not _build.on_card(C, "terminal query"):
        return lft_query_plain(E, F, G, C, jitter=jitter, levels=levels)
    if levels not in (1, 2):
        raise ValueError(f"terminal query: levels must be 1 or 2 on the card, got {levels}")
    global LAUNCHES
    Bsz, N, p, _ = E.shape
    n = p - 1
    dtype, dev = C.dtype, C.device
    for t, shape, dt, name in (
        (E, (Bsz, N, p, p), torch.float64, "E"), (F, (Bsz, N, p, p), torch.float64, "F"),
        (G, (Bsz, N, p, p), torch.float64, "G"), (C, (Bsz, N, n, p), dtype, "C"),
    ):
        _build.check(t, shape, dt, dev, name)
    if not 1 <= n <= N_MAX:
        raise ValueError(f"terminal query kernel: n = {n}; csrc/lft_query.cu takes n <= {N_MAX}")
    J = torch.empty((Bsz, N), dtype=dtype, device=dev)
    entry = "lft_query" if dtype == torch.float64 else "lft_query_f32"
    fn = _build.bind(_build.load("lft_query"), entry, 5, [ctypes.c_int] * 4 + [ctypes.c_double])
    rc = fn(
        E.data_ptr(), F.data_ptr(), G.data_ptr(), C.data_ptr(), J.data_ptr(),
        Bsz, N, n, int(levels), float(jitter), _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    return J
