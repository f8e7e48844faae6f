"""The factored terminal queries: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_lft.py::lft_query_lanes (kernel body
_query_kernel). Kernel: csrc/lft_query.cu, float64, sm_90a; its header says
what bounds it on the H100 and how the design answers that: persistent
warps, each walking its own stride of (b, t) pairs with the next query's
inputs in flight by cp.async, one query a warp in registers (the sweeps of
csrc/warpmat.cuh), no block barrier. J equals the first (block-per-query)
design's bit for bit (`chip_smoke.py --ab`).

`lft_query` takes the prefixes (E, F, G) of ops/cuda_lft_scan.py and the
terminal factors C of solver/augmented.py::build_terminal_factors, with a
leading batch axis, and returns J (B, N) for every horizon, unscaled (the
caller multiplies by s_0^2). On a CPU tensor it runs the plain version; on
a CUDA float64 tensor it launches the kernel. Float32 raises TypeError on
every device: its float32 instantiation is the next slice of the port
(ROADMAP.md); any other dtype raises too.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset


def lft_query_plain(E, F, G, C, *, jitter: float = 1e-9, levels: int):
    """Plain PyTorch version of the kernel (solver/horizon.py::
    propagator_J_curve_factored)."""
    from timeopt_tpu_torch.solver.horizon import LFTElements, propagator_J_curve_factored

    return propagator_J_curve_factored(LFTElements(E, F, G), C, psd_levels=levels, jitter=jitter)


def lft_query(E, F, G, C, *, jitter: float = 1e-9, levels: int):
    """E, F, G (B, N, p, p), C (B, N, n, p) with p = n + 1 -> J (B, N).
    `levels` (1 or 2 on the card) is the jitter ladder of the X0 solve; the
    S solve has jitter 0, so its rungs are one matrix."""
    if not _build.on_card(E, "terminal query", f32=False):
        return lft_query_plain(E, F, G, C, jitter=jitter, levels=levels)
    if levels not in (1, 2):
        raise ValueError(f"terminal query: levels must be 1 or 2 on the card, got {levels}")
    global LAUNCHES
    Bsz, N, p, _ = E.shape
    n = p - 1
    f64, dev = torch.float64, E.device
    for t, shape, name in (
        (E, (Bsz, N, p, p), "E"), (F, (Bsz, N, p, p), "F"), (G, (Bsz, N, p, p), "G"), (C, (Bsz, N, n, p), "C"),
    ):
        _build.check(t, shape, f64, dev, name)
    J = torch.empty((Bsz, N), dtype=f64, device=dev)
    fn = _build.bind(_build.load("lft_query"), "lft_query", 5, [ctypes.c_int] * 4 + [ctypes.c_double])
    rc = fn(
        E.data_ptr(), F.data_ptr(), G.data_ptr(), C.data_ptr(), J.data_ptr(),
        Bsz, N, n, int(levels), float(jitter), _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, "lft_query")
    LAUNCHES += 1
    return J
