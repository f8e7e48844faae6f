"""Every prefix of the LFT scan: hand-written CUDA kernel and its plain version.

Replaces timeopt_tpu/ops/pallas_lft.py::lft_scan_lanes (kernel body
_lft_scan_kernel). Kernel: csrc/lft_scan.cu, sm_90a, float64 arithmetic on
float64 or float32 blocks; its header says what bounds it on the H100 and
how the design answers that: per problem an element warp (step inputs by
cp.async one step ahead) and a compose warp alone on the carry's chain
(register Gauss-Jordan sweeps of csrc/warpmat.cuh), two problems a block
sharing a store warp that streams every prefix out, all handed over by
mbarriers. Its prefixes equal the first (block-per-problem) design's bit for
bit (`chip_smoke.py --ab`).

`lft_scan` takes the assembled blocks A_aug, Q_aug and BRB = B_aug R^-1
B_aug' (formed outside the kernel, as the JAX wrapper does) with a leading
batch axis, and returns the prefix compositions (E, F, G) of every step,
in float64 whatever the blocks' dtype. On a CPU tensor it runs the plain
version; on a CUDA float64 tensor it launches the kernel's float64 entry,
on a CUDA float32 tensor its float32 entry `lft_scan_f32` (float32 blocks
read from device memory, float64 arithmetic); any other dtype raises. The
float32 path keeps the prefixes in float64: they are the recursion's
state, which ends in J (ops/cuda_lft_query.py), rounded to float32 once.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # kernel launches since the last reset
N_MAX = 12  # csrc/lft_scan.cu's bound (p = n + 1 <= 13)


def lft_scan_plain(A_aug, BRB, Q_aug, *, jitter: float = 1e-9, levels: int):
    """Plain PyTorch version of the kernel: lft_prefix_scan(lft_elements(...))
    of solver/horizon.py, on the blocks upcast to float64 (float32 blocks
    give the float64 prefixes, as the kernel's float32 entry does)."""
    from timeopt_tpu_torch.solver.horizon import lft_elements_brb, lft_prefix_scan

    A_aug, BRB, Q_aug = (t.double() for t in (A_aug, BRB, Q_aug))
    elems = lft_elements_brb(A_aug, BRB, Q_aug, psd_levels=levels, jitter=jitter)
    return tuple(lft_prefix_scan(elems, psd_levels=levels, jitter=jitter))


def lft_scan(A_aug, BRB, Q_aug, *, jitter: float = 1e-9, levels: int):
    """A_aug, BRB, Q_aug (B, N, p, p), float64 or float32 -> prefixes
    (E, F, G), each (B, N, p, p) float64. `levels` (1 or 2 on the card) is
    the jitter ladder of ops/linalg.py::psd_inv for the element and the
    compose inverses."""
    if not _build.on_card(A_aug, "LFT prefix scan"):
        return lft_scan_plain(A_aug, BRB, Q_aug, jitter=jitter, levels=levels)
    if levels not in (1, 2):
        raise ValueError(f"LFT prefix scan: levels must be 1 or 2 on the card, got {levels}")
    global LAUNCHES
    Bsz, N, p, _ = A_aug.shape
    dtype, dev = A_aug.dtype, A_aug.device
    for t, name in ((A_aug, "A_aug"), (BRB, "BRB"), (Q_aug, "Q_aug")):
        _build.check(t, (Bsz, N, p, p), dtype, dev, name)
    if not 1 <= p - 1 <= N_MAX:
        raise ValueError(f"LFT prefix scan kernel: n = {p - 1}; csrc/lft_scan.cu takes n <= {N_MAX}")
    E, F, G = (torch.empty((Bsz, N, p, p), dtype=torch.float64, device=dev) for _ in range(3))
    entry = "lft_scan" if dtype == torch.float64 else "lft_scan_f32"
    fn = _build.bind(_build.load("lft_scan"), entry, 6, [ctypes.c_int] * 4 + [ctypes.c_double])
    rc = fn(
        A_aug.data_ptr(), BRB.data_ptr(), Q_aug.data_ptr(), E.data_ptr(), F.data_ptr(), G.data_ptr(),
        Bsz, N, p, int(levels), float(jitter), _build.stream_ptr(dev),
    )
    _build.raise_on_error(rc, entry)
    LAUNCHES += 1
    return E, F, G
