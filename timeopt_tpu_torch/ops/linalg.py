"""Small-matrix linear algebra (port of timeopt_tpu/ops/linalg.py).

The solver inverts and solves chains of tiny symmetric matrices (at most
13 x 13) batched over time steps and problems. The core primitive is the
same unrolled, pivot-free Gauss-Jordan elimination as the reference: for the
symmetric positive-definite inputs here the pivots are the Schur-complement
diagonals, which double as the PD test, so the PD and jitter semantics match
the JAX package exactly. Everything broadcasts over leading batch axes.
"""

from __future__ import annotations

import numpy as np
import torch


def sym(A: torch.Tensor) -> torch.Tensor:
    """Symmetrize: 0.5 (A + A^T) over the trailing two axes."""
    return 0.5 * (A + A.transpose(-1, -2))


def _eye_like(A: torch.Tensor) -> torch.Tensor:
    n = A.shape[-1]
    return torch.eye(n, dtype=A.dtype, device=A.device).expand(A.shape)


def _gj_eliminate(M: torch.Tensor, n: int, pivots: list | None = None) -> torch.Tensor:
    """Pivot-free Gauss-Jordan on the augmented (..., n, n+k) system."""
    for i in range(n):
        piv = M[..., i, i]
        if pivots is not None:
            pivots.append(piv)
        row = M[..., i, :] / piv[..., None]
        col = M[..., :, i]
        M = M - col[..., :, None] * row[..., None, :]
        M[..., i, :] = row
    return M


def gj_inv_pivots(A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Pivot-free Gauss-Jordan inverse of (..., n, n) and its pivots (..., n).
    A symmetric matrix is PD iff all pivots are strictly positive."""
    n = A.shape[-1]
    pivots: list = []
    M = _gj_eliminate(torch.cat([A, _eye_like(A)], dim=-1), n, pivots)
    return M[..., :, n:], torch.stack(pivots, dim=-1)


def gj_inv(A: torch.Tensor) -> torch.Tensor:
    return gj_inv_pivots(A)[0]


def gj_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve A X = B by pivot-free Gauss-Jordan; B: (..., n, k) or (..., n)."""
    vec = B.dim() == A.dim() - 1
    if vec:
        B = B[..., None]
    n = A.shape[-1]
    X = _gj_eliminate(torch.cat([A, B], dim=-1), n)[..., :, n:]
    return X[..., 0] if vec else X


def _ladder(fn, A: torch.Tensor, jitter: float, levels: int) -> torch.Tensor:
    """fn(sym(A) + eps I) over a fixed jitter ladder (rungs 1e4 apart),
    keeping per matrix the first finite result. Branchless."""
    A = sym(A)
    I = _eye_like(A)
    out = fn(A + jitter * I)
    for lv in range(1, levels):
        nxt = fn(A + (jitter * 1e4**lv) * I)
        ok = torch.isfinite(out).all(dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        out = torch.where(ok, out, nxt)
    return out


def psd_inv(A: torch.Tensor, jitter: float = 1e-9, levels: int = 2) -> torch.Tensor:
    """Inverse of a symmetric (nominally PD) matrix with a jitter ladder."""
    return _ladder(gj_inv, A, jitter, levels)


def psd_solve(A: torch.Tensor, B: torch.Tensor, jitter: float = 1e-9, levels: int = 2) -> torch.Tensor:
    """Solve A X = B for symmetric (nominally PD) A with a jitter ladder.
    Failures surface as non-finite values, which callers treat as rejection."""
    vec = B.dim() == A.dim() - 1
    Bm = B[..., None] if vec else B
    X = _ladder(lambda Areg: gj_solve(Areg, Bm), A, jitter, levels)
    return X[..., 0] if vec else X


def spd_check(A: torch.Tensor) -> torch.Tensor:
    """True where the symmetric (..., n, n) matrix is SPD: finite, with
    finite positive elimination pivots."""
    _, piv = gj_inv_pivots(sym(A))
    finite = torch.isfinite(A).all(dim=-1).all(dim=-1)
    return finite & (piv > 0).all(dim=-1) & torch.isfinite(piv).all(dim=-1)


def chol_lower(A: torch.Tensor) -> torch.Tensor:
    """Unrolled batched Cholesky factor L (A = L L^T), right-looking."""
    n = A.shape[-1]
    M = sym(A)
    idx = torch.arange(n, device=A.device)
    cols = []
    for j in range(n):
        d = torch.sqrt(M[..., j, j])
        c = M[..., :, j] / d[..., None]
        c = c * (idx >= j)
        M = M - c[..., :, None] * c[..., None, :]
        cols.append(c)
    return torch.stack(cols, dim=-1)


def as_terminal_weight(alpha, n: int, dtype=np.float64) -> np.ndarray:
    """Host-side: scalar / diag-vector / matrix terminal weight -> (n, n)."""
    A = np.asarray(alpha, dtype=dtype)
    if A.ndim == 0:
        return (float(A) * np.eye(n)).astype(dtype)
    if A.ndim == 1:
        if A.shape[0] != n:
            raise ValueError(f"terminal weight vector has shape {A.shape}, expected ({n},)")
        return np.diag(A).astype(dtype)
    if A.ndim == 2:
        if A.shape != (n, n):
            raise ValueError(f"terminal weight matrix has shape {A.shape}, expected ({n},{n})")
        return (0.5 * (A + A.T)).astype(dtype)
    raise ValueError(f"unsupported terminal weight ndim={A.ndim}")
