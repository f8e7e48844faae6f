"""Trajectory linearization by forward-mode AD (port of the "ad" mode of
timeopt_tpu/solver/linearize.py; the finite-difference modes are not ported
yet). One `jacfwd` over the joint (x, u) input, vmapped over all B*N steps."""

from __future__ import annotations

import torch


def linearize_ad(step, X: torch.Tensor, U: torch.Tensor):
    """Exact Jacobians A_k = df/dx, B_k = df/du along (X, U).

    X: (B, N+1, n); U: (B, N, m). Returns A (B, N, n, n), B (B, N, n, m)."""
    Bsz, Np1, n = X.shape
    N, m = Np1 - 1, U.shape[-1]
    xu = torch.cat([X[:, :-1], U], dim=-1).reshape(Bsz * N, n + m)

    def joint(v):
        return step(v[:n], v[n:])

    J = torch.func.vmap(torch.func.jacfwd(joint))(xu)  # (B*N, n, n+m)
    return J[..., :n].reshape(Bsz, N, n, n), J[..., n:].reshape(Bsz, N, n, m)


def linearize(step, X: torch.Tensor, U: torch.Tensor, mode: str = "ad"):
    if mode != "ad":
        raise NotImplementedError(
            f"linearize_mode={mode!r} is not ported yet; only 'ad' (ROADMAP.md)"
        )
    return linearize_ad(step, X, U)
