"""Homogeneous-coordinate inputs of the propagator select (port of
`homogeneous_scales`, `FusedInputs` and `build_fused_inputs` of
timeopt_tpu/solver/augmented.py). Every tensor has a leading batch axis B."""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops.linalg import chol_lower, psd_inv, sym
from timeopt_tpu_torch.ops.wrap import wrap_error


def homogeneous_scales(prob: Problem, X: torch.Tensor) -> torch.Tensor:
    """Per-step similarity scaling s_k (B, N+1) of the homogeneous coordinate:
    s_k^2 = (e_k'Q e_k + 2w) / qbar balances the augmented blocks while
    leaving J(T) unchanged up to the factor s_0^2."""
    e = wrap_error(X - prob.xg[:, None], prob.wrap_mask[:, None])
    quad = torch.einsum("bki,bkj,bij->bk", e, e, prob.Q)
    qbar = torch.diagonal(prob.Q, dim1=-2, dim2=-1).sum(-1) / prob.n + 1e-12
    corner = quad + 2.0 * prob.w[:, None]
    return torch.sqrt(torch.clamp(corner / qbar[:, None], min=1e-12))


class FusedInputs(NamedTuple):
    """Raw per-step inputs of the fused select (ops/cuda_lft.py)."""

    A: torch.Tensor  # (B, N, n, n)
    B: torch.Tensor  # (B, N, n, m)
    vecs: torch.Tensor  # (B, N, 4, n): [e_k, e_{k+1}, atil_k, Q e_k]
    scal: torch.Tensor  # (B, N, 4): [corner_k, 1/s_k, s_{k+1}, 1/s_{k+1}]
    Qq: torch.Tensor  # (B, n, n) = sym(Q) + q_reg I
    R_inv: torch.Tensor  # (B, m, m)
    Lt: torch.Tensor  # (B, n, n) = chol(Qf + rho I)' (upper)
    s: torch.Tensor  # (B, N+1) homogeneous scales (J carries s_0^2)


def build_fused_inputs(
    system: System,
    prob: Problem,
    X: torch.Tensor,
    U: torch.Tensor,
    A: torch.Tensor,
    B: torch.Tensor,
    *,
    q_reg: float = 1e-9,
    rho_reg: float = 1e-12,
    psd_levels: int = 2,
) -> FusedInputs:
    """X (B, N+1, n), U (B, N, m), A (B, N, n, n), B (B, N, n, m). The
    homogeneous scaling is always on (plain f32 would need it; f64 keeps it
    for the conditioning of Q_aug)."""
    if system.extra_cost is not None:
        raise NotImplementedError("extra stage costs take the generic select, not ported yet")
    N, n = U.shape[1], prob.n
    eye = torch.eye(n, dtype=X.dtype, device=X.device)
    mask = prob.wrap_mask[:, None]

    e = wrap_error(X[:, :-1] - prob.xg[:, None], mask)
    en = wrap_error(X[:, 1:] - prob.xg[:, None], mask)
    du = U - prob.u_ref[:, None]
    a = system.step(X[:, :-1], U) - X[:, 1:]
    atil = a - torch.einsum("bknm,bkm->bkn", B, du)
    Qe = torch.einsum("bki,bji->bkj", e, prob.Q)
    corner = torch.einsum("bki,bkj,bij->bk", e, e, prob.Q) + 2.0 * prob.w[:, None] + rho_reg

    Qq = sym(prob.Q) + q_reg * eye
    R_inv = psd_inv(prob.R, levels=psd_levels)
    Lt = chol_lower(sym(prob.Qf) + rho_reg * eye).transpose(-1, -2)

    s = homogeneous_scales(prob, X)
    scal = torch.stack([corner, 1.0 / s[:, :N], s[:, 1:], 1.0 / s[:, 1:]], dim=-1)
    vecs = torch.stack([e, en, atil, Qe], dim=2)
    return FusedInputs(A=A, B=B, vecs=vecs, scal=scal, Qq=Qq, R_inv=R_inv, Lt=Lt, s=s)
