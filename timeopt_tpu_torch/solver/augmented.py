"""Homogeneous-coordinate inputs of the propagator select (port of
timeopt_tpu/solver/augmented.py). Every tensor has a leading batch axis B.

Two forms feed the two select kernels: `build_fused_inputs` gives the raw
per-step ingredients that the fused kernel assembles itself (stationary
stage cost), `build_augmented` + `build_terminal_factors` the assembled
(n+1)-dimensional blocks of the generic kernel, whose Q_aug varies with k
(an extra stage cost). `build_terminal_blocks` gives the reference-parity
terminal blocks QT of the inverse query (terminal_mode="inverse"). The
homogeneous scaling is on unless `scale=False` (SolveOptions.
homogeneous_scaling), which takes s = 1 everywhere."""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops.linalg import chol_lower, psd_inv, sym
from timeopt_tpu_torch.ops.wrap import wrap_error
from timeopt_tpu_torch.solver.cost import extra_cost_terms


def homogeneous_scales(prob: Problem, X: torch.Tensor) -> torch.Tensor:
    """Per-step similarity scaling s_k (B, N+1) of the homogeneous coordinate:
    s_k^2 = (e_k'Q e_k + 2w) / qbar balances the augmented blocks while
    leaving J(T) unchanged up to the factor s_0^2."""
    e = wrap_error(X - prob.xg[:, None], prob.wrap_mask[:, None])
    quad = torch.einsum("bki,bkj,bij->bk", e, e, prob.Q)
    qbar = torch.diagonal(prob.Q, dim1=-2, dim2=-1).sum(-1) / prob.n + 1e-12
    corner = quad + 2.0 * prob.w[:, None]
    return torch.sqrt(torch.clamp(corner / qbar[:, None], min=1e-12))


def _scales(prob: Problem, X: torch.Tensor, scale: bool) -> torch.Tensor:
    """s (B, N+1): the homogeneous scales, or ones without `scale` (the
    blocks are then multiplied by exactly 1)."""
    if scale:
        return homogeneous_scales(prob, X)
    return torch.ones(X.shape[:2], dtype=X.dtype, device=X.device)


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
    scale: bool = True,
) -> FusedInputs:
    """X (B, N+1, n), U (B, N, m), A (B, N, n, n), B (B, N, n, m). With
    `scale` the homogeneous scales balance Q_aug (plain f32 would need them;
    f64 keeps them for its conditioning); without, s = 1."""
    if system.extra_cost is not None:
        raise ValueError("an extra stage cost makes Q_aug step-dependent: use build_augmented")
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

    s = _scales(prob, X, scale)
    scal = torch.stack([corner, 1.0 / s[:, :N], s[:, 1:], 1.0 / s[:, 1:]], dim=-1)
    vecs = torch.stack([e, en, atil, Qe], dim=2)
    return FusedInputs(A=A, B=B, vecs=vecs, scal=scal, Qq=Qq, R_inv=R_inv, Lt=Lt, s=s)


class AugmentedBlocks(NamedTuple):
    """Assembled, scaled blocks of the generic select (ops/cuda_lft_generic.py)."""

    A_aug: torch.Tensor  # (B, N, n+1, n+1)
    B_aug: torch.Tensor  # (B, N, n+1, m)
    Q_aug: torch.Tensor  # (B, N, n+1, n+1)
    R_inv: torch.Tensor  # (B, m, m)
    s: torch.Tensor  # (B, N+1) homogeneous scales (J carries s_0^2)


def build_augmented(
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
    scale: bool = True,
) -> AugmentedBlocks:
    """Homogeneous blocks z_k = [dx; 1]: Q_aug = [[Q + q_reg I + cxx, Qe + cx],
    [., e'Qe + 2w + rho + 2c]], A_aug = [[A, atil], [0, 1]], B_aug = [B; 0],
    then scaled by D_k = diag(1..1, s_k): Q~ = D_k^-1 Q_aug D_k^-1,
    A~ = D_{k+1} A_aug D_k^-1 (s = 1 without `scale`). X (B, N+1, n),
    U (B, N, m), A (B, N, n, n), B (B, N, n, m)."""
    Bsz, N, m = U.shape
    n = prob.n
    z = dict(dtype=X.dtype, device=X.device)
    mask = prob.wrap_mask[:, None]

    e = wrap_error(X[:, :-1] - prob.xg[:, None], mask)
    du = U - prob.u_ref[:, None]
    a = system.step(X[:, :-1], U) - X[:, 1:]
    atil = a - torch.einsum("bknm,bkm->bkn", B, du)
    Qe = torch.einsum("bki,bji->bkj", e, prob.Q)
    corner = torch.einsum("bki,bkj,bij->bk", e, e, prob.Q) + 2.0 * prob.w[:, None] + rho_reg
    Qblock = (sym(prob.Q) + q_reg * torch.eye(n, **z))[:, None].expand(Bsz, N, n, n)

    extra = extra_cost_terms(system, X[:, :-1], U)
    if extra is not None:
        c, cx, cxx = extra
        Qblock = Qblock + sym(cxx)
        Qe = Qe + cx
        corner = corner + 2.0 * c

    Q_aug = torch.zeros((Bsz, N, n + 1, n + 1), **z)
    Q_aug[:, :, :n, :n] = Qblock
    Q_aug[:, :, :n, n] = Qe
    Q_aug[:, :, n, :n] = Qe
    Q_aug[:, :, n, n] = corner
    Q_aug = sym(Q_aug)

    A_aug = torch.zeros((Bsz, N, n + 1, n + 1), **z)
    A_aug[:, :, :n, :n] = A
    A_aug[:, :, :n, n] = atil
    A_aug[:, :, n, n].fill_(1.0)  # not `= 1.0`: a Python number stored by item makes a tensor (CaptureGuard)

    B_aug = torch.zeros((Bsz, N, n + 1, m), **z)
    B_aug[:, :, :n, :] = B

    s = _scales(prob, X, scale)
    ones = torch.ones((Bsz, N, n), **z)
    d_col = torch.cat([ones, (1.0 / s)[:, :N, None]], dim=-1)  # D_k^-1
    d_row = torch.cat([ones, s[:, 1:, None]], dim=-1)  # D_{k+1}
    Q_aug = Q_aug * d_col[..., :, None] * d_col[..., None, :]
    A_aug = A_aug * d_row[..., :, None] * d_col[..., None, :]
    R_inv = psd_inv(prob.R, levels=psd_levels)
    return AugmentedBlocks(A_aug=A_aug, B_aug=B_aug, Q_aug=Q_aug, R_inv=R_inv, s=s)


def build_terminal_factors(prob: Problem, X: torch.Tensor, *, s: torch.Tensor, rho_reg: float = 1e-12) -> torch.Tensor:
    """Factored terminal data C_t = L'[I e_t] D_t^-1 (B, N, n, n+1) for the
    arrival steps t = 1..N, with Qf + rho I = L L' and the last column
    divided by s_t, so that QT_t = C_t'C_t is never inverted."""
    n = prob.n
    Lt = chol_lower(sym(prob.Qf) + rho_reg * torch.eye(n, dtype=X.dtype, device=X.device)).transpose(-1, -2)
    e = wrap_error(X[:, 1:] - prob.xg[:, None], prob.wrap_mask[:, None])
    Le = torch.einsum("bki,bji->bkj", e, Lt)  # L' e_t
    Bsz, N = e.shape[:2]
    C = torch.cat([Lt[:, None].expand(Bsz, N, n, n), Le[..., None]], dim=-1)
    C[:, :, :, n] = C[:, :, :, n] * (1.0 / s[:, 1:, None])
    return C


def build_terminal_blocks(prob: Problem, X: torch.Tensor, *, rho_reg: float = 1e-12, s: torch.Tensor = None) -> torch.Tensor:
    """Terminal (n+1)^2 block per arrival step t = 1..N (B, N, n+1, n+1):
    QT_t = [[P, P e_t], [e_t' P, e_t' P e_t + rho]] with P = sym(Qf), then
    scaled by D_t^-1 on both sides (last row and column divided by s_t)."""
    n = prob.n
    P = sym(prob.Qf)
    e = wrap_error(X[:, 1:] - prob.xg[:, None], prob.wrap_mask[:, None])
    px = torch.einsum("bki,bji->bkj", e, P)  # P e_t
    p0 = torch.einsum("bki,bkj,bij->bk", e, e, P)
    Bsz, N = e.shape[:2]
    QT = torch.zeros((Bsz, N, n + 1, n + 1), dtype=X.dtype, device=X.device)
    QT[:, :, :n, :n] = P[:, None]
    QT[:, :, :n, n] = px
    QT[:, :, n, :n] = px
    QT[:, :, n, n] = p0 + rho_reg
    if s is not None:
        d = torch.cat([torch.ones((Bsz, N, n), dtype=X.dtype, device=X.device), (1.0 / s[:, 1:])[..., None]], dim=-1)
        QT = QT * d[..., :, None] * d[..., None, :]
    return sym(QT)
