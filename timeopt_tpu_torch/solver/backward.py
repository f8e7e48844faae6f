"""Truncated iLQR backward pass (port of timeopt_tpu/solver/backward.py).

The horizon T* is a per-problem tensor: the terminal expansion is injected
where k+1 == T*, steps with k >= T* pass the value function through with
zero gains, and a non-PD Quu_reg or a non-finite value at any active step
clears the problem's `ok` flag. `backward_truncated` reaches the phase's
one dispatch point, ops/cuda_backward.py::backward_truncated_core.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops import cuda_backward
from timeopt_tpu_torch.ops.linalg import gj_solve, spd_check, sym
from timeopt_tpu_torch.ops.wrap import wrap_error
from timeopt_tpu_torch.solver.cost import extra_cost_terms
from timeopt_tpu_torch.utils import trace


class BackwardResult(NamedTuple):
    kappa: torch.Tensor  # (B, N, m) feedforward gains (zero where k >= T*)
    K: torch.Tensor  # (B, N, m, n) feedback gains
    ok: torch.Tensor  # (B,) bool: all active steps PD and finite


def stage_expansion(system: System, prob: Problem, X: torch.Tensor, U: torch.Tensor):
    """Per-step cost expansion along the trajectory: e, du, lx, lu, l0,
    Qstage, each with leading axes (B, N); an extra stage cost adds its
    value, gradient and Hessian."""
    e = wrap_error(X[:, :-1] - prob.xg[:, None], prob.wrap_mask[:, None])
    du = U - prob.u_ref[:, None]
    lx = torch.einsum("bki,bji->bkj", e, prob.Q)
    lu = torch.einsum("bki,bji->bkj", du, prob.R)
    l0 = (
        0.5 * torch.einsum("bki,bij,bkj->bk", e, prob.Q, e)
        + 0.5 * torch.einsum("bki,bij,bkj->bk", du, prob.R, du)
        + prob.w[:, None]
    )
    Qstage = prob.Q[:, None].expand(-1, U.shape[1], -1, -1)

    extra = extra_cost_terms(system, X[:, :-1], U)
    if extra is not None:
        c, cx, cxx = extra
        l0 = l0 + c
        lx = lx + cx
        Qstage = sym(Qstage + cxx)
    return e, du, lx, lu, l0, Qstage


def _backward_arrays(A, B, lx, lu, Qstage, QfeT, eT_ok, step_ok_in, Qf, R, T_star, lm_lambda):
    """Plain masked reverse sweep over all N steps, batched over B.
    QfeT[:, k] = Qf wrap(x_{k+1} - xg); eT_ok / step_ok_in: 1.0/0.0 flags."""
    Bsz, N, n, _ = A.shape
    m = B.shape[-1]
    I_m = torch.eye(m, dtype=A.dtype, device=A.device)
    T = T_star.to(torch.int64)
    Vx = torch.zeros((Bsz, n), dtype=A.dtype, device=A.device)
    Vxx = torch.zeros((Bsz, n, n), dtype=A.dtype, device=A.device)
    ok = T > 0
    kappa = torch.zeros((Bsz, N, m), dtype=A.dtype, device=A.device)
    K = torch.zeros((Bsz, N, m, n), dtype=A.dtype, device=A.device)
    for k in range(N - 1, -1, -1):
        Ak, Bk = A[:, k], B[:, k]
        AkT, BkT = Ak.transpose(-1, -2), Bk.transpose(-1, -2)
        is_term = (k + 1) == T
        Vx = torch.where(is_term[:, None], QfeT[:, k], Vx)
        Vxx = torch.where(is_term[:, None, None], Qf, Vxx)
        ok = ok & torch.where(is_term, eT_ok[:, k] > 0.5, True)

        Qx = lx[:, k] + (AkT @ Vx[..., None])[..., 0]
        Qu = lu[:, k] + (BkT @ Vx[..., None])[..., 0]
        Qxx = Qstage[:, k] + AkT @ Vxx @ Ak
        Quu = R + BkT @ Vxx @ Bk
        Qux = BkT @ Vxx @ Ak

        Quu_reg = sym(Quu) + lm_lambda[:, None, None] * I_m
        pd = spd_check(Quu_reg)
        kap = -gj_solve(Quu_reg, Qu)
        Kk = -gj_solve(Quu_reg, Qux)
        KkT = Kk.transpose(-1, -2)

        Vx_new = (
            Qx
            + (KkT @ Qu[..., None])[..., 0]
            + (Qux.transpose(-1, -2) @ kap[..., None])[..., 0]
            + (KkT @ (Quu @ kap[..., None]))[..., 0]
        )
        Vxx_new = sym(Qxx + KkT @ Qux + Qux.transpose(-1, -2) @ Kk + KkT @ Quu @ Kk)

        active = k < T
        step_ok = (
            pd
            & (step_ok_in[:, k] > 0.5)
            & torch.isfinite(Vx_new).all(dim=-1)
            & torch.isfinite(Vxx_new).all(dim=-1).all(dim=-1)
        )
        ok = ok & torch.where(active, step_ok, True)
        Vx = torch.where(active[:, None], Vx_new, Vx)
        Vxx = torch.where(active[:, None, None], Vxx_new, Vxx)
        kappa[:, k] = torch.where(active[:, None], kap, 0.0)
        K[:, k] = torch.where(active[:, None, None], Kk, 0.0)
    return kappa, K, ok


def backward_inputs(system: System, prob: Problem, X: torch.Tensor, U: torch.Tensor) -> tuple:
    """The trajectory-dependent inputs of backward_truncated_core besides
    (A, B, T*, lambda): (lx, lu, Qstage, QfeT, eT_ok, step_ok, Qf, R), all
    contiguous, with Qstage, Qf and R symmetrized."""
    e, du, lx, lu, _, Qstage = stage_expansion(system, prob, X, U)
    QfT = sym(prob.Qf)
    eTs = wrap_error(X[:, 1:] - prob.xg[:, None], prob.wrap_mask[:, None])
    QfeT = torch.einsum("bki,bji->bkj", eTs, QfT)
    eT_ok = torch.isfinite(eTs).all(dim=-1).to(X.dtype)
    step_ok = (torch.isfinite(e).all(dim=-1) & torch.isfinite(du).all(dim=-1)).to(X.dtype)
    out = (lx, lu, sym(Qstage), QfeT, eT_ok, step_ok, QfT, sym(prob.R))
    return tuple(t.contiguous() for t in out)


def backward_truncated(
    system: System,
    prob: Problem,
    A: torch.Tensor,
    B: torch.Tensor,
    X: torch.Tensor,
    U: torch.Tensor,
    T_star: torch.Tensor,
    lm_lambda: torch.Tensor,
) -> BackwardResult:
    args = (A.contiguous(), B.contiguous(), *backward_inputs(system, prob, X, U),
            T_star.to(torch.int64).contiguous(), lm_lambda.to(X.dtype).contiguous())
    with trace.phase("backward.kernel"):
        kappa, K, ok = cuda_backward.backward_truncated_core(*args)
    return BackwardResult(kappa=kappa, K=K, ok=ok)
