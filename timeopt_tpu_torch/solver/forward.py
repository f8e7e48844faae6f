"""Forward pass with line search over all step sizes at once (port of
timeopt_tpu/solver/forward.py). Every alpha rolls out; the first alpha in
the given order whose cost improves on J_old is taken. The rollouts go
through the phase's one dispatch point, ops/cuda_forward.py::linesearch."""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops import cuda_forward
from timeopt_tpu_torch.ops.wrap import wrap_error
from timeopt_tpu_torch.solver.cost import cost_true
from timeopt_tpu_torch.utils import trace


class LinesearchResult(NamedTuple):
    X: torch.Tensor  # (B, N+1, n)
    U: torch.Tensor  # (B, N, m)
    J: torch.Tensor  # (B,)
    accepted: torch.Tensor  # (B,) bool


def rollout_with_gains(system, prob, X, U, K, kappa, T_star, alpha: float, x_start=None):
    """Roll x+ = step(x, U_k + [k<T*](K_k wrap(x - X_k) + alpha kappa_k)) with
    the raw step from x_start (B, n), by default X[:, 0]; controls keep
    their nominal values from T* on."""
    T = T_star.to(torch.int64)
    x = X[:, 0] if x_start is None else x_start
    xs, us = [x], []
    for k in range(U.shape[1]):
        dx = wrap_error(x - X[:, k], prob.wrap_mask)
        du = (K[:, k] @ dx[..., None])[..., 0] + alpha * kappa[:, k]
        u = U[:, k] + torch.where((k < T)[:, None], du, 0.0)
        x = system.step(x, u)
        xs.append(x)
        us.append(u)
    return torch.stack(xs, dim=1), torch.stack(us, dim=1)


def linesearch_plain(system, prob, X, U, K, kappa, T_star, alphas, x_start=None):
    """Per-alpha rollouts and costs: Xs (B, A, N+1, n), Us (B, A, N, m),
    Js (B, A); an alpha whose rollout is non-finite anywhere on [0, N]
    costs +inf. Each rollout starts at x_start (default X[:, 0])."""
    Xs, Us, Js = [], [], []
    for a in alphas:
        Xn, Un = rollout_with_gains(system, prob, X, U, K, kappa, T_star, float(a), x_start)
        Jn = cost_true(system, prob, Xn, Un, T_star)
        finite = torch.isfinite(Xn).all(dim=-1).all(dim=-1)
        Xs.append(Xn)
        Us.append(Un)
        Js.append(torch.where(finite, Jn, float("inf")))
    return torch.stack(Xs, dim=1), torch.stack(Us, dim=1), torch.stack(Js, dim=1)


def select_first_improving(X, U, Xs, Us, Js, J_old) -> LinesearchResult:
    """Take the first alpha with J < J_old, else keep the nominal. Picks by
    index and `torch.where`, never by a one-hot multiply, which would leak
    the NaNs of rejected rollouts."""
    improved = Js < J_old[:, None]
    accepted = improved.any(dim=1)
    idx = torch.argmax(improved.to(torch.int32), dim=1)  # first True
    rows = torch.arange(X.shape[0], device=X.device)
    Xn = torch.where(accepted[:, None, None], Xs[rows, idx], X)
    Un = torch.where(accepted[:, None, None], Us[rows, idx], U)
    Jn = torch.where(accepted, Js[rows, idx], J_old)
    return LinesearchResult(X=Xn, U=Un, J=Jn, accepted=accepted)


def forward_linesearch(
    system: System,
    prob: Problem,
    X: torch.Tensor,
    U: torch.Tensor,
    K: torch.Tensor,
    kappa: torch.Tensor,
    T_star: torch.Tensor,
    alphas=(1.0, 0.5, 0.25, 0.1, 0.05),
) -> LinesearchResult:
    J_old = cost_true(system, prob, X, U, T_star)
    with trace.phase("forward.kernel"):
        Xs, Us, Js = cuda_forward.linesearch(system, prob, X, U, K, kappa, T_star, alphas)
    return select_first_improving(X, U, Xs, Us, Js, J_old)
