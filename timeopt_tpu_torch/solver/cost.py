"""Objective evaluation (port of timeopt_tpu/solver/cost.py): rollout, stage
costs, the true cost truncated at a per-problem T*, the nominal cost curve
and the argmin over T. Every function takes a leading batch axis B."""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, _nan_where
from timeopt_tpu_torch.ops import cuda_forward
from timeopt_tpu_torch.ops.wrap import wrap_error
from timeopt_tpu_torch.utils import trace


def rollout(system: System, prob: Problem, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """x0 (B, n), U (B, N, m) -> X (B, N+1, n) through `safe_step`: once a
    state goes non-finite or exceeds the norm guard, every later state is NaN.
    A float32 rollout integrates in float64 and stores each state rounded to
    float32, the rounding never fed back (the counterpart of the JAX
    package's df32 rollout_df)."""
    if x0.dtype == torch.float32:
        return rollout(system, prob, x0.to(torch.float64), U.to(torch.float64)).to(x0.dtype)
    xs = [x0]
    for k in range(U.shape[1]):
        xs.append(system.safe_step(xs[-1], U[:, k]))
    return torch.stack(xs, dim=1)


def rollout_kernel(system: System, prob: Problem, x0: torch.Tensor, U: torch.Tensor,
                   max_state_norm: float = 1e6) -> torch.Tensor:
    """rollout() as one launch of the line-search kernel (#5,
    ops/cuda_forward.py; its plain version off the card): one alpha from
    x0 at T* = 0, where every control keeps U_k and the gains, reference
    rows and cost go unused. The kernel takes the raw step, so safe_step's
    poisoning follows on the stored states: from the first non-finite
    state or one of norm above max_state_norm on, every state is NaN (the
    norm of a float32 state is taken of its rounding)."""
    Bsz, N, m = U.shape
    z = dict(dtype=U.dtype, device=U.device)
    X = torch.zeros((Bsz, N + 1, system.n), **z)
    K = torch.zeros((Bsz, N, m, system.n), **z)
    kappa = torch.zeros((Bsz, N, m), **z)
    T0 = torch.zeros(Bsz, dtype=torch.int64, device=U.device)
    Xs, _, _ = cuda_forward.linesearch(system, prob, X, U, K, kappa, T0, (0.0,), x_start=x0)
    X, nxt = Xs[:, 0], Xs[:, 0, 1:]
    bad = (~torch.isfinite(nxt).all(dim=-1)) | (torch.linalg.vector_norm(nxt.double(), dim=-1) > max_state_norm)
    bad = bad.to(torch.int32).cumsum(dim=1) > 0
    return torch.cat([X[:, :1], nxt + _nan_where(bad[..., None], nxt)], dim=1)


def initial_rollout(system: System, prob: Problem, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """The curve methods' initial rollout: rollout_kernel where the system
    asks for it (`System.kernel_rollout`), else rollout."""
    return (rollout_kernel if system.kernel_rollout else rollout)(system, prob, x0, U)


def extra_cost_terms(system: System, X: torch.Tensor, U: torch.Tensor):
    """Per-step (c, cx, cxx) of the optional extra stage cost, or None if
    the system has none. X (B, N, n) are the steps' states, U (B, N, m).
    The scalar cost's exact gradient and Hessian come from torch.func,
    vmapped over all B*N steps: c (B, N), cx (B, N, n), cxx (B, N, n, n).
    A traced program stamps it as the phase `extra_cost` (utils/trace.py)."""
    if system.extra_cost is None:
        return None
    fn = system.extra_cost
    Bsz, N, n = X.shape
    with trace.phase("extra_cost"):
        x, u = X.reshape(Bsz * N, n), U.reshape(Bsz * N, -1)
        c = fn(x, u)
        cx = torch.func.vmap(torch.func.grad(fn, argnums=0))(x, u)
        cxx = torch.func.vmap(torch.func.hessian(fn, argnums=0))(x, u)
        return c.reshape(Bsz, N), cx.reshape(Bsz, N, n), cxx.reshape(Bsz, N, n, n)


def _quad(e: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """e' M e for e (B, K, d), M (B, d, d) -> (B, K)."""
    return torch.einsum("bki,bij,bkj->bk", e, M, e)


def stage_costs(system: System, prob: Problem, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """l_k = 0.5 e_k'Q e_k + 0.5 du_k'R du_k + w (+ extra), k = 0..N-1 -> (B, N)."""
    e = wrap_error(X[:, :-1] - prob.xg[:, None], prob.wrap_mask[:, None])
    du = U - prob.u_ref[:, None]
    l = 0.5 * _quad(e, prob.Q) + 0.5 * _quad(du, prob.R) + prob.w[:, None]
    if system.extra_cost is not None:
        l = l + system.extra_cost(X[:, :-1], U)
    return l


def terminal_cost(prob: Problem, xT: torch.Tensor) -> torch.Tensor:
    """0.5 eT' Qf eT for xT (B, n) -> (B,)."""
    eT = wrap_error(xT - prob.xg, prob.wrap_mask)
    return 0.5 * torch.einsum("bi,bij,bj->b", eT, prob.Qf, eT)


def cost_true(
    system: System, prob: Problem, X: torch.Tensor, U: torch.Tensor, T_star: torch.Tensor
) -> torch.Tensor:
    """Exact objective truncated at T* (B,): stage costs for k < T* plus the
    terminal cost at X[T*]. A non-finite state in rows <= T*, a non-finite
    control in the active window, T* == 0 or a non-finite total give +inf."""
    N = prob.N
    T = T_star.to(torch.int64)
    active = torch.arange(N, device=X.device)[None] < T[:, None]
    l = stage_costs(system, prob, X, U)
    masked = torch.where(active, l, torch.zeros_like(l))
    idx = T.clamp(0, N)
    xT = X[torch.arange(X.shape[0], device=X.device), idx]
    total = masked.sum(dim=1) + terminal_cost(prob, xT)

    rows = torch.arange(N + 1, device=X.device)[None] <= T[:, None]
    x_ok = torch.where(rows, torch.isfinite(X).all(dim=-1), True).all(dim=1)
    u_ok = torch.where(active, torch.isfinite(U).all(dim=-1), True).all(dim=1)
    ok = x_ok & u_ok & (T > 0) & torch.isfinite(total)
    return torch.where(ok, total, torch.full_like(total, float("inf")))


def nominal_cost_curve(system: System, prob: Problem, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """J_nom(T) for T = 1..T_max of the current nominal (B, T_max): the
    running sum of stage costs plus the terminal cost at X[T]; +inf below
    T_min, where J is not finite, and on every T of a problem whose X[:T_max+1]
    or U[:T_max] is not finite. Seeds the one-pass method's T-bar."""
    T_max = prob.T_max
    run = torch.cumsum(stage_costs(system, prob, X, U)[:, :T_max], dim=1)
    eT = wrap_error(X[:, 1 : T_max + 1] - prob.xg[:, None], prob.wrap_mask[:, None])
    J = run + 0.5 * _quad(eT, prob.Qf)
    Ts = torch.arange(1, T_max + 1, device=X.device)[None]
    ok = torch.isfinite(X[:, : T_max + 1]).flatten(1).all(dim=1) & torch.isfinite(U[:, :T_max]).flatten(1).all(dim=1)
    return torch.where((Ts >= prob.T_min) & ok[:, None] & torch.isfinite(J), J, torch.full_like(J, float("inf")))


def argmin_T(J_curve: torch.Tensor, T_min: int, T_max: int) -> torch.Tensor:
    """T* = argmin over T in [T_min, T_max] of J(T), the first minimum,
    for J_curve (B, >= T_max) -> (B,) int64."""
    return torch.argmin(J_curve[:, T_min - 1 : T_max], dim=1) + T_min
