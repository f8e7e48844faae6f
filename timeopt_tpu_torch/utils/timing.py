"""Phase timers (port of timeopt_tpu/utils/timing.py): the reference's
four-phase wall-clock breakdown {linearize, select, backward, forward}.

`solve_batch` runs its phases back to back with no host wait between them,
so these profilers re-run one solve as a host-driven loop of the same
phases, each bracketed by a device synchronize on a CUDA problem (plain
`time.perf_counter` on the CPU), with the reference's host branches on the
backward pass's `ok` and the line search's acceptance. They take a
batch-of-1 Problem (the host branches read one problem's flags) and give
the solve's result beside the timers; use `solve_batch` for throughput.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver.backward import backward_truncated
from timeopt_tpu_torch.solver.cost import argmin_T, nominal_cost_curve, rollout
from timeopt_tpu_torch.solver.forward import forward_linesearch
from timeopt_tpu_torch.solver.ilqr import SolveOptions, _select_curve, default_U_init
from timeopt_tpu_torch.solver.linearize import linearize
from timeopt_tpu_torch.solver.onepass import extend_nominal_backward, onepass_pick, onepass_rollout, value_sweep_prefix

PHASES = ("linearize", "select", "backward", "forward")


class _Timers(dict):
    """Seconds per phase; `timed` runs one phase between device syncs."""

    def __init__(self, device: torch.device):
        super().__init__({k: 0.0 for k in PHASES})
        self.device = device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def timed(self, key: str, fn, *a, **kw):
        self.sync()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        self.sync()
        self[key] += time.perf_counter() - t0
        return out


def _start(prob: Problem, U_init):
    if prob.batch != 1:
        raise ValueError(f"the phase profilers take a batch-of-1 Problem, got batch {prob.batch}")
    U = default_U_init(prob) if U_init is None else U_init.to(prob.x0).reshape(1, prob.N, prob.m)
    return U, _Timers(prob.x0.device)


def _converged(J_hist: list, T_hist: list, rel_tol: float) -> bool:
    if len(J_hist) < 2:
        return False
    rel = abs(J_hist[-1] - J_hist[-2]) / (abs(J_hist[-2]) + 1e-12)
    return rel < rel_tol and len(T_hist) >= 3 and len(set(T_hist[-3:])) == 1


def profile_solve(system: System, prob: Problem, options: Optional[SolveOptions] = None, U_init=None):
    """A propagator or brute-force solve, phase by phase. Returns (result,
    timers): result holds X, U, J_hist and T_hist (lists of the accepted
    costs and horizons), J_curve and T_star; timers the seconds of each of
    PHASES."""
    opts = options or SolveOptions()
    if opts.method not in ("propagator", "bruteforce"):
        raise ValueError(f"profile_solve takes the propagator or the brute force, not {opts.method!r}")
    opts.check()
    U, timers = _start(prob, U_init)

    def select(X, U, A, B):
        J = _select_curve(system, prob, opts, X, U, A, B)
        return J, argmin_T(J, prob.T_min, prob.T_max)

    X = rollout(system, prob, prob.x0, U)
    timers.sync()
    A, B = timers.timed("linearize", linearize, system.step, X, U, opts.linearize_mode)
    J_curve, T_bar = timers.timed("select", select, X, U, A, B)
    lm = torch.full((1,), opts.lm_init, dtype=X.dtype, device=X.device)
    res_bw = timers.timed("backward", backward_truncated, system, prob, A, B, X, U, T_bar, lm)
    J_hist, T_hist = [], []
    if bool(res_bw.ok):
        ls = timers.timed("forward", forward_linesearch, system, prob, X, U, res_bw.K, res_bw.kappa, T_bar,
                          opts.alphas)
        X, U = ls.X, ls.U
        if bool(torch.isfinite(ls.J)):
            J_hist.append(float(ls.J))
            T_hist.append(int(T_bar))

    for _ in range(opts.max_iter):
        A, B = timers.timed("linearize", linearize, system.step, X, U, opts.linearize_mode)
        J_curve, T_star = timers.timed("select", select, X, U, A, B)
        res_bw = timers.timed("backward", backward_truncated, system, prob, A, B, X, U, T_star, lm)
        acc = False
        if bool(res_bw.ok):
            ls = timers.timed("forward", forward_linesearch, system, prob, X, U, res_bw.K, res_bw.kappa, T_star,
                              opts.alphas)
            acc = bool(ls.accepted) and bool(torch.isfinite(ls.J))
        if acc:
            X, U, T_bar = ls.X, ls.U, T_star
            J_hist.append(float(ls.J))
            T_hist.append(int(T_star))
            lm = torch.clamp(lm / 10.0, min=1e-12)
        else:
            lm = lm * 10.0
        if _converged(J_hist, T_hist, opts.rel_tol):
            break

    t = dict(timers)
    T_out = T_hist[-1] if T_hist else int(T_bar)
    return dict(X=X, U=U, J_hist=J_hist, T_hist=T_hist, J_curve=J_curve, T_star=T_out, timers=t), t


def profile_solve_onepass(system: System, prob: Problem, options: Optional[SolveOptions] = None, U_init=None):
    """A one-pass solve, phase by phase, with the reference's attribution:
    the prefix linearization counts as linearize; the prefix, the sweep and
    the pick as select; the shifted-gain rollout (and the fallback's line
    search) as forward; the fallback's backward pass as backward. One window
    (half-width max(1, S)) an iteration, no shrinks: a profiling view, not
    `solve_batch`'s loop. Returns (result, timers) as profile_solve."""
    opts = options or SolveOptions(method="onepass")
    if opts.method != "onepass":
        raise ValueError(f"profile_solve_onepass takes the one-pass method, not {opts.method!r}")
    opts.check()
    U, timers = _start(prob, U_init)
    S = int(opts.S_window)
    prefix_mode = "ad" if opts.linearize_mode == "ad" else "forward"
    alphas4 = opts.alphas[: min(4, len(opts.alphas))]

    X = rollout(system, prob, prob.x0, U)
    T_bar = argmin_T(nominal_cost_curve(system, prob, X, U), prob.T_min, prob.T_max)
    timers.sync()

    # warm-start fixed-T-bar update
    A, B = timers.timed("linearize", linearize, system.step, X, U, opts.linearize_mode)
    lm = torch.full((1,), opts.lm_init, dtype=X.dtype, device=X.device)
    res_bw = timers.timed("backward", backward_truncated, system, prob, A, B, X, U, T_bar, lm)
    J_hist, T_hist = [], []
    if bool(res_bw.ok):
        ls = timers.timed("forward", forward_linesearch, system, prob, X, U, res_bw.K, res_bw.kappa, T_bar,
                          opts.alphas)
        X, U = ls.X, ls.U
        if bool(torch.isfinite(ls.J)):
            J_hist.append(float(ls.J))
            T_hist.append(int(T_bar))

    for _ in range(opts.max_iter):
        A, B = timers.timed("linearize", linearize, system.step, X, U, opts.linearize_mode)
        X_ext, U_ext = timers.timed("select", extend_nominal_backward, system, X, U, U[:, 0], S,
                                    method=opts.onepass_preimage, n_iter=opts.preimage_iters)
        if S > 0:
            A_pre, B_pre = timers.timed("linearize", linearize, system.step, X_ext[:, : S + 1], U_ext[:, :S],
                                        prefix_mode)
            A_ext, B_ext = torch.cat([A_pre, A], dim=1), torch.cat([B_pre, B], dim=1)
        else:
            A_ext, B_ext = A, B
        sweep = timers.timed("select", value_sweep_prefix, system, prob, A_ext, B_ext, X_ext, U_ext, T_bar, S, lm)
        T_star, _ = timers.timed("select", onepass_pick, prob, sweep, X_ext, X_ext[:, S], T_bar, S, max(1, S),
                                 max(1, S))

        acc = False
        if bool(sweep.ok):
            Xc, Uc, Jc, okroll = timers.timed("forward", onepass_rollout, system, prob, X_ext, U_ext, sweep, T_bar,
                                              T_star, S, alphas=alphas4)
            J_prev = J_hist[-1] if J_hist else float("inf")
            acc = bool(okroll) and float(Jc) < J_prev
            if acc:
                X, U, Jn = Xc, Uc, float(Jc)
        else:
            # numerical-failure fallback: the fixed-T-bar update
            res_bw = timers.timed("backward", backward_truncated, system, prob, A, B, X, U, T_bar, lm)
            if bool(res_bw.ok):
                ls = timers.timed("forward", forward_linesearch, system, prob, X, U, res_bw.K, res_bw.kappa, T_bar,
                                  opts.alphas)
                acc = bool(ls.accepted) and bool(torch.isfinite(ls.J))
                if acc:
                    X, U, Jn = ls.X, ls.U, float(ls.J)
                    T_star = T_bar
        if acc:
            T_bar = T_star
            J_hist.append(Jn)
            T_hist.append(int(T_star))
            lm = torch.clamp(lm / 10.0, min=1e-12)
        else:
            lm = lm * 10.0
        if _converged(J_hist, T_hist, opts.rel_tol):
            break

    t = dict(timers)
    T_out = T_hist[-1] if T_hist else int(T_bar)
    return dict(X=X, U=U, J_hist=J_hist, T_hist=T_hist, T_star=T_out, timers=t), t


@full_matmul_precision
def profile_any(system: System, prob: Problem, options: SolveOptions, U_init=None):
    """The phase profiler of options.method."""
    if options.method == "onepass":
        return profile_solve_onepass(system, prob, options, U_init)
    return profile_solve(system, prob, options, U_init)
