"""Outer time-optimal iLQR loop, batched (port of timeopt_tpu/solver/ilqr.py):
the curve methods (the propagator and the brute force) here, the one-pass
method in solver/onepass.py, both behind `solve_batch`.

The curve methods' loop runs the warm start as masked iteration 0 and then up to max_iter
accept/reject iterations: Levenberg-Marquardt lambda /10 (floor 1e-12) on
accept and x10 on reject, convergence when the relative cost change is below
rel_tol and the last three accepted horizons agree. A converged problem
freezes all its state; with early_exit the loop stops once every problem of
the batch is done, which changes no result. The loop is two bodies over
fixed state buffers (`loop_state`): init (`curve_init`: the initial rollout
and the warm start) and step (`curve_step`: one iteration), driven by
solver/compiled.py: eagerly (one host check of the early exit an
iteration), or on the card as one launch of a CUDA graph that holds both
captured bodies and decides the early exit on the device.

Problems solve in their own dtype, float64 or float32. A float32 solve
stores its trajectories, linearizations, select inputs, gains and results
in float32, as the JAX package's f32 path does, and runs every recursion
(select, backward pass, rollouts, brute force, one-pass sweep) in float64,
rounding each result to float32 once, where the JAX package runs df32 on
the TPU. No float32 product runs in TF32 (ops/precision.py).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from timeopt_tpu_torch.models.base import PROBLEM_FIELDS, Problem, System
from timeopt_tpu_torch.ops import _build
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver.augmented import (
    build_augmented,
    build_fused_inputs,
    build_terminal_blocks,
    build_terminal_factors,
)
from timeopt_tpu_torch.solver.backward import backward_truncated
from timeopt_tpu_torch.solver.cost import argmin_T, initial_rollout
from timeopt_tpu_torch.solver.forward import forward_linesearch
from timeopt_tpu_torch.solver.horizon import (
    bruteforce_J_curve,
    propagator_select,
    propagator_select_fused,
    propagator_select_generic,
)
from timeopt_tpu_torch.solver.linearize import linearize
from timeopt_tpu_torch.solver.select_assoc import propagator_select_assoc
from timeopt_tpu_torch.utils import trace

SCAN_MODES = ("sequential", "associative", "assoc_df")


@dataclasses.dataclass(frozen=True)
class SolveOptions:
    """Solver configuration; the defaults are those of the JAX package.
    Ported: the propagator (factored or reference-parity inverse terminal
    query), the brute-force method and the one-pass method (window
    S_window, prefix preimages by onepass_preimage; it ignores
    terminal_mode), with AD or finite-difference linearization. The
    propagator's prefix scan (scan_mode): "sequential" (the select kernels),
    "associative" (the tree of lax.associative_scan, plain torch, then the
    query) or "assoc_df" (latency mode, solver/select_assoc.py; factored
    query only); the other methods ignore scan_mode.

    Two options act on float32 problems only. df_forward is kept for the
    JAX package's API: "auto" and "on" both name what the port always does,
    every float32 rollout carrying its state in float64 and storing its
    float32 rounding; "off" (the JAX package's plain float32 rollouts, a
    diagnostic of a chip without float64) is not ported and raises
    ValueError. select_dtype, with the JAX semantics
    (None: the problem's dtype; "float64" or "float32"), casts the select's
    inputs to that dtype and its curve back."""

    method: str = "propagator"  # "propagator" | "bruteforce" | "onepass"
    max_iter: int = 15
    lm_init: float = 1e-3
    S_window: int = 20
    linearize_mode: str = "ad"  # "ad" | "central" | "forward"
    alphas: tuple = (1.0, 0.5, 0.25, 0.1, 0.05)
    scan_mode: str = "sequential"  # "sequential" | "associative" | "assoc_df"
    terminal_mode: str = "factored"  # "factored" | "inverse"
    psd_levels: int = 2
    q_reg: Optional[float] = None  # None: 1e-9 in float64, 1e-5 otherwise
    rho_reg: float = 1e-12
    homogeneous_scaling: bool = True  # balance the augmented blocks (False: s = 1)
    rel_tol: float = 1e-4
    early_exit: bool = True
    onepass_preimage: str = "fixedpoint"  # "fixedpoint" | "newton" | "copy"
    preimage_iters: int = 4  # fixed-point preimage iterations (onepass.fixedpoint_preimage_step)
    df_forward: str = "auto"  # "auto" | "on": float64-carried rollouts of float32 problems
    select_dtype: Optional[str] = None  # None | "float64" | "float32": the select's dtype

    def check(self) -> None:
        if self.method not in ("propagator", "bruteforce", "onepass"):
            raise ValueError(f"unknown method {self.method!r}")
        if self.onepass_preimage not in ("fixedpoint", "newton", "copy"):
            raise ValueError(f"unknown onepass_preimage {self.onepass_preimage!r}")
        if self.scan_mode not in SCAN_MODES:
            raise ValueError(f"unknown scan_mode {self.scan_mode!r}")
        if self.terminal_mode not in ("factored", "inverse"):
            raise ValueError(f"unknown terminal_mode {self.terminal_mode!r}")
        if self.method == "propagator" and self.scan_mode == "assoc_df" and self.terminal_mode != "factored":
            raise ValueError("scan_mode='assoc_df' requires terminal_mode='factored'")
        if self.linearize_mode not in ("ad", "central", "forward"):
            raise ValueError(f"unknown linearize_mode {self.linearize_mode!r}")
        if self.df_forward == "off":
            raise ValueError("df_forward='off' (plain float32 rollouts) is not ported: float32 rollouts "
                             "always carry their state in float64")
        if self.df_forward not in ("auto", "on"):
            raise ValueError(f"unknown df_forward {self.df_forward!r}")
        if self.select_dtype not in (None, "float64", "float32"):
            raise ValueError(f"unknown select_dtype {self.select_dtype!r}")


@dataclasses.dataclass
class SolveResult:
    X: torch.Tensor  # (B, N+1, n) final nominal trajectory
    U: torch.Tensor  # (B, N, m) final controls
    T_star: torch.Tensor  # (B,) int64 selected horizon
    J_star: torch.Tensor  # (B,) final accepted cost (inf if never accepted)
    J_curve: torch.Tensor  # (B, T_max) last selection curve
    J_hist: torch.Tensor  # (B, max_iter+1) accepted costs, NaN-padded
    T_hist: torch.Tensor  # (B, max_iter+1) accepted horizons, -1-padded
    n_accept: torch.Tensor  # (B,) number of accepted updates
    lm_final: torch.Tensor  # (B,) final LM lambda
    n_fallback: torch.Tensor  # (B,) int64 one-pass iterations that took the fixed-T-bar fallback; 0 for the curve methods
    T_ties: torch.Tensor  # (B, T_max) bool: horizons flat-tied with T*


def flat_tie_set(J_curve: torch.Tensor, T_star: torch.Tensor, T_min: int, w: torch.Tensor) -> torch.Tensor:
    """(B, T_max) bool: |J(t) - J(T*)| <= w (|t - T*| + 1) for t >= T_min
    with finite curve entries (entry t-1 holds horizon t)."""
    Bsz, T_max = J_curve.shape
    t = torch.arange(1, T_max + 1, device=J_curve.device)[None]
    J_at = J_curve[torch.arange(Bsz, device=J_curve.device), T_star - 1][:, None]
    dT = (t - T_star[:, None]).abs().to(J_curve.dtype)
    fin = torch.isfinite(J_curve) & torch.isfinite(J_at)
    return (t >= T_min) & fin & ((J_curve - J_at).abs() <= w[:, None] * (dT + 1.0))


def resolve_q_reg(opts: SolveOptions, dtype: torch.dtype) -> float:
    """1e-9 in true float64 (the CPU and the H100 both have it), else 1e-5."""
    if opts.q_reg is not None:
        return opts.q_reg
    return 1e-9 if dtype == torch.float64 else 1e-5


def select_inputs(system, prob, opts, X, U, A, B):
    """(generic, args, s): the contiguous inputs of the select for
    T = 1..T_max and the homogeneous scales s (B, T_max+1). A stationary
    stage cost takes the fused select (args: the FusedInputs A, B, vecs,
    scal, Qq, R_inv, Lt); an extra stage cost makes Q_aug step-dependent and
    takes the generic select (generic=True; args: A_aug, B_aug, Q_aug,
    R_inv, C)."""
    Tm = prob.T_max
    Xh, Uh, Ah, Bh = X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], B[:, :Tm]
    q_reg = resolve_q_reg(opts, X.dtype)
    if system.extra_cost is None:
        fi = build_fused_inputs(system, prob, Xh, Uh, Ah, Bh, q_reg=q_reg, rho_reg=opts.rho_reg,
                                psd_levels=opts.psd_levels, scale=opts.homogeneous_scaling)
        args = (fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)
        return False, [t.contiguous() for t in args], fi.s
    blk = build_augmented(system, prob, Xh, Uh, Ah, Bh, q_reg=q_reg, rho_reg=opts.rho_reg, psd_levels=opts.psd_levels,
                          scale=opts.homogeneous_scaling)
    C = build_terminal_factors(prob, Xh, s=blk.s, rho_reg=opts.rho_reg)
    args = (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C)
    return True, [t.contiguous() for t in args], blk.s


def _select_curve(system, prob, opts, X, U, A, B) -> torch.Tensor:
    """J(T) for T = 1..T_max: the brute-force curve, or the propagator's,
    scaled by s_0^2: through the fused or the generic select (sequential
    scan, factored query), else on the assembled blocks through the unfused
    select (the inverse query or the associative scan) or the latency-mode
    select (assoc_df). With select_dtype the inputs are cast to that dtype
    and the curve back to X's."""
    sd = getattr(torch, opts.select_dtype) if opts.select_dtype else X.dtype
    if sd != X.dtype:
        inner = dataclasses.replace(opts, select_dtype=None)
        prob_sd, X_sd, U_sd, A_sd, B_sd = (_build.cast(t, sd) for t in (prob, X, U, A, B))
        return _select_curve(system, prob_sd, inner, X_sd, U_sd, A_sd, B_sd).to(X.dtype)
    Tm = prob.T_max
    Xh, Uh, Ah, Bh = X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], B[:, :Tm]
    if opts.method == "bruteforce":
        return bruteforce_J_curve(system, prob, Ah, Bh, Xh, Uh, psd_levels=opts.psd_levels)
    if opts.scan_mode == "sequential" and opts.terminal_mode == "factored":
        with trace.phase("select.inputs"):
            generic, args, s = select_inputs(system, prob, opts, X, U, A, B)
        select = propagator_select_generic if generic else propagator_select_fused
        j_scale = s[:, :1] ** 2
        with trace.phase("select.kernel"):
            J = select(*args, prob.T_min)
        return j_scale * J
    blk = build_augmented(system, prob, Xh, Uh, Ah, Bh, q_reg=resolve_q_reg(opts, X.dtype), rho_reg=opts.rho_reg,
                          psd_levels=opts.psd_levels, scale=opts.homogeneous_scaling)
    if opts.terminal_mode == "factored":
        terminal = build_terminal_factors(prob, Xh, s=blk.s, rho_reg=opts.rho_reg)
    else:
        terminal = build_terminal_blocks(prob, Xh, rho_reg=opts.rho_reg, s=blk.s)
    j_scale = blk.s[:, :1] ** 2
    if opts.scan_mode == "assoc_df":
        return j_scale * propagator_select_assoc(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, terminal, prob.T_min)
    return j_scale * propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, terminal,
                                       psd_levels=opts.psd_levels, terminal_mode=opts.terminal_mode,
                                       scan_mode=opts.scan_mode)


# ============================================================================
# The loop: state buffers and the curve methods' bodies
# ============================================================================


def loop_state(prob: Problem, opts: SolveOptions, dtype: torch.dtype, device, onepass: bool = False) -> dict:
    """The outer loop's state, one buffer a field (the JAX package's
    _LoopState), each written in place by the init and step bodies and
    never reallocated: X (B, N+1, n), U (B, N, m), lm, J_last, J_prev (B,),
    T_bar, n_acc (B,) int64, T3 (B, 3) int64 (the last three accepted
    horizons), J_curve (B, T_max), J_hist, T_hist (B, max_iter+1), done
    (B,) bool, and for the one-pass method n_fb (B,) int64."""
    Bsz, hist = prob.batch, opts.max_iter + 1
    f = dict(dtype=dtype, device=device)
    i = dict(dtype=torch.int64, device=device)
    st = dict(
        X=torch.empty((Bsz, prob.N + 1, prob.n), **f),
        U=torch.empty((Bsz, prob.N, prob.m), **f),
        lm=torch.empty(Bsz, **f),
        T_bar=torch.empty(Bsz, **i),
        J_last=torch.empty(Bsz, **f),
        J_prev=torch.empty(Bsz, **f),
        n_acc=torch.empty(Bsz, **i),
        T3=torch.empty((Bsz, 3), **i),
        J_curve=torch.empty((Bsz, prob.T_max), **f),
        J_hist=torch.empty((Bsz, hist), **f),
        T_hist=torch.empty((Bsz, hist), **i),
        done=torch.empty(Bsz, dtype=torch.bool, device=device),
    )
    if onepass:
        st["n_fb"] = torch.empty(Bsz, **i)
    return st


def T3_sentinel(device) -> torch.Tensor:
    """(3,) int64: the initial last-three-horizons, distinct so that no
    problem converges before three accepts."""
    return _build.constant((-1, -2, -3), torch.int64, device)


def commit(st: dict, new: dict, conv: torch.Tensor) -> None:
    """Write an iteration's values `new` into the state buffers, keeping a
    converged problem's state frozen, then mark the problems that
    converged (`conv`) done."""
    done = st["done"]
    for key, v in new.items():
        d = done.view((done.shape[0],) + (1,) * (v.dim() - 1))
        st[key].copy_(torch.where(d, st[key], v))
    done.logical_or_(conv)


def converged(new: dict, rel_tol: float) -> torch.Tensor:
    """(B,) bool: at least three accepts, relative cost change below
    rel_tol, and the last three accepted horizons equal."""
    rel = (new["J_last"] - new["J_prev"]).abs() / (new["J_prev"].abs() + 1e-12)
    return (new["n_acc"] >= 3) & (rel < rel_tol) & (new["T3"] == new["T3"][:, 2:3]).all(dim=1)


def curve_init(system: System, opts: SolveOptions, prob: Problem, U_init: torch.Tensor, st: dict) -> None:
    """The curve methods' init body: the initial rollout of U_init, the
    state's initial values, then the warm start as iteration 0."""
    with trace.phase("init.rollout"):
        st["X"].copy_(initial_rollout(system, prob, prob.x0, U_init))
    st["U"].copy_(U_init)
    st["lm"].fill_(opts.lm_init)
    st["T_bar"].zero_()
    st["J_last"].fill_(float("inf"))
    st["J_prev"].fill_(float("inf"))
    st["n_acc"].zero_()
    st["T3"].copy_(T3_sentinel(st["T3"].device))
    st["J_curve"].zero_()
    st["J_hist"].fill_(float("nan"))
    st["T_hist"].fill_(-1)
    st["done"].zero_()
    with trace.phase("init.warm", pending=st["done"]):
        curve_step(system, opts, prob, st, warm=True)


def curve_step(system: System, opts: SolveOptions, prob: Problem, st: dict, warm: bool = False) -> None:
    """The curve methods' step body, one outer iteration in place:
    linearize, select J(T) and T*, the backward pass at T*, the line
    search, the Levenberg-Marquardt accept/reject and the convergence
    test. The warm start (iteration 0) records whenever the backward pass
    is healthy and the line-search cost finite, and keeps lambda. Its
    phases (utils/trace.py) are stamped in a traced program."""
    Bsz = prob.batch
    rows = torch.arange(Bsz, device=st["X"].device)
    i64 = torch.int64
    with trace.phase("linearize"):
        A, B = linearize(system.step, st["X"], st["U"], opts.linearize_mode)
    with trace.phase("select"):
        J_curve = _select_curve(system, prob, opts, st["X"], st["U"], A, B)
        T_star = argmin_T(J_curve, prob.T_min, prob.T_max)
    with trace.phase("backward"):
        bw = backward_truncated(system, prob, A, B, st["X"], st["U"], T_star, st["lm"])
    with trace.phase("forward"):
        ls = forward_linesearch(system, prob, st["X"], st["U"], bw.K, bw.kappa, T_star, alphas=opts.alphas)
    with trace.phase("commit"):
        fin = torch.isfinite(ls.J)
        acc = bw.ok & ls.accepted & fin
        gate = (bw.ok & fin) if warm else acc

        g1 = gate[:, None]
        new = dict(
            X=torch.where(gate[:, None, None], ls.X, st["X"]),
            U=torch.where(gate[:, None, None], ls.U, st["U"]),
            lm=st["lm"] if warm else torch.where(acc, torch.clamp(st["lm"] / 10.0, min=1e-12), st["lm"] * 10.0),
            T_bar=T_star if warm else torch.where(acc, T_star, st["T_bar"]),
            J_last=torch.where(gate, ls.J, st["J_last"]),
            J_prev=torch.where(gate, st["J_last"], st["J_prev"]),
            n_acc=st["n_acc"] + gate.to(i64),
            T3=torch.where(g1, torch.cat([st["T3"][:, 1:], T_star[:, None]], dim=1), st["T3"]),
            J_curve=J_curve,
            J_hist=st["J_hist"].clone(),
            T_hist=st["T_hist"].clone(),
        )
        slot = st["n_acc"]
        new["J_hist"][rows, slot] = torch.where(gate, ls.J, st["J_hist"][rows, slot])
        new["T_hist"][rows, slot] = torch.where(gate, T_star, st["T_hist"][rows, slot])
        commit(st, new, converged(new, opts.rel_tol))


def loop_result(prob: Problem, st: dict) -> SolveResult:
    """The SolveResult of a finished loop's state (its buffers, not
    copies): T* the last accepted horizon, T-bar where none was accepted."""
    T_star = torch.where(st["n_acc"] > 0, st["T3"][:, 2], st["T_bar"])
    return SolveResult(
        X=st["X"],
        U=st["U"],
        T_star=T_star,
        J_star=st["J_last"],
        J_curve=st["J_curve"],
        J_hist=st["J_hist"],
        T_hist=st["T_hist"],
        n_accept=st["n_acc"],
        lm_final=st["lm"],
        n_fallback=st["n_fb"] if "n_fb" in st else torch.zeros_like(st["n_acc"]),
        # the one-pass curve is NaN outside its window, so those horizons drop out
        T_ties=flat_tie_set(st["J_curve"], T_star, prob.T_min, prob.w),
    )


def default_U_init(prob: Problem) -> torch.Tensor:
    """Nominal initial controls: u_ref tiled over the horizon, (B, N, m)."""
    return prob.u_ref[:, None].expand(-1, prob.N, -1).contiguous()


def _pad_U(U: torch.Tensor, N: int) -> torch.Tensor:
    """Pad (tile the last row) or truncate U_init (steps, m) to N steps."""
    if U.dim() == 1:
        U = U[:, None]
    if U.shape[0] < N:
        U = torch.cat([U, U[-1:].expand(N - U.shape[0], -1)], dim=0)
    return U[:N]


def prepare(probs: Problem, U_inits: Optional[torch.Tensor]) -> tuple:
    """(probs, U_inits) as the solve takes them: every tensor contiguous,
    U_inits (default: u_ref tiled) in the problems' dtype and device."""
    probs = probs.replace(**{f: t.contiguous() for f, t in probs.tensors().items()})
    if U_inits is None:
        U_inits = default_U_init(probs)
    return probs, U_inits.to(probs.x0).contiguous()


@full_matmul_precision
def solve_batch(
    system: System,
    probs: Problem,
    U_inits: Optional[torch.Tensor] = None,
    options: Optional[SolveOptions] = None,
) -> SolveResult:
    """Solve a batch of problems (every Problem tensor has a leading batch
    axis) by opts.method. Runs on the device of the problem's tensors, in
    their dtype (float64 or float32), with TF32 off. On the card the solve
    is one launch of a program's loop graph (captured CUDA graphs, one
    program per (system, options, shapes, dtype, device), built at its
    first call: solver/compiled.py); it reads nothing back to the host, so
    it returns before the card finishes. On the CPU it runs as the eager
    loop `compiled._solve_traced`, with the same results. While tracing is
    on (utils/trace.py) the call records `entry.call`."""
    from timeopt_tpu_torch.solver import compiled

    with trace.span("entry.call"):
        opts = options or SolveOptions()
        opts.check()
        with trace.span("entry.prepare"):
            probs, U_inits = prepare(probs, U_inits)
        if probs.x0.device.type == "cuda":
            return compiled.solve_programs(system, opts, [(probs, U_inits)])[0]
        return compiled._solve_traced(system, opts, probs, U_inits)


def solve(
    system: System,
    prob: Problem,
    U_init: Optional[torch.Tensor] = None,
    options: Optional[SolveOptions] = None,
) -> SolveResult:
    """Solve one problem (a Problem with batch 1) as a batch of one; the
    result has the batch axis removed."""
    if prob.batch != 1:
        raise ValueError(f"solve() takes a batch-of-1 Problem, got batch {prob.batch}; use solve_batch")
    U = None if U_init is None else _pad_U(torch.as_tensor(U_init, dtype=prob.x0.dtype, device=prob.x0.device), prob.N)[None]
    res = solve_batch(system, prob, U, options)
    return SolveResult(**{f.name: getattr(res, f.name)[0] for f in dataclasses.fields(res)})


def stack_problems(problems: list) -> Problem:
    """Concatenate Problems with equal N/T_min/T_max along the batch axis."""
    first = problems[0]
    for p in problems[1:]:
        if (p.N, p.T_min, p.T_max) != (first.N, first.T_min, first.T_max):
            raise ValueError("stack_problems: N, T_min and T_max must agree")
    return first.replace(
        **{f: torch.cat([getattr(p, f) for p in problems], dim=0) for f in PROBLEM_FIELDS}
    )


def broadcast_problem(prob: Problem, batch: int) -> Problem:
    """Tile a batch-of-1 Problem into `batch` identical problems (copies, so
    each can be edited, e.g. x0)."""
    if prob.batch != 1:
        raise ValueError(f"broadcast_problem takes a batch-of-1 Problem, got {prob.batch}")
    return prob.replace(
        **{f: t.expand((batch,) + t.shape[1:]).contiguous() for f, t in prob.tensors().items()}
    )
