"""One-pass horizon selection, the runner's baseline2 (port of
timeopt_tpu/solver/onepass.py), batched over problems.

Each iteration extends the nominal backwards in time by S steps (a
negative-time prefix of approximate preimages under the fill control
U[0]), runs one backward value sweep over the static length
L = T_max + S with the terminal at each problem's T-bar + S, picks T* in a
window around T-bar from the quadratic value model at the prefix states,
and rolls out the shifted gains. Three window shrinks are tried, the first
accepted kept; where the sweep goes numerically bad (`ok` False) the
fixed-T-bar update of the backward pass and line search is taken instead,
computed every iteration as the JAX package computes it. The loop is an
init body (`onepass_init`: rollout, T-bar, the warm-start update) and a
step body (`onepass_step`: one iteration) over the state buffers of
solver/ilqr.py::loop_state, driven eagerly or as captured CUDA graphs by
solver/compiled.py, as the curve methods' bodies are.

The sweep is plain torch: one-pass has no TPU kernel of its own. On
float32 problems it runs in float64 and returns float32 values, the
counterpart of the JAX package's df32 sweep (solver/sweep_df.py). Its
line-search launches are the line-search kernel's
(ops/cuda_forward.py): the warm start and the fallback through
`forward_linesearch`, the shifted-gain rollout through the kernel's
start-state entry on idx-shifted inputs, the three window shrinks of one
iteration stacked as one launch.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops import _build, cuda_forward
from timeopt_tpu_torch.ops.linalg import gj_solve, spd_check, sym
from timeopt_tpu_torch.ops.wrap import wrap_error
from timeopt_tpu_torch.solver.backward import stage_expansion

# ============================================================================
# Negative-time prefix
# ============================================================================


def fixedpoint_preimage_step(step, x_next, u_prev, *, n_iter=4, tol=1e-9, damping=0.5):
    """Approximate solve of step(x_prev, u) = x_next for each problem
    (x_next (B, n), u_prev (B, m)) by damped fixed-point iteration
    x <- x - damping (step(x, u) - x_next). A problem's iterate stops moving
    once it converges or once step(x, u) goes non-finite. n_iter 4 is the
    JAX package's outcome-parity choice (its docstring)."""
    x = x_next
    for _ in range(n_iter):
        fx = step(x, u_prev)
        r = fx - x_next
        nr = torch.sqrt(torch.sum(torch.square(r), dim=-1))
        stop = (~torch.isfinite(fx).all(dim=-1)) | (nr < tol)
        x = torch.where(stop[:, None], x, x - damping * r)
    return x


def newton_preimage_step(step, x_next, u_prev, *, n_iter=10, tol=1e-9):
    """Newton preimage with the exact Jacobian of step in x (torch.func);
    a non-finite Newton step falls back to half of it."""
    jac = torch.func.vmap(torch.func.jacfwd(step, argnums=0))
    x = x_next
    for _ in range(n_iter):
        fx = step(x, u_prev)
        g = fx - x_next
        stop = (~torch.isfinite(fx).all(dim=-1)) | (torch.sqrt(torch.sum(torch.square(g), dim=-1)) < tol)
        # solve_ex: a singular Jacobian gives non-finite values, not an error;
        # the Jacobian in x's dtype, as linearize_ad takes it (forward AD may
        # promote a float32 tangent to float64)
        dx = torch.linalg.solve_ex(jac(x, u_prev).to(x.dtype), g[..., None])[0][..., 0]
        x1 = x - dx
        x1 = torch.where(torch.isfinite(x1).all(dim=-1, keepdim=True), x1, x - 0.5 * dx)
        x = torch.where(stop[:, None], x, x1)
    return x


def extend_nominal_backward(
    system: System,
    X: torch.Tensor,
    U: torch.Tensor,
    u_fill: torch.Tensor,
    S_back: int,
    *,
    method: str = "fixedpoint",
    n_iter: int = 4,
    damping: float = 0.5,
):
    """A feasible-ish negative-time prefix of S_back states with the
    constant fill control u_fill (B, m): X_ext (B, S_back+N+1, n), U_ext
    (B, S_back+N, m), the nominal from index S_back on. method "copy"
    repeats X[:, 0], "newton" takes Newton preimages (10 iterations),
    "fixedpoint" damped fixed-point ones (n_iter). A non-finite preimage
    keeps the state after it."""
    if S_back <= 0:
        return X, U
    if method == "copy":
        pre = lambda x_next: x_next  # noqa: E731
    elif method == "newton":
        pre = lambda x_next: newton_preimage_step(system.step, x_next, u_fill)  # noqa: E731
    else:
        pre = lambda x_next: fixedpoint_preimage_step(  # noqa: E731
            system.step, x_next, u_fill, n_iter=n_iter, damping=damping)
    x_curr, rev = X[:, 0], []
    for _ in range(S_back):
        x_prev = pre(x_curr)
        x_curr = torch.where(torch.isfinite(x_prev).all(dim=-1, keepdim=True), x_prev, x_curr)
        rev.append(x_curr)
    X_pre = torch.stack(rev[::-1], dim=1)  # X_pre[:, s] is x_{-(S_back - s)}
    U_pre = u_fill[:, None].expand(-1, S_back, -1)
    return torch.cat([X_pre, X], dim=1), torch.cat([U_pre, U], dim=1)


# ============================================================================
# One backward value sweep over the prefix
# ============================================================================


class SweepResult(NamedTuple):
    Vxx: torch.Tensor  # (B, L, n, n) value Hessian at index i (time t = i - S)
    Vx: torch.Tensor  # (B, L, n)
    V0: torch.Tensor  # (B, L)
    K: torch.Tensor  # (B, L, m, n)
    kff: torch.Tensor  # (B, L, m)
    ok: torch.Tensor  # (B,) bool


def value_sweep_prefix(
    system: System,
    prob: Problem,
    A_ext: torch.Tensor,
    B_ext: torch.Tensor,
    X_ext: torch.Tensor,
    U_ext: torch.Tensor,
    T_bar: torch.Tensor,
    S: int,
    lm_lambda: torch.Tensor,
) -> SweepResult:
    """Backward sweep for t in [-S, T-bar - 1] with the terminal at T-bar
    (index i = t + S), over the static length L = T_max + S with masking:
    the terminal enters where i + 1 == T-bar + S, the indices above pass
    the value through with zero gains. `ok` is False where an input (e, du,
    A, B) or the terminal error is non-finite, where no rung of the LM
    ladder is SPD, or where a value (Vx, Vxx, V0) goes non-finite at an
    active step. On float32 inputs the sweep runs in float64 and its
    values come back in float32."""
    L = prob.T_max + S
    e, du, lx, lu, l0, Qstage = stage_expansion(system, prob, X_ext[:, : L + 1], U_ext[:, :L])
    eT = wrap_error(X_ext[:, 1 : L + 1] - prob.xg[:, None], prob.wrap_mask[:, None])  # (B, L, n)
    fin_in = (
        torch.isfinite(e).all(dim=-1)
        & torch.isfinite(du).all(dim=-1)
        & torch.isfinite(A_ext[:, :L]).flatten(2).all(dim=-1)
        & torch.isfinite(B_ext[:, :L]).flatten(2).all(dim=-1)
    )
    return _build.in_f64(
        _sweep_arrays, A_ext[:, :L], B_ext[:, :L], lx, lu, l0, Qstage, eT, torch.isfinite(eT).all(dim=-1), fin_in,
        sym(prob.Qf), prob.R, T_bar.to(torch.int64) + S, torch.clamp(lm_lambda, min=1e-12),
    )


LADDER = (1.0, 1e4, 1e8, 1e12)  # the static LM ladder: lambda times each rung


def _sweep_arrays(A, B, lx, lu, l0, Qs, eT, eT_fin, fin_in, QfT, R, iT, lam0) -> SweepResult:
    """The masked reverse sweep, batched over B: A (B, L, n, n), B (B, L, n, m),
    lx (B, L, n), lu (B, L, m), l0 (B, L), Qs (B, L, n, n), eT (B, L, n),
    eT_fin and fin_in (B, L) bool, QfT (B, n, n), R (B, m, m), iT (B,) int64,
    lam0 (B,). Each step regularizes sym(Quu) with the first SPD rung of
    lam0 * LADDER."""
    Bsz, L, n = eT.shape
    m = B.shape[-1]
    dt, dev = eT.dtype, eT.device
    I_m = torch.eye(m, dtype=dt, device=dev)
    lams = lam0[:, None] * _build.constant(LADDER, dt, dev)  # (B, 4)
    rows = torch.arange(Bsz, device=dev)
    Vx = torch.zeros((Bsz, n), dtype=dt, device=dev)
    Vxx = torch.zeros((Bsz, n, n), dtype=dt, device=dev)
    V0 = torch.zeros(Bsz, dtype=dt, device=dev)
    ok = torch.ones(Bsz, dtype=torch.bool, device=dev)
    out_Vxx = torch.empty((Bsz, L, n, n), dtype=dt, device=dev)
    out_Vx = torch.empty((Bsz, L, n), dtype=dt, device=dev)
    out_V0 = torch.empty((Bsz, L), dtype=dt, device=dev)
    out_K = torch.empty((Bsz, L, m, n), dtype=dt, device=dev)
    out_kff = torch.empty((Bsz, L, m), dtype=dt, device=dev)
    QfeT = torch.einsum("bij,blj->bli", QfT, eT)  # (B, L, n)
    for i in range(L - 1, -1, -1):
        Ai, Bi = A[:, i], B[:, i]
        AiT, BiT = Ai.transpose(-1, -2), Bi.transpose(-1, -2)
        is_term = (i + 1) == iT
        Vx_in = torch.where(is_term[:, None], QfeT[:, i], Vx)
        Vxx_in = torch.where(is_term[:, None, None], QfT, Vxx)
        V0_in = torch.where(is_term, 0.5 * (eT[:, i] * QfeT[:, i]).sum(dim=-1), V0)
        ok = ok & torch.where(is_term, eT_fin[:, i], True)

        Qx = lx[:, i] + (AiT @ Vx_in[..., None])[..., 0]
        Qu = lu[:, i] + (BiT @ Vx_in[..., None])[..., 0]
        Qxx = Qs[:, i] + AiT @ Vxx_in @ Ai
        Quu = R + BiT @ Vxx_in @ Bi
        Qux = BiT @ Vxx_in @ Ai

        regs = sym(Quu)[:, None] + lams[:, :, None, None] * I_m  # (B, 4, m, m)
        spd = spd_check(regs)
        Quu_reg = regs[rows, torch.argmax(spd.to(torch.int32), dim=1)]  # first SPD rung
        invQuuQu = gj_solve(Quu_reg, Qu)
        invQuuQux = gj_solve(Quu_reg, Qux)
        QuxT = Qux.transpose(-1, -2)
        Vx_new = Qx - (QuxT @ invQuuQu[..., None])[..., 0]
        Vxx_new = sym(Qxx - QuxT @ invQuuQux)
        V0_new = l0[:, i] + V0_in - 0.5 * (Qu * invQuuQu).sum(dim=-1)

        active = i < iT
        step_ok = (
            spd.any(dim=1)
            & fin_in[:, i]
            & torch.isfinite(Vx_new).all(dim=-1)
            & torch.isfinite(Vxx_new).flatten(1).all(dim=-1)
            & torch.isfinite(V0_new)
        )
        ok = ok & torch.where(active, step_ok, True)
        Vx = torch.where(active[:, None], Vx_new, Vx_in)
        Vxx = torch.where(active[:, None, None], Vxx_new, Vxx_in)
        V0 = torch.where(active, V0_new, V0_in)
        out_Vxx[:, i], out_Vx[:, i], out_V0[:, i] = Vxx, Vx, V0
        out_K[:, i] = torch.where(active[:, None, None], -invQuuQux, 0.0)
        out_kff[:, i] = torch.where(active[:, None], -invQuuQu, 0.0)
    return SweepResult(Vxx=out_Vxx, Vx=out_Vx, V0=out_V0, K=out_K, kff=out_kff, ok=ok)


# ============================================================================
# Windowed pick
# ============================================================================


def onepass_pick(
    prob: Problem,
    sweep: SweepResult,
    X_ext: torch.Tensor,
    x0: torch.Tensor,
    T_bar: torch.Tensor,
    S: int,
    S_L: int,
    S_R: int,
    *,
    locality_mult: float = 5.0,
):
    """T* (B,) int64 in the window [max(T_min, T-bar - S_L), min(T_max,
    T-bar + S_R)] by the quadratic value model at the start x0 (B, n), and
    the window curve Jw (B, T_max), NaN outside the evaluated set. A
    candidate T is evaluated where its prefix distance |wrap(x0 - X_ext[i])|,
    i = T-bar - T + S, is at most locality_mult times the median of the
    window's non-zero finite distances (the median of an even count is the
    mean of the two middle values, as numpy's). T* is the lexicographic
    argmin over (J, |T - T-bar|, T), clip(T-bar, window) where no J is
    finite, clip(T-bar, T_min, T_max) where the window is empty."""
    T_max, T_min = prob.T_max, prob.T_min
    Bsz, Lx, _ = X_ext.shape
    dev = X_ext.device
    Tb = T_bar.to(torch.int64)
    Ts = torch.arange(1, T_max + 1, device=dev)
    Lb = torch.clamp(Tb - S_L, min=T_min)
    Rb = torch.clamp(Tb + S_R, max=T_max)
    i_arr = Tb[:, None] - Ts[None] + S  # (B, T_max): start index for horizon T
    in_win = (Ts >= Lb[:, None]) & (Ts <= Rb[:, None]) & (i_arr >= 0) & (i_arr < Lx)

    rows = torch.arange(Bsz, device=dev)[:, None]
    dx0 = wrap_error(x0[:, None] - X_ext[rows, i_arr.clamp(0, Lx - 1)], prob.wrap_mask[:, None])
    dn = torch.sqrt(torch.sum(torch.square(dx0), dim=-1))
    norm_ok = torch.isfinite(dn) & (dn > 1e-12) & in_win
    med = torch.nanquantile(torch.where(norm_ok, dn, float("nan")), 0.5, dim=1, interpolation="midpoint")
    dx_max = torch.where(norm_ok.any(dim=1), locality_mult * med, float("inf"))

    ic = i_arr.clamp(0, sweep.Vxx.shape[1] - 1)
    JT = (
        0.5 * torch.einsum("bti,btij,btj->bt", dx0, sweep.Vxx[rows, ic], dx0)
        + torch.einsum("bti,bti->bt", sweep.Vx[rows, ic], dx0)
        + sweep.V0[rows, ic]
    )
    evaluated = in_win & (dn <= dx_max[:, None])
    Jw = torch.where(evaluated, JT, float("nan"))

    J_masked = torch.where(evaluated & torch.isfinite(JT), JT, float("inf"))
    bestJ = J_masked.min(dim=1).values
    tie = J_masked == bestJ[:, None]
    penalty = (Ts[None] - Tb[:, None]).abs() * (T_max + 2) + Ts[None]
    bestT = Ts[torch.argmin(torch.where(tie, penalty, torch.iinfo(torch.int64).max), dim=1)]
    bestT = torch.where(torch.isfinite(bestJ), bestT, torch.minimum(torch.maximum(Tb, Lb), Rb))
    bestT = torch.where(Lb > Rb, Tb.clamp(T_min, T_max), bestT)
    return bestT, Jw


# ============================================================================
# Shifted-gain rollout
# ============================================================================


def _tile(prob: Problem, J: int) -> Problem:
    """The batch repeated J times along its axis."""
    if J == 1:
        return prob
    return prob.replace(**{f: t.repeat((J,) + (1,) * (t.dim() - 1)) for f, t in prob.tensors().items()})


def shifted_rollout_inputs(prob: Problem, X_ext, U_ext, sweep: SweepResult, T_bar, T_star, S: int):
    """The line-search kernel's inputs for the shifted-gain rollouts of
    J candidate horizons T_star (J, B) of each problem, flattened to J*B
    rollouts (j major): (prob tiled J times, X (JB, N+1, n), U (JB, N, m),
    K (JB, N, m, n), kappa (JB, N, m), T* (JB,), x_start (JB, n)). Step t
    reads index idx = clip(T-bar - T* + t + S, 0, L - 1) of X_ext, U_ext and
    the sweep's gains; U holds the nominal U[t] from T* on; every rollout
    starts at X_ext[:, S] (a strided view of it where J = 1)."""
    N, L = prob.N, sweep.K.shape[1]
    Bsz, dev = X_ext.shape[0], X_ext.device
    Ts = T_star.reshape(-1, Bsz).to(torch.int64)
    J = Ts.shape[0]
    t = torch.arange(N + 1, device=dev)
    idx = (T_bar.to(torch.int64)[None, :, None] - Ts[..., None] + S + t).clamp(0, L - 1)  # (J, B, N+1)
    b = torch.arange(Bsz, device=dev)[None, :, None]
    ik = idx[..., :N]
    U_in = torch.where((t[:N] < Ts[..., None])[..., None], U_ext[b, ik], U_ext[None, :, S:])
    flat = lambda v: v.reshape((J * Bsz,) + v.shape[2:]).contiguous()  # noqa: E731
    x_start = X_ext[:, S] if J == 1 else X_ext[:, S].repeat(J, 1)
    return (_tile(prob, J), flat(X_ext[b, idx]), flat(U_in), flat(sweep.K[b, ik]), flat(sweep.kff[b, ik]),
            Ts.reshape(-1), x_start)


def onepass_rollout(
    system: System,
    prob: Problem,
    X_ext: torch.Tensor,
    U_ext: torch.Tensor,
    sweep: SweepResult,
    T_bar: torch.Tensor,
    T_star: torch.Tensor,
    S: int,
    *,
    alphas=(1.0, 0.5, 0.25, 0.1),
):
    """Roll out u_t = U_ext[idx] + K[idx] wrap(x - X_ext[idx]) + alpha
    kff[idx], idx = clip(T-bar - T* + t + S, 0, L - 1), for t < T*, then the
    nominal U[t], from X_ext[:, S]; keep the first alpha of least true cost
    (a rollout non-finite anywhere costs +inf), or the nominal where none is
    finite. T_star is (B,) or (J, B), J candidate horizons of each problem
    rolled out in one launch. Returns X (…, B, N+1, n), U (…, B, N, m),
    J (…, B) and ok (…, B): whether an alpha was finite.

    On the inputs gathered at idx (shifted_rollout_inputs), the line-search
    kernel's formula u = U_k + [k < T*](K_k wrap(x - X_k) + alpha kappa_k)
    is this policy; its start state is X_ext[:, S]."""
    Bsz = X_ext.shape[0]
    shape = T_star.shape
    probJ, X_in, U_in, K_in, k_in, Ts, x_start = shifted_rollout_inputs(prob, X_ext, U_ext, sweep, T_bar, T_star, S)
    JB = Ts.shape[0]
    Xs, Us, Js = cuda_forward.linesearch(system, probJ, X_in, U_in, K_in, k_in, Ts, alphas, x_start=x_start)
    r = torch.arange(JB, device=X_ext.device)
    best = torch.argmin(Js, dim=1)
    Jb = Js[r, best]
    ok = torch.isfinite(Jb)
    rep = JB // Bsz
    Xb = torch.where(ok[:, None, None], Xs[r, best], X_ext[:, S:].repeat(rep, 1, 1))
    Ub = torch.where(ok[:, None, None], Us[r, best], U_ext[:, S:].repeat(rep, 1, 1))
    return (Xb.reshape(shape + Xb.shape[1:]), Ub.reshape(shape + Ub.shape[1:]),
            torch.where(ok, Jb, float("inf")).reshape(shape), ok.reshape(shape))


# ============================================================================
# The one-pass outer loop
# ============================================================================


def extend_and_linearize(system, opts, X, U, A, B):
    """(X_ext, U_ext, A_ext, B_ext): the prefix of S = opts.S_window states
    (fill control U[:, 0]) and its Jacobians, linearized by forward
    differences unless opts.linearize_mode is "ad", before (A, B)."""
    from timeopt_tpu_torch.solver.linearize import linearize

    S = int(opts.S_window)
    X_ext, U_ext = extend_nominal_backward(system, X, U, U[:, 0], S, method=opts.onepass_preimage,
                                           n_iter=opts.preimage_iters)
    if S <= 0:
        return X_ext, U_ext, A, B
    prefix_mode = "ad" if opts.linearize_mode == "ad" else "forward"
    A_pre, B_pre = linearize(system.step, X_ext[:, : S + 1], U_ext[:, :S], prefix_mode)
    return X_ext, U_ext, torch.cat([A_pre, A], dim=1), torch.cat([B_pre, B], dim=1)


def onepass_init(system: System, opts, prob: Problem, U_init: torch.Tensor, st: dict) -> None:
    """The one-pass method's init body (state buffers of
    ilqr.loop_state(onepass=True)): the initial rollout of U_init, T-bar
    from its nominal cost curve, and the warm-start fixed-T-bar update
    (backward pass and line search at T-bar), recorded where the backward
    pass is healthy and its cost finite."""
    from timeopt_tpu_torch.solver.backward import backward_truncated
    from timeopt_tpu_torch.solver.cost import argmin_T, nominal_cost_curve, rollout
    from timeopt_tpu_torch.solver.forward import forward_linesearch
    from timeopt_tpu_torch.solver.ilqr import T3_sentinel
    from timeopt_tpu_torch.solver.linearize import linearize

    Bsz, i64 = prob.batch, torch.int64
    X = rollout(system, prob, prob.x0, U_init)
    U = U_init
    T_bar = argmin_T(nominal_cost_curve(system, prob, X, U), prob.T_min, prob.T_max)

    A, B = linearize(system.step, X, U, opts.linearize_mode)
    lm = st["lm"].fill_(opts.lm_init)
    bw = backward_truncated(system, prob, A, B, X, U, T_bar, lm)
    ls = forward_linesearch(system, prob, X, U, bw.K, bw.kappa, T_bar, alphas=opts.alphas)
    warm_ok = bw.ok & torch.isfinite(ls.J)
    st["J_hist"].fill_(float("nan"))
    st["T_hist"].fill_(-1)
    st["J_hist"][:, 0] = torch.where(warm_ok, ls.J, st["J_hist"][:, 0])
    st["T_hist"][:, 0] = torch.where(warm_ok, T_bar, st["T_hist"][:, 0])
    sentinel = T3_sentinel(X.device).expand(Bsz, 3)
    st["X"].copy_(torch.where(bw.ok[:, None, None], ls.X, X))
    st["U"].copy_(torch.where(bw.ok[:, None, None], ls.U, U))
    st["T_bar"].copy_(T_bar)
    st["J_last"].copy_(torch.where(warm_ok, ls.J, float("inf")))
    st["J_prev"].fill_(float("inf"))
    st["n_acc"].copy_(warm_ok.to(i64))
    st["T3"].copy_(torch.where(warm_ok[:, None], torch.cat([sentinel[:, 1:], T_bar[:, None]], dim=1), sentinel))
    st["J_curve"].fill_(float("nan"))
    st["n_fb"].zero_()
    st["done"].zero_()


def onepass_step(system: System, opts, prob: Problem, st: dict) -> None:
    """The one-pass method's step body, one outer iteration in place:
    prefix, sweep, the three windowed picks and their rollouts (the first
    accepted kept), the fixed-T-bar fallback where the sweep is not ok, the
    Levenberg-Marquardt accept/reject and the convergence test."""
    from timeopt_tpu_torch.solver.backward import backward_truncated
    from timeopt_tpu_torch.solver.forward import forward_linesearch
    from timeopt_tpu_torch.solver.ilqr import commit, converged
    from timeopt_tpu_torch.solver.linearize import linearize

    dtype, dev = st["X"].dtype, st["X"].device
    Bsz, S = prob.batch, int(opts.S_window)
    rows = torch.arange(Bsz, device=dev)
    i64 = torch.int64
    inf = torch.full((Bsz,), float("inf"), dtype=dtype, device=dev)
    hist_len = opts.max_iter + 1
    alphas4 = opts.alphas[: min(4, len(opts.alphas))]

    A, B = linearize(system.step, st["X"], st["U"], opts.linearize_mode)
    X_ext, U_ext, A_ext, B_ext = extend_and_linearize(system, opts, st["X"], st["U"], A, B)
    sweep = value_sweep_prefix(system, prob, A_ext, B_ext, X_ext, U_ext, st["T_bar"], S, st["lm"])

    # the three window shrinks (half-widths max(1, S // 2^j)): picks,
    # then their rollouts in one launch
    picks = [onepass_pick(prob, sweep, X_ext, X_ext[:, S], st["T_bar"], S, h, h)
             for h in (max(1, S // 2**j) for j in range(3))]
    Xc, Uc, Jc, okroll = onepass_rollout(system, prob, X_ext, U_ext, sweep, st["T_bar"],
                                         torch.stack([T for T, _ in picks]), S, alphas=alphas4)
    taken = torch.zeros(Bsz, dtype=torch.bool, device=dev)
    Xo, Uo, Jo = st["X"], st["U"], inf
    T_sel = st["T_bar"]
    Jw_last = torch.full((Bsz, prob.T_max), float("nan"), dtype=dtype, device=dev)
    for j, (T_j, Jw_j) in enumerate(picks):
        acc_j = okroll[j] & (Jc[j] < st["J_last"])
        take_now = acc_j & ~taken
        Xo = torch.where(take_now[:, None, None], Xc[j], Xo)
        Uo = torch.where(take_now[:, None, None], Uc[j], Uo)
        Jo = torch.where(take_now, Jc[j], Jo)
        T_sel = torch.where(take_now | ~taken, T_j, T_sel)
        Jw_last = torch.where((~taken)[:, None], Jw_j, Jw_last)
        taken = taken | acc_j

    # the fixed-T-bar fallback, selected where the sweep is not ok
    ok_sweep = sweep.ok
    bw_fb = backward_truncated(system, prob, A, B, st["X"], st["U"], st["T_bar"], st["lm"])
    ls_fb = forward_linesearch(system, prob, st["X"], st["U"], bw_fb.K, bw_fb.kappa, st["T_bar"],
                               alphas=opts.alphas)
    acc_fb = bw_fb.ok & ls_fb.accepted
    sw3 = ok_sweep[:, None, None]
    Xn = torch.where(sw3, Xo, torch.where(acc_fb[:, None, None], ls_fb.X, st["X"]))
    Un = torch.where(sw3, Uo, torch.where(acc_fb[:, None, None], ls_fb.U, st["U"]))
    Jn = torch.where(ok_sweep, Jo, ls_fb.J)
    T_star = torch.where(ok_sweep, T_sel, st["T_bar"])
    acc = torch.where(ok_sweep, taken, acc_fb) & torch.isfinite(Jn)

    a3 = acc[:, None, None]
    new = dict(
        X=torch.where(a3, Xn, st["X"]),
        U=torch.where(a3, Un, st["U"]),
        lm=torch.where(acc, torch.clamp(st["lm"] / 10.0, min=1e-12), st["lm"] * 10.0),
        T_bar=torch.where(acc, T_star, st["T_bar"]),
        J_last=torch.where(acc, Jn, st["J_last"]),
        J_prev=torch.where(acc, st["J_last"], st["J_prev"]),
        n_acc=st["n_acc"] + acc.to(i64),
        T3=torch.where(acc[:, None], torch.cat([st["T3"][:, 1:], T_star[:, None]], dim=1), st["T3"]),
        J_curve=torch.where(ok_sweep[:, None], Jw_last, st["J_curve"]),
        J_hist=st["J_hist"].clone(),
        T_hist=st["T_hist"].clone(),
        n_fb=st["n_fb"] + (~ok_sweep).to(i64),
    )
    slot = st["n_acc"].clamp(max=hist_len - 1)
    new["J_hist"][rows, slot] = torch.where(acc, Jn, st["J_hist"][rows, slot])
    new["T_hist"][rows, slot] = torch.where(acc, T_star, st["T_hist"][rows, slot])
    commit(st, new, converged(new, opts.rel_tol))
