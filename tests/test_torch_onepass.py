"""The port's one-pass method (timeopt_tpu_torch/solver/onepass.py, the
runner's baseline2) against the JAX package's f64 one-pass on the CPU.

Module by module (rtol 1e-10, atol 1e-12: the same float64 math in
another operation order): the preimage steps, the negative-time prefix in
its three modes, the value sweep over the prefix (per-problem T-bar, a
Quu that takes an LM rung above the first), the windowed pick (an even
count of candidates, where the median averages the two middle distances;
a tie on J; an empty window; no finite J), the shifted-gain rollout with
T-bar != T*, and the nominal cost curve.

End to end: solve_batch(method="onepass") against JAX's vmapped solve on
perturbed tiny double integrators in every preimage mode, and on a guarded
double integrator whose prefix states the guard poisons, so the sweep
fails and the fixed-T-bar fallback is taken: T*, n_accept, n_fallback and
T_hist identical, J* and J_hist within rtol 1e-8. max_iter is 4, as in
tests/test_solver_e2e.py::test_onepass_preimage_modes: beyond it the tiny
problems' iterates improve by single ulps, where the accept test J < J_prev
is decided by the two packages' rounding order.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_double_integrator
from tests.torch_helpers import T, iterate, problems, to_torch_problem
from timeopt_tpu.models.base import euler_step_fn as jax_euler_step_fn
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu.solver import onepass as jop
from timeopt_tpu.solver.cost import nominal_cost_curve as jax_nominal_cost_curve
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.models.base import euler_step_fn
from timeopt_tpu_torch.ops.linalg import spd_check
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver import onepass as top
from timeopt_tpu_torch.solver.cost import nominal_cost_curve
from timeopt_tpu_torch.solver.linearize import linearize

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-12


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# Module tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["fixedpoint", "newton"])
def test_preimage_steps_match_jax(which):
    """On the cart-pole (nonlinear, an angle wrapped): a batch of states and
    controls, one of them on a non-finite state that must stay put."""
    js, ts, _, _ = problems("Cartpole_SwingUp", 4, 16, 4, 16, seed=60)
    rng = np.random.default_rng(61)
    x_next = rng.standard_normal((4, 4))
    x_next[3, 1] = np.nan
    u = rng.standard_normal((4, 1))
    if which == "fixedpoint":
        want = jax.vmap(lambda x, v: jop.fixedpoint_preimage_step(js.step, x, v, n_iter=7))(jnp.asarray(x_next), jnp.asarray(u))
        got = top.fixedpoint_preimage_step(ts.step, T(x_next), T(u), n_iter=7)
    else:
        want = jax.vmap(lambda x, v: jop.newton_preimage_step(js.step, x, v))(jnp.asarray(x_next), jnp.asarray(u))
        got = top.newton_preimage_step(ts.step, T(x_next), T(u))
    assert np.isfinite(np.asarray(want)[:3]).all()
    _close(got.numpy(), want)


@pytest.mark.parametrize("method", ["fixedpoint", "newton", "copy"])
def test_extend_nominal_backward_matches_jax(method):
    js, ts, jp, tp = problems("Cartpole_SwingUp", 3, 24, 6, 24, seed=62)
    X, U, _, _ = iterate(js, jp, seed=63, noise=0.3)
    S = 6
    want = jax.vmap(lambda x, u: jop.extend_nominal_backward(js, x, u, u[0], S, method=method, n_iter=4))(
        jnp.asarray(X), jnp.asarray(U))
    got = top.extend_nominal_backward(ts, T(X), T(U), T(U)[:, 0], S, method=method, n_iter=4)
    assert got[0].shape == (3, S + 25, 4) and got[1].shape == (3, S + 24, 1)
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    assert torch.equal(got[0][:, S:], T(X))


def _prefix(ts, X, U, S):
    """(X_ext, U_ext, A_ext, B_ext) as numpy: the inputs both packages get,
    built by the port (its prefix is held to JAX's above)."""
    X_ext, U_ext = top.extend_nominal_backward(ts, T(X), T(U), T(U)[:, 0], S)
    A, B = linearize(ts.step, X_ext, U_ext)
    return tuple(a.numpy() for a in (X_ext, U_ext, A, B))


def test_value_sweep_prefix_matches_jax():
    """Quadrotor, a different T-bar for each problem (T_max, T_min + 3, one
    between), and problem 1's R seeded so that at its terminal step
    sym(Quu) + lambda I is indefinite and the second rung (lambda 1e4) is
    SPD, as tests/test_lm_ladder.py builds its cases."""
    js, ts, jp, tp = problems("Quadrotor", 3, 24, 6, 20, seed=64)
    X, U, _, _ = iterate(js, jp, seed=65)
    S = 5
    T_bar = np.array([20, 9, 14])
    lm = np.array([1e-6, 1e-3, 0.3])
    X_ext, U_ext, A_ext, B_ext = _prefix(ts, X, U, S)
    # problem 1: R - (lambda_min(M) + 1) v v' with M = R + B' Qf B at the
    # terminal step, v its eigenvector, so that M's eigenvalue along v is -1
    R = np.array(np.asarray(jp.R))
    i_term = T_bar[1] + S - 1
    Bt = B_ext[1, i_term]
    M = R[1] + Bt.T @ np.asarray(jp.Qf)[1] @ Bt
    ev, V = np.linalg.eigh(0.5 * (M + M.T))
    R[1] = R[1] - (ev[0] + 1.0) * np.outer(V[:, 0], V[:, 0])
    jp = jp.replace(R=jnp.asarray(R))
    tp = tp.replace(R=T(R))
    Mb = T(R[1] + Bt.T @ np.asarray(jp.Qf)[1] @ Bt)
    eye = torch.eye(4, dtype=torch.float64)
    assert not bool(spd_check(Mb + lm[1] * eye)) and bool(spd_check(Mb + 1e4 * lm[1] * eye))

    want = jax.vmap(lambda p, a, b, x, u, t, l: jop.value_sweep_prefix(js, p, a, b, x, u, t, S, l))(
        jp, jnp.asarray(A_ext), jnp.asarray(B_ext), jnp.asarray(X_ext), jnp.asarray(U_ext),
        jnp.asarray(T_bar, jnp.int32), jnp.asarray(lm))
    got = top.value_sweep_prefix(ts, tp, T(A_ext), T(B_ext), T(X_ext), T(U_ext), T(T_bar), S, T(lm))
    L = tp.T_max + S
    assert got.Vxx.shape == (3, L, 12, 12) and got.K.shape == (3, L, 4, 12)
    np.testing.assert_array_equal(got.ok.numpy(), np.asarray(want.ok))
    assert bool(got.ok.all())
    for name in ("Vxx", "Vx", "V0", "K", "kff"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=RTOL, atol=ATOL,
                                   err_msg=name)
    for b in range(3):  # above the terminal: zero gains
        assert not got.K[b, T_bar[b] + S :].any() and not got.kff[b, T_bar[b] + S :].any()


def _pick_inputs():
    """Tiny double integrator (T_min 4, T_max 16), S 4, window half-widths
    2 and 2, and five problems:
    0. T-bar 10: four candidates with non-zero distance 1, 2, 3 and 11
       (T = 10 itself sits at distance 0): the median is 2.5, so the gate
       5 x 2.5 = 12.5 keeps T = 12 at 11, which has the least J (a lower
       median of 2 would drop it);
    1. T-bar 10: J tied at T = 9 and T = 11: the nearer to T-bar, then the
       smaller, wins (9);
    2. T-bar 1: an empty window (max(4, -1) > min(16, 3)): T* is T-bar
       clipped to [T_min, T_max];
    3. T-bar 14: no finite J in the window: T* is T-bar clipped to it;
    4. T-bar 7: random SPD value expansions and prefix states."""
    js, base = tiny_double_integrator()
    B, S, n = 5, 4, 2
    L, Lx = base.T_max + S, S + base.N + 1
    rng = np.random.default_rng(66)
    X_ext = rng.standard_normal((B, Lx, n))
    Vxx = np.zeros((B, L, n, n))
    Vx = np.zeros((B, L, n))
    V0 = 9.0 + rng.uniform(size=(B, L))
    T_bar = np.array([10, 10, 1, 14, 7])
    # problems 0 and 1: candidate T sits at index i = T-bar - T + S
    for b, dists, vals in ((0, {8: 1.0, 9: 2.0, 11: 3.0, 12: 11.0}, {8: 5.0, 9: 6.0, 11: 7.0, 12: 0.5}),
                           (1, {8: 1.0, 9: 1.0, 11: 1.0, 12: 1.0}, {8: 4.0, 9: 3.0, 11: 3.0, 12: 4.0})):
        x0 = X_ext[b, S]
        for Tc, d in dists.items():
            i = T_bar[b] - Tc + S
            X_ext[b, i] = x0 - np.array([d, 0.0])
            V0[b, i] = vals[Tc]
    V0[3] = np.where(rng.uniform(size=L) < 0.5, np.inf, np.nan)
    G = rng.standard_normal((L, n, n))
    Vxx[4] = G @ G.transpose(0, 2, 1) + 0.1 * np.eye(n)
    Vx[4] = rng.standard_normal((L, n))
    K = np.zeros((B, L, 1, n))
    kff = np.zeros((B, L, 1))
    return js, base, S, T_bar, X_ext, (Vxx, Vx, V0, K, kff)


def test_onepass_pick_matches_jax():
    js, base, S, T_bar, X_ext, arrs = _pick_inputs()
    B = len(T_bar)
    jp = jilqr.broadcast_problem(base, B)
    tp = to_torch_problem(jp)
    jsw = jop.SweepResult(*(jnp.asarray(a) for a in arrs), ok=jnp.ones(B, bool))
    want_T, want_J = jax.vmap(lambda p, sw, x, t: jop.onepass_pick(p, sw, x, x[S], t, S, jnp.int32(2), jnp.int32(2)))(
        jp, jsw, jnp.asarray(X_ext), jnp.asarray(T_bar, jnp.int32))
    tsw = top.SweepResult(*(T(a) for a in arrs), ok=torch.ones(B, dtype=torch.bool))
    got_T, got_J = top.onepass_pick(tp, tsw, T(X_ext), T(X_ext)[:, S], T(T_bar), S, 2, 2)
    np.testing.assert_array_equal(got_T.numpy(), np.asarray(want_T))
    np.testing.assert_array_equal(got_T.numpy(), [12, 9, 4, 14, np.asarray(want_T)[4]])
    np.testing.assert_array_equal(np.isnan(got_J.numpy()), np.isnan(np.asarray(want_J)))
    _close(got_J.numpy(), want_J)
    assert np.isfinite(got_J.numpy()[0, 11])  # T = 12 passed the locality gate


@pytest.mark.parametrize("kff_scale", [1.0, 1e9])
def test_onepass_rollout_matches_jax(kff_scale):
    """Cart-pole, T* != T-bar on two of three problems, both packages on
    one sweep (the port's, held to JAX's above); with kff_scale 1e9 on
    problem 1 its four alphas' rollouts all blow up and it keeps its
    nominal. The three window shrinks stacked as one call give what three
    calls give."""
    js, ts, jp, tp = problems("Cartpole_SwingUp", 3, 32, 8, 30, seed=67)
    X, U, _, _ = iterate(js, jp, seed=68)
    S = 5
    X_ext, U_ext, A_ext, B_ext = _prefix(ts, X, U, S)
    T_bar = np.array([20, 25, 12])
    T_star = np.array([23, 21, 12])
    lm = np.full(3, 1e-3)
    tsw = top.value_sweep_prefix(ts, tp, T(A_ext), T(B_ext), T(X_ext), T(U_ext), T(T_bar), S, T(lm))
    tsw = tsw._replace(kff=tsw.kff * torch.tensor([1.0, kff_scale, 1.0], dtype=torch.float64)[:, None, None])
    alphas = (1.0, 0.5, 0.25, 0.1)
    jsw = jop.SweepResult(*(jnp.asarray(a.numpy()) for a in tsw))
    want = jax.vmap(lambda p, x, u, sw, tb, t: jop.onepass_rollout(js, p, x, u, sw, tb, t, S, alphas=alphas))(
        jp, jnp.asarray(X_ext), jnp.asarray(U_ext), jsw, jnp.asarray(T_bar, jnp.int32), jnp.asarray(T_star, jnp.int32))
    got = top.onepass_rollout(ts, tp, T(X_ext), T(U_ext), tsw, T(T_bar), T(T_star), S, alphas=alphas)
    np.testing.assert_array_equal(got[3].numpy(), [True, kff_scale == 1.0, True])
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    for g, w in zip(got[:3], want[:3]):
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(w))
        fin = np.isfinite(w)
        _close(g.numpy()[fin], w[fin])
    if kff_scale > 1:  # the nominal, kept
        assert torch.equal(got[0][1], T(X)[1]) and torch.equal(got[1][1], T(U)[1]) and got[2][1] == float("inf")
    Ts = torch.stack([T(T_star), T(T_bar), T(T_star) + 1])
    stacked = top.onepass_rollout(ts, tp, T(X_ext), T(U_ext), tsw, T(T_bar), Ts, S, alphas=alphas)
    for j in range(3):
        one = top.onepass_rollout(ts, tp, T(X_ext), T(U_ext), tsw, T(T_bar), Ts[j], S, alphas=alphas)
        for a, b in zip(stacked, one):
            assert torch.equal(a[j].nan_to_num(7.0), b.nan_to_num(7.0))


def test_nominal_cost_curve_matches_jax():
    """Cart-pole iterates: problem 1 with a NaN state (every T +inf),
    problem 2 with a NaN control beyond T_max (still finite)."""
    js, ts, jp, tp = problems("Cartpole_SwingUp", 3, 32, 8, 28, seed=69)
    X, U, _, _ = (np.array(a) for a in iterate(js, jp, seed=70))
    X[1, 5, 2] = np.nan
    U[2, 30, 0] = np.nan
    want = jax.vmap(lambda p, x, u: jax_nominal_cost_curve(js, p, x, u))(jp, jnp.asarray(X), jnp.asarray(U))
    got = nominal_cost_curve(ts, tp, T(X), T(U))
    assert got.shape == (3, 28)
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(np.asarray(want)))
    assert np.isinf(got.numpy()[1]).all() and np.isinf(got.numpy()[:, :7]).all()
    assert np.isfinite(got.numpy()[[0, 2], 7:]).all()
    fin = np.isfinite(np.asarray(want))
    _close(got.numpy()[fin], np.asarray(want)[fin])


# ---------------------------------------------------------------------------
# The whole solve
# ---------------------------------------------------------------------------

GUARD_POS = 0.99


def _guarded_di():
    """The double integrator with a guard that poisons the step from any
    position below GUARD_POS, on x0 = (1, v > 0): every trajectory moves
    forward, while the prefix's preimages move back below the guard, so
    their forward-difference Jacobians are NaN and the sweep is not ok."""
    js, base = tiny_double_integrator()
    ts = get_system("DoubleIntegrator")[0]
    jguard = lambda x, u: x[0] < GUARD_POS  # noqa: E731
    tguard = lambda x, u: x[..., 0] < GUARD_POS  # noqa: E731
    js = dataclasses.replace(js, name="DI_guarded", step=jax_euler_step_fn(js.xdot, js.dt, guard=jguard),
                             guard=jguard, xdot_rows=None)
    ts = dataclasses.replace(ts, name="DI_guarded", step=euler_step_fn(ts.xdot, ts.dt, 2, guard=tguard),
                             guard=tguard, device_id=None)
    rng = np.random.default_rng(71)
    x0 = np.stack([np.ones(3), 0.3 + np.abs(0.2 * rng.standard_normal(3))], axis=1)
    jp = jilqr.broadcast_problem(base, 3).replace(x0=jnp.asarray(x0))
    return js, ts, jp, to_torch_problem(jp)


def _tiny_di():
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(72)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((4, 2))
    jp = jilqr.broadcast_problem(base, 4).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp)


E2E = {
    "fixedpoint": (_tiny_di, dict(onepass_preimage="fixedpoint")),
    "newton": (_tiny_di, dict(onepass_preimage="newton")),
    "copy": (_tiny_di, dict(onepass_preimage="copy")),
    "fallback": (_guarded_di, dict(linearize_mode="central")),
}


@pytest.fixture(scope="module")
def jax_solves():
    """One JAX compile and solve per configuration, shared by the tests."""

    @functools.lru_cache(maxsize=None)
    def solve(name):
        make, kw = E2E[name]
        js, ts, jp, tp = make()
        opts = dict(method="onepass", max_iter=4, S_window=5, **kw)
        return ts, tp, opts, jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(**opts))

    return solve


@pytest.mark.parametrize("name", list(E2E))
def test_solve_batch_onepass_matches_jax(jax_solves, name):
    ts, tp, opts, want = jax_solves(name)
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(**opts))
    for f in ("T_star", "n_accept", "n_fallback", "T_hist"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-8)
    np.testing.assert_allclose(got.J_hist.numpy(), np.asarray(want.J_hist), rtol=1e-8)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-7)
    jc, wc = got.J_curve.numpy(), np.asarray(want.J_curve)
    np.testing.assert_array_equal(np.isnan(jc), np.isnan(wc))
    np.testing.assert_allclose(jc[~np.isnan(wc)], wc[~np.isnan(wc)], rtol=1e-7)
    np.testing.assert_array_equal(got.T_ties.numpy(), np.asarray(want.T_ties))
    assert bool(torch.isfinite(got.J_star).all()) and bool((got.n_accept >= 2).all())
    if name == "fallback":
        assert bool(got.n_fallback.any())
    else:
        assert not got.n_fallback.any()


def test_solve_single_onepass_matches_batch(jax_solves):
    """solve() on one problem is solve_batch's row."""
    ts, tp, opts, _ = jax_solves("fixedpoint")
    batch = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(**opts))
    one = tilqr.solve(ts, tp.replace(**{f: t[2:3] for f, t in tp.tensors().items()}),
                      options=tilqr.SolveOptions(**opts))
    assert int(one.T_star) == int(batch.T_star[2]) and float(one.J_star) == float(batch.J_star[2])
