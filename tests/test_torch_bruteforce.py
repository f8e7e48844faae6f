"""Parity of the port's brute-force curve, the solves that use it or the
unfused propagator select, and the consistency check with the JAX reference
in f64 on the CPU (the port's plain versions).

Tolerances: the brute-force J(T) within rtol 1e-9 of JAX (the same Riccati
recursion in another operation order, on well-conditioned Quu); the
propagator equals the brute force at lm_lambda = 0 within rtol 1e-6 as in
tests/test_propagator.py; solves through assert_results_match; the
inverse-query solve's last curve within rtol 1e-5 instead of 1e-7: that
query inverts the regularized, rank-deficient terminal block QT
(kappa ~ 1e9 at rho = 1e-12 with the 1e-9 jitter), which amplifies the
prefixes' ~1e-14 differences to ~1e-6 (T*, J* and the trajectories agree
as tightly as ever). The consistency check's curves within rtol 1e-9 of
JAX, its max_abs and rmse within rtol 1e-6 and atol 1e-10: each is a
difference of two curves, and at lm_lambda = 0 those nearly coincide
(max_abs ~6e-6 on J ~ 6), so the curves' own ~1e-12 relative agreement
with JAX (2e-11 absolute) is what remains.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import random_ltv_problem, tiny_double_integrator
from tests.torch_helpers import T, assert_results_match, iterate, problems, to_torch_problem
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu.solver.verify import consistency_check as jax_consistency
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.models.base import System
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import horizon as thor
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.verify import consistency_check

torch.set_num_threads(1)

# case: (B, N, T_min, T_max), cut to a few dozen steps
CASES = {
    "DoubleIntegrator": (2, 30, 8, 24),
    "Cartpole_SwingUp": (2, 30, 8, 24),
    "Quadrotor": (2, 20, 6, 16),
    "Segway_Balance": (2, 30, 8, 24),
    "Ballbot_Balance": (2, 30, 8, 24),
    "PointMass_Navigation": (2, 30, 8, 24),
}


def _window(a, Tm, extra=0):
    return a[:, : Tm + extra]


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_bruteforce_curve_matches_jax(case, levels):
    Bsz, N, T_min, Tm = CASES[case]
    js, ts, jp, tp = problems(case, Bsz, N, T_min, Tm, seed=50)
    X, U, A, Bm = iterate(js, jp, seed=51)
    X, U, A, Bm = _window(X, Tm, 1), _window(U, Tm), _window(A, Tm), _window(Bm, Tm)
    want = jax.vmap(lambda p, a, b, x, u: jhor.bruteforce_J_curve(js, p, a, b, x, u, psd_levels=levels))(
        jp, *(jnp.asarray(v) for v in (A, Bm, X, U))
    )
    got = thor.bruteforce_J_curve(ts, tp, T(A), T(Bm), T(X), T(U), psd_levels=levels)
    assert got.shape == (Bsz, Tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_value_expansion_V0_matches_jax_and_the_curve():
    Bsz, N, T_min, Tm = CASES["Quadrotor"]
    js, ts, jp, tp = problems("Quadrotor", Bsz, N, T_min, Tm, seed=52)
    X, U, A, Bm = iterate(js, jp, seed=53)
    Ts = np.array([3, 11])
    want = jax.vmap(lambda p, a, b, x, u, t: jhor.value_expansion_V0(js, p, a, b, x, u, t))(
        jp, *(jnp.asarray(v) for v in (A, Bm, X, U, Ts))
    )
    args = (ts, tp, T(A), T(Bm), T(X), T(U))
    got = thor.value_expansion_V0(*args, torch.as_tensor(Ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    curve = thor.bruteforce_J_curve(*args)
    np.testing.assert_array_equal(got.numpy(), curve[torch.arange(Bsz), torch.as_tensor(Ts) - 1].numpy())


def test_propagator_matches_bruteforce():
    """The factored propagator equals the exact quadratic model (the brute
    force at lm_lambda = 0) on a random LTV problem, as in
    tests/test_propagator.py::test_propagator_matches_bruteforce."""
    rng = np.random.default_rng(54)
    _, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=3, m=2, N=12)
    At, Bt = T(Ad), T(Bd)

    def step(x, u):
        return x @ At.T + u @ Bt.T

    system = System(name="ltv", n=3, m=2, dt=0.1, step=step, xdot=step)
    tp = to_torch_problem(jilqr.broadcast_problem(prob, 1))
    Xt, Ut = T(X)[None], T(U)[None]
    A, B = At.expand(1, 12, 3, 3), Bt.expand(1, 12, 3, 2)
    blk = taug.build_augmented(system, tp, Xt, Ut, A, B)
    C = taug.build_terminal_factors(tp, Xt, s=blk.s)
    J_prop = blk.s[:, :1] ** 2 * thor.propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C)
    J_bf = thor.bruteforce_J_curve(system, tp, A, B, Xt, Ut, lm_lambda=0.0)
    np.testing.assert_allclose(J_prop.numpy(), J_bf.numpy(), rtol=1e-6, atol=1e-9)


def _tiny_di(B=3):
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(55)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp)


@pytest.mark.parametrize("kw", [dict(method="bruteforce"), dict(terminal_mode="inverse")],
                         ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_solve_batch_matches_jax(kw):
    js, ts, jp, tp = _tiny_di()
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=6, **kw))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=6, **kw))
    inverse = kw.get("terminal_mode") == "inverse"
    assert_results_match(got, want, tp.T_min, curve=not inverse)
    if inverse:
        t = tp.T_min - 1
        np.testing.assert_allclose(got.J_curve[:, t:].numpy(), np.asarray(want.J_curve)[:, t:], rtol=1e-5)
        np.testing.assert_array_equal(got.T_ties.numpy(), np.asarray(want.T_ties))
    assert got.n_accept.min() >= 1
    np.testing.assert_array_equal(got.n_fallback.numpy(), np.asarray(want.n_fallback))


def test_solve_batch_pointmass_bruteforce_matches_jax():
    """The brute force with an extra stage cost (its gradient and Hessian
    enter lx and Qstage)."""
    js, ts, jp, tp = problems("PointMass_Navigation", 2, 40, 10, 40, seed=56)
    opts = dict(method="bruteforce", max_iter=3, psd_levels=1)
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(**opts))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(**opts))
    assert_results_match(got, want, tp.T_min)


@pytest.mark.parametrize("lm_lambda", [1e-6, 0.0])
def test_consistency_check_matches_jax(lm_lambda):
    js, ts, jp, tp = _tiny_di(B=2)
    res = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=6))
    X, U = np.asarray(res.X), np.asarray(res.U)
    got = consistency_check(ts, tp, T(X), T(U), lm_lambda=lm_lambda)
    assert got["J_prop"].shape == got["J_bf"].shape == (2, tp.T_max)
    for b in range(2):
        pb = jax.tree.map(lambda x: x[b], jp)
        want = jax_consistency(js, pb, jnp.asarray(X[b]), jnp.asarray(U[b]), lm_lambda=lm_lambda)
        np.testing.assert_allclose(got["J_prop"][b].numpy(), np.asarray(want["J_prop"]), rtol=1e-9)
        np.testing.assert_allclose(got["J_bf"][b].numpy(), np.asarray(want["J_bf"]), rtol=1e-9)
        for key in ("max_abs", "rmse"):
            np.testing.assert_allclose(float(got[key][b]), float(want[key]), rtol=1e-6, atol=1e-10)
    assert bool((got["rmse"] <= got["max_abs"]).all())
    assert float(got["max_abs"].max()) < (1e-4 if lm_lambda == 0.0 else 2e-3)


def test_solve_options_check():
    """The repaired options and the values that still raise."""
    opts = tilqr.SolveOptions()
    assert (opts.S_window, opts.rho_reg) == (20, 1e-12) == (jilqr.SolveOptions().S_window, jilqr.SolveOptions().rho_reg)
    for kw in (dict(method="bruteforce"), dict(terminal_mode="inverse"), dict(linearize_mode="central"),
               dict(linearize_mode="forward")):
        tilqr.SolveOptions(**kw).check()
    for kw in (dict(method="newton"), dict(terminal_mode="exact"), dict(linearize_mode="fd")):
        with pytest.raises(ValueError):
            tilqr.SolveOptions(**kw).check()


def test_rho_reg_reaches_the_select():
    """rho_reg enters the terminal factor C = chol(Qf + rho I)' and the
    corner of Q_aug, as in JAX: a large rho moves the curve."""
    _, ts, _, tp = _tiny_di(B=1)
    a = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=0))
    b = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=0, rho_reg=1.0))
    assert not torch.allclose(a.J_curve, b.J_curve)
