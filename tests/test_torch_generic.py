"""Parity of the port's extra-stage-cost path and of its cartpole, segway,
ballbot and PointMass models with the JAX reference in f64 on the CPU.

Tolerances, and why:
- xdot, step, safe_step: rtol 1e-13. Both run the same float64 operations
  in the same order (the reciprocal-constant forms kept); only libm's
  sin/cos/exp may differ in the last bit.
- extra_cost_terms (c, cx, cxx): rtol 1e-12. Exact AD of the same formula,
  with tangents ordered by each framework's AD rules.
- build_augmented, build_terminal_factors: rtol 1e-12 (atol 1e-14 for the
  entries that cancel to ~0): the same einsums in another summation order.
- select_generic_plain: J(T) for T >= T_min within rtol 1e-9 of the JAX
  select on the same blocks, argmin equal. Both invert and multiply the
  same pivot-free eliminations in another operation order, so they agree
  to ~kappa(Q_aug) * eps; on these short horizons kappa stays below 1e5.
  The generic select on a stationary cost (quadrotor) equals the fused
  select within the same rtol 1e-9.
- the JAX Pallas generic kernel in interpret mode (float32 inputs, its
  double-single arithmetic degraded by interpret mode): rtol 5e-3 against
  the port's plain version, and +inf below T_min.
- solve_batch: the tolerances of tests/test_torch_solver.py
  (torch_helpers.assert_results_match). On the cartpole the last J(T)
  curve and its tie set are left out: with the zero weight on theta,
  q_reg = 1e-9 makes kappa(Q_aug) ~1e15, so the JAX reference and the
  port, in another operation order, differ by up to 45% at short horizons
  on the same iterate (both far from the Riccati value there), while T*,
  J* and the trajectories agree to the stated tolerances.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import random_ltv_problem
from tests.torch_helpers import T, assert_results_match, iterate, problems
from timeopt_tpu.models import get_system as jax_get_system
from timeopt_tpu.models.base import System as JaxSystem
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import cost as jcost
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu.solver.cost import argmin_T as jax_argmin_T
from timeopt_tpu_torch.models import get_system as torch_get_system
from timeopt_tpu_torch.ops import cuda_lft_generic
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import cost as tcost
from timeopt_tpu_torch.solver import horizon as thor
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.cost import argmin_T

torch.set_num_threads(1)
NEW = ["Cartpole_SwingUp", "Segway_Balance", "Ballbot_Balance", "PointMass_Navigation"]
PM = "PointMass_Navigation"


def _states(case, rng):
    """Random (x, u) with angles far outside (-pi, pi] (wrapped by step) and
    one exploding state (poisoned by safe_step)."""
    n, m = torch_get_system(case)[0].n, torch_get_system(case)[0].m
    x = rng.uniform(-2.5, 2.5, (12, n))
    u = rng.standard_normal((12, m))
    x[:4, 2] = rng.uniform(-20.0, 20.0, 4)
    x[5] = 1e7
    return x, u


@pytest.mark.parametrize("case", NEW)
def test_model_dynamics_match_jax(case):
    js, _ = jax_get_system(case)
    ts, _ = torch_get_system(case)
    x, u = _states(case, np.random.default_rng(60))
    xj, uj = jnp.asarray(x), jnp.asarray(u)
    for fj, ft in ((js.xdot, ts.xdot), (js.step, ts.step), (js.safe_step, ts.safe_step)):
        want = np.asarray(jax.vmap(fj)(xj, uj))
        got = ft(T(x), T(u)).numpy()
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)
    assert np.isnan(ts.safe_step(T(x), T(u)).numpy()[5]).all()
    assert (ts.wrap_idx == (2,)) == (case != PM) and ts.device_id is not None


def test_extra_cost_terms_match_jax():
    js, _ = jax_get_system(PM)
    ts, _ = torch_get_system(PM)
    rng = np.random.default_rng(61)
    X = rng.uniform(-2.0, 2.0, (3, 7, 4))
    U = rng.standard_normal((3, 7, 2))
    want = jax.vmap(lambda x, u: jcost.extra_cost_terms(js, x, u))(jnp.asarray(X), jnp.asarray(U))
    got = tcost.extra_cost_terms(ts, T(X), T(U))
    for g, w, name in zip(got, want, ("c", "cx", "cxx")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12, atol=0, err_msg=name)
    assert tcost.extra_cost_terms(torch_get_system("Quadrotor")[0], T(X), T(U)) is None


def _blocks(seed=62, N=40, t_min=10):
    js, ts, jp, tp = problems(PM, 3, N, t_min, N, seed=seed)
    X, U, A, Bm = iterate(js, jp, seed=seed + 1)
    jb = jax.vmap(lambda p, x, u, a, b: jaug.build_augmented(js, p, x, u, a, b, q_reg=1e-9, psd_levels=1))(
        jp, *(jnp.asarray(v) for v in (X, U, A, Bm))
    )
    jC = jax.vmap(lambda p, x, s: jaug.build_terminal_factors(p, x, s=s))(jp, jnp.asarray(X), jb.s)
    tb = taug.build_augmented(ts, tp, T(X), T(U), T(A), T(Bm), q_reg=1e-9, psd_levels=1)
    tC = taug.build_terminal_factors(tp, T(X), s=tb.s)
    return tp, (jb, jC), (tb, tC)


def test_build_augmented_and_terminal_factors_match_jax():
    _, (jb, jC), (tb, tC) = _blocks()
    for name in tb._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                   rtol=1e-12, atol=1e-14, err_msg=name)
    np.testing.assert_allclose(tC.numpy(), np.asarray(jC), rtol=1e-12, atol=1e-14)
    ts = torch_get_system(PM)[0]
    with pytest.raises(ValueError, match="build_augmented"):
        taug.build_fused_inputs(ts, None, None, None, None, None)


def test_select_generic_plain_matches_jax():
    tp, (jb, jC), (tb, tC) = _blocks()
    t_min, t_max = tp.T_min, tp.T_max
    J_jax = np.asarray(jax.vmap(jhor._make_select_cv(t_min))(jb.A_aug, jb.B_aug, jb.Q_aug, jb.R_inv, jC))
    args = [t.contiguous() for t in (tb.A_aug, tb.B_aug, tb.Q_aug, tb.R_inv, tC)]
    launches = cuda_lft_generic.LAUNCHES
    J = thor.propagator_select_generic(*args, t_min).numpy()
    assert cuda_lft_generic.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(J[:, t_min - 1 :], J_jax[:, t_min - 1 :], rtol=1e-9)
    s0 = tb.s[:, :1].numpy() ** 2
    T_port = argmin_T(T(s0 * J), t_min, t_max).numpy()
    T_jax = np.asarray(jax.vmap(lambda c: jax_argmin_T(c, t_min, t_max))(jnp.asarray(s0 * J_jax)))
    np.testing.assert_array_equal(T_port, T_jax)


def test_generic_select_equals_fused_without_extra_cost():
    js, ts, jp, tp = problems("Quadrotor", 2, 32, 8, 32, seed=64)
    X, U, A, Bm = (T(v) for v in iterate(js, jp, seed=65))
    fi = taug.build_fused_inputs(ts, tp, X, U, A, Bm, q_reg=1e-9, psd_levels=1)
    J_f = thor.select_fused_plain(fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)
    blk = taug.build_augmented(ts, tp, X, U, A, Bm, q_reg=1e-9, psd_levels=1)
    J_g = thor.select_generic_plain(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, taug.build_terminal_factors(tp, X, s=blk.s))
    torch.testing.assert_close(blk.s, fi.s, rtol=0, atol=0)
    np.testing.assert_allclose(J_g[:, 7:].numpy(), J_f[:, 7:].numpy(), rtol=1e-9)


def test_pallas_generic_kernel_interpret_matches_port():
    """The JAX Pallas generic kernel (rows #7/#8 of PERF.md), as
    tests/test_pallas_lft.py runs it on the CPU: B=8 random LTV problems,
    N=6, float32 blocks; the port's plain version gets the same blocks in
    float64."""
    from timeopt_tpu.ops.pallas_lft import propagator_select_lanes_df

    rng = np.random.default_rng(66)
    blocks = []
    for i in range(8):
        step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=3, m=2, N=6)
        system = JaxSystem(name=f"ltv{i}", n=3, m=2, dt=0.1, step=step)
        f32 = jax.tree.map(lambda x: x.astype(jnp.float32) if jnp.issubdtype(x.dtype, jnp.floating) else x, prob)
        Xj, Uj = jnp.asarray(X, jnp.float32), jnp.asarray(U, jnp.float32)
        A = jnp.broadcast_to(jnp.asarray(Ad, jnp.float32), (6, 3, 3))
        Bm = jnp.broadcast_to(jnp.asarray(Bd, jnp.float32), (6, 3, 2))
        b = jaug.build_augmented(system, f32, Xj, Uj, A, Bm, psd_levels=1)
        blocks.append((b.A_aug, b.B_aug, b.Q_aug, b.R_inv, jaug.build_terminal_factors(f32, Xj, s=b.s)))
    args = [jnp.stack(x) for x in zip(*blocks)]
    J_df = np.asarray(propagator_select_lanes_df(*args, block_b=8, t_min=3, interpret=True))
    J = cuda_lft_generic.propagator_select_generic(*(T(np.asarray(a, np.float64)) for a in args), t_min=3).numpy()
    assert np.all(np.isinf(J_df[:, :2])) and np.all(np.isfinite(J))
    np.testing.assert_allclose(J_df[:, 2:], J[:, 2:], rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("case", [PM, "Cartpole_SwingUp"])
def test_solve_batch_matches_jax(case):
    js, ts, jp, tp = problems(case, 2, 40, 10, 40, seed=67)
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=3, psd_levels=1))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=3, psd_levels=1))
    assert_results_match(got, want, tp.T_min, curve=case == PM)
    assert got.n_accept.min() >= 1
