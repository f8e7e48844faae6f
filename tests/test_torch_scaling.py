"""The port's `homogeneous_scaling` option (SolveOptions) against the JAX
reference in f64 on the CPU.

With `homogeneous_scaling=False` the select's blocks take s = 1 everywhere,
as the reference's `scale=False` does: `build_augmented(scale=False)` and
`build_fused_inputs(scale=False)` must give the JAX package's blocks on the
same inputs within rtol 1e-12, and the unscaled solve must find the scaled
solve's horizon, with J* within rtol 1e-5 of it and of JAX's unscaled solve
(the tolerance of tests/test_solver_e2e.py::test_option_variants_agree), on
the tiny double integrator (fused select) and a short PointMass (generic
select).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_double_integrator
from tests.torch_helpers import T, iterate, problems, to_torch_problem
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import ilqr as tilqr

torch.set_num_threads(1)
PM = "PointMass_Navigation"


def _inputs(case, seed):
    js, ts, jp, tp = problems(case, 3, 24, 6, 24, seed=seed)
    X, U, A, Bm = iterate(js, jp, seed=seed + 1)
    return js, ts, jp, tp, (X, U, A, Bm)


@pytest.mark.parametrize("case", [PM, "Quadrotor"])
def test_build_augmented_unscaled_matches_jax(case):
    js, ts, jp, tp, xs = _inputs(case, 90)
    jb = jax.vmap(lambda p, x, u, a, b: jaug.build_augmented(js, p, x, u, a, b, q_reg=1e-9, psd_levels=1,
                                                              scale=False))(jp, *(jnp.asarray(v) for v in xs))
    tb = taug.build_augmented(ts, tp, *(T(v) for v in xs), q_reg=1e-9, psd_levels=1, scale=False)
    for name in tb._fields:
        np.testing.assert_allclose(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)), rtol=1e-12, atol=1e-14,
                                   err_msg=name)
    assert bool((tb.s == 1.0).all())
    # the scaled blocks differ: the option reaches them
    scaled = taug.build_augmented(ts, tp, *(T(v) for v in xs), q_reg=1e-9, psd_levels=1)
    assert not torch.equal(scaled.Q_aug, tb.Q_aug)


@pytest.mark.parametrize("case", ["Quadrotor", "Cartpole_SwingUp"])
def test_build_fused_inputs_unscaled_matches_jax(case):
    js, ts, jp, tp, xs = _inputs(case, 91)
    jf = jax.vmap(lambda p, x, u, a, b: jaug.build_fused_inputs(js, p, x, u, a, b, q_reg=1e-9, psd_levels=1,
                                                                 scale=False))(jp, *(jnp.asarray(v) for v in xs))
    tf = taug.build_fused_inputs(ts, tp, *(T(v) for v in xs), q_reg=1e-9, psd_levels=1, scale=False)
    for name in tf._fields:
        np.testing.assert_allclose(getattr(tf, name).numpy(), np.asarray(getattr(jf, name)), rtol=1e-12, atol=1e-14,
                                   err_msg=name)
    assert bool((tf.s == 1.0).all()) and bool((tf.scal[..., 1:] == 1.0).all())


def _tiny_di(B=3):
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(92)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp)


@pytest.mark.parametrize("case,terminal_mode", [("tiny_di", "factored"), ("tiny_di", "inverse"), (PM, "factored")])
def test_unscaled_solve_agrees(case, terminal_mode):
    """The torch variant of test_option_variants_agree: the unscaled solve
    finds the scaled solve's T*, and J* within rtol 1e-5 of the scaled
    solve's and of JAX's unscaled solve's."""
    if case == "tiny_di":
        js, ts, jp, tp = _tiny_di()
        max_iter = 6
    else:
        js, ts, jp, tp = problems(case, 2, 40, 10, 40, seed=93)
        max_iter = 3
    kw = dict(method="propagator", max_iter=max_iter, terminal_mode=terminal_mode)
    base = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(**kw))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(homogeneous_scaling=False, **kw))
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(homogeneous_scaling=False, **kw))
    np.testing.assert_array_equal(got.T_star.numpy(), base.T_star.numpy())
    np.testing.assert_array_equal(got.T_star.numpy(), np.asarray(want.T_star))
    np.testing.assert_allclose(got.J_star.numpy(), base.J_star.numpy(), rtol=1e-5)
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-5)
    assert bool(torch.isfinite(got.J_star).all())
