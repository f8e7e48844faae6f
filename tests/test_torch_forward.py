"""Parity of the port's all-alphas line search (solver/forward.py, the plain
version behind ops/cuda_forward.py) with the JAX reference in f64 on the
CPU. Gains come from the JAX backward pass; scaling the feedforward gain
makes the large alphas diverge (the quadrotor guard poisons them) so that
only the last alpha improves, or no alpha improves at all. PointMass's cost
includes its extra stage cost.

Tolerance: X, U and J within rtol 1e-10 (a rollout compounds rounding over
N steps; both run the same float64 operations); `accepted` is identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.solver import backward as jback
from timeopt_tpu.solver import forward as jfw
from timeopt_tpu_torch.ops import cuda_forward
from timeopt_tpu_torch.solver import forward as tfw

torch.set_num_threads(1)
N = 24
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.05)


@pytest.mark.parametrize(
    "case,kappa_scale",
    [("Quadrotor", 1.0), ("Quadrotor", 30.0), ("Quadrotor", 1e6), ("DoubleIntegrator", 1.0),
     ("Cartpole_SwingUp", 1.0), ("PointMass_Navigation", 1.0)],
    ids=["quadrotor", "quadrotor_diverging", "quadrotor_none_improves", "double_integrator", "cartpole",
         "pointmass"],
)
def test_linesearch_matches_jax(case, kappa_scale):
    js, ts, jp, tp = problems(case, 3, N, 4, N, seed=30)
    X, U, A, Bm = iterate(js, jp, seed=31)
    Tst = np.array([12, 7, 20])
    lm = np.full(3, 1e-3)
    kj, Kj, _ = jax.vmap(
        lambda p, a, b, x, u, t, l: jback.backward_truncated(js, p, a, b, x, u, t, l)
    )(jp, *(jnp.asarray(v) for v in (A, Bm, X, U, Tst, lm)))
    kap = np.asarray(kj) * kappa_scale
    K = np.asarray(Kj)
    want = jax.vmap(
        lambda p, x, u, k, kp, t: jfw.forward_linesearch(js, p, x, u, k, kp, t, alphas=ALPHAS)
    )(jp, *(jnp.asarray(v) for v in (X, U, K, kap, Tst)))
    launches = cuda_forward.LAUNCHES
    got = tfw.forward_linesearch(ts, tp, T(X), T(U), T(K), T(kap), T(Tst), alphas=ALPHAS)
    assert cuda_forward.LAUNCHES == launches
    np.testing.assert_array_equal(got.accepted.numpy(), np.asarray(want.accepted))
    for name in ("X", "U", "J"):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=1e-10, atol=1e-12, err_msg=name
        )

    _, _, Js = tfw.linesearch_plain(ts, tp, T(X), T(U), T(K), T(kap), T(Tst), ALPHAS)
    if kappa_scale == 30.0:
        # problem 2: the three largest alphas diverge, the last one improves
        assert torch.isinf(Js[2, :3]).all() and bool(got.accepted[2])
        assert not bool(got.accepted[0])
    if kappa_scale == 1e6:
        assert torch.isinf(Js).all() and not got.accepted.any()
        np.testing.assert_array_equal(got.X.numpy(), X)


def test_select_first_improving_never_leaks_nan():
    X = torch.zeros((2, 3, 1), dtype=torch.float64)
    U = torch.zeros((2, 2, 1), dtype=torch.float64)
    Xs = torch.stack([torch.full((3, 1), float("nan")), torch.ones(3, 1)])[None].expand(2, -1, -1, -1)
    Us = torch.ones((2, 2, 2, 1), dtype=torch.float64)
    Js = torch.tensor([[float("inf"), 1.0], [float("inf"), 9.0]], dtype=torch.float64)
    res = tfw.select_first_improving(X, U, Xs.double(), Us, Js, torch.tensor([5.0, 5.0], dtype=torch.float64))
    assert res.accepted.tolist() == [True, False]
    assert torch.isfinite(res.X).all()
    assert res.J.tolist() == [1.0, 5.0]
