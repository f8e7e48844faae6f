"""Parity of the port's truncated backward pass (solver/backward.py, the plain
version behind ops/cuda_backward.py) with the JAX reference in f64 on the
CPU: T* at 1, mid-horizon and N, a lambda that makes Quu_reg indefinite,
a non-finite terminal error, and PointMass's extra stage cost (its
gradient and Hessian enter lx and Qstage).

Tolerance: kappa and K within rtol 1e-9 / atol 1e-12 (the Riccati recursion
compounds the different operation order over up to N steps); the ok flags
are identical.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.solver import backward as jback
from timeopt_tpu_torch.ops import cuda_backward
from timeopt_tpu_torch.solver import backward as tback

torch.set_num_threads(1)
N = 24


@pytest.mark.parametrize(
    "case,variant",
    [
        ("Quadrotor", "T1"), ("Quadrotor", "Tmid"), ("Quadrotor", "TN"),
        ("Quadrotor", "nonpd"), ("Quadrotor", "nonfinite_eT"), ("DoubleIntegrator", "Tmid"),
        ("Cartpole_SwingUp", "Tmid"), ("PointMass_Navigation", "Tmid"),
    ],
)
def test_backward_matches_jax(case, variant):
    js, ts, jp, tp = problems(case, 3, N, 4, N, seed=20)
    X, U, A, Bm = iterate(js, jp, seed=21)
    Tst = {"T1": [1, 1, 1], "TN": [N, N, N]}.get(variant, [N // 2, 7, N - 3])
    Tst = np.asarray(Tst)
    lm = np.full(3, 1e-3)
    if variant == "nonpd":
        lm[0] = -1e4  # Quu + lambda I indefinite: the PD test must fail
    if variant == "nonfinite_eT":
        X = X.copy()
        X[1, Tst[1], 2] = np.nan  # terminal error at x_{T*} is NaN
    kj, Kj, okj = jax.vmap(
        lambda p, a, b, x, u, t, l: jback.backward_truncated(js, p, a, b, x, u, t, l)
    )(jp, *(jnp.asarray(v) for v in (A, Bm, X, U, Tst, lm)))
    launches = cuda_backward.LAUNCHES
    res = tback.backward_truncated(ts, tp, T(A), T(Bm), T(X), T(U), T(Tst), T(lm))
    assert cuda_backward.LAUNCHES == launches
    np.testing.assert_array_equal(res.ok.numpy(), np.asarray(okj))
    np.testing.assert_allclose(res.kappa.numpy(), np.asarray(kj), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(res.K.numpy(), np.asarray(Kj), rtol=1e-9, atol=1e-12)
    # zero gains from T* on
    for b, t in enumerate(Tst):
        assert not res.kappa[b, t:].any() and not res.K[b, t:].any()
    if variant in ("nonpd", "nonfinite_eT"):
        bad = 0 if variant == "nonpd" else 1
        assert not bool(res.ok[bad]) and bool(res.ok.sum() == 2)
    else:
        assert bool(res.ok.all())


def test_backward_T_star_zero_is_not_ok():
    js, ts, jp, tp = problems("DoubleIntegrator", 2, N, 4, N, seed=22)
    X, U, A, Bm = iterate(js, jp, seed=23)
    res = tback.backward_truncated(ts, tp, T(A), T(Bm), T(X), T(U), T(np.array([0, 5])), T(np.full(2, 1e-3)))
    assert res.ok.tolist() == [False, True]
    assert not res.kappa[0].any()
