"""Parity of the port's finite-difference linearization modes
(solver/linearize.py, "central" and "forward") with the JAX reference in
f64 on the CPU, on every system, atol 1e-12: the same stencils and
relative steps, so the Jacobians differ only by the steps' last-bit
differences divided by the step size. Forward mode poisons a step's A and
B with NaN where its base evaluation is not finite, as the reference does.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.solver.linearize import linearize as jax_linearize
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.linearize import linearize

torch.set_num_threads(1)
CASES = ("DoubleIntegrator", "Cartpole_SwingUp", "Quadrotor", "Segway_Balance", "Ballbot_Balance",
         "PointMass_Navigation")


def _fd_pair(case, mode, poison=False):
    js, ts, jp, tp = problems(case, 2, 12, 4, 12, seed=70)
    X, U, _, _ = iterate(js, jp, seed=71)
    if poison:
        X = X.copy()
        X[1, 5, 0] = np.nan  # the base evaluation of step 5 of problem 1 is NaN
    want = jax.vmap(lambda x, u: jax_linearize(js.step, x, u, mode))(X, U)
    got = linearize(ts.step, T(X), T(U), mode)
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("mode", ["central", "forward"])
@pytest.mark.parametrize("case", CASES)
def test_fd_jacobians_match_jax(case, mode):
    got, want = _fd_pair(case, mode)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["central", "forward"])
def test_nonfinite_base_matches_jax(mode):
    """Forward mode: NaN in every entry of the step's A and B; central mode
    carries the NaN through its stencil as the reference does."""
    got, want = _fd_pair("Quadrotor", mode, poison=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w))
        f = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[f], w[f], rtol=0, atol=1e-12)
    if mode == "forward":
        assert np.isnan(got[0][1, 5].numpy()).all() and np.isnan(got[1][1, 5].numpy()).all()
        assert np.isfinite(got[0][0].numpy()).all()


def test_solve_with_central_diff_matches_ad_closely():
    """The runner's --use-central-diff path: a solve with FD Jacobians picks
    the same horizons as one with AD Jacobians on the double integrator
    (linear dynamics: FD is exact up to rounding)."""
    _, ts, _, tp = problems("DoubleIntegrator", 2, 30, 8, 24, seed=72)
    ad = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=4))
    fd = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=4, linearize_mode="central"))
    assert torch.equal(ad.T_star, fd.T_star)
    np.testing.assert_allclose(fd.J_star.numpy(), ad.J_star.numpy(), rtol=1e-8)
