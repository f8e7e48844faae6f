"""End-to-end parity of the port's batched HOP-DDP solve (solver/ilqr.py, the
plain CPU path of all three phases) with the JAX reference in f64 on the
CPU, on the tiny double integrator (T_max < N, so the select window is
cut) and on a short quadrotor.

Tolerances: T*, n_accept and T_hist identical; J* within rtol 1e-8 and the
final X, U within atol 1e-7 (the phases' own ~1e-10 differences pass
through up to max_iter+1 accept decisions and rollouts).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_double_integrator
from tests.torch_helpers import T, assert_results_match, problems, to_torch_problem
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver import ilqr as tilqr

torch.set_num_threads(1)


def _tiny_di(B=3):
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(40)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp)


@pytest.mark.parametrize("case", ["tiny_di", "quadrotor"])
def test_solve_batch_matches_jax(case):
    if case == "tiny_di":
        js, ts, jp, tp = _tiny_di()
        max_iter = 6
    else:
        js, ts, jp, tp = problems("Quadrotor", 2, 40, 20, 40, seed=41)
        max_iter = 3
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=max_iter, psd_levels=1))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=max_iter, psd_levels=1))
    assert_results_match(got, want, tp.T_min)
    assert got.n_accept.min() >= 1


def test_solve_single_matches_jax():
    js, base = tiny_double_integrator()
    ts = get_system("DoubleIntegrator")[0]
    U0 = 0.1 * np.random.default_rng(42).standard_normal((10, 1))  # padded to N by _pad_U
    want = jilqr.solve(js, base, U_init=jnp.asarray(U0), options=jilqr.SolveOptions(max_iter=5))
    got = tilqr.solve(ts, to_torch_problem(jilqr.broadcast_problem(base, 1)), U_init=T(U0),
                      options=tilqr.SolveOptions(max_iter=5))
    assert got.X.shape == want.X.shape and got.T_ties.shape == want.T_ties.shape
    assert_results_match(got, want, base.T_min)


def test_early_exit_changes_no_result():
    _, ts, _, tp = _tiny_di()
    a = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=8, early_exit=True))
    b = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=8, early_exit=False))
    for f in ("X", "U", "T_star", "J_star", "J_hist", "T_hist", "n_accept", "lm_final"):
        assert torch.equal(getattr(a, f).nan_to_num(7.0), getattr(b, f).nan_to_num(7.0)), f


@pytest.mark.parametrize(
    "kw",
    [dict(method="onepass"), dict(scan_mode="associative"), dict(method="onepass", terminal_mode="inverse"),
     dict(scan_mode="associative", method="bruteforce")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_unported_options_raise(kw):
    """Every option here is ported now and solves. The one-pass method
    ignores terminal_mode and the brute force scan_mode, as the JAX package
    does, so their T* and J* are bitwise those of the plain method; the
    associative scan gives the sequential select's T* and its J* within
    rtol 1e-9 (a changed compose order). An unknown scan mode raises."""
    _, ts, _, tp = _tiny_di(B=1)
    opts = tilqr.SolveOptions(max_iter=1, **kw)
    res = tilqr.solve_batch(ts, tp, options=opts)
    assert bool(torch.isfinite(res.J_star).all()) and int(res.n_accept[0]) >= 1
    ref_kw = {k: v for k, v in kw.items() if k == "method"}
    ref = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=1, **ref_kw))
    assert torch.equal(res.T_star, ref.T_star)
    if "method" in kw:
        assert torch.equal(res.J_star, ref.J_star)
    else:
        np.testing.assert_allclose(res.J_star.numpy(), ref.J_star.numpy(), rtol=1e-9)
    with pytest.raises(ValueError, match="unknown scan_mode"):
        tilqr.solve_batch(ts, tp, options=dataclasses.replace(opts, scan_mode="tree"))


def test_problem_batching_helpers():
    js, base = tiny_double_integrator()
    one = to_torch_problem(jilqr.broadcast_problem(base, 1))
    four = tilqr.broadcast_problem(one, 4)
    assert four.batch == 4 and all(t.is_contiguous() for t in four.tensors().values())
    both = tilqr.stack_problems([one, four])
    assert both.batch == 5 and torch.equal(both.Q[0], both.Q[4])
    U = tilqr._pad_U(T(np.arange(3.0)), 5)
    assert U.shape == (5, 1) and U[:, 0].tolist() == [0.0, 1.0, 2.0, 2.0, 2.0]
    np.testing.assert_array_equal(
        tilqr.default_U_init(four).numpy(), np.broadcast_to(np.asarray(base.u_ref), (4, base.N, 1))
    )
