"""Parity of the PyTorch port's base layers with the JAX reference (f64, CPU):
angle wrap, small-matrix linear algebra, the two ported models (step,
guard, AD Jacobians), the cost functions and the fused select inputs.

Tolerances: rtol 1e-12 where both packages run the same operations in the
same order (wrap, linalg, dynamics, costs); rtol 1e-10 for AD Jacobians,
whose tangent arithmetic is ordered by each framework's AD rules.
"""

from __future__ import annotations

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.models import get_system as jax_get_system
from timeopt_tpu.ops import linalg as jla
from timeopt_tpu.ops import wrap as jwrap
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import cost as jcost
from timeopt_tpu.solver.linearize import linearize_ad as jax_linearize_ad
from timeopt_tpu_torch.models import get_system as torch_get_system
from timeopt_tpu_torch.models import make_problem
from timeopt_tpu_torch.ops import linalg as tla
from timeopt_tpu_torch.ops import wrap as twrap
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import cost as tcost
from timeopt_tpu_torch.solver.linearize import linearize_ad as torch_linearize_ad

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_angle_wrap_matches_jax():
    rng = np.random.default_rng(1)
    a = np.concatenate([rng.uniform(-40, 40, 200), [-np.pi, np.pi, 0.0, -3 * np.pi, 7.5]])
    np.testing.assert_allclose(
        twrap.angle_normalize(T(a)).numpy(), np.asarray(jwrap.angle_normalize(jnp.asarray(a))),
        rtol=1e-12, atol=0,
    )
    e = rng.uniform(-10, 10, (7, 5))
    mask = jwrap.wrap_mask_from_idx((1, 3), 5)
    np.testing.assert_array_equal(mask, twrap.wrap_mask_from_idx((1, 3), 5))
    np.testing.assert_allclose(
        twrap.wrap_error(T(e), T(mask)).numpy(),
        np.asarray(jwrap.wrap_error(jnp.asarray(e), mask)), rtol=1e-12, atol=0,
    )


def _spd(rng, batch, n, cond=10.0):
    G = rng.standard_normal(batch + (n, n))
    return G @ np.swapaxes(G, -1, -2) + cond ** -1 * n * np.eye(n)


@pytest.mark.parametrize(
    "name",
    ["sym", "gj_inv_pivots", "gj_solve_mat", "gj_solve_vec", "psd_inv_1", "psd_inv_2_singular",
     "psd_solve", "spd_check", "chol_lower"],
)
def test_linalg_matches_jax(name):
    rng = np.random.default_rng(2)
    A = _spd(rng, (3, 4), 5)
    Bm = rng.standard_normal((3, 4, 5, 2))
    if name == "sym":
        M = rng.standard_normal((4, 6, 6))
        pairs = [(tla.sym(T(M)), jla.sym(jnp.asarray(M)))]
    elif name == "gj_inv_pivots":
        pairs = list(zip(tla.gj_inv_pivots(T(A)), jla.gj_inv_pivots(jnp.asarray(A))))
    elif name == "gj_solve_mat":
        pairs = [(tla.gj_solve(T(A), T(Bm)), jla.gj_solve(jnp.asarray(A), jnp.asarray(Bm)))]
    elif name == "gj_solve_vec":
        pairs = [(tla.gj_solve(T(A), T(Bm[..., 0])), jla.gj_solve(jnp.asarray(A), jnp.asarray(Bm[..., 0])))]
    elif name == "psd_inv_1":
        pairs = [(tla.psd_inv(T(A), levels=1), jla.psd_inv(jnp.asarray(A), levels=1))]
    elif name == "psd_inv_2_singular":
        # a zero pivot makes rung 0 non-finite: the second rung is selected
        S = A.copy()
        S[0, 0] = 0.0
        pairs = [(tla.psd_inv(T(S), jitter=0.0, levels=2), jla.psd_inv(jnp.asarray(S), jitter=0.0, levels=2))]
    elif name == "psd_solve":
        pairs = [(tla.psd_solve(T(A), T(Bm)), jla.psd_solve(jnp.asarray(A), jnp.asarray(Bm)))]
    elif name == "spd_check":
        M = A.copy()
        M[1, 2] -= 50.0 * np.eye(5)  # indefinite
        M[2, 1, 0, 0] = np.nan
        pairs = [(tla.spd_check(T(M)), jla.spd_check(jnp.asarray(M)))]
        assert not bool(pairs[0][0].all())
    else:
        pairs = [(tla.chol_lower(T(A)), jla.chol_lower(jnp.asarray(A)))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    np.testing.assert_array_equal(tla.as_terminal_weight(300.0, 4), jla.as_terminal_weight(300.0, 4))


def _quad_states(rng):
    """Random quadrotor (x, u) plus states that trip each guard clause."""
    x = rng.standard_normal((10, 12)) * 0.5
    u = rng.standard_normal((10, 4)) + np.array([9.81, 0, 0, 0])
    x[1, 7] = np.pi / 2  # |cos(theta)| < 1e-3
    x[2, 10] = 2e3  # |omega| > 1e3
    x[3, 0] = 2e6  # ||x|| > 1e6
    x[4, 5] = np.nan  # non-finite state
    u[5, 2] = np.inf  # non-finite control
    x[6, 7] = -np.pi / 2 + 5e-4  # just inside the singular band
    return x, u


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator"])
def test_step_and_guard_match_jax(case):
    js, _ = jax_get_system(case)
    ts, _ = torch_get_system(case)
    rng = np.random.default_rng(3)
    if case == "Quadrotor":
        x, u = _quad_states(rng)
        gj = np.asarray(jax.vmap(js.guard)(jnp.asarray(x), jnp.asarray(u)))
        gt = ts.guard(T(x), T(u)).numpy()
        np.testing.assert_array_equal(gt, gj)
        assert gt[1:7].all() and not gt[0] and not gt[7:].any()
    else:
        x, u = rng.standard_normal((10, 2)), rng.standard_normal((10, 1))
    want = np.asarray(jax.vmap(js.step)(jnp.asarray(x), jnp.asarray(u)))
    got = ts.step(T(x), T(u)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15)
    wx = np.asarray(jax.vmap(js.xdot)(jnp.asarray(x), jnp.asarray(u)))
    ok = np.isfinite(wx)
    np.testing.assert_allclose(ts.xdot(T(x), T(u)).numpy()[ok], wx[ok], rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator", "Cartpole_SwingUp", "Segway_Balance",
                                  "Ballbot_Balance", "PointMass_Navigation"])
def test_ad_jacobians_match_jax(case):
    js, _ = jax_get_system(case)
    ts, _ = torch_get_system(case)
    rng = np.random.default_rng(4)
    if case == "Quadrotor":
        x, u = _quad_states(rng)
        keep = [0, 1, 2, 6, 7, 8, 9]  # finite inputs, guarded ones included
        X = np.concatenate([x[keep], x[:1]], 0)[None]  # (1, N+1, n)
        U = u[keep][None]
    else:
        X, U = rng.standard_normal((1, 8, js.n)), rng.standard_normal((1, 7, js.m))
    Aj, Bj = jax_linearize_ad(js.step, jnp.asarray(X[0]), jnp.asarray(U[0]))
    At, Bt = torch_linearize_ad(ts.step, T(X), T(U))
    assert torch.isfinite(At).all() and torch.isfinite(Bt).all()
    np.testing.assert_allclose(At[0].numpy(), np.asarray(Aj), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(Bt[0].numpy(), np.asarray(Bj), rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator", "Cartpole_SwingUp", "PointMass_Navigation"])
def test_costs_match_jax(case):
    N = 24
    js, ts, jp, tp = problems(case, 4, N, 6, N, seed=5)
    X, U, _, _ = iterate(js, jp, seed=6)
    X = X.copy()
    X[3, 10, 0] = np.nan  # poisoned state inside the window of some T*
    Tst = np.array([0, 7, N, 12])

    Xr = jax.vmap(lambda p, u: jcost.rollout(js, p, p.x0, u))(jp, jnp.asarray(U))
    np.testing.assert_allclose(tcost.rollout(ts, tp, tp.x0, T(U)).numpy(), np.asarray(Xr), rtol=1e-12, atol=1e-15)
    l_j = jax.vmap(lambda p, x, u: jcost.stage_costs(js, p, x, u))(jp, jnp.asarray(X), jnp.asarray(U))
    np.testing.assert_allclose(tcost.stage_costs(ts, tp, T(X), T(U)).numpy(), np.asarray(l_j), rtol=1e-12)
    c_j = jax.vmap(lambda p, x, u, t: jcost.cost_true(js, p, x, u, t))(
        jp, jnp.asarray(X), jnp.asarray(U), jnp.asarray(Tst)
    )
    c_t = tcost.cost_true(ts, tp, T(X), T(U), T(Tst)).numpy()
    np.testing.assert_array_equal(np.isinf(c_t), np.isinf(np.asarray(c_j)))
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-12)
    assert np.isinf(c_t[0]) and np.isinf(c_t[3]) and np.isfinite(c_t[1])


def test_argmin_T_first_minimum_like_jax():
    curves = np.array([
        [9.0, 3.0, np.nan, 1.0, 1.0, 2.0],
        [9.0, 5.0, 4.0, 4.0, 4.0, 7.0],
        [np.inf, 1.0, 2.0, 0.5, 0.5, 0.5],
        [3.0, np.inf, np.inf, np.inf, np.inf, np.inf],
    ])
    for T_min, T_max in ((1, 6), (2, 5), (4, 6)):
        want = [int(jcost.argmin_T(jnp.asarray(c), T_min, T_max)) for c in curves]
        got = tcost.argmin_T(T(curves), T_min, T_max).tolist()
        assert got == want


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator"])
def test_fused_inputs_match_jax(case):
    N = 24
    js, ts, jp, tp = problems(case, 3, N, 6, N, seed=7)
    X, U, A, Bm = iterate(js, jp, seed=8)
    fj = jax.vmap(
        lambda p, x, u, a, b: jaug.build_fused_inputs(js, p, x, u, a, b, q_reg=1e-9, psd_levels=1)
    )(jp, *(jnp.asarray(v) for v in (X, U, A, Bm)))
    ft = taug.build_fused_inputs(ts, tp, T(X), T(U), T(A), T(Bm), q_reg=1e-9, psd_levels=1)
    for name in ft._fields:
        np.testing.assert_allclose(
            getattr(ft, name).numpy(), np.asarray(getattr(fj, name)), rtol=1e-12, atol=1e-14, err_msg=name
        )


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator", "Cartpole_SwingUp", "Segway_Balance",
                                  "Ballbot_Balance", "PointMass_Navigation"])
def test_default_problem_matches_jax(case):
    _, jmk = jax_get_system(case)
    _, tmk = torch_get_system(case)
    jp, tp = jmk(dtype=jnp.float64), tmk(device="cpu")
    assert (tp.N, tp.T_min, tp.T_max) == (jp.N, jp.T_min, jp.T_max)
    for f, t in tp.tensors().items():
        np.testing.assert_array_equal(t[0].numpy(), np.asarray(getattr(jp, f)), err_msg=f)


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator", "PointMass_Navigation"])
def test_problems_default_to_the_card(case):
    """default_problem() and make_problem() build on the card unless the
    caller passes device="cpu"; with no card they raise, nothing falls back."""
    _, mk = torch_get_system(case)
    tp = mk(device="cpu")
    kw = dict(x0=tp.x0[0].numpy(), xg=tp.xg[0].numpy(), u_ref=tp.u_ref[0].numpy(), Q=tp.Q[0].numpy(),
              R=tp.R[0].numpy(), alpha=1.0, w=float(tp.w[0]), N=tp.N, T_min=tp.T_min, T_max=tp.T_max)
    if torch.cuda.is_available():
        for p in (mk(), make_problem(**kw)):
            assert all(t.device.type == "cuda" for t in p.tensors().values())
    else:
        for build in (mk, lambda: make_problem(**kw)):
            with pytest.raises((RuntimeError, AssertionError)):
                build()
    assert all(t.device.type == "cpu" for t in make_problem(**kw, device="cpu").tensors().values())


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py with everything its
    phases import, loads without JAX."""
    code = (
        "import importlib, pkgutil, sys, timeopt_tpu_torch\n"
        "for m in pkgutil.walk_packages(timeopt_tpu_torch.__path__, 'timeopt_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import timeopt_tpu_torch.runner.run_suite, timeopt_tpu_torch.solver.verify\n"
        "import timeopt_tpu_torch.ops.cuda_lft_scan, timeopt_tpu_torch.ops.cuda_lft_query, timeopt_tpu_torch.models\n"
        "import chip_smoke\n"
        "chip_smoke._counted()\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
