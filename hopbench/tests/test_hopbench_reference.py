"""The benchmark's plain reference (hopbench/reference/) held to the paper's
reference formulas and, as a second witness, to the program, at small
sizes on the CPU.

    python -m pytest hopbench/tests/test_hopbench_reference.py -q
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from hopbench.reference import check, systems

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
F64 = torch.float64


def cfg(name: str) -> dict:
    return json.loads((CONFIGS / f"{name}.json").read_text())


def quad_xdot_np(x, u):
    """systems.py make_quadrotor's xdot, one state at a time in numpy: the
    rotation built as a product of three matrices, the cross product by
    np.cross, the inertia divided."""
    m, g, I, kv, kw = 1.0, 9.81, np.array([0.02, 0.02, 0.04]), 0.05, 0.01
    ph, th, ps = x[6:9]
    Rz = np.array([[np.cos(ps), -np.sin(ps), 0], [np.sin(ps), np.cos(ps), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(ph), -np.sin(ph)], [0, np.sin(ph), np.cos(ph)]])
    acc = Rz @ Ry @ Rx @ np.array([0, 0, u[0] / m]) - np.array([0, 0, g]) - kv * x[3:6]
    W = np.array([[1, np.sin(ph) * np.tan(th), np.cos(ph) * np.tan(th)],
                  [0, np.cos(ph), -np.sin(ph)],
                  [0, np.sin(ph) / np.cos(th), np.cos(ph) / np.cos(th)]])
    om = x[9:12]
    omd = (u[1:4] - np.cross(om, I * om)) / I - kw * om
    return np.concatenate([x[3:6], acc, W @ om, omd])


def obstacle_np(p):
    """systems.py make_pointmass_navigation's penalty and its hand-derived
    gradient and Hessian in the position, one state at a time."""
    c, gr, H = 0.0, np.zeros(2), np.zeros((2, 2))
    for ox, oy, r, w in ((-1.0, -0.5, 0.65, 6.0), (0.0, 0.2, 0.70, 6.0), (1.0, 1.0, 0.65, 6.0)):
        d = p - np.array([ox, oy])
        e = w * np.exp(-d @ d / (2 * r * r))
        c += e
        gr += -e * d / r**2
        H += e * (np.outer(d, d) / r**4 - np.eye(2) / r**2)
    return c, gr, H


def random_states(rng, B, n, scale):
    return torch.as_tensor(rng.standard_normal((B, n)) * scale)


def test_quadrotor_xdot_matches_reference_formulas():
    rng = np.random.default_rng(0)
    x = random_states(rng, 64, 12, 0.5)
    u = torch.as_tensor(rng.standard_normal((64, 4)) + [9.81, 0, 0, 0])
    got = systems.Quadrotor.xdot(x, u).numpy()
    want = np.stack([quad_xdot_np(xi, ui) for xi, ui in zip(x.numpy(), u.numpy())])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_quadrotor_xdot_matches_program():
    from timeopt_tpu_torch.models import quadrotor

    rng = np.random.default_rng(1)
    x = random_states(rng, 64, 12, 0.5)
    u = torch.as_tensor(rng.standard_normal((64, 4)) + [9.81, 0, 0, 0])
    np.testing.assert_allclose(systems.Quadrotor.xdot(x, u).numpy(), quadrotor.xdot(x, u).numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", ["cos_pitch", "omega", "norm", "nonfinite_x", "nonfinite_u"])
def test_quadrotor_guard_poisons_the_next_state(case):
    x = torch.zeros(1, 12, dtype=F64)
    u = torch.tensor([[9.81, 0, 0, 0]], dtype=F64)
    if case == "cos_pitch":
        x[0, 7] = np.pi / 2 - 1e-4
    elif case == "omega":
        x[0, 10] = 1.5e3
    elif case == "norm":
        x[0, 0] = 2e6
    elif case == "nonfinite_x":
        x[0, 3] = float("inf")
    else:
        u[0, 1] = float("nan")
    nxt = systems.step(systems.Quadrotor, x, u, 0.05)
    assert torch.isnan(nxt).all()
    hover = torch.tensor([[9.81, 0, 0, 0]], dtype=F64)
    assert torch.isfinite(systems.step(systems.Quadrotor, torch.zeros(1, 12, dtype=F64), hover, 0.05)).all()


def test_quadrotor_step_matches_program():
    from timeopt_tpu_torch.models import quadrotor

    rng = np.random.default_rng(2)
    x = random_states(rng, 32, 12, 0.5)
    x[0, 7] = np.pi / 2  # a guarded state: NaN on both sides
    u = torch.as_tensor(rng.standard_normal((32, 4)) + [9.81, 0, 0, 0])
    got, want = systems.step(systems.Quadrotor, x, u, 0.05), quadrotor.step(x, u)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    np.testing.assert_allclose(got[1:].numpy(), want[1:].numpy(), rtol=1e-13, atol=1e-13)


def test_pointmass_dynamics_and_obstacle_cost():
    rng = np.random.default_rng(3)
    x = random_states(rng, 50, 4, 1.0)
    u = torch.as_tensor(rng.standard_normal((50, 2)))
    np.testing.assert_array_equal(systems.PointMass.xdot(x, u).numpy(),
                                  np.concatenate([x[:, 2:].numpy(), u.numpy()], axis=1))
    c, cx, cxx = systems.PointMass.extra_cost(x)
    for i in range(50):
        cw, gw, Hw = obstacle_np(x[i, :2].numpy())
        np.testing.assert_allclose(c[i].item(), cw, rtol=1e-13)
        np.testing.assert_allclose(cx[i, :2].numpy(), gw, rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(cxx[i, :2, :2].numpy(), Hw, rtol=1e-12, atol=1e-14)
    assert not cx[:, 2:].any() and not cxx[:, 2:].any() and not cxx[:, :, 2:].any()


def test_pointmass_obstacle_cost_matches_program_autodiff():
    from timeopt_tpu_torch.models import pointmass
    from timeopt_tpu_torch.solver.cost import extra_cost_terms

    rng = np.random.default_rng(4)
    X = torch.as_tensor(rng.standard_normal((3, 9, 4)))
    U = torch.as_tensor(rng.standard_normal((3, 8, 2)))
    c, cx, cxx = extra_cost_terms(pointmass.SYSTEM, X[:, :-1], U)
    rc, rcx, rcxx = systems.PointMass.extra_cost(X[:, :-1])
    for a, b in ((rc, c), (rcx, cx), (rcxx, cxx)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-12, atol=1e-14)


def program_problem(name: str, B: int, rng):
    from hopbench import problems

    conf = cfg(name)
    conf["dtype"] = "float64"
    prob = problems.pool(conf, 1, B, int(rng.integers(1 << 40)), torch.device("cpu"))[0]
    return conf, prob


@pytest.mark.parametrize("name", ["quadrotor-n160-f32", "pointmass-n240-f32"])
def test_cost_matches_program_cost_true(name):
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.cost import cost_true, rollout

    rng = np.random.default_rng(5)
    conf, prob = program_problem(name, 6, rng)
    system, _ = get_system(conf["program_system"])
    dep = check.Deployment(conf, F64, "cpu")
    U = prob.u_ref[:, None].expand(-1, prob.N, -1) + 0.05 * torch.as_tensor(rng.standard_normal((6, prob.N, prob.m)))
    X = dep.rollout(prob.x0, U)
    np.testing.assert_allclose(X.numpy(), rollout(system, prob, prob.x0, U).numpy(), rtol=1e-12, atol=1e-12)
    T = torch.as_tensor(rng.integers(prob.T_min, prob.T_max + 1, 6))
    np.testing.assert_allclose(dep.cost(X, U, T).numpy(), cost_true(system, prob, X, U, T).numpy(), rtol=1e-12)


@pytest.mark.parametrize("name", ["quadrotor-n160-f32", "pointmass-n240-f32"])
def test_curve_matches_program_brute_force(name):
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.horizon import bruteforce_J_curve
    from timeopt_tpu_torch.solver.linearize import linearize

    rng = np.random.default_rng(6)
    conf, prob = program_problem(name, 3, rng)
    conf.update(N=48, T_min=10, T_max=40)
    prob = prob.replace(N=48, T_min=10, T_max=40)
    system, _ = get_system(conf["program_system"])
    dep = check.Deployment(conf, F64, "cpu")
    U = prob.u_ref[:, None].expand(-1, prob.N, -1) + 0.05 * torch.as_tensor(rng.standard_normal((3, prob.N, prob.m)))
    X = dep.rollout(prob.x0, U)
    A, Bj = linearize(system.step, X, U)
    rA, rB = dep.jacobians(X, U)
    np.testing.assert_allclose(rA.numpy(), A.numpy(), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rB.numpy(), Bj.numpy(), rtol=1e-12, atol=1e-12)
    Tm = prob.T_max
    want = bruteforce_J_curve(system, prob, A[:, :Tm], Bj[:, :Tm], X[:, : Tm + 1], U[:, :Tm])
    # the program's brute force adds its solve's 1e-9 jitter to lambda = 1e-6
    np.testing.assert_allclose(dep.curve(X, U, lam=1e-6 + 1e-9).numpy(), want.numpy(), rtol=1e-9)


def test_half_spacing_is_half_a_float32_ulp():
    a = torch.tensor([1.0, 1.5, 400.0, 1000.0], dtype=F64)
    want = np.spacing(a.numpy().astype(np.float32)).astype(np.float64) / 2
    np.testing.assert_array_equal(check.half_spacing(a, torch.float32).numpy(), want)


def test_judge_reads_exact_answers_as_exact_and_catches_an_altered_horizon():
    rng = np.random.default_rng(7)
    conf = cfg("quadrotor-n160-f32")
    conf.update(N=30, T_min=5, T_max=30)
    dep = check.Deployment(conf, F64, "cpu")
    x0 = torch.as_tensor(conf["x0"], dtype=F64) + 0.4 * torch.as_tensor(rng.standard_normal((4, 12))) * torch.as_tensor(
        conf["sigma_x0"], dtype=F64)
    U = dep.u_ref.expand(4, 30, 4).clone()
    X = dep.rollout(x0, U)
    T = dep.argmin(dep.curve(X, U))
    J = dep.cost(X, U, T)
    r = check.worst(check.judge(dep, x0, T, J, U))
    assert r["cost_gap"] == 0.0 and r["horizon_excess"] == 0.0 and r["nonfinite"] == 0
    # the start's own controls are no descent at all
    assert r["descent_left"] == float("inf") and r["descent_left_median"] == float("inf")
    r = check.worst(check.judge(dep, x0, torch.where(T + 3 <= 30, T + 3, T - 3), J, U))
    assert r["cost_gap"] > 1e-6
    r = check.worst(check.judge(dep, x0, T, J.clone().fill_(float("inf")), U))
    assert r["nonfinite"] == 4


def test_costs_at_every_horizon_are_the_cost_at_each():
    rng = np.random.default_rng(8)
    conf = cfg("pointmass-n240-f32")
    conf.update(N=40, T_min=5, T_max=40)
    dep = check.Deployment(conf, F64, "cpu")
    x0 = torch.as_tensor(rng.standard_normal((3, 4)))
    U = 0.3 * torch.as_tensor(rng.standard_normal((3, 40, 2)))
    X = dep.rollout(x0, U)
    every = dep.costs(X, U)
    for T in (1, 5, 17, 40):
        np.testing.assert_allclose(every[:, T - 1].numpy(), dep.cost(X, U, torch.full((3,), T)).numpy(), rtol=1e-13)


@pytest.mark.parametrize("name", ["quadrotor-n160-f32", "pointmass-n240-f32"])
def test_the_convex_model_lies_below_the_cost_and_is_the_plain_curve_without_an_extra_cost(name):
    rng = np.random.default_rng(9)
    conf = cfg(name)
    conf.update(N=40, T_min=5, T_max=40)
    dep = check.Deployment(conf, F64, "cpu")
    x0 = torch.as_tensor(conf["x0"], dtype=F64) + torch.as_tensor(conf["sigma_x0"], dtype=F64) * torch.as_tensor(
        rng.standard_normal((4, dep.n)))
    U = dep.u_ref + 0.05 * torch.as_tensor(rng.standard_normal((4, 40, dep.m)))
    X = dep.rollout(x0, U)
    model = dep.curve(X, U, psd=True)
    assert (model <= dep.costs(X, U) + 1e-9).all()
    if name.startswith("quadrotor"):
        np.testing.assert_array_equal(model.numpy(), dep.curve(X, U).numpy())


def test_descent_left_is_near_zero_at_a_converged_solve_and_large_after_one_newton_step():
    """Newton steps at a fixed horizon by the reference's own model: one
    leaves a share of the descent, many leave none."""
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.parallel import solve_batch_resident
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    from hopbench import problems

    conf = cfg("quadrotor-n160-f32")
    conf.update(dtype="float64", N=60, T_min=20, T_max=60)
    prob = problems.pool(conf, 1, 4, 2**33 + 1, torch.device("cpu"))[0]
    system, _ = get_system(conf["program_system"])
    dep = check.Deployment(conf, F64, "cpu")
    left = {}
    for iters in (1, 15):
        res = solve_batch_resident(system, [prob], options=SolveOptions(max_iter=iters, psd_levels=1))[0]
        left[iters] = check.worst(check.judge(dep, prob.x0, res.T_star, res.J_star, res.U))["descent_left"]
    assert left[15] < 1e-3 < 1e-2 < left[1], left
