"""The 6-DoF powered-descent lander (models/rocket6dof.py, Rocket6DoF: 14
states, 3 inputs) on the CPU, against the benchmark's plain float64
reference of the same system (hopbench/reference/plain/Rocket6DoF.py,
written apart from the port), and the kernels' size limits.

- xdot and the guard on seeded random states and controls, with rows on
  each side of every guard (a NaN, an infinity, a mass below the dry mass,
  a thrust below the floor);
- the step's Jacobians (linearize_ad, the port's AD path, which the card's
  Jacobian kernel is held to) against autograd through the reference's
  step;
- a small solve_batch (B = 3, N = 160, T* inside [40, 160]) whose answers
  the reference judges (hopbench/reference/check.py): sound, its cost its
  controls' cost, its horizon the reference's;
- the initial rollout as one launch of the line-search kernel
  (solver/cost.py::rollout_kernel; off the card its plain version) bit for
  bit rollout's torch steps, poisoned rows included, and only the lander
  asking for it;
- the size tiers of the fused select and the backward pass, and each
  kernel wrapper's refusal of a size past its kernel's limit, raised before
  any launch (the card faked: the refusal comes before the library loads).

    python -m pytest tests/test_torch_rocket6dof.py -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from hopbench.reference import check
from hopbench.reference.systems import step as plain_step
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver.ilqr import SolveOptions, broadcast_problem, solve_batch
from timeopt_tpu_torch.solver.linearize import linearize_ad

torch.set_num_threads(1)
SYSTEM, MAKE = get_system("Rocket6DoF")
PLAIN = check.system("Rocket6DoF")


def _rows(seed: int, rows: int = 256):
    """Seeded (x, u) around the lander's envelope: masses from 1.2 to 2.4,
    unit-ish quaternions, rates and thrusts of a few units; then rows on and
    past each guard."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, 14))
    x[:, 0] = rng.uniform(1.2, 2.4, rows)
    x[:, 1:7] *= 3.0
    q = rng.standard_normal((rows, 4))
    x[:, 7:11] = q / np.linalg.norm(q, axis=1, keepdims=True)
    u = 2.0 * rng.standard_normal((rows, 3))
    u[:, 0] += 2.0
    x[0, 3], x[1, 12], u[2, 1], x[3, 0], u[4, 0] = np.nan, np.inf, np.nan, -np.inf, np.inf
    x[5, 0], x[6, 0] = 0.999, 1.0  # below the dry mass, on it
    u[7] = (1e-7, 0.0, 0.0)  # a thrust below the floor
    u[8] = (0.0, 0.0, 0.0)
    return torch.as_tensor(x), torch.as_tensor(u)


def test_sizes_and_registry():
    assert (SYSTEM.n, SYSTEM.m, SYSTEM.dt, SYSTEM.device_id, SYSTEM.step.device_id) == (14, 3, 0.05, 6, 6)
    assert (PLAIN.n, PLAIN.m) == (14, 3) and SYSTEM.name == PLAIN.name
    prob = MAKE(device="cpu")
    assert (prob.N, prob.T_min, prob.T_max, prob.n, prob.m) == (200, 40, 200, 14, 3)
    assert bool((torch.diagonal(prob.Q, dim1=-2, dim2=-1) > 0).all())  # no zero weight: the select's digit loss


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_xdot_and_guard_match_the_plain_reference(seed):
    x, u = _rows(seed)
    got, want = SYSTEM.xdot(x, u), PLAIN.xdot(x, u)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    f = torch.isfinite(want)
    torch.testing.assert_close(got[f], want[f], rtol=1e-13, atol=1e-13)
    g = SYSTEM.guard(x, u)
    assert torch.equal(g, PLAIN.guard(x, u))
    assert g[:6].all() and g[7:9].all() and not g[6] and not g[9:].any()
    step = SYSTEM.step(x, u)
    assert torch.isnan(step[g]).all() and torch.isfinite(step[~g]).all()
    torch.testing.assert_close(step[~g], plain_step(PLAIN, x, u, SYSTEM.dt)[~g], rtol=1e-13, atol=1e-13)


def test_jacobians_match_autograd_through_the_reference():
    """linearize_ad of the port's step against torch.func.jacrev of the
    reference's step, on the rows no guard poisons, within rtol 1e-12."""
    x, u = _rows(3)
    keep = ~PLAIN.guard(x, u)
    x, u = x[keep], u[keep]
    A, Bm = linearize_ad(SYSTEM.step, x[:, None].expand(-1, 2, -1).contiguous(), u[:, None].contiguous())
    jx, ju = torch.vmap(torch.func.jacrev(lambda a, b: plain_step(PLAIN, a, b, SYSTEM.dt), argnums=(0, 1)))(x, u)
    torch.testing.assert_close(A[:, 0], jx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(Bm[:, 0], ju, rtol=1e-12, atol=1e-12)


# The small solve's judge readings, float64 and float32 alike: horizon
# excess 0.069 (one problem's T* one step off the model curve's argmin, on
# a flat bottom), descent left 2.1e-5; each bound about three and five
# times that. In the cell, outer steps left stale read above 3 and +inf
# (the limits file's readings).
HORIZON_EXCESS = 0.2
DESCENT_LEFT = 1e-4


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_a_small_solve_is_judged_sound_by_the_reference(dtype):
    """B = 3, N = 160, T in [40, 160] from the cell's start, its positions
    and velocities perturbed: the landing's free final time falls inside the
    range (T* 145 to 148, as in the cell), so the horizon is chosen, not
    clipped. Every answer finite, J* its controls' cost at T* under the
    reference (within the storage's half spacing and 1e-10 relative beyond
    it), T* the argmin of the reference's model curve or flat-tied with it,
    and the descent one more Newton step would add small against the
    solve's own; the largest thrust under the paper's bound of 5."""
    N, B = 160, 3
    base = MAKE(N=N, device="cpu", dtype=dtype).replace(T_min=40, T_max=N)
    rng = np.random.default_rng(11)
    x0 = base.x0.double().numpy() + np.asarray(SYSTEM.sigma_x0) * rng.standard_normal((B, 14))
    probs = broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, dtype=dtype))
    res = solve_batch(SYSTEM, probs, options=SolveOptions(max_iter=12))
    assert res.J_star.dtype == dtype and bool(torch.isfinite(res.J_star).all())
    assert bool(((res.T_star > 40) & (res.T_star < N)).all()), res.T_star
    cfg = {"system": "Rocket6DoF", "dt": SYSTEM.dt, "N": N, "T_min": 40, "T_max": N,
           "xg": base.xg[0].tolist(), "u_ref": base.u_ref[0].tolist(),
           "Q_diag": torch.diagonal(base.Q[0]).tolist(), "R_diag": torch.diagonal(base.R[0]).tolist(),
           "Qf": torch.diagonal(base.Qf[0]).tolist(), "w": float(base.w[0]), "wrap_idx": [],
           "dtype": str(dtype).replace("torch.", "")}
    dep = check.Deployment(cfg, torch.float64, "cpu")
    per = check.judge(dep, probs.x0, res.T_star, res.J_star, res.U)
    worst = check.worst(per)
    assert bool(per["ok"].all()) and worst["nonfinite"] == 0
    assert worst["cost_gap"] <= 1e-10, worst
    assert worst["horizon_excess"] <= HORIZON_EXCESS, worst
    assert worst["descent_left"] <= DESCENT_LEFT, worst
    active = torch.arange(N)[None] < res.T_star[:, None]
    thrust = torch.where(active, torch.linalg.vector_norm(res.U.double(), dim=-1), 0.0)
    assert float(thrust.max()) < 5.0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_kernel_rollout_is_rollout_bit_for_bit(dtype):
    """rollout_kernel (the lander's initial rollout: the line search at
    T* = 0 from x0, then safe_step's poisoning) gives rollout's states bit
    for bit on the CPU, where the line search runs its plain version: a
    NaN control, a guarded zero thrust and a state past the norm guard each
    poison their row from that step on, as safe_step does."""
    from timeopt_tpu_torch.solver.cost import rollout, rollout_kernel

    B, N = 5, 40
    base = MAKE(N=N, device="cpu", dtype=dtype)
    rng = np.random.default_rng(3)
    x0 = base.x0.double().numpy() + np.asarray(SYSTEM.sigma_x0) * rng.standard_normal((B, 14))
    probs = broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, dtype=dtype))
    U = probs.u_ref[:, None].expand(B, N, 3) + 0.3 * torch.as_tensor(rng.standard_normal((B, N, 3)), dtype=dtype)
    U[1, 7, 0] = float("nan")
    U[2, 5] = 0.0  # below the thrust floor: the guard poisons the step
    U[3, 9, 0] = 1e9  # the next state's norm past 1e6
    got, want = rollout_kernel(SYSTEM, probs, probs.x0, U), rollout(SYSTEM, probs, probs.x0, U)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    first_nan = [int(torch.isnan(got[b]).any(dim=-1).int().argmax()) for b in (1, 2, 3)]
    assert first_nan == [8, 6, 10] and bool(torch.isfinite(got[[0, 4]]).all())


def test_only_the_lander_asks_for_the_kernel_rollout():
    from timeopt_tpu_torch.models import SYSTEMS

    asking = sorted(name for name in SYSTEMS if get_system(name)[0].kernel_rollout)
    assert asking == ["Rocket6DoF"]


# ---- the kernels' size tiers and limits --------------------------------------


def test_size_tiers():
    from timeopt_tpu_torch.ops import cuda_backward, cuda_lft

    assert [cuda_lft.tier(n, m) for n, m in ((2, 1), (4, 2), (5, 1), (12, 4), (13, 3), (14, 3), (14, 8))] == \
        [4, 4, 12, 12, 14, 14, 14]
    assert [cuda_backward.tier(n, m) for n, m in ((2, 1), (4, 2), (12, 4), (14, 3), (3, 1), (12, 8))] == \
        [2, 4, 12, 14, 12, 12]
    with pytest.raises(ValueError, match=r"n = 15, m = 3; csrc/lft_select.cu takes 1 <= n <= 14"):
        cuda_lft.tier(15, 3)
    with pytest.raises(ValueError, match=r"m = 9"):
        cuda_lft.tier(4, 9)
    with pytest.raises(ValueError, match=r"\(n, m\) = \(14, 4\); csrc/backward.cu takes n <= 12 with m <= 8, "
                                         r"or \(n, m\) = \(14, 3\)"):
        cuda_backward.tier(14, 4)
    with pytest.raises(ValueError, match=r"\(n, m\) = \(13, 3\)"):
        cuda_backward.tier(13, 3)


@pytest.fixture
def fake_card(monkeypatch):
    """Every wrapper takes its kernel's branch on CPU tensors, and a library
    load raises: a refusal must come before it."""
    from timeopt_tpu_torch.ops import _build

    def no_load(*a, **k):
        raise AssertionError("the kernel's library was loaded")

    monkeypatch.setattr(_build, "on_card", lambda x, phase: True)
    monkeypatch.setattr(_build, "load", no_load)


def _z(*shape):
    return torch.zeros(shape, dtype=torch.float64)


def test_generic_select_refuses_n_past_12(fake_card):
    from timeopt_tpu_torch.ops import cuda_lft_generic

    B, N, n, m = 2, 3, 14, 3
    p = n + 1
    with pytest.raises(ValueError, match=r"generic select kernel: n = 14, m = 3; csrc/lft_select_generic.cu "
                                         r"takes n <= 12 and m <= 8"):
        cuda_lft_generic.propagator_select_generic(_z(B, N, p, p), _z(B, N, p, m), _z(B, N, p, p), _z(B, m, m),
                                                   _z(B, N, n, p), t_min=1)


def test_query_refuses_n_past_12(fake_card):
    from timeopt_tpu_torch.ops import cuda_lft_query

    B, N, n = 2, 3, 13
    p = n + 1
    with pytest.raises(ValueError, match=r"terminal query kernel: n = 13; csrc/lft_query.cu takes n <= 12"):
        cuda_lft_query.lft_query(_z(B, N, p, p), _z(B, N, p, p), _z(B, N, p, p), _z(B, N, n, p), levels=1)


def test_scan_refuses_n_past_12(fake_card):
    from timeopt_tpu_torch.ops import cuda_lft_scan

    B, N, p = 2, 3, 15
    with pytest.raises(ValueError, match=r"LFT prefix scan kernel: n = 14; csrc/lft_scan.cu takes n <= 12"):
        cuda_lft_scan.lft_scan(_z(B, N, p, p), _z(B, N, p, p), _z(B, N, p, p), levels=1)


def test_fused_select_refuses_n_past_14(fake_card):
    from timeopt_tpu_torch.ops import cuda_lft

    B, N, n, m = 2, 3, 15, 3
    with pytest.raises(ValueError, match=r"fused select kernel: n = 15, m = 3"):
        cuda_lft.propagator_select_fused(_z(B, N, n, n), _z(B, N, n, m), _z(B, N, 4, n), _z(B, N, 4), _z(B, n, n),
                                         _z(B, m, m), _z(B, n, n), t_min=1)


def test_backward_refuses_a_shape_it_does_not_compile(fake_card):
    from timeopt_tpu_torch.ops import cuda_backward

    B, N, n, m = 2, 3, 14, 4
    args = (_z(B, N, n, n), _z(B, N, n, m), _z(B, N, n), _z(B, N, m), _z(B, N, n, n), _z(B, N, n), _z(B, N),
            _z(B, N), _z(B, n, n), _z(B, m, m), torch.ones(B, dtype=torch.int64), _z(B))
    with pytest.raises(ValueError, match=r"backward kernel: \(n, m\) = \(14, 4\)"):
        cuda_backward.backward_truncated_core(*args)
