"""The port's phase timers (timeopt_tpu_torch/utils/timing.py), as
tests/test_timing.py holds the JAX package's: the reference's four keys,
non-negative timers with a positive sum, and the profiled solve's T* and
last accepted J equal to the batched solve's (rtol 1e-8), for the
propagator, the brute force and the one-pass method on the tiny double
integrator, on the CPU."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.helpers import tiny_double_integrator
from tests.torch_helpers import to_torch_problem
from timeopt_tpu.solver.ilqr import broadcast_problem
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver.ilqr import SolveOptions, broadcast_problem as tbroadcast, solve
from timeopt_tpu_torch.utils.timing import PHASES, profile_any, profile_solve, profile_solve_onepass

torch.set_num_threads(1)


def _tiny():
    _, base = tiny_double_integrator()
    return get_system("DoubleIntegrator")[0], to_torch_problem(broadcast_problem(base, 1))


@pytest.mark.parametrize("method,max_iter", [("propagator", 6), ("bruteforce", 4), ("onepass", 6)])
def test_profile_timers_and_result(method, max_iter):
    system, prob = _tiny()
    opts = SolveOptions(method=method, max_iter=max_iter, S_window=5)
    profiler = profile_solve_onepass if method == "onepass" else profile_solve
    result, timers = profiler(system, prob, opts)
    assert tuple(timers) == PHASES
    assert all(t >= 0 for t in timers.values()) and sum(timers.values()) > 0
    assert timers["select"] > 0 and timers["linearize"] > 0
    fused = solve(system, prob, options=opts)
    assert result["T_star"] == int(fused.T_star)
    np.testing.assert_allclose(result["J_hist"][-1], float(fused.J_star), rtol=1e-8)
    assert len(result["J_hist"]) == int(fused.n_accept)
    assert profile_any(system, prob, opts)[0]["T_hist"] == result["T_hist"]


def test_profile_takes_one_problem():
    system, prob = _tiny()
    with pytest.raises(ValueError, match="batch-of-1"):
        profile_solve(system, tbroadcast(prob, 2), SolveOptions(max_iter=1))
    with pytest.raises(ValueError, match="one-pass"):
        profile_solve_onepass(system, prob, SolveOptions(method="propagator"))
