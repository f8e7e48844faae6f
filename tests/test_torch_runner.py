"""The port's suite runner (timeopt_tpu_torch/runner/run_suite.py) against
the JAX runner and the committed results/cpu_f64_25 artifacts, on the CPU.

- The trial problems are bit-equal to the JAX runner's (same CRC32 seeding).
- The table code (no pandas) gives the JAX runner's pandas results on the
  same rows, value for value, and the same CSV text.
- The runner reproduces the committed DoubleIntegrator rows of all three
  solvers: T* and n_iter identical, J* within rtol 1e-8 (the port's
  operation order differs, so not bitwise), and the trial-0 consistency
  columns within rtol 1e-6; with --consistency and --phase-timers its
  header is the committed one.
- The cart-pole's trial 0 of baseline2 (the one-pass method) reproduces
  the committed T* 140 and J* within rtol 1e-6.
"""

from __future__ import annotations

import csv
import io
import math
import os

import numpy as np
import pandas as pd
import pytest
import torch

from timeopt_tpu.runner import run_suite as jrun
from timeopt_tpu_torch.models.base import PROBLEM_FIELDS
from timeopt_tpu_torch.runner import run_suite as trun

torch.set_num_threads(2)
_COMMITTED = os.path.join(os.path.dirname(__file__), "..", "results", "cpu_f64_25", "summary_all.csv")


@pytest.mark.parametrize("case", trun.CASES + trun.EXTRA_CASES)
def test_trial_problems_bit_equal_to_jax(case):
    import jax.numpy as jnp

    _, _, jp = jrun.build_trial_problems(case, 7, 3, jnp.float64)
    _, base, tp = trun.build_trial_problems(case, 7, 3, device="cpu")
    assert base.batch == 1 and (tp.N, tp.T_min, tp.T_max) == (jp.N, jp.T_min, jp.T_max)
    for f in PROBLEM_FIELDS:
        np.testing.assert_array_equal(getattr(tp, f).numpy(), np.asarray(getattr(jp, f)), err_msg=f)


def _rows():
    """Rows as run_case makes them, with the awkward values: an infinite J*,
    a NaN J*, a trial only one solver has, consistency columns on trial 0."""
    rng = np.random.default_rng(80)
    rows = []
    for case in ("B_case", "A_case"):
        for solver in ("ourmethod", "baseline1"):
            for i in range(4 if solver == "ourmethod" else 3):
                J = float(rng.uniform(1, 10))
                if (case, solver, i) == ("A_case", "ourmethod", 1):
                    J = math.inf
                if (case, solver, i) == ("B_case", "baseline1", 2):
                    J = math.nan
                rows.append({
                    "case": case, "trial": i, "solver": solver, "status": "ok", "T_star": int(rng.integers(10, 50)),
                    "J_star": J, "total_time": float(rng.uniform(1e-4, 1e-2)), "final_err": float(rng.uniform()),
                    "success": bool(rng.uniform() > 0.3), "n_iter": 3, "n_tied": 1, "solver_error": None,
                    "compile_and_run_s": 1.25,
                    **({"consistency_max_abs": 2.4e-4, "consistency_rmse": 4.4e-5} if i == 0 else {}),
                })
    return rows


def _same(a, b) -> bool:
    if isinstance(a, float) or isinstance(b, float):
        a, b = float("nan") if a is None else float(a), float("nan") if b is None else float(b)
        return (math.isnan(a) and math.isnan(b)) or a == b
    return a == b


@pytest.mark.parametrize("solvers", [["ourmethod", "baseline1"], ["ourmethod"]])
def test_enrich_and_aggregate_matches_pandas(solvers, tmp_path):
    rows = [r for r in _rows() if r["solver"] in solvers]
    want_df, want_agg = jrun.enrich_and_aggregate(pd.DataFrame(rows), solvers)
    got_rows, got_agg = trun.enrich_and_aggregate(rows, solvers)
    for got, want in ((got_rows, want_df), (got_agg, want_agg)):
        assert trun.columns_of(got) == list(want.columns)
        assert len(got) == len(want)
        for g, (_, w) in zip(got, want.iterrows()):
            for c in want.columns:
                wv = w[c]
                wv = wv.item() if hasattr(wv, "item") else wv
                assert _same(g[c], wv), (c, g[c], wv)
        buf = io.StringIO()
        want.to_csv(buf, index=False)
        trun.write_csv(tmp_path / "t.csv", trun.columns_of(got), got)
        assert (tmp_path / "t.csv").read_text() == buf.getvalue()


def test_unported_flags_fail_at_parsing():
    """Unknown cases and solvers fail at parsing. --f32 (alone and with
    --consistency) and --distributed are ported (their runs:
    tests/test_torch_f32_solve.py, tests/test_torch_f32_scan_query.py,
    tests/test_torch_parallel.py)."""
    for argv in (["--cases", "Pendulum"], ["--solvers", "ourmethod,baseline3"]):
        with pytest.raises(SystemExit):
            trun.parse_args(argv)
    assert trun.parse_args(["--distributed"]).distributed
    assert trun.parse_args(["--f32"]).f32
    both = trun.parse_args(["--f32", "--consistency"])
    assert both.f32 and both.consistency
    args = trun.parse_args(["--solvers", "ourmethod,baseline1", "--cases", "Quadrotor,PointMass_Navigation"])
    assert args.device == "cuda" and args.solvers == ["ourmethod", "baseline1"]
    assert args.cases == ["Quadrotor", "PointMass_Navigation"]
    default = trun.parse_args([])
    assert default.cases == trun.CASES and default.solvers == ["ourmethod", "baseline1", "baseline2"]
    assert not default.phase_timers


def test_ported_flags_parse():
    """baseline2 (the one-pass method) and --phase-timers are ported."""
    args = trun.parse_args(["--solvers", "ourmethod,baseline2", "--phase-timers"])
    assert args.solvers == ["ourmethod", "baseline2"] and args.phase_timers
    assert trun.SOLVER_METHODS["baseline2"] == "onepass"


def test_cuda_device_without_a_card_fails(tmp_path):
    """No fallback: --device cuda on a machine without a GPU raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trun.main(["--cases", "DoubleIntegrator", "--trials", "1", "--solvers", "ourmethod",
                   "--outdir", str(tmp_path)])


def _committed(case, solver):
    with open(_COMMITTED, newline="") as f:
        return [r for r in csv.DictReader(f) if r["case"] == case and r["solver"] == solver]


def test_doubleintegrator_rows_reproduce_committed(tmp_path):
    """The port's version of tests/test_artifact_repro.py: the committed
    DoubleIntegrator case, 25 trials, seed 0, max_iter 12, ourmethod and
    baseline1, with every output flag."""
    trun.main(["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "25", "--solvers", "ourmethod,baseline1",
               "--consistency", "--save-jt", "--save-trajectories", "--outdir", str(tmp_path)])
    with open(tmp_path / "summary_all.csv", newline="") as f:
        got = list(csv.DictReader(f))
    with open(_COMMITTED, newline="") as f:
        header = next(csv.reader(f))
    assert list(got[0]) == [c for c in header if not c.startswith("t_")]  # no --phase-timers
    for solver in ("ourmethod", "baseline1"):
        want = _committed("DoubleIntegrator", solver)
        mine = {r["trial"]: r for r in got if r["solver"] == solver}
        assert len(want) == len(mine) == 25
        for w in want:
            g = mine[w["trial"]]
            assert (g["T_star"], g["n_iter"], g["status"]) == (w["T_star"], w["n_iter"], w["status"]), w["trial"]
            np.testing.assert_allclose(float(g["J_star"]), float(w["J_star"]), rtol=1e-8)
        for c in ("consistency_max_abs", "consistency_rmse"):
            np.testing.assert_allclose(float(mine["0"][c]), float(_committed("DoubleIntegrator", solver)[0][c]),
                                       rtol=1e-6)
    for name in ("summary_agg.csv", "DoubleIntegrator/summary_all.csv", "DoubleIntegrator/summary_agg.csv"):
        assert (tmp_path / name).exists()
    with open(tmp_path / "DoubleIntegrator" / "DoubleIntegrator_Jt.csv", newline="") as f:
        jt = list(csv.DictReader(f))
    assert list(jt[0]) == ["t", "J_propagator", "J_bruteforce"] and len(jt) == 80
    traj = np.load(tmp_path / "DoubleIntegrator" / "trajectories_baseline1.npz")
    assert traj["X"].shape == (25, 121, 2) and sorted(traj.files) == ["J_hist", "J_star", "T_hist", "T_star", "U", "X"]


def test_doubleintegrator_baseline2_rows_reproduce_committed(tmp_path):
    """baseline2 on the committed DoubleIntegrator case (25 trials, seed 0,
    max_iter 12) with --consistency and --phase-timers: the committed
    header, every row's T*, n_iter and status, J* within rtol 1e-8, and the
    trial-0 timer columns (seconds of this CPU run, not the committed
    values) present, non-negative and with a positive sum."""
    trun.main(["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "25", "--solvers", "baseline2",
               "--consistency", "--phase-timers", "--outdir", str(tmp_path)])
    with open(tmp_path / "summary_all.csv", newline="") as f:
        got = list(csv.DictReader(f))
    with open(_COMMITTED, newline="") as f:
        header = next(csv.reader(f))
    assert list(got[0]) == header
    want = _committed("DoubleIntegrator", "baseline2")
    assert len(want) == len(got) == 25
    for w, g in zip(want, got):
        assert (g["trial"], g["T_star"], g["n_iter"], g["status"]) == (w["trial"], w["T_star"], w["n_iter"], w["status"])
        np.testing.assert_allclose(float(g["J_star"]), float(w["J_star"]), rtol=1e-8)
        assert g["solver_error"] == w["solver_error"] == ""
    timers = [float(got[0][f"t_{k}"]) for k in ("linearize", "select", "backward", "forward")]
    assert min(timers) >= 0 and sum(timers) > 0
    assert all(g[f"t_{k}"] == "" for g in got[1:] for k in ("linearize", "select", "backward", "forward"))


def test_cartpole_baseline2_trial0_anchor():
    """The one-pass method on the cart-pole's nominal trial (trial 0 of
    results/cpu_f64_25): T* 140, n_iter 13, J* 125.974151183 within rtol
    1e-6."""
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    system, _, probs = trun.build_trial_problems("Cartpole_SwingUp", 1, 0, device="cpu")
    res = solve_batch(system, probs, options=SolveOptions(method="onepass", max_iter=12, S_window=20))
    w = _committed("Cartpole_SwingUp", "baseline2")[0]
    assert (int(res.T_star[0]), int(res.n_accept[0])) == (int(w["T_star"]), int(w["n_iter"])) == (140, 13)
    np.testing.assert_allclose(float(res.J_star[0]), float(w["J_star"]), rtol=1e-6)
