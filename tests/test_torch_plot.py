"""The port's figures (timeopt_tpu_torch/runner/plot.py) on the CPU, held
against the JAX package's plot module: from the committed
results/cpu_f64_25/summary_all.csv, the columns that _load recomputes
(cost_ratio_best, time_base, time_ratio_base) within rtol 1e-12 of the
JAX _load's (pandas), the same columns in the same order and the same
success-only rows; main() writes the paper figure, the three boxplots and
the timing breakdown; plot_jt and plot_trajectories draw a tiny runner
output (--save-jt, --save-trajectories); the paper figure draws without
baseline1 rows."""

from __future__ import annotations

import os

import numpy as np
import pytest

pytest.importorskip("matplotlib")

from timeopt_tpu.runner import plot as jplot  # noqa: E402
from timeopt_tpu_torch.runner import plot as tplot  # noqa: E402
from timeopt_tpu_torch.runner import run_suite  # noqa: E402

CSV = os.path.join(os.path.dirname(__file__), "..", "results", "cpu_f64_25", "summary_all.csv")


def _assert_table_matches(got: dict, want) -> None:
    assert list(got) == list(want.columns)
    assert len(got["case"]) == len(want)
    for c in ("J_star", "total_time", "cost_ratio_best", "time_base", "time_ratio_base", "T_star"):
        np.testing.assert_allclose(got[c], want[c].to_numpy(float), rtol=1e-12, atol=0, err_msg=c)
    for c in ("case", "solver"):
        assert list(got[c]) == list(want[c]), c
    np.testing.assert_array_equal(got["success"], want["success"].to_numpy(bool))


def test_load_and_success_filter_match_jax():
    got, want = tplot._load(CSV), jplot._load(CSV)
    _assert_table_matches(got, want)
    _assert_table_matches(tplot._success_only(got), jplot._success_only(want))
    assert len(tplot._success_only(got)["case"]) < len(got["case"])  # the segway's failed trials go


def test_main_writes_the_figures(tmp_path):
    tplot.main(["--csv", CSV, "--outdir", str(tmp_path)])
    for name in ("paper_main", "boxplot_cost_ratio", "boxplot_runtime_ratio", "boxplot_T_star", "timing_breakdown"):
        assert (tmp_path / f"{name}.png").stat().st_size > 0, name


def test_per_case_figures_of_a_runner_output(tmp_path):
    run_suite.main(["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "2", "--max-iter", "2",
                    "--solvers", "ourmethod,baseline1", "--save-jt", "--save-trajectories", "--outdir", str(tmp_path)])
    tplot.main(["--csv", str(tmp_path / "summary_all.csv"), "--outdir", str(tmp_path), "--all-trials"])
    case_dir = tmp_path / "DoubleIntegrator"
    for name in ("DoubleIntegrator_Jt.png", "DoubleIntegrator_trajectories.png"):
        assert (case_dir / name).stat().st_size > 0, name
    assert not (tmp_path / "timing_breakdown.png").exists()  # no --phase-timers columns


def test_paper_figure_without_baseline1(tmp_path):
    """Without baseline1 rows the runtime ratios are all NaN: the panel stays
    linear instead of failing on a log axis with no positive value."""
    df = tplot._load(CSV)
    df = tplot._rows(df, df["solver"] != "baseline1")
    df["time_ratio_base"] = np.full(len(df["case"]), np.nan)
    assert os.path.getsize(tplot.paper_main(df, str(tmp_path))) > 0
