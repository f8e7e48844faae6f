"""Figures from the runner's summary_all.csv (port of timeopt_tpu/runner/plot.py).

    python -m timeopt_tpu_torch.runner.plot --csv ilqr_results/summary_all.csv --outdir ilqr_results

The same figures and CLI as the JAX module: the ratios recomputed from the
rows (cost_ratio_best against the best J* of each (case, trial),
time_ratio_base against baseline1's total_time), the success-only filter
(every solver of a (case, trial) succeeded; --all-trials keeps every row),
the 2-panel paper figure, per-case boxplots, the phase-timer breakdown
and, from what --save-jt and --save-trajectories wrote under
<outdir>/<case>/, the J(T) and trajectory figures.

A table is a dict of columns (numpy arrays, in file order), read with the
csv module: the port needs neither pandas nor JAX. matplotlib (Agg
backend) is imported inside the functions that draw, so the module
imports where matplotlib is absent.
"""

from __future__ import annotations

import argparse
import csv
import os

import numpy as np


def _column(cells: list) -> np.ndarray:
    """A CSV column as pandas reads it: bool for True/False, float64 for
    numbers (an empty cell NaN), else strings."""
    vals = [c for c in cells if c != ""]
    if vals and all(c in ("True", "False") for c in vals) and len(vals) == len(cells):
        return np.array([c == "True" for c in cells])
    try:
        return np.array([float(c) if c != "" else np.nan for c in cells], dtype=np.float64)
    except ValueError:
        return np.array(cells, dtype=object)


def read_table(csv_path) -> dict:
    with open(csv_path, newline="") as f:
        rows = list(csv.reader(f))
    header, body = rows[0], rows[1:]
    return {c: _column([r[i] for r in body]) for i, c in enumerate(header)}


def _keys(df: dict) -> list:
    """(case, trial) of each row."""
    return list(zip(df["case"], df["trial"]))


def _load(csv_path) -> dict:
    """The rows with the ratios recomputed robustly: cost_ratio_best =
    J* / the least J* of the row's (case, trial) (NaN skipped); with
    baseline1 rows, time_base and time_ratio_base moved to the last columns
    from baseline1's total_time of the same (case, trial)."""
    df = read_table(csv_path)
    keys = _keys(df)
    best: dict = {}
    for k, J in zip(keys, df["J_star"]):
        if not np.isnan(J):
            best[k] = min(best.get(k, np.inf), J)
    with np.errstate(divide="ignore", invalid="ignore"):
        df["cost_ratio_best"] = df["J_star"] / np.array([best.get(k, np.nan) for k in keys])
        is_b1 = df["solver"] == "baseline1"
        if is_b1.any():
            base = {k: t for k, t, b in zip(keys, df["total_time"], is_b1) if b}
            for c in ("time_base", "time_ratio_base"):
                df.pop(c, None)
            df["time_base"] = np.array([base.get(k, np.nan) for k in keys])
            df["time_ratio_base"] = df["total_time"] / df["time_base"]
    return df


def _rows(df: dict, mask) -> dict:
    return {c: v[mask] for c, v in df.items()}


def _success_only(df: dict) -> dict:
    """The rows of the (case, trial)s on which every solver succeeded."""
    keys = _keys(df)
    failed = {k for k, ok in zip(keys, df["success"]) if not ok}
    return _rows(df, np.array([k not in failed for k in keys], dtype=bool))


def _values(df: dict, case, solver, col) -> np.ndarray:
    """The column's non-NaN values on the rows of (case, solver)."""
    v = df[col][(df["case"] == case) & (df["solver"] == solver)].astype(float)
    return v[~np.isnan(v)]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def paper_main(df: dict, outdir):
    """2-panel median+IQR errorbar figure: runtime ratio (log scale) and cost
    ratio per case/solver."""
    plt = _pyplot()
    cases = sorted(set(df["case"]))
    solvers = sorted(set(df["solver"]))
    fig, axes = plt.subplots(1, 2, figsize=(11, 4))
    xs = np.arange(len(cases))
    width = 0.8 / max(len(solvers), 1)

    for col, ax, title, logy in (
        ("time_ratio_base", axes[0], "runtime / baseline1", True),
        ("cost_ratio_best", axes[1], "cost / best", False),
    ):
        drawn = False  # a log axis needs a positive value (no baseline1 rows: none)
        for si, s in enumerate(solvers):
            med, lo, hi = [], [], []
            for c in cases:
                v = _values(df, c, s, col) if col in df else np.array([])
                if len(v) == 0:
                    med.append(np.nan)
                    lo.append(0)
                    hi.append(0)
                else:
                    q1, q2, q3 = np.percentile(v, [25, 50, 75])
                    med.append(q2)
                    lo.append(q2 - q1)
                    hi.append(q3 - q2)
                    drawn = drawn or q2 > 0
            ax.errorbar(xs + (si - (len(solvers) - 1) / 2) * width, med, yerr=[lo, hi], fmt="o", capsize=3, label=s)
        ax.set_xticks(xs)
        ax.set_xticklabels(cases, rotation=20, ha="right")
        ax.set_title(title)
        ax.grid(True, alpha=0.3)
        if logy and drawn:
            ax.set_yscale("log")
    axes[0].legend()
    fig.tight_layout()
    out = os.path.join(outdir, "paper_main.png")
    fig.savefig(out, dpi=160)
    plt.close(fig)
    return out


def boxplots(df: dict, outdir):
    """Per-case boxplots of cost ratio / runtime ratio / T*."""
    plt = _pyplot()
    outs = []
    for col, name in (("cost_ratio_best", "cost_ratio"), ("time_ratio_base", "runtime_ratio"), ("T_star", "T_star")):
        cases = sorted(set(df["case"]))
        solvers = sorted(set(df["solver"]))
        fig, axes = plt.subplots(1, len(cases), figsize=(3.2 * len(cases), 3.6), squeeze=False)
        for ci, c in enumerate(cases):
            ax = axes[0][ci]
            data = [_values(df, c, s, col) if col in df else np.array([]) for s in solvers]
            ax.boxplot(data, tick_labels=solvers)
            ax.set_title(c, fontsize=9)
            ax.tick_params(axis="x", rotation=30)
            ax.grid(True, alpha=0.3)
        fig.suptitle(name)
        fig.tight_layout()
        out = os.path.join(outdir, f"boxplot_{name}.png")
        fig.savefig(out, dpi=160)
        plt.close(fig)
        outs.append(out)
    return outs


PHASES = ("linearize", "select", "backward", "forward")


def timing_breakdown(df: dict, outdir):
    """Stacked per-phase timing bars per case/solver from the
    t_linearize/t_select/t_backward/t_forward columns (`run_suite
    --phase-timers`): each (case, solver)'s first row that has all four."""
    cols = [f"t_{p}" for p in PHASES]
    if not all(c in df for c in cols):
        return []
    sub = _rows(df, ~np.any([np.isnan(df[c].astype(float)) for c in cols], axis=0))
    if len(sub["case"]) == 0:
        return []
    plt = _pyplot()
    cases = sorted(set(sub["case"]))
    fig, axes = plt.subplots(1, len(cases), figsize=(3.4 * len(cases), 3.8), squeeze=False)
    colors = dict(zip(PHASES, ("#4ECDC4", "#FF6B6B", "#95E1D3", "#FFE66D")))
    for ci, c in enumerate(cases):
        ax = axes[0][ci]
        in_case = sub["case"] == c
        solvers = sorted(set(sub["solver"][in_case]))
        first = [np.flatnonzero(in_case & (sub["solver"] == s))[0] for s in solvers]
        x = np.arange(len(solvers))
        bottom = np.zeros(len(solvers))
        for p in PHASES:
            vals = sub[f"t_{p}"][first].astype(float)
            ax.bar(x, vals, 0.55, bottom=bottom, label=p.capitalize(), color=colors[p])
            bottom += vals
        for i, tot in enumerate(bottom):
            ax.text(i, tot, f"{tot:.3f}s", ha="center", va="bottom", fontsize=8)
        ax.set_xticks(x)
        ax.set_xticklabels(solvers, rotation=30, fontsize=8)
        ax.set_title(c, fontsize=9)
        ax.grid(True, alpha=0.3, axis="y")
    axes[0][0].set_ylabel("time (s)")
    axes[0][-1].legend(fontsize=8)
    fig.suptitle("Computation time breakdown (trial 0)")
    fig.tight_layout()
    out = os.path.join(outdir, "timing_breakdown.png")
    fig.savefig(out, dpi=160)
    plt.close(fig)
    return [out]


def per_case_figures(outdir):
    """The per-case figures of what the runner saved under <outdir>/<case>/:
    a J(T) figure for each <case>_Jt.csv (`--save-jt`) and a
    solver-comparison trajectory figure for each set of
    trajectories_<solver>.npz (`--save-trajectories`)."""
    outs = []
    for case in sorted(os.listdir(outdir)):
        case_dir = os.path.join(outdir, case)
        if not os.path.isdir(case_dir):
            continue
        jt_csv = os.path.join(case_dir, f"{case}_Jt.csv")
        if os.path.isfile(jt_csv):
            outs.append(plot_jt(jt_csv, case_dir, case_name=case))
        npzs = {
            fn[len("trajectories_"):-len(".npz")]: os.path.join(case_dir, fn)
            for fn in sorted(os.listdir(case_dir))
            if fn.startswith("trajectories_") and fn.endswith(".npz")
        }
        if npzs:
            outs.append(plot_trajectories(npzs, case, case_dir))
    return outs


def plot_trajectories(npz_paths_by_solver, case_name, outdir, trial=0, T_stars=None):
    """Per-case state/control trajectory figure comparing solvers;
    `npz_paths_by_solver` maps solver name -> trajectories_<solver>.npz
    written by the runner's --save-trajectories flag. (T_stars is unused, as
    in the JAX module: each solver's own T* bounds its curves.)"""
    plt = _pyplot()
    data = {}
    for solver, path in npz_paths_by_solver.items():
        z = np.load(path)
        data[solver] = dict(X=z["X"][trial], U=z["U"][trial], T=int(z["T_star"][trial]))
    any_d = next(iter(data.values()))
    n = any_d["X"].shape[1]
    m = any_d["U"].shape[1]
    styles = {
        "ourmethod": dict(color="#2E86AB", linestyle="-", linewidth=2.2),
        "baseline2": dict(color="#A23B72", linestyle="--", linewidth=2.2),
        "baseline1": dict(color="#F18F01", linestyle="-.", linewidth=1.8),
    }
    rows = max(n, m)
    fig, axes = plt.subplots(rows, 2, figsize=(11, 2.2 * rows), squeeze=False)
    for i in range(n):
        ax = axes[i][0]
        for solver, d in data.items():
            T = d["T"]
            ax.plot(np.arange(T + 1), d["X"][: T + 1, i], label=solver, **styles.get(solver, {}))
        ax.set_ylabel(f"x_{i + 1}")
        ax.grid(True, alpha=0.3)
    for j in range(m):
        ax = axes[j][1]
        for solver, d in data.items():
            T = d["T"]
            ax.step(np.arange(T), d["U"][:T, j], where="post", label=solver, **styles.get(solver, {}))
        ax.set_ylabel(f"u_{j + 1}")
        ax.grid(True, alpha=0.3)
    axes[0][0].legend(fontsize=8)
    fig.suptitle(case_name)
    fig.tight_layout()
    out = os.path.join(outdir, f"{case_name}_trajectories.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def plot_jt(csv_path, outdir, case_name=None):
    """J(T) selection-curve figure from a <case>_Jt.csv written by the
    runner's --save-jt flag: one curve per method column, the argmin of
    each marked."""
    plt = _pyplot()
    df = read_table(csv_path)
    if case_name is None:
        case_name = os.path.basename(csv_path).replace("_Jt.csv", "")
    styles = {
        "J_propagator": dict(color="#2E86AB", linestyle="-", linewidth=2.2),
        "J_onepass": dict(color="#A23B72", linestyle="--", linewidth=2.2),
        "J_bruteforce": dict(color="#F18F01", linestyle="-.", linewidth=1.8),
    }
    fig, ax = plt.subplots(figsize=(7, 4))
    t = df["t"]
    for col, J in df.items():
        if col == "t":
            continue
        J = J.astype(float)
        ax.plot(t, J, label=col[2:], **styles.get(col, {}))
        if np.isfinite(J).any():
            i = int(np.nanargmin(J))
            ax.plot(t[i], J[i], "o", ms=6, color=styles.get(col, {}).get("color", "k"))
    ax.set_xlabel("horizon T")
    ax.set_ylabel("J(T)")
    ax.set_title(f"{case_name}: selection curve J(T)")
    ax.grid(True, alpha=0.3)
    ax.legend(fontsize=9)
    fig.tight_layout()
    out = os.path.join(outdir, f"{case_name}_Jt.png")
    fig.savefig(out, dpi=150)
    plt.close(fig)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csv", type=str, default="ilqr_results/summary_all.csv")
    ap.add_argument("--outdir", type=str, default="ilqr_results")
    ap.add_argument("--all-trials", action="store_true", help="include failed trials")
    args = ap.parse_args(argv)

    df = _load(args.csv)
    if not args.all_trials:
        df = _success_only(df)
    os.makedirs(args.outdir, exist_ok=True)
    outs = (
        [paper_main(df, args.outdir)]
        + boxplots(df, args.outdir)
        + timing_breakdown(df, args.outdir)
        + per_case_figures(args.outdir)
    )
    for o in outs:
        print("wrote", o)


if __name__ == "__main__":
    main()
