"""Benchmark suite runner of the port (port of timeopt_tpu/runner/run_suite.py).

    python -m timeopt_tpu_torch.runner.run_suite --trials 25 --solvers ourmethod,baseline1
    python -m timeopt_tpu_torch.runner.run_suite --device cpu --cases DoubleIntegrator

The same flags, the same CSV files and columns (summary_all.csv /
summary_agg.csv per case and for the whole run; <case>_Jt.csv with
--save-jt; trajectories_<solver>.npz with --save-trajectories) and the same
CRC32 trial seeding as the JAX runner, so the trial problems are
bit-identical. All trials of a (case, solver) run as one batched solve on
`--device` (default cuda; with no GPU the run fails, nothing falls back to
the CPU); `total_time` is the synchronized batch wall-clock divided by the
number of trials, and `compile_and_run_s` the first, untimed solve of the
batch, which includes building the CUDA kernels on a first launch and
capturing the solve's CUDA graphs (solver/compiled.py), as the JAX
runner's first solve includes its compile. The CSV
files are written with the csv module (repr floats, so J round-trips
exactly); pandas is not needed.

With --phase-timers, trial 0 of each (case, solver) is solved once more
through the host-driven phase profiler (utils/timing.py), a warm-up call
and a reported one, which fills the t_linearize, t_select, t_backward and
t_forward columns of its row.

With --distributed (several processes, e.g. `torchrun --nproc_per_node=K
-m timeopt_tpu_torch.runner.run_suite --distributed`) every rank builds the
same trial problems, solves its contiguous slice of them on its own card
(NCCL; gloo with --device cpu) through parallel/distributed.py, and
all-gathers the results, so every rank computes the same rows; rank 0
alone writes the CSV and .npz files. `total_time` is then the gathered
batch's wall-clock on each rank divided by the trials.

With --f32 the trial problems are float32 and solve on the port's float32
path (float32 storage, float64 recursions; SolveOptions' df_forward and
select_dtype at their defaults), as the JAX runner's --f32 solves in
float32; with --consistency, trial 0's consistency_max_abs and
consistency_rmse then come from consistency_check's float32 curves, as the
JAX runner's do. The figures are runner/plot.py's (matplotlib).
"""

from __future__ import annotations

import argparse
import csv
import math
import os
import time
import zlib

import numpy as np
import torch

CASES = [
    "DoubleIntegrator",
    "Cartpole_SwingUp",
    "Quadrotor",
    "Segway_Balance",
    "Ballbot_Balance",
]

# Available via --cases but not in the default suite, as in the JAX runner.
EXTRA_CASES = ["PointMass_Navigation"]

SOLVER_METHODS = {
    "ourmethod": "propagator",
    "baseline1": "bruteforce",
    "baseline2": "onepass",
}

def _case_rng(seed: int, case: str) -> np.random.Generator:
    return np.random.default_rng(int(seed) + zlib.crc32(case.encode()) % 10_000)


def build_trial_problems(case: str, trials: int, seed: int, device="cuda", dtype=torch.float64):
    """(system, base, probs): trial 0 is the nominal x0/xg, trials 1.. are
    Gaussian-perturbed with the case's sigmas, drawn as the JAX runner
    draws them (in float64, then stored in `dtype`). `base` is the
    batch-of-1 default problem in `dtype`, on the CPU; the trials go to
    `device`."""
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    system, mk = get_system(case)
    base = mk(device="cpu", dtype=dtype)
    rng = _case_rng(seed, case)

    sx = np.asarray(system.sigma_x0, float)
    sg = np.asarray(system.sigma_xg, float)
    x0, xg = base.x0[0].numpy(), base.xg[0].numpy()
    x0s, xgs = [x0], [xg]
    for _ in range(1, trials):
        x0s.append(x0 + sx * rng.standard_normal(system.n))
        xgs.append(xg + sg * rng.standard_normal(system.n))

    probs = broadcast_problem(base, trials).replace(
        x0=torch.as_tensor(np.stack(x0s)).to(dtype), xg=torch.as_tensor(np.stack(xgs)).to(dtype)
    )
    return system, base, probs.to(device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _take(probs, i: int):
    """Problem i of a batch, as a batch of 1."""
    return probs.replace(**{f: t[i : i + 1] for f, t in probs.tensors().items()})


def _timed(fn, device):
    _sync(device)
    t0 = time.perf_counter()
    out = fn()
    _sync(device)
    return out, time.perf_counter() - t0


def run_case(
    case: str,
    *,
    trials: int,
    seed: int,
    solvers,
    max_iter: int,
    S_window: int,
    use_central_diff: bool,
    success_tol: float,
    device,
    dtype=torch.float64,
    timing: str = "amortized",
    save_trajectories: bool = False,
    save_jt: bool = False,
    consistency: bool = False,
    phase_timers: bool = False,
    distributed: bool = False,
    outdir: str = ".",
):
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, solve, solve_batch
    from timeopt_tpu_torch.solver.verify import consistency_check

    device = torch.device(device)
    system, base, probs = build_trial_problems(case, trials, seed, device, dtype)
    lin_mode = "central" if use_central_diff else "ad"

    if distributed:
        # every rank builds the same trials, solves its slice and gathers all
        from timeopt_tpu_torch.parallel import distributed as dist

        lo, hi = dist.process_batch_bounds(trials)
        local = probs.replace(**{f: t[lo:hi] for f, t in probs.tensors().items()})

        def _solve_all(opts):
            res = dist.gather_results(dist.solve_batch_global(system, local, options=opts, device=device))
            return SolveResult(**{k: torch.as_tensor(v, device=device) for k, v in vars(res).items()})

    else:

        def _solve_all(opts):
            return solve_batch(system, probs, options=opts)

    rows = []
    jt_cols = {}
    for solver_name in solvers:
        method = SOLVER_METHODS[solver_name]
        opts = SolveOptions(method=method, max_iter=max_iter, S_window=S_window, linearize_mode=lin_mode)
        print(f"[{case}] {solver_name}: solving {trials} trials (batched, max_iter={max_iter}) ...", flush=True)
        # the first solve of the batch builds any kernel not yet built and captures the solve; then time
        res, compile_and_run = _timed(lambda: _solve_all(opts), device)

        if timing == "per-solve":
            per_trial_times = []
            for i in range(trials):
                ri, secs = _timed(lambda: solve(system, _take(probs, i), options=opts), device)
                per_trial_times.append(secs)
                print(
                    f"\r[{case}] {solver_name}: trial {i + 1}/{trials}  T={int(ri.T_star)} "
                    f"J={float(ri.J_star):.4g} t={secs * 1e3:.0f}ms ",
                    end="" if i + 1 < trials else "\n",
                    flush=True,
                )
        else:
            res, batch_time = _timed(lambda: _solve_all(opts), device)
            per_trial_times = [batch_time / trials] * trials

        T = res.T_star.cpu().numpy()
        J = res.J_star.cpu().numpy()
        X = res.X.cpu().numpy()
        nacc = res.n_accept.cpu().numpy()
        nfb = res.n_fallback.cpu().numpy()
        ntied = res.T_ties.sum(dim=-1).cpu().numpy()
        rows_idx = torch.arange(trials, device=device)
        eT = wrap_error(res.X[rows_idx, res.T_star] - probs.xg, probs.wrap_mask).cpu().numpy()

        if save_trajectories:
            case_dir = os.path.join(outdir, case)
            os.makedirs(case_dir, exist_ok=True)
            np.savez_compressed(
                os.path.join(case_dir, f"trajectories_{solver_name}.npz"),
                X=X, U=res.U.cpu().numpy(), T_star=T, J_star=J,
                J_hist=res.J_hist.cpu().numpy(), T_hist=res.T_hist.cpu().numpy(),
            )
        if save_jt:
            # trial-0 final J(T) curve; non-finite entries become empty cells
            curve = res.J_curve[0].cpu().numpy().astype(float)
            jt_cols[f"J_{method}"] = np.where(np.isfinite(curve), curve, np.nan)
        cc_max = cc_rmse = float("nan")
        if consistency:
            # propagator vs brute-force J(T) on this solver's trial-0 final trajectory
            cc = consistency_check(system, _take(probs, 0), res.X[:1], res.U[:1])
            cc_max, cc_rmse = float(cc["max_abs"][0]), float(cc["rmse"][0])
        phase_cols = {}
        if phase_timers:
            # trial 0 through the host-driven phase profiler: a warm-up
            # call, then the reported one
            from timeopt_tpu_torch.utils.timing import profile_any

            profile_any(system, _take(probs, 0), opts)
            _, timers = profile_any(system, _take(probs, 0), opts)
            phase_cols = {f"t_{k}": float(v) for k, v in timers.items()}

        for i in range(trials):
            final_err = float(np.linalg.norm(eT[i]))
            success = bool(np.isfinite(J[i]) and np.isfinite(final_err) and final_err <= success_tol)
            rows.append(
                {
                    "case": case,
                    "trial": i,
                    "solver": solver_name,
                    "status": "ok" if success else "fail",
                    "T_star": int(T[i]),
                    "J_star": float(J[i]),
                    "total_time": float(per_trial_times[i]),
                    "final_err": final_err,
                    "success": success,
                    "n_iter": int(nacc[i]),
                    "n_tied": int(ntied[i]),
                    "solver_error": (
                        f"sweep_fallback_iters={int(nfb[i])}" if method == "onepass" and int(nfb[i]) > 0 else None
                    ),
                    "compile_and_run_s": float(compile_and_run),
                    **(
                        {"consistency_max_abs": cc_max, "consistency_rmse": cc_rmse}
                        if consistency and i == 0
                        else {}
                    ),
                    **(phase_cols if i == 0 else {}),
                }
            )
        succ = np.mean([r["success"] for r in rows if r["solver"] == solver_name])
        print(
            f"[{case}] {solver_name}: median T*={int(np.median(T))} median J*={np.median(J):.4g} "
            f"time/solve={np.median(per_trial_times) * 1e3:.2f} ms success={succ:.2f}",
            flush=True,
        )
    if save_jt and jt_cols:
        case_dir = os.path.join(outdir, case)
        os.makedirs(case_dir, exist_ok=True)
        cols = ["t", *jt_cols]
        table = [
            {"t": t + 1, **{k: float(v[t]) for k, v in jt_cols.items()}} for t in range(int(base.T_max))
        ]
        write_csv(os.path.join(case_dir, f"{case}_Jt.csv"), cols, table)
    return rows


# ---------------------------------------------------------------------------
# Tables: lists of dict rows, with the semantics of the JAX runner's pandas code
# ---------------------------------------------------------------------------


def _nan(v) -> bool:
    return isinstance(v, float) and math.isnan(v)


def columns_of(rows) -> list:
    """The union of the rows' keys in order of first appearance."""
    cols = {}
    for r in rows:
        cols.update(dict.fromkeys(r))
    return list(cols)


def _median(vals) -> float:
    vals = [float(v) for v in vals if v is not None and not _nan(float(v))]
    return float(np.median(vals)) if vals else float("nan")


def _mean(vals) -> float:
    vals = [float(v) for v in vals if v is not None and not _nan(float(v))]
    return float(np.mean(vals)) if vals else float("nan")


def enrich_and_aggregate(rows, solvers):
    """best_J / cost_ratio_best / time_base / time_ratio_base per row and the
    per-(case, solver) aggregate, sorted by (case, solver). Returns
    (rows, agg): lists of dicts with every column present, missing values
    NaN."""
    cols = columns_of(rows)
    out = [{c: r.get(c, float("nan")) for c in cols} for r in rows]
    best = {}  # min over the (case, trial) group, NaN skipped
    for r in out:
        if not _nan(r["J_star"]):
            key = (r["case"], r["trial"])
            best[key] = min(best.get(key, float("inf")), r["J_star"])
    base_time = {}
    if "baseline1" in solvers:
        base_time = {(r["case"], r["trial"]): r["total_time"] for r in out if r["solver"] == "baseline1"}
    with np.errstate(divide="ignore", invalid="ignore"):
        for r in out:
            key = (r["case"], r["trial"])
            r["best_J"] = best.get(key, float("nan"))
            r["cost_ratio_best"] = float(np.float64(r["J_star"]) / r["best_J"])
            r["time_base"] = base_time.get(key, float("nan"))
            r["time_ratio_base"] = float(np.float64(r["total_time"]) / r["time_base"])

    agg = []
    for case, solver in sorted({(r["case"], r["solver"]) for r in out}):
        g = [r for r in out if r["case"] == case and r["solver"] == solver]
        agg.append(
            {
                "case": case,
                "solver": solver,
                "n": len(g),
                "success_rate": _mean(r["success"] for r in g),
                "T_median": _median(r["T_star"] for r in g),
                "J_median": _median(r["J_star"] for r in g),
                "time_median": _median(r["total_time"] for r in g),
                "ratio_cost_median": _median(r["cost_ratio_best"] for r in g),
                "ratio_time_median": _median(r["time_ratio_base"] for r in g),
            }
        )
    return out, agg


def _cell(v) -> str:
    """A CSV cell as pandas writes it: empty for None and NaN, repr for floats."""
    if v is None or _nan(v):
        return ""
    if isinstance(v, (bool, np.bool_)):
        return str(bool(v))
    if isinstance(v, (float, np.floating)):
        return repr(float(v))
    return str(v)


def write_csv(path: str, cols, rows) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([_cell(r.get(c)) for c in cols])


def _write_tables(outdir: str, rows, agg) -> None:
    os.makedirs(outdir, exist_ok=True)
    write_csv(os.path.join(outdir, "summary_all.csv"), columns_of(rows), rows)
    write_csv(os.path.join(outdir, "summary_agg.csv"), columns_of(agg), agg)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--outdir", type=str, default="ilqr_results")
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-iter", type=int, default=12)
    ap.add_argument("--S-window", type=int, default=20)
    ap.add_argument("--use-central-diff", action="store_true")
    ap.add_argument("--success-tol", type=float, default=0.5)
    ap.add_argument("--solvers", type=str, default="ourmethod,baseline1,baseline2")
    ap.add_argument("--cases", type=str, default="")
    ap.add_argument("--timing", choices=["amortized", "per-solve"], default="amortized")
    ap.add_argument("--device", type=str, default="cuda", help="PyTorch device of the solves (default cuda)")
    ap.add_argument("--f32", action="store_true",
                    help="solve in float32 (float32 storage, float64 recursions)")
    ap.add_argument(
        "--save-trajectories", action="store_true",
        help="save per-case solved trajectories (X, U, T*, J*) to <outdir>/<case>/trajectories_<solver>.npz",
    )
    ap.add_argument(
        "--save-jt", action="store_true",
        help="save the trial-0 J(T) selection curve per case/solver to <outdir>/<case>/<case>_Jt.csv",
    )
    ap.add_argument(
        "--distributed", action="store_true",
        help="multi-process run (torchrun's environment: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): the trials "
             "split over the ranks (NCCL on --device cuda, gloo on cpu), results all-gathered, files written by "
             "rank 0 only",
    )
    ap.add_argument(
        "--phase-timers", action="store_true",
        help="add trial-0 per-phase timer columns (t_linearize/t_select/t_backward/t_forward) from the host-driven "
             "phase profiler",
    )
    ap.add_argument(
        "--consistency", action="store_true",
        help="report propagator-vs-bruteforce J(T) consistency (max|d|, rmse) on each solver's trial-0 final trajectory",
    )
    args = ap.parse_args(argv)

    args.solvers = [s.strip() for s in args.solvers.split(",") if s.strip()]
    for s in args.solvers:
        if s not in SOLVER_METHODS:
            ap.error(f"unknown solver: {s}. Options: {list(SOLVER_METHODS)}")
    args.cases = [c.strip() for c in args.cases.split(",") if c.strip()] or CASES
    for c in args.cases:
        if c not in CASES + EXTRA_CASES:
            ap.error(f"unknown case: {c}. Options: {CASES + EXTRA_CASES}")
    return args


def main(argv=None):
    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (use --device cpu for the plain CPU path)")
    is_writer = True
    if args.distributed:
        from timeopt_tpu_torch.parallel import distributed as dist

        dist.initialize(device)
        if args.timing == "per-solve" or args.phase_timers:
            raise ValueError(
                "--distributed supports only amortized timing (per-solve/phase profiling is single-process "
                "host-driven)"
            )
        device = dist.local_device(device)
        # every rank computes the same rows from the gathered results; one writes
        is_writer = dist.process_index() == 0

    all_rows = []
    for case in args.cases:
        rows = run_case(
            case,
            trials=args.trials,
            seed=args.seed,
            solvers=args.solvers,
            max_iter=args.max_iter,
            S_window=args.S_window,
            use_central_diff=args.use_central_diff,
            success_tol=args.success_tol,
            device=device,
            dtype=torch.float32 if args.f32 else torch.float64,
            timing=args.timing,
            save_trajectories=args.save_trajectories and is_writer,
            save_jt=args.save_jt and is_writer,
            consistency=args.consistency,
            phase_timers=args.phase_timers,
            distributed=args.distributed,
            outdir=args.outdir,
        )
        if is_writer:
            _write_tables(os.path.join(args.outdir, case), *enrich_and_aggregate(rows, args.solvers))
        all_rows.extend(rows)

    df_all, agg_all = enrich_and_aggregate(all_rows, args.solvers)
    if not is_writer:
        return
    _write_tables(args.outdir, df_all, agg_all)
    print("\nSaved:")
    print(" ", os.path.join(args.outdir, "summary_all.csv"))
    print(" ", os.path.join(args.outdir, "summary_agg.csv"))
    cols = columns_of(agg_all)
    print(" ".join(cols))
    for r in agg_all:
        print(" ".join(_cell(r[c]) for c in cols))


if __name__ == "__main__":
    main()
