"""Benchmark of the PyTorch/CUDA port: batched HOP-DDP solves/s on one card.

    python3 bench_torch.py

The port's counterpart of bench.py (the JAX package's entry, which stays
as it is), with its configuration, timing and output:

- the problems: BENCH_CASE (Quadrotor) in float32, BENCH_BATCH (1024) of
  them, x0 perturbed as bench.py perturbs it (x0[:, :3] += 0.4 N(0, 1) for
  the quadrotor, x0 += sigma_x0 N(0, 1) for any other case, float32 draws
  from numpy's default_rng(0)); BENCH_N overrides the case's N and clamps
  T_min and T_max to it;
- the solver: SolveOptions(method="propagator", max_iter=12,
  psd_levels=1), the port's float32 path (float32 storage, float64
  recursions in the select, backward and line-search kernels);
- the timing: the problems on the device before the timed region; one
  untimed first call (it builds the CUDA kernels); then BENCH_REPS (5)
  reps of BENCH_PIPE (4) batches back to back with one final sync each,
  the least time per batch. The batch goes through solve_batch on one
  card. bench.py's BENCH_SHARDED is not taken: the port has no
  data-parallel speedup inside one process (parallel/mesh.py solves its
  chunks one after another), so throughput over several cards is a
  matter for the runner's --distributed, one rank per card;
- the output: exactly one JSON line on stdout with bench.py's keys
  (metric, value, unit, vs_baseline, batch, pipeline, batch_time_s,
  success_rate, T_star_median). `value` is solves/s, `vs_baseline` the
  same against the reference's 1/2.9 solves/s (one quadrotor solve in 2.9
  s on a CPU, BASELINE.md), `success_rate` the share of problems with a
  finite J* and ||wrap(x_T* - x_g)|| <= 0.5, `T_star_median` the median
  selected horizon. The metric names the card (torch.cuda.get_device_name)
  and float32. Progress goes to stderr.

It runs on the card and fails without one. `main(device="cpu")` runs the
same code on the CPU (plain PyTorch versions of the kernels), for tests at
a tiny size; no environment variable makes it fall back.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

MAX_ITER = 12
BASELINE_SOLVES_PER_S = 1.0 / 2.9


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def knobs() -> dict:
    """bench.py's environment knobs, read when main() runs."""
    env = os.environ.get
    return dict(batch=int(env("BENCH_BATCH", "1024")), reps=int(env("BENCH_REPS", "5")),
                pipe=int(env("BENCH_PIPE", "4")), case=env("BENCH_CASE", "Quadrotor"),
                n=int(env("BENCH_N", "0")))


def bench_problems(case: str, batch: int, bench_n: int):
    """(system, problems on the CPU): bench.py's float32 problem set."""
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    system, mk = get_system(case)
    base = mk(device="cpu", dtype=torch.float32)
    if bench_n:
        base = base.replace(N=bench_n, T_min=min(base.T_min, bench_n), T_max=min(base.T_max, bench_n))
    rng = np.random.default_rng(0)
    x0s = np.tile(base.x0[0].numpy(), (batch, 1))
    if case == "Quadrotor":
        x0s[:, :3] += 0.4 * rng.standard_normal((batch, 3)).astype(np.float32)
    else:
        x0s += np.asarray(system.sigma_x0, np.float32) * rng.standard_normal(x0s.shape).astype(np.float32)
    return system, broadcast_problem(base, batch).replace(x0=torch.as_tensor(x0s))


def main(device: str = "cuda") -> dict:
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    k = knobs()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; this benchmark runs on the card")
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    log(f"device: {card}, batch={k['batch']}, case={k['case']}, float32")

    system, probs = bench_problems(k["case"], k["batch"], k["n"])
    probs = probs.to(device)  # device-resident before the timed region
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    rows = torch.arange(k["batch"], device=device)

    def bench_fn():
        res = solve_batch(system, probs, options=opts)
        eT = wrap_error(res.X[rows, res.T_star] - probs.xg, probs.wrap_mask)
        err = torch.sqrt(torch.sum(torch.square(eT), dim=-1))
        J, T = res.J_star, res.T_star
        checksum = (torch.where(torch.isfinite(J), J, 0.0).sum() + T.sum()
                    + torch.where(torch.isfinite(err), err, 0.0).sum())
        return J, T, err, checksum

    t0 = time.perf_counter()
    float(bench_fn()[3])  # the first call builds the kernels and captures the solve's graphs
    log(f"first call (kernel builds, capture + run): {time.perf_counter() - t0:.1f}s")

    times = []
    for _ in range(k["reps"]):
        t0 = time.perf_counter()
        for _ in range(k["pipe"]):
            out = bench_fn()
        float(out[3])  # the device runs in order: syncing the last syncs all
        times.append((time.perf_counter() - t0) / k["pipe"])
    t_batch = min(times)
    solves_per_s = k["batch"] / t_batch

    J, T, err = (t.cpu().numpy() for t in out[:3])
    finite = np.isfinite(J)
    success = finite & np.isfinite(err) & (err <= 0.5)
    log(f"batch time: {t_batch * 1e3:.1f} ms  solves/s: {solves_per_s:.0f}  finite: {finite.mean():.3f}  "
        f"success@0.5: {success.mean():.3f}  T* range: [{T.min()}, {T.max()}] median {np.median(T)}")

    name = "quadrotor" if k["case"] == "Quadrotor" else k["case"]
    horizon = f", N={k['n']}" if k["n"] else ""
    line = {
        "metric": f"{name} HOP-DDP solves/s (batched, 1 x {card}, float32, max_iter={MAX_ITER}{horizon})",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / BASELINE_SOLVES_PER_S, 1),
        "batch": k["batch"],
        "pipeline": k["pipe"],
        "batch_time_s": round(t_batch, 4),
        "success_rate": round(float(success.mean()), 4),
        "T_star_median": float(np.median(T)),
    }
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
