"""Benchmark of the PyTorch/CUDA port: batched HOP-DDP solves/s over the cards.

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
- the entry: with BENCH_SHARDED=1 (the default) the dp-sharded serving
  entry, as bench.py's: the batch split over a ("dp",) mesh of every local
  card and each chunk placed on its card before the timed region
  (parallel/mesh.py: make_mesh, shard_problems), then solved in place by
  solve_batch_resident, every card's captured program driven together, no
  split, copy or gather between cards in the timed region; each card
  reduces its own checksum and the scalars are added. One card is a mesh
  of one device, the same program. BENCH_SHARDED=0 places the whole batch
  on one card, as bench.py's does (the same solve on one chunk: what
  solve_batch runs);
- the timing: one untimed first call (it builds the CUDA kernels and
  captures each card's program); then BENCH_REPS (5) reps of BENCH_PIPE
  (4) batches queued on the device with one sync a group, as bench.py's:
  each batch is one loop-graph launch a card that reads nothing back
  (solver/compiled.py), so the host queues the group's batches ahead of
  the cards; the least time per batch;
- the output: exactly one JSON line on stdout with bench.py's keys
  (metric, value, unit, vs_baseline, batch, pipeline, batch_time_s,
  success_rate, T_star_median). `value` is solves/s, `vs_baseline` the
  same against the reference's 1/2.9 solves/s (one quadrotor solve in 2.9
  s on a CPU, BASELINE.md), `success_rate` the share of problems with a
  finite J* and ||wrap(x_T* - x_g)|| <= 0.5, `T_star_median` the median
  selected horizon. The metric says dp-sharded where it is, and names the
  card count and the card (torch.cuda.get_device_name), and float32.
  Progress goes to stderr.

It runs on the card and fails without one. `main(device="cpu",
n_devices=k)` runs the same code on a mesh of k CPU entries (plain
PyTorch versions of the kernels), for tests at a tiny size; no
environment variable makes it fall back.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional

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
                n=int(env("BENCH_N", "0")), sharded=env("BENCH_SHARDED", "1") == "1")


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


def make_bench(system, parts: list):
    """The timed function over problems already on their devices: `parts`
    is shard_problems' chunks, or one Problem. A call solves them in place
    (solve_batch_resident) and, on each chunk's device, takes J*, T*, the
    final error and a checksum of the three; it returns the per-chunk
    (J, T, err), in batch order, and the checksums' sum on the first
    chunk's device, whose read to the host waits for every device's work
    of the call."""
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.parallel import solve_batch_resident
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    parts = [p for p in parts if p.batch]
    rows = [torch.arange(p.batch, device=p.x0.device) for p in parts]
    home = parts[0].x0.device

    def bench_fn():
        outs, checksum = [], 0.0
        for p, r, res in zip(parts, rows, solve_batch_resident(system, parts, options=opts)):
            eT = wrap_error(res.X[r, res.T_star] - p.xg, p.wrap_mask)
            err = torch.sqrt(torch.sum(torch.square(eT), dim=-1))
            J, T = res.J_star, res.T_star
            outs.append((J, T, err))
            checksum = checksum + (torch.where(torch.isfinite(J), J, 0.0).sum() + T.sum()
                                   + torch.where(torch.isfinite(err), err, 0.0).sum()).to(home)
        return outs, checksum

    return bench_fn


def summary(outs: list) -> tuple:
    """(J, T, err, success) on the host in batch order from make_bench's
    per-chunk outputs; success: J* finite and ||wrap(x_T* - x_g)|| <= 0.5."""
    J, T, err = (np.concatenate([o[i].cpu().numpy() for o in outs]) for i in range(3))
    return J, T, err, np.isfinite(J) & np.isfinite(err) & (err <= 0.5)


def main(device: str = "cuda", n_devices: Optional[int] = None) -> dict:
    """Run the benchmark and print its JSON line. Sharded, the mesh is
    make_mesh(n_devices) of `device`'s type: every local card by default,
    or n_devices (default 1) entries of the CPU."""
    from timeopt_tpu_torch.parallel import make_mesh, shard_problems

    k = knobs()
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_torch: no CUDA device; this benchmark runs on the card")
    system, probs = bench_problems(k["case"], k["batch"], k["n"])
    # the problems on their devices before the timed region
    if k["sharded"]:
        parts = shard_problems(probs, make_mesh(n_devices, device_type=device.type))
    else:
        parts = [probs.to(device)]
    count = len(parts)
    card = torch.cuda.get_device_name(parts[0].x0.device) if device.type == "cuda" else "CPU"
    log(f"device: {count} x {card}, batch={k['batch']}, case={k['case']}, float32, sharded={k['sharded']}")
    bench_fn = make_bench(system, parts)

    t0 = time.perf_counter()
    float(bench_fn()[1])  # the first call builds the kernels and captures each card's program
    log(f"first call (kernel builds, capture + run): {time.perf_counter() - t0:.1f}s")

    times = []
    for _ in range(k["reps"]):
        t0 = time.perf_counter()
        for _ in range(k["pipe"]):
            out = bench_fn()
        float(out[1])  # each card runs in order, and the sum waits for every card's last checksum
        times.append((time.perf_counter() - t0) / k["pipe"])
    t_batch = min(times)
    solves_per_s = k["batch"] / t_batch

    J, T, err, success = summary(out[0])
    finite = np.isfinite(J)
    log(f"batch time: {t_batch * 1e3:.1f} ms  solves/s: {solves_per_s:.0f}  finite: {finite.mean():.3f}  "
        f"success@0.5: {success.mean():.3f}  T* range: [{T.min()}, {T.max()}] median {np.median(T)}")

    name = "quadrotor" if k["case"] == "Quadrotor" else k["case"]
    horizon = f", N={k['n']}" if k["n"] else ""
    line = {
        "metric": (f"{name} HOP-DDP solves/s (batched{', dp-sharded' if k['sharded'] else ''}, {count} x {card}, "
                   f"float32, max_iter={MAX_ITER}{horizon})"),
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
