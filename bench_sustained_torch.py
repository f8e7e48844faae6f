"""Sustained-stream benchmark of the PyTorch/CUDA port over the cards.

    python3 bench_sustained_torch.py

The port's counterpart of scripts/bench_sustained.py (the JAX package's,
which stays as it is): the dp-sharded serving entry of bench_torch.py
(quadrotor, float32, max_iter 12, psd_levels 1, bench.py's problem set;
the batch split over every local card and placed before any timing, then
solved in place by solve_batch_resident) run as a continuous stream of
SUS_BATCH (1024) batches for DURATION_S (60) seconds, SUS_PIPE (4) batches
queued on the device with one sync a group, as scripts/bench_sustained.py's
(each batch one loop-graph launch a card with no read to the host), each
group's time divided by SUS_PIPE as its batches' time; then one BIG_BATCH
(8192; 0 leaves it out) point over the same cards: one untimed call, then
the least of 3 timed ones.

Checks that hold the record to what it claims, each raising if it fails:
no captured program is built inside the stream's window (the programs of
compiled.programs() after it are those before it), and the last batch's
T* and J* are bit for bit the first batch's (the stream solves the same
problems over and over).

Output: one JSON line on stdout with scripts/bench_sustained.py's keys in
its order (metric, value, unit, vs_baseline, duration_s, n_batches,
p50_batch_s, p99_batch_s, max_batch_s, first_half_solves_per_s,
second_half_solves_per_s, success_rate, big_batch {batch, batch_time_s,
solves_per_s, success_rate}); the metric names the card count, the card
and float32. With SUS_OUT set, the record is also written there (indented
JSON). Progress goes to stderr.

It runs on the card and raises without one. `sustained(mesh, ...)` runs the
same stream on any mesh, a CPU one included, for tests at a tiny size.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

import bench_torch

MAX_ITER = bench_torch.MAX_ITER
log = bench_torch.log


def knobs() -> dict:
    """scripts/bench_sustained.py's environment knobs, read when main() runs."""
    env = os.environ.get
    return dict(duration_s=float(env("DURATION_S", "60")), batch=int(env("SUS_BATCH", "1024")),
                pipe=int(env("SUS_PIPE", "4")), big=int(env("BIG_BATCH", "8192")), out=env("SUS_OUT"))


def sustained(mesh, duration_s: float, batch: int, pipe: int, big: int, case: str = "Quadrotor",
              bench_n: int = 0) -> tuple:
    """The stream and the big-batch point on `mesh`'s "dp" devices:
    (record, arrays), `arrays` holding the first and last batch's T* and
    J* and the big batch's (T_big, J_big; absent with big=0), in batch
    order on the host."""
    from timeopt_tpu_torch.parallel import shard_problems
    from timeopt_tpu_torch.solver import compiled

    def make(B: int):
        system, probs = bench_torch.bench_problems(case, B, bench_n)
        return bench_torch.make_bench(system, shard_problems(probs, mesh))

    devs = mesh.axis_devices("dp")
    card = torch.cuda.get_device_name(devs[0]) if devs[0].type == "cuda" else "CPU"
    bench_fn = make(batch)
    t0 = time.perf_counter()
    first = bench_fn()
    float(first[1])
    log(f"warmup (kernel builds, capture + run): {time.perf_counter() - t0:.1f}s")

    before = compiled.programs()
    group_times = []  # seconds per group of `pipe` batches
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < duration_s or len(group_times) < 2:
        tg = time.perf_counter()
        for _ in range(pipe):
            out = bench_fn()
        float(out[1])  # each card runs in order: the checksum's read ends the group on every card
        group_times.append(time.perf_counter() - tg)
    total_s = time.perf_counter() - t_start
    built = [p.label for p in compiled.programs() if not any(p is q for q in before)]
    log(f"programs built in the stream's window: {len(built)}")
    if built:
        raise RuntimeError(f"bench_sustained_torch: programs built inside the timed window: {built}")
    n_batches = len(group_times) * pipe
    per_batch = np.asarray(group_times) / pipe

    J0, T0 = bench_torch.summary(first[0])[:2]
    J, T, err, success = bench_torch.summary(out[0])
    same = np.array_equal(T, T0) and J.tobytes() == J0.tobytes()
    log(f"last batch's T* and J* bitwise the first's: {same}")
    if not same:
        raise RuntimeError("bench_sustained_torch: the last batch's T* or J* differ from the first batch's")
    arrays = dict(T_first=T0, J_first=J0, T=T, J=J)
    half = len(per_batch) // 2
    name = "quadrotor" if case == "Quadrotor" else case
    horizon = f", N={bench_n}" if bench_n else ""
    record = {
        "metric": (f"{name} HOP-DDP sustained solves/s (continuous stream, B={batch}, PIPE={pipe}, "
                   f"{total_s:.0f}s, {len(devs)} x {card}, float32, max_iter={MAX_ITER}{horizon})"),
        "value": round(n_batches * batch / total_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(n_batches * batch / total_s / bench_torch.BASELINE_SOLVES_PER_S, 1),
        "duration_s": round(total_s, 1),
        "n_batches": n_batches,
        "p50_batch_s": round(float(np.percentile(per_batch, 50)), 5),
        "p99_batch_s": round(float(np.percentile(per_batch, 99)), 5),
        "max_batch_s": round(float(per_batch.max()), 5),
        "first_half_solves_per_s": round(batch / float(per_batch[:half].mean()), 1),
        "second_half_solves_per_s": round(batch / float(per_batch[half:].mean()), 1),
        "success_rate": round(float(success.mean()), 4),
    }
    log(f"stream: {record['value']} solves/s over {n_batches} batches in {total_s:.1f}s, p50 "
        f"{record['p50_batch_s']} s, p99 {record['p99_batch_s']} s")

    if big:
        big_fn = make(big)
        t0 = time.perf_counter()
        float(big_fn()[1])
        log(f"B={big} warmup (capture + run): {time.perf_counter() - t0:.1f}s")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            outb = big_fn()
            float(outb[1])
            times.append(time.perf_counter() - t0)
        tb = min(times)
        Jb, Tb, _, succ_b = bench_torch.summary(outb[0])
        arrays.update(T_big=Tb, J_big=Jb)
        record["big_batch"] = {
            "batch": big,
            "batch_time_s": round(tb, 4),
            "solves_per_s": round(big / tb, 2),
            "success_rate": round(float(succ_b.mean()), 4),
        }
        log(f"B={big}: {record['big_batch']['solves_per_s']} solves/s, times {[round(t, 4) for t in times]}")
    return record, arrays


def main() -> dict:
    from timeopt_tpu_torch.parallel import make_mesh

    k = knobs()
    if not torch.cuda.is_available():
        raise RuntimeError("bench_sustained_torch: no CUDA device; this benchmark runs on the card")
    record, _ = sustained(make_mesh(), k["duration_s"], k["batch"], k["pipe"], k["big"])
    if k["out"]:
        os.makedirs(os.path.dirname(os.path.abspath(k["out"])), exist_ok=True)
        with open(k["out"], "w") as f:
            json.dump(record, f, indent=1)
            f.write("\n")
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
