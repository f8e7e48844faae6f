"""One run of one cell of the benchmark of timeopt_tpu_torch.

    python3 -m hopbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (BENCHMARK.json `workloads`) names a deployment
(hopbench/configs/), a traffic mix (hopbench/traffic/) and its cards
(`chips`). The run:

1. set-up: makes the cell's pool of batches on the first card from the
   seed; on several cards splits each batch into equal chunks, one a card,
   placed by the program's shard_problems (parallel/mesh.py), so a run
   judges the same problems whatever the cards; and warms up the program
   the traffic uses on each card (its first call builds the kernels, into
   timeopt_tpu_torch/_build/ inside the checkout, and captures the
   program), then runs every in-flight slot once through the whole path;
2. the window: the closed loop of hopbench/loop.py for `--seconds`;
3. with `--trace 1`, the cell's per-layer metrics (hopbench/metrics/);
4. the program's state freed, the reference judges the window's answers
   (hopbench/judge.py) against the cell's limits (hopbench/limits/).

It prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), device, with --trace 1 on the card `breakdown`
(hopbench/breakdown.py), and last `checks`, each number compared with its
limit; the same numbers are the last lines of standard error. It
exits non-zero, printing no result, without the cards the cell asks for,
without the program, or if jax, jaxlib, flax or the JAX package
(timeopt_tpu) is loaded in the process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from hopbench import harness  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "timeopt_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def forbidden_loaded() -> list:
    """The forbidden top-level names among the loaded modules, compared whole."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"


def options(cfg: dict, mix: dict):
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    return SolveOptions(method=mix["method"], max_iter=int(cfg["max_iter"]), psd_levels=int(cfg["psd_levels"]))


def split(pool: list, devices: list) -> list:
    """Each batch of the pool as the solve takes it, its parts, one a
    device: the whole batch on one card; on several, equal contiguous
    chunks in the devices' order, placed by the program's shard_problems as
    its serving entry takes them (parallel/mesh.py)."""
    if len(devices) == 1:
        return [[p] for p in pool]
    import numpy as np

    from timeopt_tpu_torch.parallel import shard_problems
    from timeopt_tpu_torch.parallel.mesh import Mesh

    if pool[0].batch % len(devices):
        raise ValueError(f"hopbench: a batch of {pool[0].batch} does not split evenly over {len(devices)} cards")
    mesh = Mesh(np.array(devices, dtype=object), ("dp",))
    return [shard_problems(p, mesh) for p in pool]


def run_cell(cfg: dict, mix: dict, lim: dict, per_layer: list, e2e: list, seed: int, seconds: float, trace: bool,
             devices: list, solve=None, max_batches=None) -> dict:
    """One run of a cell (its configuration, mix and limits) on `devices`
    (the cell's cards in order; the harness's tests give entries of the
    CPU): returns the result line's object. per_layer and e2e are the
    cell's metric entries; `solve` replaces the program's call (it takes a
    batch's parts and returns their results, one a device) and
    `max_batches` ends the window early (the harness's tests break the
    solve underneath and count the batches)."""
    import torch

    from hopbench import breakdown, context, judge, loop, problems
    from timeopt_tpu_torch.parallel import solve_batch_resident
    from timeopt_tpu_torch.solver import compiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = devices[0]
    cuda = device.type == "cuda"
    system = problems.program_system(cfg)
    opts = options(cfg, mix)
    B, k = int(mix["batch"]), int(mix["in_flight"])
    pool = problems.pool(cfg, int(mix["pool"]), B, seed, device)
    parts = split(pool, devices)
    if solve is None:
        def solve(ps):
            return solve_batch_resident(system, ps, options=opts)
    dtype = getattr(torch, cfg["dtype"])
    slots = [loop.Slot(B, int(cfg["N"]), system.m, dtype, devices) for _ in range(k)]

    # warm-up: the program's build on each card (kernels, capture, loop graph), then each slot once
    t0 = time.perf_counter()
    for s in slots:
        s.fill(solve(parts[0]), timing=False)
    for s in slots:
        s.wait()
    log(f"[setup] warm-up {time.perf_counter() - t0:.3f} s: "
        + "; ".join(f"{p.label} warm-up {p.warmup_s:.3f} s capture {p.capture_s:.3f} s" for p in compiled.programs()))
    progs = compiled.programs()
    ctr0 = [p.ctr.tolist() for p in progs]
    col = judge.Collector(cfg, len(pool), B, int(mix["judge_rows"]), seed)

    win = loop.run(solve, parts, slots, seconds, col.done, timing=trace and cuda, max_batches=max_batches)
    setup_s = win.start - T_START
    built = [p.label for p in compiled.programs() if not any(p is q for q in progs)]
    if built:
        raise RuntimeError(f"hopbench: programs built inside the window: {built}")
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"hopbench: modules loaded that the benchmark forbids: {found}")
    peaks = [torch.cuda.max_memory_allocated(d) for d in devices] if cuda else [0]
    from timeopt_tpu_torch.ops import cuda_loop

    counters = {"runs": 0, "steps": 0}
    for p, c0 in zip(progs, ctr0):
        c1 = p.ctr.tolist()
        counters["runs"] += c1[cuda_loop.RUNS] - c0[cuda_loop.RUNS]
        counters["steps"] += c1[cuda_loop.STEPS] - c0[cuda_loop.STEPS]
    log(f"[window] {len(win.batches)} batches of {B} over {len(devices)} card(s) in {win.seconds:.3f} s, {k} in "
        f"flight; loop runs {counters['runs']}, steps {counters['steps']}; setup {setup_s:.3f} s; memory peak "
        f"each card {peaks}")

    metrics, brk = {}, None
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": len(devices),
           "memory_peak_bytes": int(max(peaks))}
    if trace:
        ctx = context.Context(cfg, mix, system, opts, pool, win, counters, device)
        for m in per_layer:
            v = harness.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        timed = [b for b in win.batches if b.card_ms]
        busy = [sum(b.card_ms[c][1] - b.card_ms[c][0] for b in timed) for c in range(len(devices))]
        dev["busy_s"] = sum(busy) / len(devices) / 1e3  # averaged over the cards
        dev["window_s"] = win.seconds
        if cuda:
            brk = breakdown.read(ctx, len(devices))
    else:
        e2e_values = dict(loop.end_to_end(win, B), setup_s=setup_s)
        for m in e2e:
            metrics[m["name"]] = {"value": float(e2e_values[m["name"]]), "unit": m["unit"]}

    x0_pool = [p.x0.cpu().numpy() for p in pool]
    compiled.clear_compiled()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    nums = judge.numbers(cfg, col, x0_pool, device)
    ok, checks = judge.verdict(nums, lim)
    card = power_limit() if cuda else "cpu"
    log(f"[judge] {nums['judged']} problems judged in {time.perf_counter() - t0:.3f} s; card {card}; "
        f"unlimited numbers: " + ", ".join(f"{k} {v}" for k, v in nums.items() if k not in checks))
    for key, c in checks.items():
        log(f"check {key} {c['value']!r} limit {c['limit']!r}")
    res = {"correct": bool(ok), "attempted": col.attempted, "failed": col.failed, "metrics": metrics, "device": dev}
    if brk is not None:
        res["breakdown"] = brk
    return dict(res, card=card, checks=checks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    man = harness.manifest()
    w = harness.cell(args.workload, man)
    cfg, mix, lim = harness.config(w["config"]), harness.traffic(w["traffic"]), harness.limits(w["name"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        log(f"hopbench: the cell {w['name']} needs {w['chips']} CUDA device(s); "
            f"available {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run_cell(cfg, mix, lim, harness.metrics_of(w["name"], man, "per_layer"),
                   harness.metrics_of(w["name"], man, "end_to_end"), args.seed, args.seconds, bool(args.trace),
                   [torch.device("cuda", i) for i in range(int(w["chips"]))])
    found = forbidden_loaded()
    if found:
        log(f"hopbench: modules loaded that the benchmark forbids: {found}")
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
