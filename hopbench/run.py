"""One run of one cell of the benchmark of timeopt_tpu_torch.

    python3 -m hopbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The cell (BENCHMARK.json `workloads`) names a deployment
(hopbench/configs/) and a traffic mix (hopbench/traffic/). The run:

1. set-up: makes the cell's pool of batches on the card from the seed, and
   warms up the one program the traffic uses (its first call builds the
   kernels, into timeopt_tpu_torch/_build/ inside the checkout, and captures
   the program), then runs every in-flight slot once through the whole path;
2. the window: the closed loop of hopbench/loop.py for `--seconds`;
3. with `--trace 1`, the cell's per-layer metrics (hopbench/metrics/);
4. the program's state freed, the reference judges the window's answers
   (hopbench/judge.py) against the cell's limits (hopbench/limits/).

It prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with --trace 1
its per-layer metrics), device, and last `checks`, each number compared
with its limit; the same numbers are the last lines of standard error. It
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


def run_cell(cfg: dict, mix: dict, lim: dict, per_layer: list, e2e: list, seed: int, seconds: float, trace: bool,
             device, solve=None, max_batches=None) -> dict:
    """One run of a cell (its configuration, mix and limits): returns the
    result line's object. per_layer and e2e are the cell's metric entries;
    `solve` replaces the program's call and `max_batches` ends the window
    early (the harness's tests break the solve underneath and count the
    batches)."""
    import torch

    from hopbench import context, judge, loop, problems
    from timeopt_tpu_torch.parallel import solve_batch_resident
    from timeopt_tpu_torch.solver import compiled

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = device.type == "cuda"
    system = problems.program_system(cfg)
    opts = options(cfg, mix)
    B, k = int(mix["batch"]), int(mix["in_flight"])
    pool = problems.pool(cfg, int(mix["pool"]), B, seed, device)
    if solve is None:
        def solve(p):
            return solve_batch_resident(system, [p], options=opts)[0]
    dtype = getattr(torch, cfg["dtype"])
    slots = [loop.Slot(B, int(cfg["N"]), system.m, dtype, device) for _ in range(k)]

    # warm-up: the program's build (kernels, capture, loop graph), then each slot once
    t0 = time.perf_counter()
    for s in slots:
        s.fill(solve(pool[0]), timing=False)
    for s in slots:
        s.wait()
    log(f"[setup] warm-up {time.perf_counter() - t0:.3f} s: "
        + "; ".join(f"{p.label} warm-up {p.warmup_s:.3f} s capture {p.capture_s:.3f} s" for p in compiled.programs()))
    progs = compiled.programs()
    ctr0 = [p.ctr.tolist() for p in progs]
    col = judge.Collector(cfg, len(pool), B, int(mix["judge_rows"]), seed)

    win = loop.run(solve, pool, slots, seconds, col.done, timing=trace and cuda, max_batches=max_batches)
    setup_s = win.start - T_START
    built = [p.label for p in compiled.programs() if not any(p is q for q in progs)]
    if built:
        raise RuntimeError(f"hopbench: programs built inside the window: {built}")
    found = forbidden_loaded()
    if found:
        raise RuntimeError(f"hopbench: modules loaded that the benchmark forbids: {found}")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    from timeopt_tpu_torch.ops import cuda_loop

    counters = {"runs": 0, "steps": 0}
    for p, c0 in zip(progs, ctr0):
        c1 = p.ctr.tolist()
        counters["runs"] += c1[cuda_loop.RUNS] - c0[cuda_loop.RUNS]
        counters["steps"] += c1[cuda_loop.STEPS] - c0[cuda_loop.STEPS]
    log(f"[window] {len(win.batches)} batches of {B} in {win.seconds:.3f} s, {k} in flight; loop runs "
        f"{counters['runs']}, steps {counters['steps']}; setup {setup_s:.3f} s")

    metrics = {}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
           "memory_peak_bytes": int(peak)}
    if trace:
        ctx = context.Context(cfg, mix, system, opts, pool, win, counters, device)
        for m in per_layer:
            v = harness.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        timed = [b for b in win.batches if b.start_ms is not None]
        dev["busy_s"] = sum(b.end_ms - b.start_ms for b in timed) / 1e3
        dev["window_s"] = win.seconds
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
    return {"correct": bool(ok), "attempted": col.attempted, "failed": col.failed,
            "metrics": metrics, "device": dev, "card": card, "checks": checks}


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
                   torch.device("cuda", 0))
    found = forbidden_loaded()
    if found:
        log(f"hopbench: modules loaded that the benchmark forbids: {found}")
        return 3
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
