"""The readings a cell's limits are set from, on the chip, in one process.

    python3 -m hopbench.control --workload <cell> --seeds <n> [<n> ...]
        [--faults <fault> ...] [--fault-seeds <k>] [--out <file>]

For each seed, at the cell's own size and load, on its cards: the cell's
pool of batches from that seed, each batch of the pool solved once through
the cell's closed loop (hopbench/loop.py; split over the cards as a run
splits it, hopbench/run.py::split), and the window's answers judged as a
run judges them (hopbench/judge.py). Then, on the same sampled problems, the
control: the plain reference in float32 put in the program's place
(reference/check.py::control: its own rollout of the program's controls,
its own horizon curve's argmin and its own cost there), judged the same
way. Then each fault of hopbench/faults.py planted in the program, on the
first --fault-seeds seeds (3 by default). The program's numbers over the
seeds give each limit's lower reading, the control's and the faults' its
upper one. Prints one JSON line per reading and a summary (the largest
program reading, the smallest control reading and the smallest reading of
each fault, for each number), and writes them to --out when given.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from hopbench import faults, harness, judge, loop, problems
from hopbench.reference.check import Deployment, control, worst
from hopbench.run import forbidden_loaded, log, options, power_limit, split

NUMBERS = ("cost_gap", "horizon_excess", "descent_left", "descent_left_median", "nonfinite")


def solve_pool(cfg: dict, mix: dict, system, opts, seed: int, devices: list) -> tuple:
    """The pool of `seed` solved once through the closed loop on `devices`:
    (the sample's (x0, T*, J*, U) on the first device, the program's
    numbers)."""
    from timeopt_tpu_torch.parallel import solve_batch_resident

    device = devices[0]
    B, k, P = int(mix["batch"]), int(mix["in_flight"]), int(mix["pool"])
    slots = [loop.Slot(B, int(cfg["N"]), system.m, getattr(torch, cfg["dtype"]), devices) for _ in range(k)]
    pool = problems.pool(cfg, P, B, seed, device)
    col = judge.Collector(cfg, P, B, int(mix["judge_rows"]), seed)
    loop.run(lambda ps: solve_batch_resident(system, ps, options=opts), split(pool, devices), slots, 1e9, col.done,
             max_batches=P)
    x0_pool = [p.x0.cpu().numpy() for p in pool]
    nums = judge.numbers(cfg, col, x0_pool, device)
    return tuple(torch.as_tensor(a).to(device) for a in col.sample(x0_pool)), nums


def readings(name: str, seeds: list, fault_names: list, fault_seeds: int, devices: list) -> dict:
    man = harness.manifest()
    w = harness.cell(name, man)
    cfg, mix = harness.config(w["config"]), harness.traffic(w["traffic"])
    system = problems.program_system(cfg)
    opts = options(cfg, mix)
    device = devices[0]
    d64, d32 = Deployment(cfg, torch.float64, device), Deployment(cfg, torch.float32, device)
    out = {"workload": name, "seeds": [], "faults": []}
    for seed in seeds:
        t0 = time.perf_counter()
        (x0, T, J, U), prog = solve_pool(cfg, mix, system, opts, seed, devices)
        parts = []
        for i in range(0, x0.shape[0], judge.BLOCK):
            Tc, Jc, Uc = control(d32, x0[i:i + judge.BLOCK], U[i:i + judge.BLOCK])
            parts.append(judge.per_problem(d64, x0[i:i + judge.BLOCK], Tc, Jc, Uc))
        ctrl = worst({k: torch.cat([p[k] for p in parts]) for k in parts[0]})
        rec = {"seed": seed, "program": prog, "control": ctrl, "seconds": time.perf_counter() - t0}
        out["seeds"].append(rec)
        print(json.dumps(rec), flush=True)
    for f in fault_names:
        with faults.planted(f, opts) as fopts:
            for seed in seeds[:fault_seeds]:
                t0 = time.perf_counter()
                _, nums = solve_pool(cfg, mix, system, fopts, seed, devices)
                rec = {"fault": f, "seed": seed, "numbers": nums, "seconds": time.perf_counter() - t0}
                out["faults"].append(rec)
                print(json.dumps(rec), flush=True)
    out["summary"] = {
        key: dict({"program_max": max(r["program"][key] for r in out["seeds"]),
                   "control_min": min(r["control"][key] for r in out["seeds"])},
                  **{f"{f}_min": min(r["numbers"][key] for r in out["faults"] if r["fault"] == f)
                     for f in fault_names}) for key in NUMBERS}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--faults", nargs="*", default=[], choices=faults.FAULTS)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    chips = int(harness.cell(args.workload, harness.manifest())["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"hopbench.control: the cell needs {chips} CUDA device(s)")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = readings(args.workload, args.seeds, args.faults, args.fault_seeds,
                   [torch.device("cuda", i) for i in range(chips)])
    out["card"] = power_limit()
    if forbidden_loaded():
        log(f"hopbench.control: forbidden modules loaded: {forbidden_loaded()}")
        return 3
    print(json.dumps({"summary": out["summary"], "card": out["card"]}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
