"""The traced window of a cell, read by the per-layer metrics that read the
program's own spans and counters (timeopt_tpu_torch/utils/trace.py):
`step.*_ms`, `loop.active_share`, `entry.between_ms`, `entry.call_ms`,
`setup.warmup_s` and `setup.capture_s`.

`window(ctx)` (memoised through ctx.cached) turns the program's tracing on
and runs the cell's own closed loop again (hopbench/loop.py::run, fresh
slots, the cell's in_flight) over the pool: pool + 2 x in_flight batches,
of which the first in_flight (the traced program's build and the loop's
ramp) are discarded. It then drains the stamp logs and calibrates the
clocks, prints the `[trace]` table to standard error, and returns the
`Summary`. It returns None off the card, and where the program has no
recorder (a program older than it): every reader then returns None.

`summarize` computes the summary from the records and the set-up
program's `build` span alone (the program keeps its build's spans; the
recorder lists only those of builds made while tracing is on), so the
harness's tests hold the readers to synthetic ones.
"""

from __future__ import annotations

import statistics
import sys
from dataclasses import dataclass, field

# the phases of a step, in order, and the ones nested in them
TOP = ("linearize", "select", "backward", "forward", "commit")
NESTED = ("select.inputs", "select.kernel", "extra_cost", "backward.kernel", "forward.kernel")
KERNEL = {"select.kernel": " #1|#7", "backward.kernel": " #3", "forward.kernel": " #5"}
BUILD = ("build.warmup.init", "build.warmup.step", "build.capture.init", "build.capture.step", "build.loop_graph")


@dataclass
class Summary:
    batch: int
    steps: int  # traced steps kept
    launches: list  # launch indices kept
    phase_ms: dict  # phase -> median over the kept steps of its time in the step (ms; every instance summed)
    self_ms: dict  # phase -> median self time (ms)
    period_ms: float | None  # median step-start to next step-start, within a launch
    launch_ms: float | None  # median launch-start to next launch-start (init begin to init begin)
    init_ms: dict  # init, init.rollout, init.warm -> median ms a launch
    top_sum_ms: float | None  # median over steps of the top-level phases' sum
    active_share: float | None  # %: problem-steps on problems not done at the step's start
    pending_by_iteration: dict  # iteration -> mean count of problems not done at its start
    between_ms: list  # device gaps from one kept launch's last stamp to the next's first
    gaps: list  # (ms, launch before, host span open at the gap's middle), longest first
    call_ms: list  # entry.call host spans of the kept launches
    build: dict = field(default_factory=dict)  # set-up program's build span name -> s (and its kernel loads)


def _median(xs):
    return statistics.median(xs) if xs else None


def build_seconds(build) -> dict:
    """Span name -> seconds of a program's `build` span (trace.Span) and its
    descendants: each library load as `build.kernels.<lib>`, each of BUILD
    also with its self time as `<name>.self`, instances of a name summed."""
    out, todo = {"build": build.seconds}, list(build.children)
    while todo:
        r = todo.pop(0)
        todo += r.children
        key = r.name if r.name != "build.kernels" else f"build.kernels.{r.args.get('lib')}"
        out[key] = out.get(key, 0.0) + r.seconds
        if r.name in BUILD:
            out[f"{r.name}.self"] = r.seconds - sum(c.seconds for c in r.children)
    return out


def summarize(recs: list, batch: int, keep_from: int, setup=None) -> Summary:
    """The summary of trace.records() `recs`: the traced program's device
    phases and calls of launches >= keep_from, and the build of `setup`,
    the `build` span of the program the set-up built (tracing off)."""
    dev = [r for r in recs if r.track == "device"]
    traced = max((r.program for r in dev), default=None)
    dev = [r for r in dev if r.program == traced and r.launch >= keep_from]
    index = {id(r): i for i, r in enumerate(recs)}
    steps = [r for r in dev if r.name == "step" and r.iteration >= 0]

    def descendants(i):
        out, todo = [], [i]
        while todo:
            j = todo.pop()
            kids = [k for k in children.get(j, ())]
            out += kids
            todo += kids
        return out

    children: dict = {}
    for i, r in enumerate(recs):
        if r.parent is not None:
            children.setdefault(r.parent, []).append(i)
    per_step, self_step = [], []
    for s in steps:
        tot, own = {}, {}
        for k in descendants(index[id(s)]):
            r = recs[k]
            tot[r.name] = tot.get(r.name, 0) + r.ns
            own[r.name] = own.get(r.name, 0) + r.self_ns
        own["step"] = s.self_ns
        per_step.append(tot)
        self_step.append(own)
    names = TOP + NESTED
    phase_ms = {n: _median([d[n] / 1e6 for d in per_step if n in d]) for n in names}
    self_ms = {n: _median([d[n] / 1e6 for d in self_step if n in d]) for n in names + ("step",)}
    phase_ms = {n: v for n, v in phase_ms.items() if v is not None}
    self_ms = {n: v for n, v in self_ms.items() if v is not None}

    by_launch: dict = {}
    for r in dev:
        by_launch.setdefault(r.launch, []).append(r)
    periods = []
    for rs in by_launch.values():
        starts = sorted(r.t0 for r in rs if r.name == "step" and r.iteration >= 0)
        periods += [(b - a) / 1e6 for a, b in zip(starts, starts[1:])]
    first = {lnc: min(r.t0 for r in rs) for lnc, rs in by_launch.items()}
    launch_ms = _median([(first[lnc + 1] - first[lnc]) / 1e6 for lnc in first if lnc + 1 in first])
    init_ms = {n: _median([r.ns / 1e6 for r in dev if r.name == n]) for n in ("init", "init.rollout", "init.warm")}
    tops = [sum(d.get(n, 0) for n in TOP) / 1e6 for d in per_step]

    counted = [s for s in steps if s.count is not None]
    active = 100.0 * sum(s.count for s in counted) / (batch * len(counted)) if counted else None
    pending: dict = {}
    for s in counted:
        pending.setdefault(s.iteration, []).append(s.count)
    pending = {it: statistics.fmean(v) for it, v in sorted(pending.items())}

    host = [r for r in recs if r.track == "host"]
    launches = sorted(by_launch)
    between, gaps = [], []
    for a, b in zip(launches, launches[1:]):
        if b != a + 1:
            continue
        end = max(r.t1 for r in by_launch[a])
        start = min(r.t0 for r in by_launch[b])
        between.append((start - end) / 1e6)
        mid = (start + end) // 2
        open_ = [r for r in host if r.t0 <= mid <= r.t1]
        depth = lambda r: 0 if r.parent is None else 1 + depth(recs[r.parent])  # noqa: E731
        deepest = max(open_, key=depth, default=None)
        what = "none: the host waiting" if deepest is None else (
            deepest.name + (f" (launch {deepest.launch})" if deepest.launch is not None else ""))
        gaps.append(((start - end) / 1e6, a, what))
    gaps.sort(key=lambda g: -g[0])
    calls = [r.ns / 1e6 for r in host if r.name == "entry.call" and r.program == traced
             and r.launch is not None and r.launch >= keep_from]
    return Summary(batch=batch, steps=len(steps), launches=launches, phase_ms=phase_ms, self_ms=self_ms,
                   period_ms=_median(periods), launch_ms=launch_ms,
                   init_ms={n: v for n, v in init_ms.items() if v is not None}, top_sum_ms=_median(tops),
                   active_share=active, pending_by_iteration=pending, between_ms=between, gaps=gaps, call_ms=calls,
                   build={} if setup is None else build_seconds(setup))


def table(s: Summary, cal: dict | None, dropped: int, iter_ms: float | None) -> list:
    """The `[trace]` lines of a summary."""
    out = [f"[trace] {s.steps} traced steps of B={s.batch} in launches {s.launches[:1]}..{s.launches[-1:]}; "
           f"rows dropped {dropped}"]
    if cal:
        out.append(f"[trace] clock: offset {cal['offset_ns'][0]} -> {cal['offset_ns'][1]} ns over "
                   f"{(cal['host_ns'][1] - cal['host_ns'][0]) / 1e9:.3f} s, drift {cal['drift_ns_per_s']:.1f} ns/s, "
                   f"uncertainty {cal['uncertainty_ns']} ns, resolution {cal['resolution_ns']} ns")
    period = s.period_ms
    out.append(f"[trace] {'phase':<24}{'median ms':>12}{'self ms':>10}{'of period':>11}")
    for n in TOP + NESTED:
        if n in s.phase_ms:
            share = f"{100 * s.phase_ms[n] / period:10.2f}%" if period else ""
            out.append(f"[trace] {('  ' if n in NESTED else '') + n + KERNEL.get(n, ''):<24}{s.phase_ms[n]:12.4f}"
                       f"{s.self_ms.get(n, 0.0):10.4f}{share}")
    if period:
        out.append(f"[trace] step period {period:.4f} ms (step start to step start); top-level phases "
                   f"{s.top_sum_ms:.4f} ms = {100 * s.top_sum_ms / period:.2f}% of it; step's own stamps and "
                   f"gaps {s.self_ms.get('step', 0.0):.4f} ms"
                   + (f"; loop.iter_ms of the untraced window {iter_ms:.4f} ms, the period "
                      f"{100 * (period / iter_ms - 1):+.2f}% of it" if iter_ms else ""))
    if s.launch_ms and s.steps and s.launches:
        per = s.steps / len(s.launches)
        out.append(f"[trace] launch period {s.launch_ms:.4f} ms (init to init) over {per:.2f} steps = "
                   f"{s.launch_ms / per:.4f} ms a step"
                   + (f" ({100 * (s.launch_ms / per / iter_ms - 1):+.2f}% of loop.iter_ms)" if iter_ms else "")
                   + "; init " + ", ".join(f"{n} {v:.4f} ms" for n, v in s.init_ms.items()))
    if s.active_share is not None:
        out.append(f"[trace] pending at each step's start: active share {s.active_share:.3f}%; mean by iteration "
                   + ", ".join(f"{it}: {v:.1f}" for it, v in s.pending_by_iteration.items()))
    if s.between_ms:
        out.append(f"[trace] between launches: median {statistics.median(s.between_ms):.4f} ms, "
                   f"max {max(s.between_ms):.4f} ms over {len(s.between_ms)}; longest: "
                   + "; ".join(f"{ms:.4f} ms after launch {a} ({what} open)" for ms, a, what in s.gaps[:5]))
    if s.call_ms:
        out.append(f"[trace] entry.call: median {statistics.median(s.call_ms):.4f} ms, "
                   f"max {max(s.call_ms):.4f} ms over {len(s.call_ms)}")
    if s.build:
        out.append("[trace] set-up build: " + ", ".join(f"{k} {v:.4f} s" for k, v in s.build.items()))
    return out


def _traced(ctx):
    if ctx.device.type != "cuda":
        return None
    try:
        from timeopt_tpu_torch.utils import trace
    except ImportError:
        return None
    import torch

    from hopbench import loop
    from timeopt_tpu_torch.parallel import solve_batch_resident
    from timeopt_tpu_torch.solver import compiled

    B, k = int(ctx.mix["batch"]), int(ctx.mix["in_flight"])
    dtype = getattr(torch, ctx.cfg["dtype"])
    slots = [loop.Slot(B, int(ctx.cfg["N"]), ctx.system.m, dtype, [ctx.device]) for _ in range(k)]

    def solve(parts):
        return solve_batch_resident(ctx.system, parts, options=ctx.opts)

    setup = next((p.spans["build"] for p in reversed(compiled.programs()) if "build" in p.spans), None)
    with trace.recording(ctx.device):
        loop.run(solve, [[p] for p in ctx.pool], slots, float("inf"), lambda b, slot: None,
                 max_batches=len(ctx.pool) + 2 * k)
    s = summarize(trace.records(), B, k, setup)
    spans = [b.end_ms - b.start_ms for b in ctx.window.batches if b.start_ms is not None]
    steps = ctx.counters.get("steps", 0)
    iter_ms = sum(spans) / steps if spans and steps else None
    for line in table(s, trace.calibration(), trace.dropped(), iter_ms):
        print(line, file=sys.stderr, flush=True)
    return s


def window(ctx):
    """The cell's traced window's Summary (None off the card or without the
    program's recorder), made once for every reader."""
    return ctx.cached("spans", lambda: _traced(ctx))
