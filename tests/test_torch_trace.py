"""The port's tracing (timeopt_tpu_torch/utils/trace.py) on the CPU.

On the card a traced program's captured init and step graphs hold a stamp
kernel at each phase boundary; on the CPU the eager loop
(`compiled._run_eager`) records the same rows with time.perf_counter_ns(). Here, without a card:

- (a) a traced eager solve of a tiny double integrator and a tiny PointMass
  records every phase of init and of each step, in order, nested as the
  bodies nest them, with the launch and iteration ids of the run (the
  extra cost twice a step on PointMass, under the select's inputs and under
  the backward pass); the one-pass bodies stamp init and their steps;
- (b) each step's pending count is the problems not done at its start;
- (c) with tracing off nothing is recorded, and the result is bitwise the
  traced solve's; the program cache keys traced and untraced programs
  apart;
- (d) a full log counts its drops and keeps only whole phases;
- (e) self time is duration less the children's; `write_chrome` writes a
  valid trace; the traced bodies pass `CaptureGuard`;
- (f) a program's warmup_s, capture_s and loop_s are its build spans',
  which the program keeps and the recorder lists only while tracing is
  on; a traced build's warm-up puts its seconds down to the phases;
- (g) records() raises on rows of a card whose clock was not fitted;
- (h) a traced build counts the size tier of each select and backward
  launch its warm-up and captures place, in its innermost build span;
  untraced, or outside a build, nothing is counted.

The card's side (stamps inside the loop graph, bitwise results, the clock
calibration) is in tests/test_torch_card.py.
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from tests.test_torch_compiled import _batch, _same
from timeopt_tpu_torch.solver import compiled
from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch
from timeopt_tpu_torch.utils import trace

torch.set_num_threads(1)

STEP = ["linearize", "select", "backward", "forward", "commit"]


@pytest.fixture(autouse=True)
def _fresh():
    trace.reset()
    yield
    trace.reset()


def _children(recs, i):
    return [r.name for r in recs if r.parent == i]


def _traced_program(case, opts, launches=2, seed=3, capacity=None):
    """A CPU program built and launched `launches` times with tracing on:
    (program, its device records, the steps each launch ran)."""
    system, probs, U = _batch(case, B=4, seed=seed)
    with trace.recording(capacity=capacity or trace.CAPACITY):
        prog = compiled.CompiledSolve(system, opts, probs, U)
        steps = []
        for _ in range(launches):
            prog.launch(probs, U)
            steps.append(prog.iterations())
    recs = [r for r in trace.records() if r.track == "device"]
    return prog, recs, steps


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_eager_solve_records_every_phase_in_order(case):
    """(a) Per launch: init (iteration -1: init.rollout, init.warm and the
    step's phases), then one step per iteration 0..k-1, each holding the
    step's phases in order; the select holds its inputs and its kernel, the
    backward and forward passes their kernels."""
    opts = SolveOptions(max_iter=5, psd_levels=1)
    prog, recs, steps = _traced_program(case, opts)
    extra = case == "PointMass_Navigation"
    full = recs  # parents index the whole list: rebuild it
    recs = trace.records()
    for launch, k in enumerate(steps):
        tops = [i for i, r in enumerate(recs) if r.track == "device" and r.parent is None and r.launch == launch]
        assert [recs[i].name for i in tops] == ["init"] + ["step"] * k
        assert [recs[i].iteration for i in tops] == [-1] + list(range(k))
        assert all(recs[i].program == prog.id for i in tops)
        assert [recs[i].t0 for i in tops] == sorted(recs[i].t0 for i in tops)
        init = tops[0]
        assert _children(recs, init) == ["init.rollout", "init.warm"]
        warm = next(i for i, r in enumerate(recs) if r.parent == init and r.name == "init.warm")
        for s in [warm] + tops[1:]:
            assert _children(recs, s) == STEP
            kids = {recs[i].name: i for i, r in enumerate(recs) if r.parent == s}
            assert _children(recs, kids["select"]) == ["select.inputs", "select.kernel"]
            assert _children(recs, kids["backward"]) == (["extra_cost"] if extra else []) + ["backward.kernel"]
            assert _children(recs, kids["forward"]) == ["forward.kernel"]
            inputs = next(i for i, r in enumerate(recs) if r.parent == kids["select"] and r.name == "select.inputs")
            assert _children(recs, inputs) == (["extra_cost"] if extra else [])
            for i, r in enumerate(recs):
                if r.parent == s:
                    assert r.iteration == recs[s].iteration and r.launch == launch
    # per launch: init, init.rollout, init.warm, k steps, and (1 + k) times a step's phases
    assert len(full) == sum(3 + k + (1 + k) * (len(STEP) + 4 + 2 * extra) for k in steps)


def test_onepass_bodies_stamp_init_and_steps():
    """(a) The one-pass bodies: init and each step stamped, iterations in
    order, the count at each step's start."""
    opts = SolveOptions(method="onepass", max_iter=3, psd_levels=1)
    prog, recs, steps = _traced_program("DoubleIntegrator", opts, launches=1)
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == ["init"] + ["step"] * steps[0]
    assert [r.iteration for r in tops[1:]] == list(range(steps[0]))
    assert all(r.count is not None for r in tops[1:])


@pytest.mark.parametrize("early_exit", [True, False])
def test_pending_count_is_the_problems_not_done(monkeypatch, early_exit):
    """(b) The count at each step's start (and init.warm's: every problem)
    equals the problems whose done flag is unset when the step body starts."""
    seen = []
    plain = compiled.bodies

    def counted(opts):
        b = plain(opts)

        def step(system, o, prob, st):
            seen.append(int((~st["done"]).sum()))
            return b.step(system, o, prob, st)

        return compiled.Bodies(b.state, b.init, step)

    monkeypatch.setattr(compiled, "bodies", counted)
    opts = SolveOptions(max_iter=8, psd_levels=1, early_exit=early_exit)
    prog, recs, steps = _traced_program("DoubleIntegrator", opts, launches=1, seed=5)
    counts = [r.count for r in recs if r.name == "step"]
    assert counts == seen and len(counts) == steps[0]
    assert [r.count for r in recs if r.name == "init.warm"] == [4]
    assert counts == sorted(counts, reverse=True)  # a done problem stays done
    assert all(r.count is None for r in recs if r.name not in ("step", "init.warm"))


def test_tracing_off_records_no_call_and_gives_the_same_result():
    """(c) Off: no call span and no row; on: entry.call and its children,
    the rows, and the result bitwise the untraced one."""
    system, probs, U = _batch("PointMass_Navigation", B=3, seed=7)
    opts = SolveOptions(max_iter=4, psd_levels=1)
    off = solve_batch(system, probs, U, opts)
    assert trace.records() == [] and not trace.on()
    with trace.recording():
        assert trace.on()
        on = solve_batch(system, probs, U, opts)
    assert not trace.on()
    _same(on, off)
    recs = trace.records()
    host = [r for r in recs if r.track == "host"]
    assert [r.name for r in host] == ["entry.call", "entry.prepare"]
    assert host[0].program is not None and host[0].launch == 0 and host[1].parent == 0
    dev = [r for r in recs if r.track == "device"]
    assert dev and {r.program for r in dev} == {host[0].program}


def test_the_program_key_holds_tracing():
    """(c) A program built while tracing is on is another program than the
    one built while it is off; each is found again under its own key."""
    compiled.clear_compiled()
    system, probs, U = _batch("DoubleIntegrator", B=2, seed=9)
    opts = SolveOptions(max_iter=3, psd_levels=1)
    off = compiled.program(system, opts, probs, U)
    with trace.recording():
        on = compiled.program(system, opts, probs, U)
        assert compiled.program(system, opts, probs, U) is on
    assert on is not off and on.traced and not off.traced
    assert off.log is None and on.log is not None
    assert compiled.program(system, opts, probs, U) is off
    compiled.clear_compiled()


def test_a_full_log_counts_its_drops():
    """(d) A log of 10 rows: the rest of the stamps are counted as dropped,
    and only phases with both rows kept are records."""
    opts = SolveOptions(max_iter=4, psd_levels=1)
    _, whole, steps = _traced_program("DoubleIntegrator", opts, launches=1)
    rows = 2 * len(whole)
    trace.reset()
    _, cut, steps_cut = _traced_program("DoubleIntegrator", opts, launches=1, capacity=10)
    assert steps_cut == steps
    assert trace.dropped() == rows - 10
    assert 0 < len(cut) < 5 and all(r.t1 >= r.t0 for r in cut)


def test_self_time_is_duration_less_children():
    """(e) Every record's self time is its duration less its children's
    (which do not overlap); nested host spans likewise."""
    opts = SolveOptions(max_iter=3, psd_levels=1)
    _traced_program("PointMass_Navigation", opts, launches=1)
    with trace.recording():
        with trace.span("outer"):
            time.sleep(0.002)
            with trace.span("inner"):
                time.sleep(0.003)
    recs = trace.records()
    for i, r in enumerate(recs):
        kids = [c for c in recs if c.parent == i]
        assert r.self_ns == r.ns - sum(c.ns for c in kids), r.name
        assert all(r.t0 <= c.t0 <= c.t1 <= r.t1 for c in kids)
    outer = next(r for r in recs if r.name == "outer")
    inner = next(r for r in recs if r.name == "inner")
    assert inner.self_ns == inner.ns and 2e6 <= outer.self_ns < outer.ns


def test_write_chrome_writes_a_valid_trace(tmp_path):
    """(e) The Chrome trace: valid JSON, one complete event per record,
    host spans on track 0, device phases on another, named."""
    system, probs, U = _batch("DoubleIntegrator", B=2, seed=11)
    with trace.recording():
        solve_batch(system, probs, U, SolveOptions(max_iter=3, psd_levels=1))
    recs = trace.records()
    path = tmp_path / "t.json"
    trace.write_chrome(path, recs)
    doc = json.loads(path.read_text())
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(xs) == len(recs) and [e["name"] for e in xs] == [r.name for r in recs]
    assert {e["tid"] for e, r in zip(xs, recs) if r.track == "host"} == {0}
    assert {e["tid"] for e, r in zip(xs, recs) if r.track == "device"} == {1}
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in xs)
    names = {e["tid"]: e["args"]["name"] for e in doc["traceEvents"] if e["ph"] == "M"}
    assert names[0] == "host" and names[1].startswith("device")


def test_traced_bodies_pass_the_capture_guard():
    """(e) The CPU stamps read nothing to the host: a traced program's init
    and step bodies run under CaptureGuard."""
    system, probs, U = _batch("PointMass_Navigation", B=2, seed=13)
    opts = SolveOptions(max_iter=3, psd_levels=1)
    with trace.recording():
        prog = compiled.CompiledSolve(system, opts, probs, U)
    prog._load(probs, U)
    with trace.stamping(prog.log, prog.ctr), compiled.CaptureGuard():
        prog._init()
        prog._step()
    names = [r.name for r in trace.records() if r.parent is None]
    assert names == ["init", "step"]


def test_build_spans_back_the_build_attributes():
    """(f) warmup_s, capture_s and loop_s are the seconds of the program's
    build spans (the spans the card's build records), which the program's
    `build` span holds as its children; with tracing off the recorder lists
    none of them, with it on it lists them as build spans of the program."""
    system, probs, U = _batch("DoubleIntegrator", B=2, seed=15)
    prog = compiled.CompiledSolve(system, SolveOptions(max_iter=3, psd_levels=1), probs, U)
    assert prog.warmup_s == prog.capture_s == prog.loop_s == 0.0
    with prog._span("build"):
        for name, secs in (("build.warmup.init", 0.004), ("build.warmup.step", 0.002),
                           ("build.capture.init", 0.001), ("build.capture.step", 0.001),
                           ("build.loop_graph", 0.003)):
            with prog._span(name):
                time.sleep(secs)
    sp = prog.spans
    assert prog.warmup_s == sp["build.warmup.init"].seconds + sp["build.warmup.step"].seconds >= 0.006
    assert prog.loop_s == sp["build.loop_graph"].seconds >= 0.003
    assert prog.capture_s == pytest.approx(sp["build.capture.init"].seconds + sp["build.capture.step"].seconds
                                           + prog.loop_s, rel=1e-12)
    assert [c.name for c in sp["build"].children] == ["build.warmup.init", "build.warmup.step",
                                                      "build.capture.init", "build.capture.step", "build.loop_graph"]
    assert trace.records() == []  # tracing off: the program keeps its build's spans, the recorder none
    with trace.recording():
        with prog._span("build"):
            for name in ("build.warmup.init", "build.warmup.step", "build.capture.init", "build.capture.step",
                         "build.loop_graph"):
                with prog._span(name):
                    time.sleep(0.001)
    recs = trace.records()
    mine = [i for i, r in enumerate(recs) if r.kind == "build" and r.program == prog.id]
    assert [recs[i].name for i in mine] == ["build", "build.warmup.init", "build.warmup.step", "build.capture.init",
                                            "build.capture.step", "build.loop_graph"]
    assert all(recs[i].parent == mine[0] for i in mine[1:])
    assert sum(recs[i].ns for i in mine[1:]) <= recs[mine[0]].ns


def test_a_warm_up_puts_its_seconds_down_to_the_phases():
    """(f) Under stamping with `warm` (a traced build's eager warm-up) each
    phase of the bodies is also a build span, nested as the phases nest:
    the set-up tree of a traced build. Without a log (an untraced build)
    stamping places nothing."""
    system, probs, U = _batch("DoubleIntegrator", B=2, seed=17)
    with trace.recording():
        prog = compiled.CompiledSolve(system, SolveOptions(max_iter=3, psd_levels=1), probs, U)
        prog._load(probs, U)
        with prog._span("build.warmup.init"), trace.stamping(prog.log, prog.ctr, warm=True):
            prog._init()
        with trace.stamping(None, prog.ctr, warm=True):
            prog._init()
    recs = [r for r in trace.records() if r.track == "host"]
    assert all(r.kind == "build" for r in recs)
    assert _children(recs, 0) == ["init"]
    assert _children(recs, 1) == ["init.rollout", "init.warm"]
    warm = next(i for i, r in enumerate(recs) if r.name == "init.warm")
    assert _children(recs, warm) == STEP
    assert prog.warmup_s == recs[0].ns / 1e9 > 0


def test_rows_of_an_unfitted_card_raise():
    """(g) records() reads device rows on the one card recording(device)
    calibrated; rows of any other card (here planted: a second card's, with
    no card fitted) raise rather than take another clock's offset."""
    trace._ROWS.append((torch.device("cuda", 1), 0, 0, 0, 0, 123, -1))
    with pytest.raises(ValueError, match="cuda:1"):
        trace.records()
    with pytest.raises(ValueError, match="no clock of its own"):
        trace.calibrate("cpu")


def test_counts_go_to_the_innermost_build_span_while_tracing():
    """(h) count() adds to the innermost open build span's counts, only
    while tracing is on; counts() sums a span's tree."""
    with trace.build_span("build") as off:
        trace.count("select.tier14")
    assert trace.counts(off) == {}
    with trace.recording():
        trace.count("select.tier14")  # no build open: nothing, and no error
        with trace.build_span("build") as b:
            with trace.build_span("build.capture.step") as c:
                with trace.build_span("build.kernels", lib="lft_select"):
                    pass
                trace.count("select.tier14")
                trace.count("select.tier14")
            trace.count("backward.tier14")
    assert c.args["counts"] == {"select.tier14": 2} and b.args["counts"] == {"backward.tier14": 1}
    assert trace.counts(b) == {"select.tier14": 2, "backward.tier14": 1}
    rec = next(r for r in trace.records() if r.name == "build.capture.step")
    assert rec.args["counts"] == {"select.tier14": 2}


@pytest.mark.parametrize("n,m", [(4, 2), (12, 4), (14, 3)])
def test_a_traced_build_counts_each_launchs_size_tier(monkeypatch, n, m):
    """(h) The fused select's and the backward pass's wrappers, their
    kernels faked (no card here), count the tier each launch binds inside a
    traced build (the registry's narrow 4 and 12, the wide 14), and nothing
    untraced."""
    from timeopt_tpu_torch.ops import _build, cuda_backward, cuda_lft

    monkeypatch.setattr(_build, "on_card", lambda x, phase: True)
    monkeypatch.setattr(_build, "load", lambda *a: None)
    monkeypatch.setattr(_build, "bind", lambda *a: (lambda *args: 0))
    monkeypatch.setattr(_build, "stream_ptr", lambda dev: 0)
    B, N = 2, 3
    z = lambda *shape: torch.zeros(shape, dtype=torch.float64)  # noqa: E731
    eye = lambda k: torch.eye(k, dtype=torch.float64).expand(B, k, k).contiguous()  # noqa: E731
    sel = (z(B, N, n, n), z(B, N, n, m), z(B, N, 4, n), z(B, N, 4), eye(n), eye(m), eye(n))
    bw = (z(B, N, n, n), z(B, N, n, m), z(B, N, n), z(B, N, m), z(B, N, n, n), z(B, N, n), z(B, N), z(B, N),
          eye(n), eye(m), torch.ones(B, dtype=torch.int64), z(B))

    def launches():
        cuda_lft.propagator_select_fused(*sel, t_min=1)
        cuda_backward.backward_truncated_core(*bw)
        cuda_backward.backward_truncated_core(*bw)

    with trace.build_span("build") as off:
        launches()
    with trace.recording():
        with trace.build_span("build") as b, trace.build_span("build.capture.step"):
            launches()
    assert trace.counts(off) == {}
    assert trace.counts(b) == {f"select.tier{n}": 1, f"backward.tier{n}": 2}
