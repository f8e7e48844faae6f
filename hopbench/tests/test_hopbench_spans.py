"""The readers of the program's spans and counters (hopbench/spans.py and
the metrics that read it) on synthetic records: a traced program's four
launches of two steps each, the first launch discarded as the traced
window discards the first in_flight, and the set-up program's build.

    python -m pytest hopbench/tests/test_hopbench_spans.py -q
"""

from dataclasses import dataclass, field

import pytest

from hopbench import harness, spans

MS = 1_000_000


@dataclass
class Rec:
    """The fields of timeopt_tpu_torch/utils/trace.py::Record."""

    name: str
    track: str
    t0: int
    t1: int
    parent: int | None = None
    self_ns: int = 0
    program: int | None = None
    launch: int | None = None
    iteration: int | None = None
    count: int | None = None
    kind: str = ""
    args: dict = field(default_factory=dict)

    @property
    def ns(self):
        return self.t1 - self.t0


@dataclass
class BuildSpan:
    """The fields of timeopt_tpu_torch/utils/trace.py::Span that a build's
    tree is read by."""

    name: str
    seconds: float
    children: list = field(default_factory=list)
    args: dict = field(default_factory=dict)


def setup_build():
    """A set-up program's `build` span: the warm-up with a library load
    inside, the captures and the loop graph."""
    return BuildSpan("build", 2.0, [
        BuildSpan("build.warmup.init", 1.0, [BuildSpan("build.kernels", 0.2, args={"lib": "lft_select"})]),
        BuildSpan("build.warmup.step", 0.5), BuildSpan("build.capture.init", 0.1),
        BuildSpan("build.capture.step", 0.2), BuildSpan("build.loop_graph", 0.05)])


class Synthetic:
    def __init__(self):
        self.recs = []

    def add(self, name, track, t0, ns, parent=None, **kw):
        self.recs.append(Rec(name, track, t0, t0 + ns, parent, **kw))
        return len(self.recs) - 1

    def done(self):
        for i, r in enumerate(self.recs):
            r.self_ns = r.ns - sum(c.ns for c in self.recs if c.parent == i)
        return self.recs


# a step: (phase, start ms within the step, ms, children (phase, start, ms))
STEP = [("linearize", 0.0, 1.0, []),
        ("select", 1.0, 2.0, [("select.inputs", 1.0, 0.5, [("extra_cost", 1.1, 0.2)]), ("select.kernel", 1.5, 1.4)]),
        ("backward", 3.0, 0.5, [("extra_cost", 3.0, 0.2), ("backward.kernel", 3.2, 0.3)]),
        ("forward", 3.5, 0.4, [("forward.kernel", 3.5, 0.3)]),
        ("commit", 3.9, 0.1, [])]
PERIOD = 4.05  # ms from one step's start to the next (the loop condition between)
GAP = 0.25  # ms between one launch's last stamp and the next launch's first


def synthetic(extra=True):
    b = Synthetic()
    t = 3000 * MS
    for launch in range(4):
        b.add("entry.call", "host", t - 3 * MS, (2 + launch) * MS, kind="call", program=7, launch=launch)
        init = b.add("init", "device", t, int(1.5 * MS), program=7, launch=launch, iteration=-1)
        b.add("init.rollout", "device", t, MS, init, program=7, launch=launch, iteration=-1)
        t += int(1.5 * MS)
        for it, count in ((0, 8), (1, 6)):
            s = b.add("step", "device", t, int(4.0 * MS), program=7, launch=launch, iteration=it, count=count)
            for name, at, ms, kids in STEP:
                p = b.add(name, "device", t + int(at * MS), int(ms * MS), s, program=7, launch=launch, iteration=it)
                for kid in kids:
                    if kid[0] == "extra_cost" and not extra:
                        continue
                    q = b.add(kid[0], "device", t + int(kid[1] * MS), int(kid[2] * MS), p, program=7, launch=launch,
                              iteration=it)
                    for g in (kid[3] if len(kid) > 3 else ()):
                        if g[0] == "extra_cost" and not extra:
                            continue
                        b.add(g[0], "device", t + int(g[1] * MS), int(g[2] * MS), q, program=7, launch=launch,
                              iteration=it)
            t += int(PERIOD * MS)
        t += int(GAP * MS)
    return b.done()


class Ctx:
    """What a reader takes from hopbench/context.py::Context here."""

    def __init__(self, summary):
        self.summary = summary

    def cached(self, key, fn):
        assert key == "spans"
        return self.summary


def test_summary_of_synthetic_records():
    s = spans.summarize(synthetic(), batch=8, keep_from=1, setup=setup_build())
    assert s.steps == 6 and s.launches == [1, 2, 3]
    want = {"linearize": 1.0, "select": 2.0, "select.inputs": 0.5, "select.kernel": 1.4, "extra_cost": 0.4,
            "backward": 0.5, "backward.kernel": 0.3, "forward": 0.4, "forward.kernel": 0.3, "commit": 0.1}
    assert s.phase_ms == pytest.approx(want)
    assert s.self_ms["select"] == pytest.approx(0.1) and s.self_ms["select.inputs"] == pytest.approx(0.3)
    assert s.period_ms == pytest.approx(PERIOD) and s.top_sum_ms == pytest.approx(4.0)
    assert s.launch_ms == pytest.approx(1.5 + 2 * PERIOD + GAP) and s.init_ms == pytest.approx(
        {"init": 1.5, "init.rollout": 1.0})
    assert s.active_share == pytest.approx(100 * (8 + 6) / 16)
    assert s.pending_by_iteration == {0: 8, 1: 6}
    assert s.between_ms == pytest.approx([PERIOD - 4.0 + GAP] * 2)
    assert [g[2] for g in s.gaps] == ["entry.call (launch 2)", "entry.call (launch 3)"]  # the next call open
    assert s.call_ms == pytest.approx([3.0, 4.0, 5.0])
    assert s.build["build.warmup.init"] == pytest.approx(1.0) and s.build["build.kernels.lft_select"] == 0.2
    assert s.build["build.warmup.init.self"] == pytest.approx(0.8)
    assert any("top-level phases" in line for line in spans.table(s, None, 0, PERIOD))


READS = {"step.linearize_ms": 1.0, "step.select_ms": 2.0, "step.select_kernel_ms": 1.4, "step.backward_ms": 0.5,
         "step.forward_ms": 0.4, "step.commit_ms": 0.1, "step.extra_cost_ms": 0.4, "loop.active_share": 87.5,
         "entry.between_ms": PERIOD - 4.0 + GAP, "entry.call_ms": 4.0, "setup.warmup_s": 1.5,
         "setup.capture_s": 0.35}


@pytest.mark.parametrize("metric", sorted(READS))
def test_each_reader_reads_the_summary(metric):
    ctx = Ctx(spans.summarize(synthetic(), batch=8, keep_from=1, setup=setup_build()))
    assert harness.reader(metric)(ctx) == pytest.approx(READS[metric])
    assert harness.reader(metric)(Ctx(None)) is None  # off the card, or a program without the recorder


def test_every_new_metric_is_in_the_manifest():
    man = harness.manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for metric in READS:
        assert entries[metric]["source"] in ("program_span", "program_counter")
    assert entries["step.extra_cost_ms"]["workloads"] == ["pointmass-prop-b1024"]
    assert entries["loop.active_share"]["better"] == "higher"


def test_the_breakdown_of_the_programs_stamps():
    from hopbench import breakdown

    class BCtx:
        counters = {"steps": 100, "runs": 10}

        def peek(self, key):
            assert key == "spans"
            return spans.summarize(synthetic(), batch=8, keep_from=1, setup=setup_build())

    got = breakdown.read(BCtx(), 1)
    ops = dict(got["device_ops"])
    assert len(got["device_ops"]) == 10 and got["device_ops"][0][0] == "step.select"
    assert ops["step.select"] == pytest.approx(2.0 * 100 / 1e3) and ops["init"] == pytest.approx(1.5 * 10 / 1e3)
    assert got["idle_gaps"][0] == ["after launch 1 (entry.call (launch 2) open)", pytest.approx((PERIOD - 4.0 + GAP) / 1e3)]


def test_a_step_without_extra_cost_reads_none():
    s = spans.summarize(synthetic(extra=False), batch=8, keep_from=1)
    assert harness.reader("step.extra_cost_ms")(Ctx(s)) is None
