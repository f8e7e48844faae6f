"""The benchmark's harness at a tiny size on the CPU: the manifest against
the contract's rules, the loading of configurations, mixes, limits and
metric readers by name (a new one is a new file and entry, no edit), the
window's arithmetic, the closed loop, and whole runs of each cell's
traffic through the program with the card's look skipped: sound runs come
out correct, runs with the solve broken underneath do not.

    python -m pytest hopbench/tests/test_hopbench_harness.py -q

The tests marked `cuda` run cells on the cards and skip without them.
"""

import dataclasses
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from hopbench import faults, harness, loop
from hopbench.run import options, run_cell

ROOT = Path(__file__).resolve().parents[2]
MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


# ---------------------------------------------------------------------------
# The manifest
# ---------------------------------------------------------------------------


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert MAN["command"][:3] == ["python3", "-m", "hopbench.run"] and MAN["paths"] == ["hopbench"]
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    names = [c["name"] for c in MAN["configs"]] + CELLS + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("hopbench/")
        assert any(w["config"] == c["name"] for w in MAN["workloads"])
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200 and NAME.match(w["traffic"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(CELLS) // 4)  # at most a quarter of the cells on four chips, or one
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        moved = next(e for e in MAN["end_to_end"] if e["name"] == m["moves"])
        assert all(harness.reports(moved, w, MAN) for w in m["workloads"])
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].endswith("_roofline")
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(cell):
    e2e = [m["name"] for m in harness.metrics_of(cell, MAN, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.metrics_of(cell, MAN, "per_layer")


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files_by_name(cell):
    w = harness.cell(cell, MAN)
    cfg, mix, lim = harness.config(w["config"]), harness.traffic(w["traffic"]), harness.limits(cell)
    assert cfg["name"] == w["config"] and mix["name"] == w["traffic"]
    assert {"nonfinite", "repeat_mismatch", "failed", "cost_gap"} <= set(lim)
    for key in ("x0", "sigma_x0", "xg", "u_ref", "Q_diag", "R_diag", "Qf", "w", "dt", "N", "T_min", "T_max",
                "dtype", "max_iter", "psd_levels", "wrap_idx", "system", "program_system", "source"):
        assert key in cfg
    for m in harness.metrics_of(cell, MAN, "per_layer"):
        assert callable(harness.reader(m["name"]))


def test_a_new_config_mix_metric_and_cell_are_picked_up_with_no_edit(tmp_path):
    here = tmp_path / "hopbench"
    shutil.copytree(harness.HERE / "configs", here / "configs")
    shutil.copytree(harness.HERE / "traffic", here / "traffic")
    shutil.copytree(harness.HERE / "limits", here / "limits")
    shutil.copytree(harness.HERE / "metrics", here / "metrics")
    cfg = dict(harness.config("quadrotor-n160-f32"), name="quadrotor-n80-f32", N=80, T_max=80)
    (here / "configs" / "quadrotor-n80-f32.json").write_text(json.dumps(cfg))
    mix = dict(harness.traffic("prop-b1024-k4"), name="prop-b256-k2", batch=256, in_flight=2)
    (here / "traffic" / "prop-b256-k2.json").write_text(json.dumps(mix))
    (here / "limits" / "quadrotor-prop-b256.json").write_text(json.dumps({"cost_gap": 1e-8, "failed": 0}))
    (here / "metrics" / "loop.batches.py").write_text("def read(ctx):\n    return len(ctx.window.batches)\n")
    man = json.loads(json.dumps(MAN))
    man["workloads"].append({"name": "quadrotor-prop-b256", "config": "quadrotor-n80-f32",
                             "traffic": "prop-b256-k2", "chips": 1, "why": "a new cell"})
    man["per_layer"].append({"name": "loop.batches", "unit": "batches", "better": "higher", "source": "host_clock",
                             "layer": "outer loop", "moves": "solves_per_s"})
    w = harness.cell("quadrotor-prop-b256", man)
    assert harness.config(w["config"], here)["N"] == 80
    assert harness.traffic(w["traffic"], here)["batch"] == 256
    assert harness.limits(w["name"], here)["cost_gap"] == 1e-8
    per_layer = [m["name"] for m in harness.metrics_of(w["name"], man, "per_layer")]
    assert per_layer == ["loop.batches"]  # every other metric lists its cells; this one reports wherever it moves
    assert "loop.batches" in [m["name"] for m in harness.metrics_of(CELLS[0], man, "per_layer")]

    class Ctx:
        window = loop.Window(batches=[1, 2, 3])

    assert harness.reader("loop.batches", here)(Ctx()) == 3


UNICYCLE = '''"""A unicycle: x = [px, py, theta], u = [v, omega]."""

import torch


class Unicycle:
    name = "Unicycle"
    n, m = 3, 2
    xdot_flops = 4  # a cosine, a sine, two multiplies
    guard_flops = 0
    extra_cost_flops = 0

    @staticmethod
    def xdot(x, u):
        th, v = x[..., 2], u[..., 0]
        return torch.stack([v * torch.cos(th), v * torch.sin(th), u[..., 1]], dim=-1)

    @staticmethod
    def guard(x, u):
        return ~(torch.isfinite(x).all(-1) & torch.isfinite(u).all(-1))

    @staticmethod
    def extra_cost(x):
        return None


SYSTEM = Unicycle
'''


def test_a_new_system_is_judged_and_counted_with_no_edit(tmp_path, monkeypatch):
    """A configuration whose `system` names a file of its own under
    reference/plain/ (here a unicycle): its Deployment, the judge and the
    line-search and Jacobian work counts take the file, nothing edited."""
    from hopbench import judge, work
    from hopbench.reference import check

    plain = tmp_path / "hopbench" / "reference" / "plain"
    plain.mkdir(parents=True)
    (plain / "Unicycle.py").write_text(UNICYCLE)
    monkeypatch.setattr(check, "PLAIN", plain)
    cfg = dict(harness.config("quadrotor-n160-f32"), name="unicycle-n40-f32", system="Unicycle",
               program_system="Unicycle", N=40, T_min=10, T_max=40, x0=[0.0, 0.0, 0.0], sigma_x0=[0.1, 0.1, 0.0],
               xg=[2.0, 1.0, 0.0], u_ref=[0.0, 0.0], Q_diag=[1.0, 1.0, 0.1], R_diag=[0.1, 0.1], Qf=50.0, w=0.01,
               wrap_idx=[2])
    dep = check.Deployment(cfg, torch.float64, "cpu")
    assert (dep.system.name, dep.n, dep.m) == ("Unicycle", 3, 2)
    rng = np.random.default_rng(3)
    x0 = torch.as_tensor(rng.standard_normal((5, 3)) * 0.1)
    U = torch.as_tensor(rng.standard_normal((5, 40, 2)) * 0.3)
    X = dep.rollout(x0, U)
    th = X[:, :-1, 2]
    assert torch.allclose(X[:, 1:, 0], X[:, :-1, 0] + dep.dt * U[..., 0] * torch.cos(th))
    T = dep.argmin(dep.curve(X, U, psd=True))
    J = dep.cost(X, U, T)
    exact = judge.per_problem(dep, x0, T, J, U)
    assert exact["ok"].all() and float(exact["cost_gap"].max()) == 0.0
    assert float(exact["horizon_excess"].max()) == 0.0
    off = judge.per_problem(dep, x0, T, J * 1.01, U)
    assert float(off["cost_gap"].min()) > 1e-3
    T_star = [20, 30, 40, 0, 15]
    ls = work.linesearch("Unicycle", T_star, 40, 3, 2, 5)
    step = 3 + 2 * 2 * 3 + 2 * 2 + 4 + 0 + 2 * 3
    stage = 3 + 2 * 3 * 3 + 2 * 3 + 2 + 2 * 2 * 2 + 2 * 2 + 5 + 0
    terminal = 3 + 2 * 3 * 3 + 2 * 3 + 2
    assert ls["flops"] == 5 * (5 * 40 * step + sum(T_star) * stage + 4 * terminal)
    assert work.linearize("Unicycle", 5, 40, 3, 2)["flops"] == 5 * 40 * 5 * (3 * 4 + 2 * 3)
    with pytest.raises(FileNotFoundError, match="no plain system 'Tricycle'"):
        check.system("Tricycle")


# ---------------------------------------------------------------------------
# The window's arithmetic and the closed loop
# ---------------------------------------------------------------------------


def test_end_to_end_counts_every_batch_over_the_whole_window():
    rng = np.random.default_rng(0)
    win = loop.Window(start=10.0, end=40.0)
    for i in range(137):
        t = 10.0 + 0.2 * i
        win.batches.append(loop.Batch(index=i, pool_index=i % 8, enqueue=t, done=t + rng.uniform(0.5, 1.5)))
    e = loop.end_to_end(win, 1024)
    assert e["solves_per_s"] == 137 * 1024 / 30.0
    lat = [b.done - b.enqueue for b in win.batches]
    assert e["batch_p90_s"] == pytest.approx(np.percentile(lat, 90), rel=1e-12)


class FakeResult:
    def __init__(self, B, N, m, tag):
        self.T_star = torch.full((B,), tag, dtype=torch.int64)
        self.J_star = torch.full((B,), float(tag), dtype=torch.float32)
        self.U = torch.full((B, N, m), float(tag), dtype=torch.float32)


def test_closed_loop_keeps_k_in_flight_and_reads_every_batch_in_order():
    calls, seen = [], []

    def solve(p):
        calls.append(p)
        return FakeResult(4, 3, 2, p)

    slots = [loop.Slot(4, 3, 2, torch.float32, [torch.device("cpu")]) for _ in range(3)]
    win = loop.run(lambda p: [solve(p)], [0, 1, 2, 3, 4], slots, 1e9,
                   lambda b, s: seen.append((b.index, int(s.T[0]))), max_batches=11)
    assert calls == [i % 5 for i in range(11)]
    assert seen == [(i, i % 5) for i in range(11)]
    assert [b.pool_index for b in win.batches] == [i % 5 for i in range(11)]
    assert win.end >= win.start and all(b.done >= b.returned >= b.enqueue for b in win.batches)


def test_closed_loop_stops_enqueueing_when_the_seconds_run_out():
    slots = [loop.Slot(2, 1, 1, torch.float32, [torch.device("cpu")]) for _ in range(2)]
    win = loop.run(lambda p: [FakeResult(2, 1, 1, p)], [0], slots, 0.05, lambda b, s: None)
    assert win.batches and all(b.enqueue - win.start < 0.05 for b in win.batches)


def test_a_slot_puts_each_cards_answers_in_its_own_rows():
    cpu = torch.device("cpu")
    slot = loop.Slot(8, 3, 2, torch.float32, [cpu] * 4)
    slot.fill([FakeResult(2, 3, 2, tag) for tag in (5, 6, 7, 8)], timing=False)
    want = torch.tensor([5, 5, 6, 6, 7, 7, 8, 8])
    assert torch.equal(slot.T, want) and torch.equal(slot.J, want.float())
    assert torch.equal(slot.U, want.float()[:, None, None].expand(8, 3, 2))
    with pytest.raises(ValueError, match="fill 6 of the slot's 8 rows"):
        slot.fill([FakeResult(2, 3, 2, tag) for tag in (5, 6, 7)], timing=False)


def card_batch(i: int, card_ms: list) -> loop.Batch:
    return loop.Batch(index=i, pool_index=i, enqueue=float(i), card_ms=card_ms, start_ms=card_ms[0][0],
                      end_ms=card_ms[0][1])


class WindowCtx:
    def __init__(self, batches):
        self.window = loop.Window(batches=batches)


def test_the_card_readers_on_hand_made_times():
    # three batches on two cards, each card timed from its own base event:
    # card 0 runs 0-10, 10-20, 22-30 (idle 2 of 30); card 1 runs 5-12, 12-25, 25-40 (idle 0 of 35)
    bs = [card_batch(0, [(0.0, 10.0), (5.0, 12.0)]), card_batch(1, [(10.0, 20.0), (12.0, 25.0)]),
          card_batch(2, [(22.0, 30.0), (25.0, 40.0)])]
    ctx = WindowCtx(bs)
    assert harness.reader("cards.idle_share")(ctx) == pytest.approx(100.0 * 2 / 30)
    # per batch the slowest card's time minus the fastest's: |10 - 7|, |10 - 13|, |8 - 15|
    assert harness.reader("cards.skew_ms")(ctx) == pytest.approx(3.0)
    one = WindowCtx([card_batch(i, [c[0]]) for i, c in enumerate([b.card_ms for b in bs])])
    assert harness.reader("cards.skew_ms")(one) is None  # one card: no skew
    assert harness.reader("cards.idle_share")(one) == pytest.approx(harness.reader("device.idle_share")(one))
    assert harness.reader("cards.idle_share")(WindowCtx([])) is None  # off the card: no events


def test_the_breakdown_of_cards_without_the_programs_stamps():
    from hopbench import breakdown

    bs = [card_batch(0, [(0.0, 10.0), (5.0, 12.0)]), card_batch(1, [(10.0, 20.0), (12.0, 25.0)]),
          card_batch(2, [(22.0, 30.0), (26.0, 40.0)])]

    class Ctx(WindowCtx):
        def peek(self, key):
            return None

    got = breakdown.read(Ctx(bs), 2)
    assert got["device_ops"] == [["card1.batches", 0.034], ["card0.batches", 0.028]]
    assert got["idle_gaps"] == [["card0 before batch 2", 0.002], ["card1 before batch 2", 0.001]]


# ---------------------------------------------------------------------------
# Whole runs at a tiny size on the CPU, sound and broken
# ---------------------------------------------------------------------------


def tiny(cell: str):
    """The cell's configuration and its mix at a tiny size, and its devices:
    as many entries of the CPU as the cell has cards, two problems a card
    (six on one)."""
    w = harness.cell(cell, MAN)
    cfg = harness.config(w["config"])  # the cell's own horizon and weights: the limits hold at them
    chips = int(w["chips"])
    mix = dict(harness.traffic(w["traffic"]), batch=6 if chips == 1 else 2 * chips, in_flight=2, pool=2,
               judge_rows=3)
    return w, cfg, mix, [torch.device("cpu")] * chips


def run_tiny(cell: str, solve_wrap=None, mix_and_devices=None):
    """A run of the cell at a tiny size on the CPU whose window holds every
    batch of the pool twice (the program solves each part once here; its
    repeats on the card are compared bit for bit in every run)."""
    from timeopt_tpu_torch.parallel import solve_batch_resident

    w, cfg, mix, devices = tiny(cell)
    if mix_and_devices is not None:
        mix, devices = mix_and_devices
    opts = options(cfg, mix)
    from hopbench import problems

    system = problems.program_system(cfg)

    solved = {}

    def solve(parts):  # each part solved once, its answers handed out afresh at every call
        todo = [p for p in parts if id(p) not in solved]
        for p, r in zip(todo, solve_batch_resident(system, todo, options=opts) if todo else []):
            solved[id(p)] = r
        return [dataclasses.replace(solved[id(p)]) for p in parts]

    return run_cell(cfg, mix, harness.limits(cell), [], harness.metrics_of(cell, MAN, "end_to_end"),
                    2**31 + 99, 1e9, False, devices,
                    solve=solve if solve_wrap is None else solve_wrap(solve), max_batches=2 * mix["pool"])


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_tiny_run_is_correct(cell):
    res = run_tiny(cell)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 4 * tiny(cell)[2]["batch"] and res["failed"] == 0
    assert res["device"]["count"] == harness.cell(cell, MAN)["chips"]
    assert list(res)[-1] == "checks"
    assert "solves_per_s" in res["metrics"] and "setup_s" in res["metrics"]


def test_a_batch_split_over_four_cards_judges_what_it_judges_unsplit():
    """The four-card cell's pool batch split into four chunks (shard_problems
    over a CPU mesh, each chunk solved as its card solves it) and the same
    batch solved whole: the same problems judged, to the same numbers."""
    cell = next(w["name"] for w in MAN["workloads"] if w["chips"] == 4)
    w, cfg, mix, devices = tiny(cell)
    split = run_tiny(cell)
    whole = run_tiny(cell, mix_and_devices=(mix, devices[:1]))
    assert split["checks"] == whole["checks"] and split["attempted"] == whole["attempted"]
    assert (split["device"]["count"], whole["device"]["count"]) == (4, 1)


def stale(solve):
    """The solve's launch leaves the program's state unchanged: each call
    returns the answers of the call before it."""
    last = []

    def broken(parts):
        res = solve(parts)
        out = last[0] if last else res
        last[:] = [res]
        return out

    return broken


def half(solve):
    """Half of the batch left out: the first half of each card's part
    solved, its answers standing for the second half too."""
    def broken(parts):
        out = []
        for p in parts:
            h = p.batch // 2
            res = solve([p.replace(**{f: t[:h] for f, t in p.tensors().items()})])[0]
            for f in ("T_star", "J_star", "U"):
                v = getattr(res, f)
                setattr(res, f, torch.cat([v, v[: p.batch - h]], dim=0))
            out.append(res)
        return out

    return broken


def altered(solve):
    """An answer altered where it is produced: every T* one step off."""
    def broken(parts):
        out = solve(parts)
        for p, res in zip(parts, out):
            res.T_star = torch.where(res.T_star < p.T_max, res.T_star + 1, res.T_star - 1)
        return out

    return broken


def card_left_out(solve):
    """One card's answers never come: the last card's rows take the first
    card's answers."""
    def broken(parts):
        out = solve(parts)
        return out[:-1] + [out[0]]

    return broken


@pytest.mark.parametrize("fault", [stale, half, altered], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_with_the_solve_broken_is_not_correct(cell, fault):
    res = run_tiny(cell, fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"] if w["chips"] > 1])
def test_a_run_with_a_cards_answers_left_out_is_not_correct(cell):
    res = run_tiny(cell, card_left_out)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_an_outer_step_that_leaves_the_state_unchanged_is_not_correct(cell):
    """Every outer step after the warm start leaves the state as it was:
    the answers are the warm start's, consistent with themselves, and the
    reference's descent number fails them."""
    w, cfg, mix, _ = tiny(cell)
    with faults.planted("stale_step", options(cfg, mix)):
        res = run_tiny(cell)
    assert res["correct"] is False, res["checks"]
    c = res["checks"]["descent_left_median"]
    assert c["value"] > c["limit"], res["checks"]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def run_on_cards(cell: str, trace: int) -> dict:
    out = subprocess.run([sys.executable, "-m", "hopbench.run", "--workload", cell, "--seed", str(2**31 + 5),
                          "--seconds", "3", "--trace", str(trace)], cwd=ROOT, capture_output=True, text=True,
                         timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark runs on the card")
    res = run_on_cards(CELLS[0], 0)
    assert res["correct"] is True and res["device"]["platform"] == "gpu"


@pytest.mark.cuda
def test_the_four_card_cell_runs_on_four_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        pytest.skip("fewer than 4 CUDA devices: the cell runs on four cards")
    cell = next(w["name"] for w in MAN["workloads"] if w["chips"] == 4)
    res = run_on_cards(cell, 1)
    assert res["correct"] is True and res["device"]["count"] == 4
    assert {"cards.idle_share", "cards.skew_ms", "entry.enqueue_ms", "loop.steps_per_batch"} <= set(res["metrics"])
