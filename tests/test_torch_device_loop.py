"""The compiled solve's device-side outer loop (ops/cuda_loop.py,
solver/compiled.py) on the CPU.

On the card a program's solve is one launch of its loop graph: the init
graph, the condition kernel, then a conditional WHILE node around the step
graph and the condition kernel, so the early exit is decided on the device
and nothing is read back to the host. On the CPU a program runs the same
steps eagerly, with the condition's plain version `loop_condition` between
the bodies, over the same buffers. Here, without a card:

- (a) `loop_condition` on a table of (done, it, max_iter, early_exit,
  first) cases, B = 1, 37 and 8192, against the rule written out in
  Python: it = 0 or it + 1, cond = it < max_iter and not (early_exit and
  every problem done), and a finished loop adds one run and its steps;
- (b) the CPU program's loop bitwise `_solve_traced` (both run
  `compiled._run_eager`, the program on its own buffers), its counter `it`
  the steps `_solve_traced` takes, for the propagator, the brute force and
  the one-pass method, with early_exit on and off;
- (c) the same programs against the JAX package's `solve_batch` on the
  double integrator and PointMass: T* identical, J* within rtol 1e-9;
- (d) init, step and the loop condition under `CaptureGuard`: no op a
  capture refuses;
- (e) `settle_launches` books init x loops + step x steps from the
  counters (here with stand-in counts: on the CPU the plain versions count
  nothing), the counts the eager driver makes, once each;
- (f) four calls queued on one program, each with its own inputs, each
  equal to its own solve; a program evicted from the cache with a launch
  queued is synchronized before it is freed, its launches booked, and it
  refuses to launch again.

The card's side (the loop graph, no host read under
torch.cuda.set_sync_debug_mode("error"), four queued seeds) is in
tests/test_torch_card.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.test_torch_compiled import _batch, _same
from tests.torch_helpers import problems
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu_torch.ops import cuda_loop
from timeopt_tpu_torch.solver import compiled
from timeopt_tpu_torch.solver.ilqr import SolveOptions, prepare

torch.set_num_threads(1)


def _rule(done: np.ndarray, ctr: list, max_iter: int, early_exit: bool, first: bool) -> list:
    """The loop condition written out in Python: the counters after one
    condition step."""
    it = 0 if first else ctr[0] + 1
    go = it < max_iter and not (early_exit and bool(done.all()))
    runs, steps = ctr[2] + (not go), ctr[3] + (0 if go else it)
    return [it, int(go), runs, steps]


# (B, done pattern, it before, max_iter, early_exit, first)
COND_CASES = [
    (1, "none", 0, 12, True, True),
    (1, "all", 0, 12, True, True),
    (1, "all", 0, 12, False, True),
    (1, "all", 11, 12, True, False),
    (1, "none", 11, 12, True, False),
    (1, "none", 10, 12, False, False),
    (1, "none", 0, 0, True, True),
    (37, "all", 4, 12, True, False),
    (37, "last", 4, 12, True, False),
    (37, "first", 7, 12, True, False),
    (37, "random", 2, 12, False, False),
    (37, "all", 2, 12, False, False),
    (8192, "all", 8, 12, True, False),
    (8192, "last", 8, 12, True, False),
    (8192, "random", 11, 12, True, False),
    (8192, "none", 0, 1, True, True),
]


def _done(B: int, pattern: str, seed: int = 0) -> torch.Tensor:
    d = {"none": np.zeros(B, bool), "all": np.ones(B, bool)}.get(pattern)
    if d is None:
        d = np.random.default_rng(seed).random(B) < 0.7 if pattern == "random" else np.ones(B, bool)
        if pattern == "last":
            d[-1] = False
        elif pattern == "first":
            d[0] = False
    return torch.as_tensor(d)


@pytest.mark.parametrize("B,pattern,it,max_iter,early_exit,first", COND_CASES)
def test_loop_condition_table(B, pattern, it, max_iter, early_exit, first):
    """(a) loop_condition, and loop_cond on a CPU tensor (which runs it),
    give the written-out rule's counters; the returned (it, cond) are
    views of them."""
    done = _done(B, pattern)
    start = [it, 1, 3, 17]
    want = _rule(done.numpy(), start, max_iter, early_exit, first)
    for fn in (cuda_loop.loop_condition, cuda_loop.loop_cond):
        ctr = torch.tensor(start, dtype=torch.int64)
        got_it, cond = fn(done, ctr, max_iter, early_exit, first)
        assert ctr.tolist() == want
        assert (int(got_it), int(cond)) == (want[0], want[1])
        ctr[cuda_loop.IT] = -5
        assert int(got_it) == -5  # a view of the counter


def _counting_bodies(monkeypatch) -> list:
    """Count the step bodies _solve_traced runs (it takes them from
    compiled.bodies)."""
    steps = []
    plain = compiled.bodies

    def counted(opts):
        b = plain(opts)
        return compiled.Bodies(b.state, b.init, lambda *a: (steps.append(1), b.step(*a)))

    monkeypatch.setattr(compiled, "bodies", counted)
    return steps


@pytest.mark.parametrize("method", ["propagator", "bruteforce", "onepass"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_emulated_loop_matches_the_eager_driver(monkeypatch, method, early_exit):
    """(b) The CPU program's loop (bodies and loop_condition over its
    buffers) equals _solve_traced bit for bit, and its counter holds the
    steps _solve_traced takes: max_iter without the early exit, fewer with
    it where the batch converges first."""
    system, probs, U = _batch("DoubleIntegrator", B=3, seed=11)
    max_iter = 12 if early_exit else 3
    opts = SolveOptions(method=method, max_iter=max_iter, psd_levels=1, S_window=4, early_exit=early_exit)
    prog = compiled.CompiledSolve(system, opts, probs, U)
    got = compiled.run_programs([(prog, probs, U)])[0]
    steps = _counting_bodies(monkeypatch)
    want = compiled._solve_traced(system, opts, probs, U)
    _same(got, want)
    assert prog.iterations() == len(steps)
    assert len(steps) == max_iter if not early_exit else 0 < len(steps) < max_iter
    assert prog.settle() == (1, len(steps))


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
@pytest.mark.parametrize("early_exit", [True, False])
def test_emulated_loop_matches_jax(case, early_exit):
    """(c) The CPU program against the JAX package's batched solve on the
    same problems: T* identical, J* within rtol 1e-9."""
    N, T_min, T_max = (24, 4, 16) if case == "DoubleIntegrator" else (30, 8, 26)
    js, ts, jp, tp = problems(case, B=3, N=N, T_min=T_min, T_max=T_max, seed=9)
    kw = dict(max_iter=6, psd_levels=1, early_exit=early_exit)
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(use_pallas=False, **kw))
    probs, U = prepare(tp, None)
    opts = SolveOptions(**kw)
    got = compiled.run_programs([(compiled.CompiledSolve(ts, opts, probs, U), probs, U)])[0]
    np.testing.assert_array_equal(got.T_star.numpy(), np.asarray(want.T_star))
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-9)


@pytest.mark.parametrize("method", ["propagator", "bruteforce", "onepass"])
def test_bodies_and_condition_pass_the_capture_guard(method):
    """(d) After the eager warm-up, init, step and the loop condition (first
    and later) run under CaptureGuard without a refused op."""
    system, probs, U = _batch("PointMass_Navigation")
    opts = SolveOptions(method=method, max_iter=3, psd_levels=1, S_window=4)
    prog = compiled.CompiledSolve(system, opts, probs, U)
    prog.launch(probs, U)
    args = (prog.state["done"], prog.ctr, opts.max_iter, opts.early_exit)
    with compiled.CaptureGuard():
        prog._init()
        cuda_loop.loop_cond(*args, first=True)
        prog._step()
        cuda_loop.loop_cond(*args)
    assert int(prog.ctr[cuda_loop.IT]) == 1


def test_settle_launches_books_init_and_steps(monkeypatch):
    """(e) settle_launches adds a cached program's init counts once a loop
    and its step counts once a step, from the counters, to each module
    (stand-in counts on the CPU,
    where no wrapper counts), and the condition's launches (one a loop and
    one a step) to cuda_loop; a second settle adds nothing; a third
    launch, settled on its own, adds one loop and its steps."""
    system, probs, U = _batch("DoubleIntegrator", seed=12)
    opts = SolveOptions(max_iter=12, psd_levels=1)
    compiled.clear_compiled()
    prog = compiled.program(system, opts, probs, U)
    mods = compiled._launch_modules()
    for m in mods + (cuda_loop,):
        monkeypatch.setattr(m, "LAUNCHES", 0)
    init = [1, 0, 2, 0, 0, 0, 3, 1]
    step = [1, 1, 0, 0, 4, 0, 0, 1]
    prog.graphs = {"init": (None, init), "step": (None, step)}
    steps = _counting_bodies(monkeypatch)
    compiled._solve_traced(system, opts, probs, U)
    prog.launch(probs, U)
    prog.launch(probs, U)
    compiled.settle_launches()
    k = len(steps)
    assert 0 < k and prog.iterations() == k
    assert [m.LAUNCHES for m in mods] == [2 * (i + k * s) for i, s in zip(init, step)]
    assert cuda_loop.LAUNCHES == 2 * (1 + k)
    compiled.settle_launches()
    assert cuda_loop.LAUNCHES == 2 * (1 + k)
    prog.launch(probs, U)
    assert prog.settle() == (1, k)
    compiled.settle_launches()
    assert cuda_loop.LAUNCHES == 3 * (1 + k)
    assert [m.LAUNCHES for m in mods] == [3 * (i + k * s) for i, s in zip(init, step)]
    compiled.clear_compiled()


def test_queued_calls_on_one_program_keep_their_own_inputs():
    """(f) Four calls on one program, each with its own inputs, launched
    one after the other with each result cloned before the next load:
    four different results, each bitwise its own solve."""
    opts = SolveOptions(max_iter=6, psd_levels=1)
    sets = [_batch("DoubleIntegrator", seed=20 + i)[1:] for i in range(4)]
    system = _batch("DoubleIntegrator")[0]
    prog = compiled.CompiledSolve(system, opts, *sets[0])
    got = [compiled.run_programs([(prog, p, u)])[0] for p, u in sets]
    for r, (p, u) in zip(got, sets):
        _same(r, compiled._solve_traced(system, opts, p, u))
    assert len({r.X.sum().item() for r in got}) == 4


def test_eviction_synchronizes_then_closes(monkeypatch):
    """(f) A program dropped from the cache while its launch may still be
    queued: its device is synchronized before its graphs go, its launches
    are booked, its result stays right, and it refuses to launch again."""
    compiled.clear_compiled()
    monkeypatch.setattr(compiled, "MAX_PROGRAMS", 1)
    events = []
    plain_sync, plain_settle = compiled._synchronize, compiled.CompiledSolve.settle
    monkeypatch.setattr(compiled, "_synchronize", lambda d: (events.append("sync"), plain_sync(d)))
    monkeypatch.setattr(compiled.CompiledSolve, "settle",
                        lambda self: (events.append("settle"), plain_settle(self))[1])
    system, probs, U = _batch("DoubleIntegrator", seed=30)
    opts = SolveOptions(max_iter=4, psd_levels=1)
    first = compiled.program(system, opts, probs, U)
    first.launch(probs, U)  # queued, on the card
    res = first.result()
    compiled.program(system, opts, probs.replace(T_min=5), U)  # evicts `first`
    assert events[:2] == ["sync", "settle"] and first.closed and first not in compiled.programs()
    assert first._settled == (1, first.iterations())
    _same(res, compiled._solve_traced(system, opts, probs, U))
    with pytest.raises(RuntimeError, match="closed"):
        first.launch(probs, U)
    compiled.clear_compiled()
    assert compiled.programs() == []
