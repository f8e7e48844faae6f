"""The compiled solve: the counterpart of the JAX package's `_solve_jit` and
`_solve_batch_jit` (timeopt_tpu/solver/ilqr.py) and of their device-side
outer loop (`_run_outer_loop`, a `lax.while_loop` whose condition, the
iteration bound and the batch-wide early exit, is evaluated on the device).

A solve is two bodies over a fixed set of state buffers
(solver/ilqr.py::loop_state): *init* (the initial rollout and the warm
start: ilqr.curve_init, onepass.onepass_init) and *step* (one outer
iteration: ilqr.curve_step, onepass.onepass_step). Each reads the buffers
and writes them in place; nothing it allocates outlives it, and it reads
nothing back to the host. Two drivers run them:

- `_solve_traced`, eager: the bodies in a Python loop (`_run_eager`), the
  loop's condition in plain torch (cuda_loop.loop_condition) checked after
  init and after each step, one host read a check. It is solve_batch's path
  on the CPU, and the reference of the program.
- `CompiledSolve`, a program: for problems on the card, `solve_batch` looks
  one up by (system, options, shapes, dtypes, device) or builds it: static
  input buffers and the loop's counters (ops/cuda_loop.py), one eager
  warm-up of both bodies on a side stream (torch asks for it before a
  capture; it also builds and loads the kernels, makes the constants of
  ops/_build.py::constant and runs the occupancy queries the launchers
  cache), an init graph and a step graph captured on one side stream into
  one memory pool (`torch.cuda.CUDAGraph(keep_graph=True)`), then the loop
  graph (ops/cuda_loop.py::LoopGraph, csrc/loop_graph.cu): the init graph,
  the condition kernel, and a conditional WHILE node whose body is the step
  graph and the condition kernel again. A call copies its inputs into the
  buffers, launches the loop graph once and clones its results out, all on
  the current stream. It reads nothing back to the host, so it returns
  before the device finishes, and calls queue on the device: a call's
  inputs are loaded after the launch before it in stream order, and each
  result is cloned before the next load. The build is the counterpart of
  JAX's compile: the first call pays it. On the CPU a program runs
  `_run_eager` on its own buffers and counters.

A launch runs the kernels and torch ops of `_solve_traced` in the same
order on the same values, and as many steps (the condition is checked
after init and after each step), so its results are bitwise the eager
driver's. A capture that fails raises `CaptureError`, naming the op at
fault (the body is rerun eagerly under `CaptureGuard` to find it), and so
does a loop graph that cannot be built (naming what it refuses); nothing
falls back to running eagerly or to a loop driven from the host.

Launch counts: each kernel wrapper counts its launches in a Python global,
which a graph launch does not run. The wrapper calls made while capturing
launch nothing, so their counts are taken back; each program records the
counts its captures issued, by module. The host does not know how many
steps a launch ran, so the books are kept lazily: the condition kernel adds
each finished loop and its steps to the program's counters, and
`settle_launches()` reads them and adds init x loops + step x steps to
each module's count (and loops + steps to cuda_loop's, the condition's
launches), so a captured solve, once settled, counts what the eager solve
counts. Readers of the counts settle first; a solve never does.
"""

from __future__ import annotations

import dataclasses
import traceback
from collections import OrderedDict
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops import cuda_loop, cuda_trace
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, curve_init, curve_step, loop_result, loop_state
from timeopt_tpu_torch.solver.onepass import onepass_init, onepass_step
from timeopt_tpu_torch.utils import trace

MAX_PROGRAMS = 8  # programs kept, least recently used dropped first
_PROGRAMS: OrderedDict = OrderedDict()


class Bodies(NamedTuple):
    state: Callable  # (prob, opts, dtype, device) -> dict of buffers
    init: Callable  # (system, opts, prob, U_init, state) -> None
    step: Callable  # (system, opts, prob, state) -> None


def bodies(opts: SolveOptions) -> Bodies:
    """The state and the init and step bodies of opts.method."""
    if opts.method == "onepass":
        return Bodies(lambda *a: loop_state(*a, onepass=True), onepass_init, onepass_step)
    return Bodies(loop_state, curve_init, curve_step)


def _run_eager(b: Bodies, system: System, opts: SolveOptions, prob: Problem, U_init: torch.Tensor, st: dict,
               ctr: torch.Tensor) -> None:
    """init, then a step for as long as the loop's condition holds
    (cuda_loop.loop_condition on the counters `ctr`: at most max_iter
    steps, and with early_exit none once every problem is done), checked
    after init and after each step: the steps a loop-graph launch runs,
    eagerly, one read to the host a check."""
    with trace.phase("init"):
        b.init(system, opts, prob, U_init, st)
    cond = cuda_loop.loop_condition(st["done"], ctr, opts.max_iter, opts.early_exit, first=True)[1]
    while bool(cond):
        with trace.phase("step", pending=st["done"]):
            b.step(system, opts, prob, st)
        cond = cuda_loop.loop_condition(st["done"], ctr, opts.max_iter, opts.early_exit)[1]


@full_matmul_precision
def _solve_traced(system: System, opts: SolveOptions, prob: Problem, U_init: torch.Tensor) -> SolveResult:
    """The eager driver (_run_eager) on fresh state buffers and counters.
    Takes its inputs as solve_batch hands them on (ilqr.prepare). While
    tracing is on, its bodies stamp into a log of their own (a program id
    of its own, launch 0)."""
    b = bodies(opts)
    st = b.state(prob, opts, U_init.dtype, U_init.device)
    ctr = cuda_loop.new_counters(U_init.device)
    log = None
    if trace.on():
        log = trace.Log(U_init.device, trace.program_id(), f"{system.name} {opts.method} B={prob.batch} eager")
        trace.annotate("entry.call", program=log.program, launch=0)
    with trace.stamping(log, ctr):
        _run_eager(b, system, opts, prob, U_init, st, ctr)
    if log is not None:
        log.drain()  # the log goes with this call
    return loop_result(prob, st)


# ============================================================================
# What a capture refuses
# ============================================================================


class CaptureError(RuntimeError):
    """A body could not be captured into a CUDA graph."""


_REFUSED = {
    "_local_scalar_dense": "a read to the host (.item(), bool(), int() or float() of a tensor)",
    "lift_fresh": "a tensor made from Python data (torch.tensor)",
    "lift_fresh_copy": "a tensor made from Python data (torch.tensor)",
    "nonzero": "an output whose shape depends on the data (a read to the host)",
    "masked_select": "an output whose shape depends on the data (a read to the host)",
}
_HERE = Path(__file__).resolve()
_TORCH = Path(torch.__file__).resolve().parent


def _refused(func, args, kwargs):
    """Why a capture refuses this op, or None."""
    name = func.overloadpacket.__name__
    if name in _REFUSED:
        return _REFUSED[name]
    tensors = [a for a in list(args) + list(kwargs.values()) if isinstance(a, torch.Tensor)]
    if name == "_to_copy" and tensors and tensors[0].device.type == "cpu":
        dev = kwargs.get("device")
        if dev is not None and torch.device(dev).type == "cuda":
            return "a copy from host memory to the card"
    on_card = any(t.device.type == "cuda" for t in tensors)
    if on_card and any(t.device.type == "cpu" and t.dim() > 0 for t in tensors):
        return "a copy from host memory to the card (a CPU tensor beside a CUDA one)"
    return None


def _caller() -> str:
    """file:line (function) of the innermost frame outside torch and this
    module: where the refused op was called."""
    for fr in reversed(traceback.extract_stack()):
        path = Path(fr.filename).resolve()
        if path != _HERE and _TORCH not in path.parents:
            return f"{fr.filename}:{fr.lineno} ({fr.name})"
    return "unknown"


class CaptureGuard(TorchDispatchMode):
    """While active, raises CaptureError at the first op that a CUDA-graph
    capture refuses: a read to the host (`aten._local_scalar_dense`), a
    tensor made from Python data (`aten.lift_fresh`), a copy from host
    memory to the card, an op whose output shape depends on the data. It
    runs the ops eagerly, so it checks a body on the CPU too, where the
    copies to the card cannot show (every tensor is on the host)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        why = _refused(func, args, kwargs)
        if why is not None:
            raise CaptureError(f"{func} ({why}) at {_caller()}")
        return func(*args, **kwargs)


# ============================================================================
# The program
# ============================================================================


def _launch_modules() -> tuple:
    """The modules whose LAUNCHES count kernel launches (dyngen: the
    generated line searches of systems without a device_id; cuda_linearize:
    the Jacobians of registry systems)."""
    from timeopt_tpu_torch.ops import (cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query,
                                       cuda_lft_scan, cuda_linearize, dyngen)

    return (cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan, dyngen,
            cuda_linearize)


def _device(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class CompiledSolve:
    """One solve program: input and state buffers, the loop's counters and,
    on the card, the captured init and step graphs and the loop graph
    around them. On the CPU it runs _run_eager on the same buffers and
    counters: the refill, the condition and the result copies are then
    those of the program on the card. `pool_bytes` (the growth of the
    card's reserved memory over the two captures: the graphs' pool) and the
    build's spans (`spans`, utils/trace.py: `build`, `build.warmup.init|step`,
    `build.capture.init|step`, `build.loop_graph`; `build`'s children hold
    the library loads too) describe the build;
    `warmup_s`, `capture_s` (the two captures and the loop graph) and
    `loop_s` (the loop graph alone) are their seconds.

    A program built while tracing is on (`traced`, part of its cache key)
    has a stamp log (utils/trace.py) and stamps its bodies' phases: its
    captures hold the stamp kernels (`stamps`: launches a capture), which
    a program built with tracing off does not. `id` and the launch index
    (`launches`, the launches so far) tag its calls' spans and its rows."""

    def __init__(self, system: System, opts: SolveOptions, probs: Problem, U_init: torch.Tensor):
        self.system, self.opts = system, opts
        self.device = probs.x0.device
        self.label = (f"{system.name} {opts.method} B={probs.batch} N={probs.N} "
                      f"{str(U_init.dtype).replace('torch.', '')}")
        self.bodies = bodies(opts)
        self.id = trace.program_id()
        self.traced = trace.on()
        self.graphs = None  # on the card: {"init"|"step": (CUDAGraph, launches by module)}
        self.stamps = {"init": 0, "step": 0}  # stamp launches of each capture
        self.loop = None  # on the card: the cuda_loop.LoopGraph
        self.closed = False
        self.launches = 0
        self.pool_bytes = 0
        self.spans = {}  # build span name -> trace.Span
        self._settled = (0, 0)  # (loops, steps) of the counters already booked
        self._unsettled = False
        with _device(self.device):
            self.inputs = {f: torch.empty_like(t) for f, t in probs.tensors().items()}
            self.U_init = torch.empty_like(U_init)
            self.prob = probs.replace(**self.inputs)
            self.state = self.bodies.state(self.prob, opts, U_init.dtype, self.device)
            self.ctr = cuda_loop.new_counters(self.device)
            self.log = trace.Log(self.device, self.id, self.label) if self.traced else None
            if self.device.type == "cuda":
                self._build(probs, U_init)

    def _seconds(self, *names) -> float:
        return sum(self.spans[n].seconds for n in names if n in self.spans)

    @property
    def warmup_s(self) -> float:
        return self._seconds("build.warmup.init", "build.warmup.step")

    @property
    def capture_s(self) -> float:
        return self._seconds("build.capture.init", "build.capture.step", "build.loop_graph")

    @property
    def loop_s(self) -> float:
        return self._seconds("build.loop_graph")

    def _span(self, name: str) -> trace.Span:
        """A build span of this program, kept for the attributes above."""
        self.spans[name] = trace.build_span(name, program=self.id)
        return self.spans[name]

    def _init(self) -> None:
        with trace.phase("init"):
            self.bodies.init(self.system, self.opts, self.prob, self.U_init, self.state)

    def _step(self) -> None:
        with trace.phase("step", pending=self.state["done"]):
            self.bodies.step(self.system, self.opts, self.prob, self.state)

    def _load(self, probs: Problem, U_init: torch.Tensor) -> None:
        for f, t in list(probs.tensors().items()) + [("U_init", U_init)]:
            buf = self.U_init if f == "U_init" else self.inputs[f]
            if t.shape != buf.shape or t.dtype != buf.dtype:
                raise ValueError(f"{self.label}: input {f} {tuple(t.shape)} {t.dtype}, the program's "
                                 f"{tuple(buf.shape)} {buf.dtype}")
            buf.copy_(t)

    def _build(self, probs: Problem, U_init: torch.Tensor) -> None:
        self._load(probs, U_init)
        with self._span("build") as build:
            build.args.update(label=self.label, traced=self.traced)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            # a traced build's warm-up phases are build spans too (a synchronize each)
            with trace.stamping(self.log, self.ctr, warm=True):
                for name, body in (("init", self._init), ("step", self._step)):
                    with self._span(f"build.warmup.{name}"), torch.cuda.stream(side):
                        body()
                        torch.cuda.synchronize(self.device)
            torch.cuda.current_stream(self.device).wait_stream(side)
            if self.log is not None:
                self.log.clear()  # the warm-up's stamps belong to no launch
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            pool = torch.cuda.graph_pool_handle()
            # one capture stream for both: the allocator reuses a block freed in
            # the pool only on the stream it was freed on
            stream = torch.cuda.Stream(self.device)
            graphs = {}
            for name, body in (("init", self._init), ("step", self._step)):
                with self._span(f"build.capture.{name}"), trace.stamping(self.log, self.ctr):
                    graph, counted, self.stamps[name] = self._capture(name, body, pool, stream)
                    graphs[name] = (graph, counted)
            torch.cuda.synchronize(self.device)
            self.graphs = graphs
            self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
            with self._span("build.loop_graph"):
                try:
                    self.loop = cuda_loop.LoopGraph(graphs["init"][0], graphs["step"][0], self.state["done"],
                                                    self.ctr, self.opts.max_iter, self.opts.early_exit)
                except RuntimeError as exc:
                    raise CaptureError(f"building the loop graph of {self.label} failed: {exc}") from exc

    def _capture(self, name: str, body, pool, stream) -> tuple:
        """(graph, launches by module, stamp launches) of one body, captured
        on the side stream `stream` as `torch.cuda.graph` captures, without its
        gc.collect() and empty_cache() before each capture: the build
        empties the cache once for both, and a collection of a large
        process's heap before every capture adds up over many programs.
        The graph keeps its cudaGraph_t (keep_graph) for the loop graph and
        is never instantiated itself."""
        mods = _launch_modules() + (cuda_trace,)
        before = [m.LAUNCHES for m in mods]
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        stream.wait_stream(torch.cuda.current_stream(self.device))
        try:
            with torch.cuda.stream(stream):
                graph.capture_begin(pool=pool)
                try:
                    body()
                finally:
                    graph.capture_end()
            torch.cuda.current_stream(self.device).wait_stream(stream)
        except Exception as exc:
            raise CaptureError(f"capturing the {name} body of {self.label} failed: {self._diagnose(body, exc)}") from exc
        finally:
            counted = [m.LAUNCHES - b for m, b in zip(mods, before)]
            for m, b in zip(mods, before):
                m.LAUNCHES = b
        return graph, counted[:-1], counted[-1]

    def _diagnose(self, body, exc: Exception) -> str:
        """The op at fault: the body rerun eagerly under CaptureGuard."""
        try:
            with CaptureGuard():
                body()
        except CaptureError as found:
            return str(found)
        except Exception as other:  # noqa: BLE001 - reported, the capture's error chained
            return f"{type(exc).__name__}: {exc} (an eager rerun raised {type(other).__name__}: {other})"
        return f"{type(exc).__name__}: {exc} (CaptureGuard found no refused op)"

    def launch(self, probs: Problem | None = None, U_init: torch.Tensor | None = None) -> None:
        """One solve: the inputs loaded (when given), then init and up to
        max_iter steps, each step only while the condition holds. On the
        card one launch of the loop graph on the current stream, nothing
        read back; on the CPU the same steps run eagerly."""
        if self.closed:
            raise RuntimeError(f"program {self.label} was closed (evicted or cleared)")
        tag = dict(program=self.id, launch=self.launches)
        trace.annotate("entry.call", **tag)
        with _device(self.device):
            if probs is not None:
                with trace.span("entry.load", **tag):
                    self._load(probs, U_init)
            with trace.span("entry.launch", **tag):
                if self.loop is not None:
                    self.loop.launch()
                else:
                    with trace.stamping(self.log, self.ctr):
                        _run_eager(self.bodies, self.system, self.opts, self.prob, self.U_init, self.state, self.ctr)
                    if self.log is not None:
                        self.log.drain()  # an uncached program on the CPU goes with its call
        self.launches += 1
        self._unsettled = True

    def iterations(self) -> int:
        """The steps the last launch ran, read from the loop's counter (on
        the card a read to the host: it waits for that launch)."""
        with _device(self.device):
            return int(self.ctr[cuda_loop.IT])

    def settle(self) -> tuple:
        """(loops, steps) run since the last settle, read from the loop's
        counters; a captured program adds their launches to the wrappers'
        counts (init's a loop, step's a step, and one condition launch for
        each of both). On the CPU nothing is booked: the bodies ran the
        plain versions, which count nothing."""
        with _device(self.device):
            loops, steps = self.ctr[cuda_loop.RUNS:].tolist()
        new = (loops - self._settled[0], steps - self._settled[1])
        self._settled, self._unsettled = (loops, steps), False
        if self.graphs is not None:
            for m, i, s in zip(_launch_modules(), self.graphs["init"][1], self.graphs["step"][1]):
                m.LAUNCHES += i * new[0] + s * new[1]
            cuda_loop.LAUNCHES += new[0] + new[1]
            cuda_trace.LAUNCHES += self.stamps["init"] * new[0] + self.stamps["step"] * new[1]
        return new

    def result(self) -> SolveResult:
        """The result, copied out of the buffers."""
        with _device(self.device), trace.span("entry.result", program=self.id, launch=self.launches - 1):
            res = loop_result(self.prob, self.state)
            return SolveResult(**{f.name: getattr(res, f.name).clone() for f in dataclasses.fields(res)})

    def close(self) -> None:
        """Wait for the program's device (a launch may still be queued),
        book its launches, then free its loop graph and captures and their
        pool. A closed program does not launch again."""
        if self.closed:
            return
        _synchronize(self.device)
        self.settle()
        if self.log is not None:
            self.log.drain()
        if self.loop is not None:
            self.loop.close()
        self.loop = self.graphs = None
        self.closed = True


def settle_launches() -> None:
    """Book the launches of every cached program's solves since the last
    settle (CompiledSolve.settle; a program dropped from the cache settled
    when it was closed): one read of the counters of each program that
    launched, so it waits for those launches. The readers of the launch
    counts call it first; the solve path never does."""
    for prog in _PROGRAMS.values():
        if prog._unsettled:
            prog.settle()


def run_programs(runs: list) -> list:
    """Solve with programs, each with its (probs, U_init): every program
    loaded and launched in turn (on the card one loop-graph launch each,
    nothing read back, so programs on different cards run at once), then
    each result cloned out. Returns the results in order."""
    if len({id(prog) for prog, _, _ in runs}) < len(runs):
        raise ValueError("two parts share one program (the same card, system, options and shapes): "
                         "its buffers hold one part at a time")
    for prog, probs, U in runs:
        prog.launch(probs, U)
    return [prog.result() for prog, _, _ in runs]


def program(system: System, opts: SolveOptions, probs: Problem, U_init: torch.Tensor) -> CompiledSolve:
    """The cached program for these inputs' system, options, shapes,
    dtypes and device, and whether tracing is on, built (warm-up and
    capture on these inputs) on a miss; at most MAX_PROGRAMS are kept, and
    the one dropped is closed (its device synchronized first: a launch of
    it may still be queued)."""
    key = (system, system.step, system.xdot, system.guard, system.extra_cost, opts, probs.N, probs.T_min,
           probs.T_max, probs.x0.device, trace.on(),
           tuple((tuple(t.shape), t.dtype) for t in list(probs.tensors().values()) + [U_init]))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = CompiledSolve(system, opts, probs, U_init)
        while len(_PROGRAMS) > MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)[1].close()
    else:
        _PROGRAMS.move_to_end(key)
    return prog


@full_matmul_precision
def solve_programs(system: System, opts: SolveOptions, parts: list) -> list:
    """Solve each (probs, U_init) of `parts` (inputs as ilqr.prepare gives
    them) through a program, all parts launched before any result is
    copied out (run_programs). A part on a card takes its cached or new
    program; a part on the CPU a program of its own, uncached: an eager
    program keeps nothing worth reusing, and the chunks of a CPU mesh, all
    on one device, would otherwise share one."""
    runs = []
    for probs, U in parts:
        with _device(probs.x0.device), trace.span("entry.program"):
            prog = (program if probs.x0.device.type == "cuda" else CompiledSolve)(system, opts, probs, U)
        runs.append((prog, probs, U))
    return run_programs(runs)


def programs() -> list:
    """The cached programs, least recently used first."""
    return list(_PROGRAMS.values())


def clear_compiled() -> None:
    """Close every cached program (its launches booked, its device
    synchronized) and return its graphs' memory to the card."""
    while _PROGRAMS:
        _PROGRAMS.popitem(last=False)[1].close()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
