"""The compiled solve: the counterpart of the JAX package's `_solve_jit` and
`_solve_batch_jit` (timeopt_tpu/solver/ilqr.py) and of their device-side
outer loop (`_run_outer_loop`, a `lax.while_loop` with a batch-wide early
exit).

A solve is two bodies over a fixed set of state buffers
(solver/ilqr.py::loop_state): *init* (the initial rollout and the warm
start: ilqr.curve_init, onepass.onepass_init) and *step* (one outer
iteration: ilqr.curve_step, onepass.onepass_step). Each reads the buffers
and writes them in place; nothing it allocates outlives it, and it reads
nothing back to the host. Two drivers run them:

- `_solve_traced`, eager: the bodies in a Python loop, with the early exit
  (one host read of `done.all()` between iterations). It is the only path
  on the CPU, and the reference of the captured one.
- `CompiledSolve`, captured: for problems on the card, `solve_batch` looks
  one up by (system, options, shapes, dtypes, device) or builds it: static
  input buffers, one eager warm-up of both bodies on a side stream (torch
  asks for it before a capture; it also builds and loads the kernels, makes
  the constants of ops/_build.py::constant and runs the occupancy queries
  the launchers cache), then an init graph and a step graph captured on a
  side stream (`torch.cuda.CUDAGraph`), sharing one memory pool. A call copies its inputs
  into the buffers, replays init, replays step up to max_iter times with
  the same host check between replays, and clones its results out. The
  capture is the counterpart of JAX's compile: the first call pays it.

A replay runs the kernels and torch ops of `_solve_traced` in the same
order on the same values, so its results are bitwise the eager driver's.
A capture that fails raises `CaptureError`, naming the op at fault (the
body is rerun eagerly under `CaptureGuard` to find it); nothing falls back
to running eagerly.

Launch counts: each kernel wrapper counts its launches in a Python global,
which a replay does not run. The wrapper calls made while capturing launch
nothing, so their counts are taken back; each program records the counts
its captures issued, by module, and adds them on every replay, so a
captured solve counts what the eager solve counts.
"""

from __future__ import annotations

import dataclasses
import time
import traceback
from collections import OrderedDict
from contextlib import nullcontext
from pathlib import Path
from typing import Callable, NamedTuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, curve_init, curve_step, loop_result, loop_state
from timeopt_tpu_torch.solver.onepass import onepass_init, onepass_step

MAX_PROGRAMS = 8  # captured programs kept, least recently used dropped first
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


@full_matmul_precision
def _solve_traced(system: System, opts: SolveOptions, prob: Problem, U_init: torch.Tensor) -> SolveResult:
    """The eager driver: init, then up to max_iter steps, stopping (with
    early_exit) once every problem is done. Takes its inputs as solve_batch
    hands them on (ilqr.prepare)."""
    b = bodies(opts)
    st = b.state(prob, opts, U_init.dtype, U_init.device)
    b.init(system, opts, prob, U_init, st)
    for _ in range(opts.max_iter):
        if opts.early_exit and bool(st["done"].all()):
            break
        b.step(system, opts, prob, st)
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
# The captured driver
# ============================================================================


def _launch_modules() -> tuple:
    """The modules whose LAUNCHES count kernel launches (dyngen: the
    generated line searches of systems without a device_id)."""
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan, dyngen

    return (cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan, dyngen)


def _device(device: torch.device):
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


class CompiledSolve:
    """One solve program: input and state buffers and, on the card, the
    captured init and step graphs. On the CPU it runs the bodies eagerly on
    the same buffers instead of replaying: the refill and the result copies
    are then those of the captured program. `warmup_s`, `capture_s` and
    `pool_bytes` (the growth of the card's reserved memory over the two
    captures: the graphs' pool) describe the build."""

    def __init__(self, system: System, opts: SolveOptions, probs: Problem, U_init: torch.Tensor):
        self.system, self.opts = system, opts
        self.device = probs.x0.device
        self.label = (f"{system.name} {opts.method} B={probs.batch} N={probs.N} "
                      f"{str(U_init.dtype).replace('torch.', '')}")
        self.bodies = bodies(opts)
        self.graphs = None
        self.warmup_s = self.capture_s = 0.0
        self.pool_bytes = 0
        with _device(self.device):
            self.inputs = {f: torch.empty_like(t) for f, t in probs.tensors().items()}
            self.U_init = torch.empty_like(U_init)
            self.prob = probs.replace(**self.inputs)
            self.state = self.bodies.state(self.prob, opts, U_init.dtype, self.device)
            if self.device.type == "cuda":
                self._build(probs, U_init)

    def _init(self) -> None:
        self.bodies.init(self.system, self.opts, self.prob, self.U_init, self.state)

    def _step(self) -> None:
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
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._init()
            self._step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        torch.cuda.synchronize(self.device)
        self.warmup_s = time.perf_counter() - t0
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        t0 = time.perf_counter()
        pool = torch.cuda.graph_pool_handle()
        # one capture stream for both: the allocator reuses a block freed in
        # the pool only on the stream it was freed on
        stream = torch.cuda.Stream(self.device)
        self.graphs = {"init": self._capture("init", self._init, pool, stream),
                       "step": self._capture("step", self._step, pool, stream)}
        torch.cuda.synchronize(self.device)
        self.capture_s = time.perf_counter() - t0
        self.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved

    def _capture(self, name: str, body, pool, stream) -> tuple:
        """(graph, launches by module) of one body, captured on the side
        stream `stream` as `torch.cuda.graph` captures, without its
        gc.collect() and empty_cache() before each capture: the build
        empties the cache once for both, and a collection of a large
        process's heap before every capture adds up over many programs."""
        mods = _launch_modules()
        before = [m.LAUNCHES for m in mods]
        graph = torch.cuda.CUDAGraph()
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
        return graph, counted

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

    def _run(self, name: str) -> None:
        if self.graphs is None:
            (self._init if name == "init" else self._step)()
            return
        graph, counted = self.graphs[name]
        graph.replay()
        for m, c in zip(_launch_modules(), counted):
            m.LAUNCHES += c

    def start(self, probs: Problem, U_init: torch.Tensor) -> None:
        """Load the inputs and run init."""
        with _device(self.device):
            self._load(probs, U_init)
            self._run("init")

    def step(self) -> None:
        with _device(self.device):
            self._run("step")

    def all_done(self) -> bool:
        """The early exit's host check (the lax.while_loop condition)."""
        return bool(self.state["done"].all())

    def result(self) -> SolveResult:
        """The result, copied out of the buffers."""
        with _device(self.device):
            res = loop_result(self.prob, self.state)
            return SolveResult(**{f.name: getattr(res, f.name).clone() for f in dataclasses.fields(res)})


def run_programs(runs: list, opts: SolveOptions) -> list:
    """Drive programs, each with its (probs, U_init), together: each
    starts, then every iteration steps every program not yet done, all
    programs' steps launched before any program's done check (with
    early_exit), so programs on different cards run at once. Returns their
    results in order."""
    if len({id(prog) for prog, _, _ in runs}) < len(runs):
        raise ValueError("two parts share one program (the same card, system, options and shapes): "
                         "its buffers hold one part at a time")
    for prog, probs, U in runs:
        prog.start(probs, U)
    active = [prog for prog, _, _ in runs]
    for _ in range(opts.max_iter):
        if opts.early_exit:
            active = [prog for prog in active if not prog.all_done()]
        if not active:
            break
        for prog in active:
            prog.step()
    return [prog.result() for prog, _, _ in runs]


def program(system: System, opts: SolveOptions, probs: Problem, U_init: torch.Tensor) -> CompiledSolve:
    """The cached program for these inputs' system, options, shapes,
    dtypes and device, built (warm-up and capture on these inputs) on a
    miss; at most MAX_PROGRAMS are kept."""
    key = (system, system.step, system.xdot, system.guard, system.extra_cost, opts, probs.N, probs.T_min,
           probs.T_max, probs.x0.device,
           tuple((tuple(t.shape), t.dtype) for t in list(probs.tensors().values()) + [U_init]))
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = CompiledSolve(system, opts, probs, U_init)
        while len(_PROGRAMS) > MAX_PROGRAMS:
            _PROGRAMS.popitem(last=False)
    else:
        _PROGRAMS.move_to_end(key)
    return prog


@full_matmul_precision
def solve_programs(system: System, opts: SolveOptions, parts: list) -> list:
    """Solve each (probs, U_init) of `parts` (inputs as ilqr.prepare gives
    them) through a program, all parts driven together (run_programs). A
    part on a card takes its cached or new program; a part on the CPU a
    program of its own, uncached: an eager program keeps nothing worth
    reusing, and the chunks of a CPU mesh, all on one device, would
    otherwise share one."""
    runs = []
    for probs, U in parts:
        with _device(probs.x0.device):
            prog = (program if probs.x0.device.type == "cuda" else CompiledSolve)(system, opts, probs, U)
        runs.append((prog, probs, U))
    return run_programs(runs, opts)


def programs() -> list:
    """The cached programs, least recently used first."""
    return list(_PROGRAMS.values())


def clear_compiled() -> None:
    """Drop every cached program and return its graphs' memory to the card."""
    _PROGRAMS.clear()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()

