"""The port's tracing: spans and counters recorded where the work happens,
kept in memory, read on one clock.

Four kinds of record:

- **device phase stamps.** A traced program (solver/compiled.py: one built
  while tracing is on) stamps each boundary of the phases of its init and
  step bodies (`phase`, PHASES). On the card a stamp is a kernel
  (ops/cuda_trace.py, csrc/trace.cu) captured into the init and step
  graphs, so it runs inside the loop graph's WHILE body; it reads the
  card's nanosecond clock. On the CPU it reads time.perf_counter_ns(): the
  CPU's ops run synchronously, so there host time is device time. A row
  holds the program, the launch (the loops the program finished before
  it), the iteration (-1 in init), the phase's begin or end, the time and,
  at the start of `step` and `init.warm`, the count of problems not done.
- **host spans of a solve call** (`span`): `entry.call` and its children
  `entry.prepare`, `entry.program`, `entry.load`, `entry.launch`,
  `entry.result` (parallel/mesh.py::solve_batch_resident and
  ilqr.solve_batch down to CompiledSolve). Recorded only while tracing is
  on; off, each costs one flag test. `entry.load`, `entry.launch` and
  `entry.result` hold the (program, launch) of the device rows they
  enqueued, and `entry.call` that of its first launch.
- **host spans of a program's build** (`build_span`): `build`, its
  children `build.warmup.init`, `build.warmup.step`, `build.capture.init`,
  `build.capture.step`, `build.loop_graph`, and a `build.kernels` span for
  each library load (ops/_build.py: nvcc, or the cached library opened),
  under whichever span is open then. Measured always: a few readings a
  build, which CompiledSolve's warmup_s, capture_s and loop_s are views of;
  each span holds its children, so a program's `build` span holds its
  build's tree. The recorder lists them only while tracing is on, so an
  untraced process keeps no more than its programs do. A traced build
  also makes each body phase of its warm-up a build span.
- **counts of a traced build** (`count`): kept in the args of the
  innermost build span open when they are made (read with `counts`),
  beside its `build.kernels` spans. The kernels' wrappers count there the
  size tier that each select and backward launch binds (`select.tier<n>`,
  `backward.tier<n>`: ops/cuda_lft.py::tier, ops/cuda_backward.py::tier),
  once for each launch the build's warm-up and captures place. Counted
  only while tracing is on; off, one flag test. A replay of a captured
  graph runs no Python and counts nothing.

Tracing is off by default and on inside `recording()`. A program's cache
key holds whether tracing is on, so a program built with tracing off
captures no stamp: its graphs are those of an untraced build. The Python
that places the stamps runs only while a body is captured (or, on the CPU,
run), so a launch adds nothing on the host.

`calibrate(device)` fits the card's clock to the host's: it launches a stamp
between two host readings with a synchronize, many times, and keeps the
narrowest pair (the offset, and half the pair's width as its uncertainty).
`recording(device)` calibrates at its start and at its end, so that the
offset's drift is fitted. One card is calibrated between resets.
`records()` gives every row and span on that card's clock, each with its
parent and self time (its duration less the part its children cover); it
raises on rows of a card whose clock was not fitted. `write_chrome(path)`
writes them as a Chrome/Perfetto trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import math
import threading
import time
import weakref

import torch

# the phases a body stamps; a row's code is 2 x index, + 1 at the phase's end
PHASES = ("init", "init.rollout", "init.warm", "step", "linearize", "select", "select.inputs", "select.kernel",
          "extra_cost", "backward", "backward.kernel", "forward", "forward.kernel", "commit")
CODE = {name: i for i, name in enumerate(PHASES)}
CAPACITY = 1 << 17  # rows of a traced program's stamp log (40 bytes each on the card)
REPS = 50  # host-device pairs of a calibration (and stamps of its burst)

_ON = False
_CAPACITY = CAPACITY
_NULL = contextlib.nullcontext()
_SPANS: list = []  # host spans recorded while tracing is on, in start order
_THREAD = threading.local()  # .open: the host spans open now in this thread, outermost first
_ROWS: list = []  # drained rows: (device, program, launch, iteration, code, t_ns, count)
_LOGS: weakref.WeakSet = weakref.WeakSet()
_LABELS: dict = {}  # program -> label
_CALIB: list = []  # the calibrations of _CARD, in order
_CARD = None  # the card whose clock is fitted
_DROPPED = 0
_STAMPER = None
_IDS = itertools.count()


def on() -> bool:
    """Whether tracing is on (inside recording())."""
    return _ON


def program_id() -> int:
    """A new program id (a traced program's rows and its calls' spans carry it)."""
    return next(_IDS)


def label(program: int) -> str:
    return _LABELS.get(program, str(program))


# ============================================================================
# Host spans
# ============================================================================


class Span:
    """A host span: name, start and end (time.perf_counter_ns), the span
    open around it in its thread when it started, the spans that opened
    inside it, its kind ("call" or "build") and args."""

    __slots__ = ("name", "kind", "args", "t0", "t1", "parent", "children")

    def __init__(self, name: str, kind: str, args: dict):
        self.name, self.kind, self.args = name, kind, args
        self.t0 = self.t1 = self.parent = None
        self.children = []

    @property
    def seconds(self) -> float:
        return 0.0 if self.t1 is None else (self.t1 - self.t0) / 1e9

    def __enter__(self):
        stack = _open()
        self.parent = stack[-1] if stack else None
        if self.parent is not None:
            self.parent.children.append(self)
        if _ON:
            _SPANS.append(self)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        self.t1 = time.perf_counter_ns()
        stack = _open()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        return False


def span(name: str, **args):
    """A host span of a solve call: recorded while tracing is on, else
    nothing (a shared null context)."""
    if not _ON:
        return _NULL
    return Span(name, "call", args)


def build_span(name: str, **args) -> Span:
    """A host span of a build, measured whether tracing is on or not (the
    recorder lists it while tracing is on)."""
    return Span(name, "build", args)


def count(name: str) -> None:
    """One more `name` in the args' "counts" of the innermost build span
    open in this thread, while tracing is on (a traced build); else, or
    outside any build, nothing."""
    if not _ON:
        return
    for s in reversed(_open()):
        if s.kind == "build":
            c = s.args.setdefault("counts", {})
            c[name] = c.get(name, 0) + 1
            return


def counts(span: Span) -> dict:
    """The counts of a build span and of every span under it, summed."""
    out, todo = {}, [span]
    while todo:
        s = todo.pop()
        todo += s.children
        for k, v in s.args.get("counts", {}).items():
            out[k] = out.get(k, 0) + v
    return out


def _open() -> list:
    if not hasattr(_THREAD, "open"):
        _THREAD.open = []
    return _THREAD.open


def annotate(name: str, **args) -> None:
    """Set each of args not yet set on the innermost span `name` open in
    this thread (a call span: none while tracing is off)."""
    if not _ON:
        return
    for s in reversed(_open()):
        if s.name == name:
            for k, v in args.items():
                s.args.setdefault(k, v)
            return


# ============================================================================
# Device phase stamps
# ============================================================================


class Log:
    """A program's stamp log: on the card the buffers of ops/cuda_trace.py
    (rows claimed on the device; once `capacity` are taken the rest count as
    dropped), on the CPU a list of the same rows. `drain` moves what it
    holds into the recorder."""

    def __init__(self, device, program: int, label: str, capacity: int | None = None):
        self.device = _card(device)
        self.program = program
        self.capacity = capacity or _CAPACITY
        self.cuda = self.device.type == "cuda"
        _LABELS[program] = label
        if self.cuda:
            from timeopt_tpu_torch.ops import cuda_trace

            self.rows, self.head = cuda_trace.new_log(self.capacity, self.device)
        else:
            self.rows, self.dropped = [], 0
        _LOGS.add(self)

    def stamp(self, ctr, done, init: bool, code: int) -> None:
        if self.cuda:
            from timeopt_tpu_torch.ops import cuda_trace

            cuda_trace.stamp(self.rows, self.head, ctr, done, init, code)
        elif len(self.rows) < self.capacity:
            # tensors kept, read at the drain: a body reads nothing to the host
            self.rows.append((None if ctr is None else ctr.clone(), init, code, time.perf_counter_ns(),
                              None if done is None else (~done).sum()))
        else:
            self.dropped += 1

    def _take(self) -> tuple:
        """(rows as tuples, dropped), the log emptied; on the card after a
        wait for its device."""
        if self.cuda:
            with torch.cuda.device(self.device):
                torch.cuda.synchronize(self.device)
                cursor, dropped = self.head.tolist()
                rows = [tuple(r) for r in self.rows[: min(cursor, self.capacity)].tolist()]
                self.head.zero_()
                torch.cuda.synchronize(self.device)
            return rows, dropped
        from timeopt_tpu_torch.ops.cuda_loop import IT, RUNS

        rows = [(-1 if c is None else int(c[RUNS]), -1 if init or c is None else int(c[IT]), code, t,
                 -1 if n is None else int(n)) for c, init, code, t, n in self.rows]
        dropped, self.rows, self.dropped = self.dropped, [], 0
        return rows, dropped

    def drain(self) -> None:
        global _DROPPED
        rows, dropped = self._take()
        _ROWS.extend((self.device, self.program) + r for r in rows)
        _DROPPED += dropped

    def clear(self) -> None:
        """Empty the log, keeping nothing (a build's warm-up stamps)."""
        self._take()


class _Stamper:
    def __init__(self, log: Log, ctr, warm: bool):
        self.log, self.ctr, self.warm, self.init = log, ctr, warm, False

    @contextlib.contextmanager
    def phase(self, code: int, pending):
        outer = self.init
        self.init = outer or code == CODE["init"]
        self.log.stamp(self.ctr, pending, self.init, 2 * code)
        if not self.warm:
            yield
        else:
            with build_span(PHASES[code]):
                yield
                if self.log.cuda:
                    torch.cuda.synchronize(self.log.device)
        self.log.stamp(self.ctr, None, self.init, 2 * code + 1)
        self.init = outer


@contextlib.contextmanager
def stamping(log: Log | None, ctr, warm: bool = False):
    """While open, the bodies' phases stamp into `log`, each row tagged from
    the loop counters `ctr`; with no log, nothing. With `warm` (a traced
    build's eager warm-up) each phase is also a build span, closed after a
    synchronize of the log's device, so the warm-up's seconds fall to its
    phases."""
    global _STAMPER
    if log is None:
        yield
        return
    prev, _STAMPER = _STAMPER, _Stamper(log, ctr, warm)
    try:
        yield
    finally:
        _STAMPER = prev


def phase(name: str, pending=None):
    """The phase `name` of a body: stamped at its begin and end while a
    traced program's body runs or is captured (`stamping`), else nothing.
    `pending` (the state's done flags) adds the count of problems not done
    to the begin row."""
    s = _STAMPER
    if s is None:
        return _NULL
    return s.phase(CODE[name], pending)


def drain() -> None:
    """Move the rows of every live log into the recorder."""
    for log in list(_LOGS):
        log.drain()


def dropped() -> int:
    """Rows that found their log full, since the last reset."""
    drain()
    return _DROPPED


# ============================================================================
# One clock
# ============================================================================


@dataclasses.dataclass
class Calibration:
    host_ns: int  # perf_counter_ns at the narrowest pair's midpoint
    offset_ns: int  # the card's clock less the host's there
    uncertainty_ns: int  # half the pair's width: the offset is within it
    resolution_ns: int  # the clock's step: the gcd of the steps between back-to-back stamps


def _card(device) -> torch.device:
    """A card's device with its index (the current card's where none)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def calibrate(device) -> Calibration:
    """One fit of the card's clock to the host's (recorded for records()):
    REPS stamps, each launched between two host readings with a
    synchronize, the narrowest pair giving the offset; then REPS stamps
    back to back, whose steps give the clock's resolution. One card is
    fitted between resets: another card raises."""
    global _CARD
    from timeopt_tpu_torch.ops import cuda_trace

    device = _card(device)
    if device.type != "cuda":
        raise ValueError(f"calibrate: {device} has no clock of its own (a CPU's rows are on the host's)")
    if _CARD is not None and device != _CARD:
        raise ValueError(f"calibrate: {_CARD}'s clock is the one fitted; reset() before fitting {device}'s")
    pairs = []
    with torch.cuda.device(device):
        rows, head = cuda_trace.new_log(2 * REPS + 1, device)
        cuda_trace.stamp(rows, head, None, None, False, 0)  # loads the kernel
        for _ in range(REPS):
            torch.cuda.synchronize(device)
            h0 = time.perf_counter_ns()
            cuda_trace.stamp(rows, head, None, None, False, 0)
            torch.cuda.synchronize(device)
            pairs.append((h0, time.perf_counter_ns()))
        for _ in range(REPS):
            cuda_trace.stamp(rows, head, None, None, False, 0)
        t = [int(v) for v in rows[1:, 3].tolist()]
    i = min(range(REPS), key=lambda k: pairs[k][1] - pairs[k][0])
    h0, h1 = pairs[i]
    burst = t[REPS:]
    cal = Calibration(host_ns=(h0 + h1) // 2, offset_ns=t[i] - (h0 + h1) // 2, uncertainty_ns=(h1 - h0 + 1) // 2,
                      resolution_ns=math.gcd(*(b - a for a, b in zip(burst, burst[1:]))))
    _CARD = device
    _CALIB.append(cal)
    return cal


def device_ns(host_ns: int) -> int:
    """A host time (perf_counter_ns) on the fitted card's clock: the offset
    on the line through the first and the last calibration (one: constant;
    none: the host time as it is)."""
    if not _CALIB:
        return host_ns
    a, b = _CALIB[0], _CALIB[-1]
    if b.host_ns == a.host_ns:
        return host_ns + a.offset_ns
    return host_ns + round(a.offset_ns + (b.offset_ns - a.offset_ns) * (host_ns - a.host_ns)
                           / (b.host_ns - a.host_ns))


def calibration() -> dict | None:
    """The fit of the calibrated card: offsets at the first and the last
    calibration, their host times, the drift (ns a second), the largest
    uncertainty and the least resolution seen; None if none was made."""
    cals = _CALIB
    if not cals:
        return None
    a, b = cals[0], cals[-1]
    span_s = (b.host_ns - a.host_ns) / 1e9
    return {"n": len(cals), "offset_ns": [a.offset_ns, b.offset_ns], "host_ns": [a.host_ns, b.host_ns],
            "drift_ns_per_s": (b.offset_ns - a.offset_ns) / span_s if span_s > 0 else 0.0,
            "uncertainty_ns": max(c.uncertainty_ns for c in cals),
            "resolution_ns": min((c.resolution_ns for c in cals if c.resolution_ns), default=0)}


# ============================================================================
# Reading
# ============================================================================


@dataclasses.dataclass
class Record:
    """A span on the calibrated card's clock (ns). Host spans: track "host", kind
    "call" or "build"; device phases: track "device", with the iteration
    (-1 in init) and, at a step's start, the count of problems not done."""

    name: str
    track: str
    t0: int
    t1: int
    parent: int | None = None  # index of the enclosing record (same track)
    self_ns: int = 0  # duration less the part its children cover
    program: int | None = None
    launch: int | None = None
    iteration: int | None = None
    count: int | None = None
    kind: str = ""
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def ns(self) -> int:
        return self.t1 - self.t0


def records() -> list:
    """Every host span and device phase recorded so far (the logs drained
    first), on the calibrated card's clock (with none, the host's, which is
    the CPU's device clock). Host spans come first, in start order, then
    each program's device phases in stamp order; a phase whose begin or end
    row was dropped is left out. Each record's `parent` indexes this list.
    Raises on rows of a card other than the calibrated one: their clock
    was not fitted."""
    drain()
    stray = {r[0] for r in _ROWS if r[0].type == "cuda"} - {_CARD}
    if stray:
        raise ValueError(f"records: rows of {sorted(map(str, stray))}, whose clock was not fitted "
                         f"(recording(device) fits one card; fitted: {_CARD})")

    def dev(device, t: int) -> int:
        return t if device.type == "cuda" else device_ns(t)

    out, index = [], {}
    for s in _SPANS:
        if s.t1 is None:
            continue
        a = dict(s.args)
        index[id(s)] = len(out)
        out.append(Record(s.name, "host", device_ns(s.t0), device_ns(s.t1), parent=index.get(id(s.parent)),
                          program=a.pop("program", None), launch=a.pop("launch", None), kind=s.kind, args=a))
    stacks: dict = {}
    for device, program, launch, it, code, t, count in _ROWS:
        stack = stacks.setdefault((device, program, launch), [])
        p, end = divmod(code, 2)
        if not end:
            stack.append(len(out))
            out.append(Record(PHASES[p], "device", dev(device, t), None, parent=stack[-2] if len(stack) > 1 else None,
                              program=program, launch=launch, iteration=it, count=None if count < 0 else count))
        elif stack and out[stack[-1]].name == PHASES[p]:
            out[stack.pop()].t1 = dev(device, t)
    keep = [r.t1 is not None for r in out]
    new = list(itertools.accumulate(keep, initial=0))
    out = [dataclasses.replace(r, parent=None if r.parent is None or not keep[r.parent] else new[r.parent])
           for r, k in zip(out, keep) if k]
    children: dict = {}
    for i, r in enumerate(out):
        if r.parent is not None:
            children.setdefault(r.parent, []).append(i)
    for i, r in enumerate(out):
        covered, end = 0, r.t0
        for c in sorted(children.get(i, ()), key=lambda c: out[c].t0):
            lo, hi = max(out[c].t0, end, r.t0), min(out[c].t1, r.t1)
            if hi > lo:
                covered += hi - lo
                end = hi
        r.self_ns = r.ns - covered
    return out


def write_chrome(path, recs: list | None = None) -> None:
    """The records (default: records()) as a Chrome/Perfetto trace (JSON,
    open it in ui.perfetto.dev or chrome://tracing): host spans on one
    track, each card's device phases on another, times in microseconds
    from the first record."""
    recs = records() if recs is None else recs
    base = min((r.t0 for r in recs), default=0)
    tids = {"host": 0}
    events = []
    for r in recs:
        tid = tids.setdefault(r.track if r.track == "host" else f"device {label(r.program)}", len(tids))
        args = dict(r.args, self_us=r.self_ns / 1e3)
        for k in ("program", "launch", "iteration", "count"):
            if getattr(r, k) is not None:
                args[k] = getattr(r, k)
        events.append({"name": r.name, "cat": r.kind or r.track, "ph": "X", "pid": 0, "tid": tid,
                       "ts": (r.t0 - base) / 1e3, "dur": r.ns / 1e3, "args": args})
    events += [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid, "args": {"name": name}}
               for name, tid in tids.items()]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ns"}, f)


# ============================================================================
# The switch
# ============================================================================


def reset() -> None:
    """Forget every span and row recorded so far (every live log emptied),
    the drops, the calibrations and the card fitted. A program keeps its
    own build spans."""
    global _DROPPED, _CARD
    for log in list(_LOGS):
        log.clear()
    _SPANS.clear()
    _ROWS.clear()
    _CALIB.clear()
    _CARD = None
    _DROPPED = 0


@contextlib.contextmanager
def recording(device=None, capacity: int = CAPACITY):
    """Tracing on while open: call and build spans are recorded, and
    programs built now are traced (each with a log of `capacity` rows).
    With a card `device`, its clock is calibrated at the start and, after
    the rows are drained, at the end; rows of any other card cannot be
    read."""
    global _ON, _CAPACITY
    prev = (_ON, _CAPACITY)
    _ON, _CAPACITY = True, capacity
    card = device is not None and torch.device(device).type == "cuda"
    if card:
        calibrate(device)
    try:
        yield
    finally:
        _ON, _CAPACITY = prev
        if card:
            drain()
            calibrate(device)
