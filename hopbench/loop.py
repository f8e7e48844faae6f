"""The traffic: a closed loop with k batches in flight.

Like k clients that each wait for their answer before they send the next
batch: a batch is enqueued (the program's solve, which returns before the
device has finished), its answers (T*, J*, U) are copied to pinned host
memory on the same stream and an event is recorded after the copy; when the
oldest batch in flight has completed, the loop enqueues the next batch of
the pool, in turn. Batches are enqueued while the window's seconds last;
the window runs from the first enqueue to the completion of the last batch
enqueued, and every batch enqueued in it counts.

Host times (perf_counter) per batch: `enqueue` before the solve's call,
`returned` after it, `done` when the host has seen the batch's copy
complete. With `timing`, CUDA events before the call and after the copy
give each batch's start and end on the device, relative to an event
recorded before the first enqueue.

On the CPU (the harness's tests) a call runs to its end before it returns,
the copies are plain and there are no events.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field

import torch


@dataclass
class Batch:
    index: int  # position in the window
    pool_index: int
    enqueue: float
    returned: float = 0.0
    done: float = 0.0
    start_ms: float | None = None  # device, from the window's base event
    end_ms: float | None = None


@dataclass
class Window:
    batches: list = field(default_factory=list)
    start: float = 0.0  # host time of the first enqueue
    end: float = 0.0  # host time the last batch was seen complete

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Slot:
    """Host buffers for one batch in flight: T* (B,), J* (B,), U (B, N, m)."""

    def __init__(self, batch: int, N: int, m: int, dtype, device: torch.device):
        pin = device.type == "cuda"
        self.T = torch.empty(batch, dtype=torch.int64, pin_memory=pin)
        self.J = torch.empty(batch, dtype=dtype, pin_memory=pin)
        self.U = torch.empty((batch, N, m), dtype=dtype, pin_memory=pin)
        self.cuda = pin
        self.event = torch.cuda.Event() if pin else None
        self.batch: Batch | None = None
        self.start_ev = self.end_ev = None

    def fill(self, res, timing: bool) -> None:
        """Enqueue the copies of res's answers and the event after them."""
        self.T.copy_(res.T_star, non_blocking=self.cuda)
        self.J.copy_(res.J_star, non_blocking=self.cuda)
        self.U.copy_(res.U, non_blocking=self.cuda)
        if self.cuda:
            if timing:
                self.end_ev = torch.cuda.Event(enable_timing=True)
                self.end_ev.record()
            self.event.record()

    def wait(self) -> None:
        if self.cuda:
            self.event.synchronize()


def run(solve, pool: list, slots: list, seconds: float, on_done, timing: bool = False,
        max_batches: int | None = None) -> Window:
    """The closed loop over `pool` (Problems) with len(slots) batches in
    flight for `seconds` (or until `max_batches` are enqueued):
    solve(problem) enqueues one batch and returns its SolveResult;
    on_done(batch, slot) reads each batch's answers from its slot once they
    are complete, before the slot is used again. Returns the window's
    batches and times."""
    win = Window()
    free = deque(slots)
    busy: deque = deque()
    base = None
    if timing and slots[0].cuda:
        base = torch.cuda.Event(enable_timing=True)
        base.record()
    i = 0
    win.start = time.perf_counter()
    while True:
        while free and time.perf_counter() - win.start < seconds and (max_batches is None or i < max_batches):
            slot = free.popleft()
            t = time.perf_counter()
            b = Batch(index=i, pool_index=i % len(pool), enqueue=t)
            if base is not None:
                slot.start_ev = torch.cuda.Event(enable_timing=True)
                slot.start_ev.record()
            res = solve(pool[b.pool_index])
            b.returned = time.perf_counter()
            slot.fill(res, timing and base is not None)
            slot.batch = b
            busy.append(slot)
            win.batches.append(b)
            i += 1
        if not busy:
            break
        slot = busy.popleft()
        slot.wait()
        b = slot.batch
        b.done = time.perf_counter()
        if base is not None:
            b.start_ms = base.elapsed_time(slot.start_ev)
            b.end_ms = base.elapsed_time(slot.end_ev)
        on_done(b, slot)
        free.append(slot)
        win.end = b.done
    return win


def p90(values) -> float:
    """The 90th percentile (linear interpolation between order statistics,
    numpy's default) of every value."""
    xs = sorted(values)
    if not xs:
        raise ValueError("p90 of no values")
    pos = 0.9 * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def end_to_end(win: Window, batch: int) -> dict:
    """solves/s over the whole window and the p90 of every batch's time
    from its enqueue to its completion."""
    return dict(solves_per_s=len(win.batches) * batch / win.seconds,
                batch_p90_s=p90([b.done - b.enqueue for b in win.batches]))
