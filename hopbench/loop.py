"""The traffic: a closed loop with k batches in flight.

Like k clients that each wait for their answer before they send the next
batch: a batch is enqueued (the program's solve, which returns before the
device has finished), its answers (T*, J*, U) are copied to pinned host
memory on the same stream and an event is recorded after the copy; when the
oldest batch in flight has completed, the loop enqueues the next batch of
the pool, in turn. Batches are enqueued while the window's seconds last;
the window runs from the first enqueue to the completion of the last batch
enqueued, and every batch enqueued in it counts.

A batch may be split over several cards: the solve takes its parts, one a
card, and returns one result a card; each card's answers are copied into
their own rows of the slot, on that card's stream, with an event on every
card after them, and the batch is complete when every card's event is.

Host times (perf_counter) per batch: `enqueue` before the solve's call,
`returned` after it, `done` when the host has seen the batch's copy
complete. With `timing`, CUDA events before the call and after the copy
give each batch's start and end on each card, relative to an event
recorded on that card before the first enqueue.

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
    start_ms: float | None = None  # device, from the window's base event: the first card's
    end_ms: float | None = None
    card_ms: list | None = None  # (start_ms, end_ms) on each card, from that card's base event


@dataclass
class Window:
    batches: list = field(default_factory=list)
    start: float = 0.0  # host time of the first enqueue
    end: float = 0.0  # host time the last batch was seen complete

    @property
    def seconds(self) -> float:
        return self.end - self.start


def record(device: torch.device, timing: bool = False) -> torch.cuda.Event:
    """An event recorded on `device`'s current stream."""
    ev = torch.cuda.Event(enable_timing=timing)
    ev.record(torch.cuda.current_stream(device))
    return ev


class Slot:
    """Host buffers for one batch in flight: T* (B,), J* (B,), U (B, N, m),
    the answers of the cards in `devices`, each card's in its rows, in
    order."""

    def __init__(self, batch: int, N: int, m: int, dtype, devices: list):
        pin = devices[0].type == "cuda"
        self.T = torch.empty(batch, dtype=torch.int64, pin_memory=pin)
        self.J = torch.empty(batch, dtype=dtype, pin_memory=pin)
        self.U = torch.empty((batch, N, m), dtype=dtype, pin_memory=pin)
        self.cuda = pin
        self.devices = devices
        self.events = [torch.cuda.Event() for _ in devices] if pin else []
        self.batch: Batch | None = None
        self.start_evs = self.end_evs = None

    def fill(self, results: list, timing: bool) -> None:
        """Enqueue the copies of each card's answers (`results`, one a card,
        in order) into its rows, on its card's stream, and an event on
        every card after them."""
        r0 = 0
        for res in results:
            r1 = r0 + res.T_star.shape[0]
            self.T[r0:r1].copy_(res.T_star, non_blocking=self.cuda)
            self.J[r0:r1].copy_(res.J_star, non_blocking=self.cuda)
            self.U[r0:r1].copy_(res.U, non_blocking=self.cuda)
            r0 = r1
        if r0 != self.T.shape[0]:
            raise ValueError(f"hopbench: the results fill {r0} of the slot's {self.T.shape[0]} rows")
        if self.cuda:
            if timing:
                self.end_evs = [record(d, timing=True) for d in self.devices]
            for ev, d in zip(self.events, self.devices):
                ev.record(torch.cuda.current_stream(d))

    def wait(self) -> None:
        for ev in self.events:
            ev.synchronize()


def run(solve, pool: list, slots: list, seconds: float, on_done, timing: bool = False,
        max_batches: int | None = None) -> Window:
    """The closed loop over `pool` (each batch as its parts, one a card)
    with len(slots) batches in flight for `seconds` (or until
    `max_batches` are enqueued): solve(parts) enqueues one batch and
    returns its SolveResults, one a card;
    on_done(batch, slot) reads each batch's answers from its slot once they
    are complete, before the slot is used again. Returns the window's
    batches and times."""
    win = Window()
    free = deque(slots)
    busy: deque = deque()
    bases = None
    if timing and slots[0].cuda:
        bases = [record(d, timing=True) for d in slots[0].devices]
    i = 0
    win.start = time.perf_counter()
    while True:
        while free and time.perf_counter() - win.start < seconds and (max_batches is None or i < max_batches):
            slot = free.popleft()
            t = time.perf_counter()
            b = Batch(index=i, pool_index=i % len(pool), enqueue=t)
            if bases is not None:
                slot.start_evs = [record(d, timing=True) for d in slot.devices]
            res = solve(pool[b.pool_index])
            b.returned = time.perf_counter()
            slot.fill(res, bases is not None)
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
        if bases is not None:
            b.card_ms = [(base.elapsed_time(s), base.elapsed_time(e))
                         for base, s, e in zip(bases, slot.start_evs, slot.end_evs)]
            b.start_ms, b.end_ms = b.card_ms[0]
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
