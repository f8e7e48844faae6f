"""The `breakdown` of a traced run's result line: the device's work that
took most time and the longest idle gaps, at most 10 of each, in seconds.

Where the cell's readers ran the traced window of the program's own stamps
(hopbench/spans.py; the one-card cells), `device_ops` gives each phase of
a step and of init as its median a step (a launch) times the steps (loop
runs) of the timed window, and `idle_gaps` the stamps' longest gaps
between launches, each named by the host span open at its middle.
Without it, `device_ops` gives each card's busy time in the window (its
batches, start event to end event) and `idle_gaps` the longest gaps on a
card between one batch's end event and the next one's start event.
"""

from __future__ import annotations

from hopbench import spans

TOP_N = 10


def read(ctx, cards: int) -> dict:
    s = ctx.peek("spans")
    if s is not None:
        steps, runs = ctx.counters.get("steps", 0), ctx.counters.get("runs", 0)
        ops = [(f"step.{n}", s.phase_ms[n] * steps / 1e3) for n in spans.TOP + spans.NESTED if n in s.phase_ms]
        ops += [(n, v * runs / 1e3) for n, v in s.init_ms.items()]
        gaps = [(f"after launch {a} ({what} open)", ms / 1e3) for ms, a, what in s.gaps]
    else:
        bs = [b for b in ctx.window.batches if b.card_ms]
        ops = [(f"card{c}.batches", sum(b.card_ms[c][1] - b.card_ms[c][0] for b in bs) / 1e3) for c in range(cards)]
        gaps = [(f"card{c} before batch {b.index}", (b.card_ms[c][0] - a.card_ms[c][1]) / 1e3)
                for c in range(cards) for a, b in zip(bs, bs[1:]) if b.card_ms[c][0] > a.card_ms[c][1]]
    return {"device_ops": [list(o) for o in sorted(ops, key=lambda o: -o[1])[:TOP_N]],
            "idle_gaps": [list(g) for g in sorted(gaps, key=lambda g: -g[1])[:TOP_N]]}
