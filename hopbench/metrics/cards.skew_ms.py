"""cards.skew_ms: how long a batch waits for its slowest card: the median,
over the window's batches, of the slowest card's time from its start event
to its end event minus the fastest card's (ms). Each card's time compares
two events of that card only (hopbench/loop.py: each batch's `card_ms`).
None with fewer than two cards."""

import statistics


def read(ctx):
    skews = [max(e - s for s, e in b.card_ms) - min(e - s for s, e in b.card_ms)
             for b in ctx.window.batches if b.card_ms and len(b.card_ms) > 1]
    return statistics.median(skews) if skews else None
