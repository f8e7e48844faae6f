"""loop.iter_ms: device milliseconds per outer step: the device time of
every batch of the window (CUDA events before its solve call and after its
answers' copy) over all the steps they ran (the device loop counters)."""


def read(ctx):
    spans = [b.end_ms - b.start_ms for b in ctx.window.batches if b.start_ms is not None]
    steps = ctx.counters.get("steps", 0)
    return sum(spans) / steps if spans and steps else None
