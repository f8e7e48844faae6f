"""entry.enqueue_ms: the host's milliseconds for one solve call to return
(parallel/mesh.py::solve_batch_resident down to the loop graph's launch,
solver/compiled.py), the median over every batch of the window."""

import statistics


def read(ctx):
    times = [b.returned - b.enqueue for b in ctx.window.batches]
    return 1e3 * statistics.median(times) if times else None
