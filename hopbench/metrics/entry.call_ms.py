"""entry.call_ms: the median host span `entry.call` of the traced window's
kept calls (parallel/mesh.py::solve_batch_resident down to the loop graph's
launch and the result's clones): the program's own view of
entry.enqueue_ms (hopbench/spans.py)."""

import statistics

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return statistics.median(s.call_ms) if s is not None and s.call_ms else None
