"""entry.between_ms: the median device time from one launch's last stamp
to the next launch's first, over the traced window's kept launches: the
loop condition's last run, the result clones, the answers' copies, the next
inputs' loads and any idle (hopbench/spans.py)."""

import statistics

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return statistics.median(s.between_ms) if s is not None and s.between_ms else None
