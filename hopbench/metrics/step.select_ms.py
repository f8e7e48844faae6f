"""step.select_ms: the select: its inputs (fused inputs, or the augmented
blocks and terminal factors), the kernel (#1 or #7) and T*'s argmin: the
median over the traced window's steps of the `select` phase's device time in
a step (ms), from the program's own stamps inside the captured step graph
(hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("select")
