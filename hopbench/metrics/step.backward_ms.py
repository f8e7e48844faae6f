"""step.backward_ms: the backward pass: its inputs and csrc/backward.cu (#3)
with its wrapper: the median over the traced window's steps of the
`backward` phase's device time in a step (ms), from the program's own stamps
inside the captured step graph (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("backward")
