"""step.forward_ms: the line search: J_old, csrc/linesearch.cu (#5) with its
wrapper, and the first-improving pick: the median over the traced window's
steps of the `forward` phase's device time in a step (ms), from the
program's own stamps inside the captured step graph (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("forward")
