"""step.select_kernel_ms: the select kernel in situ: csrc/lft_select.cu (#1) or
csrc/lft_select_generic.cu (#7) and its wrapper: the median over the traced
window's steps of the `select.kernel` phase's device time in a step (ms),
from the program's own stamps inside the captured step graph
(hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("select.kernel")
