"""wide.backward_kernel_ms: the backward pass #3 in situ at its wide size
tier (csrc/backward.cu, (n, m) = (14, 3)): the median over the traced
window's steps of the `backward.kernel` phase's device time in a step
(ms), from the program's own stamps inside the captured step graph
(hopbench/spans.py). None unless the traced program launched the backward
pass at the wide tier (hopbench/tiers.py)."""

from hopbench import spans, tiers


def read(ctx):
    return spans.window(ctx).phase_ms.get("backward.kernel") if tiers.wide(ctx, "backward") else None
