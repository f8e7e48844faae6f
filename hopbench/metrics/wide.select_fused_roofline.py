"""wide.select_fused_roofline: select_fused_roofline (csrc/lft_select.cu
alone on the cell's first iterate: hopbench/work.py's select_fused bound,
here at the cell's n = 14, over the kernel's time back to back, in %)
where the traced program launched the select at its wide size tier
(hopbench/tiers.py), else None."""

from hopbench import harness, tiers


def read(ctx):
    return harness.reader("select_fused_roofline")(ctx) if tiers.wide(ctx, "select") else None
