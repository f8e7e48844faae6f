"""wide.select_kernel_ms: step.select_kernel_ms (the fused select #1 in
situ: the median over the traced window's steps of the `select.kernel`
phase's device time in a step, ms) where the traced program launched the
select at its wide size tier (csrc/lft_select.cu, n <= 14;
hopbench/tiers.py), else None."""

from hopbench import harness, tiers


def read(ctx):
    return harness.reader("step.select_kernel_ms")(ctx) if tiers.wide(ctx, "select") else None
