"""wide.linesearch_roofline: linesearch_roofline (csrc/linesearch.cu alone
on the cell's first iterate, here on the 6-DoF lander's struct, system id
6, whose xdot and guard operations the plain reference declares for
hopbench/work.py) where the traced program launched the select at its
wide size tier (hopbench/tiers.py), else None."""

from hopbench import harness, tiers


def read(ctx):
    return harness.reader("linesearch_roofline")(ctx) if tiers.wide(ctx, "select") else None
