"""wide.linearize_roofline: linearize_roofline (csrc/linearize.cu on the
cell's first iterate, captured as the program's step captures it, here on
the 6-DoF lander's struct, whose xdot operations the plain reference
declares for hopbench/work.py) where the traced program launched the
select at its wide size tier (hopbench/tiers.py), else None."""

from hopbench import harness, tiers


def read(ctx):
    return harness.reader("linearize_roofline")(ctx) if tiers.wide(ctx, "select") else None
