"""setup.warmup_s: the eager warm-up of the program the cell built in its
set-up: its build spans `build.warmup.init` + `build.warmup.step`
(solver/compiled.py, measured at every build and kept by the program;
the kernel library loads nest in them), in seconds (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    if s is None or "build.warmup.init" not in s.build:
        return None
    return s.build["build.warmup.init"] + s.build.get("build.warmup.step", 0.0)
