"""setup.capture_s: the captures of the program the cell built in its
set-up and the loop graph around them: its build spans
`build.capture.init` + `build.capture.step` + `build.loop_graph`
(solver/compiled.py, measured at every build and kept by the program),
in seconds (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    if s is None or "build.capture.init" not in s.build:
        return None
    return sum(s.build.get(n, 0.0) for n in ("build.capture.init", "build.capture.step", "build.loop_graph"))
