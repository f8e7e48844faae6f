"""step.commit_ms: the Levenberg-Marquardt accept/reject, the history, the
convergence test and the commit into the state: the median over the traced
window's steps of the `commit` phase's device time in a step (ms), from the
program's own stamps inside the captured step graph (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("commit")
