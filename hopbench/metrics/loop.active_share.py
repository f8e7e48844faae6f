"""loop.active_share: the share (%) of the traced window's problem-steps
spent on problems not yet done at the step's start: the stamps' pending
counter at each step's start (problems whose `done` flag is unset) summed
over the steps, over B x steps (hopbench/spans.py). 100% means no step
computes a converged problem."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.active_share
