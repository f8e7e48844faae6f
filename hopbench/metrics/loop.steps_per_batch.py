"""loop.steps_per_batch: the outer steps a batch's loop graph ran, all
steps over all loop runs of the window, from the program's device counters
(ops/cuda_loop.py: runs, steps) read after it."""


def read(ctx):
    runs, steps = ctx.counters.get("runs", 0), ctx.counters.get("steps", 0)
    return steps / runs if runs else None
