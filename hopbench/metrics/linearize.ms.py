"""linearize.ms: solver/linearize.py::linearize alone on the cell's first
iterate (the pool's first batch, B x N steps), captured into a CUDA graph
as the program's step captures it: milliseconds a replay, back to back
between CUDA events."""


def read(ctx):
    from timeopt_tpu_torch.solver.linearize import linearize

    prob, X, U, _, _ = ctx.first_iterate()
    return ctx.graph_ms(lambda: linearize(ctx.system.step, X, U, ctx.opts.linearize_mode))
