"""linearize_roofline: csrc/linearize.cu (the registry systems' Jacobian
kernel) on the cell's first iterate (the pool's first batch, B x N steps),
captured into a CUDA graph as the program's step captures it: the frozen
work's least time (hopbench/work.py: linearize) over a replay's time back
to back, in %. None where the kernel is off the path: a step without a
`device_id` (a user's own System) or another linearize mode than "ad"."""


def read(ctx):
    if ctx.opts.linearize_mode != "ad" or getattr(ctx.system.step, "device_id", None) is None:
        return None
    from timeopt_tpu_torch.solver.linearize import linearize

    prob, X, U, _, _ = ctx.first_iterate()
    ms = ctx.graph_ms(lambda: linearize(ctx.system.step, X, U, ctx.opts.linearize_mode))
    bound = ctx.work.linearize(ctx.system.name, prob.batch, prob.N, prob.n, prob.m, itemsize=ctx.itemsize)
    return 100.0 * bound["bound_ms"] / ms
