"""linesearch_roofline: csrc/linesearch.cu (#5, its rollout entry: every
alpha's closed-loop rollout and truncated cost) alone on the cell's first
iterate, with the backward pass's gains at the select's T*: the frozen
work's least time (hopbench/work.py: linesearch) over the kernel's time
back to back, in %. None off the propagator's path."""


def read(ctx):
    if ctx.opts.method != "propagator":
        return None
    from timeopt_tpu_torch.ops import cuda_forward

    prob, X, U, _, _ = ctx.first_iterate()
    K, kappa, T = ctx.gains()
    alphas = ctx.opts.alphas
    ms = ctx.device_ms(lambda: cuda_forward.linesearch(ctx.system, prob, X, U, K, kappa, T, alphas))
    bound = ctx.work.linesearch(ctx.system.name, T.tolist(), prob.N, prob.n, prob.m, len(alphas),
                                itemsize=ctx.itemsize)
    return 100.0 * bound["bound_ms"] / ms
