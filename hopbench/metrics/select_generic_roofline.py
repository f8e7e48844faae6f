"""select_generic_roofline: csrc/lft_select_generic.cu (#7, the select of
an extra stage cost) alone on the cell's first iterate: the frozen work's
least time (hopbench/work.py: select_generic over B, T_max steps) over the
kernel's time back to back, in %. None off the generic select's path."""


def read(ctx):
    if ctx.opts.method != "propagator":
        return None
    generic, args, _, _ = ctx.select()
    if not generic:
        return None
    from timeopt_tpu_torch.ops import cuda_lft_generic

    prob = ctx.pool[0]
    ms = ctx.device_ms(lambda: cuda_lft_generic.propagator_select_generic(*args, t_min=prob.T_min))
    bound = ctx.work.select_generic(prob.batch, prob.T_max, prob.n, prob.m, prob.T_min, itemsize=ctx.itemsize)
    return 100.0 * bound["bound_ms"] / ms
