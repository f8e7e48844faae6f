"""select_fused_roofline: csrc/lft_select.cu (#1, the fused select of a
stationary stage cost) alone on the cell's first iterate: the frozen work's
least time (hopbench/work.py: select_fused over B, T_max steps) over the
kernel's time back to back, in %. None off the propagator's fused path."""


def read(ctx):
    if ctx.opts.method != "propagator":
        return None
    generic, args, _, _ = ctx.select()
    if generic:
        return None
    from timeopt_tpu_torch.ops import cuda_lft

    prob = ctx.pool[0]
    ms = ctx.device_ms(lambda: cuda_lft.propagator_select_fused(*args, t_min=prob.T_min))
    bound = ctx.work.select_fused(prob.batch, prob.T_max, prob.n, prob.m, prob.T_min, itemsize=ctx.itemsize)
    return 100.0 * bound["bound_ms"] / ms
