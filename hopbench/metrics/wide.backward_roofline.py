"""wide.backward_roofline: csrc/backward.cu (#3) at its wide size tier
alone on the cell's first iterate, at the select's T* there: the frozen
work's least time (hopbench/work.py: backward, the active steps t < T* of
each problem) over the kernel's time back to back, in %. None off the
propagator's path or unless the traced program launched the backward pass
at the wide tier (hopbench/tiers.py)."""

import torch

from hopbench import tiers


def read(ctx):
    if ctx.opts.method != "propagator" or not tiers.wide(ctx, "backward"):
        return None
    from timeopt_tpu_torch.ops import cuda_backward
    from timeopt_tpu_torch.solver.backward import backward_inputs

    prob, X, U, A, B = ctx.first_iterate()
    T = ctx.select()[3]
    lm = torch.full((prob.batch,), ctx.opts.lm_init, dtype=X.dtype, device=X.device)
    args = (A.contiguous(), B.contiguous(), *backward_inputs(ctx.system, prob, X, U), T.to(torch.int64).contiguous(),
            lm)
    ms = ctx.device_ms(lambda: cuda_backward.backward_truncated_core(*args))
    bound = ctx.work.backward(T.tolist(), prob.N, prob.n, prob.m, itemsize=ctx.itemsize)
    return 100.0 * bound["bound_ms"] / ms
