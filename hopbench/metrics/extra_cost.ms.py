"""extra_cost.ms: solver/cost.py::extra_cost_terms (the extra stage cost's
value, vmap(grad) and vmap(hessian) over the B x N steps) alone on the
cell's first iterate, captured into a CUDA graph as the program's step
captures it: milliseconds a replay, back to back between CUDA events; none
for a system without an extra stage cost."""


def read(ctx):
    if ctx.system.extra_cost is None:
        return None
    from timeopt_tpu_torch.solver.cost import extra_cost_terms

    prob, X, U, _, _ = ctx.first_iterate()
    return ctx.graph_ms(lambda: extra_cost_terms(ctx.system, X[:, :-1], U))
