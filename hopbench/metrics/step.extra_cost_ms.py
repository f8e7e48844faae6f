"""step.extra_cost_ms: the extra stage cost's terms
(solver/cost.py::extra_cost_terms), both of a step's evaluations summed (the
select's inputs and the backward pass's); none for a system without one: the
median over the traced window's steps of the `extra_cost` phase's device
time in a step (ms), from the program's own stamps inside the captured step
graph (hopbench/spans.py)."""

from hopbench import spans


def read(ctx):
    s = spans.window(ctx)
    return None if s is None else s.phase_ms.get("extra_cost")
