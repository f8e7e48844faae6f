"""Faults planted under the timed path, to read what the numbers that decide
`correct` make of a solve that goes wrong in a way that still gives
consistent answers (hopbench/control.py on the chip, the harness's tests on
the CPU):

- `stale_step`: every outer step after the warm start leaves the solver's
  state as it was (the warm start, iteration 0, still runs);
- `bf16_backward`: the backward pass's gains K and kappa rounded to
  bfloat16;
- `bf16_select`: the select's curve J(T) rounded to bfloat16 before its
  argmin;
- `half_iter`: half the configuration's outer iterations (max_iter).

`planted(name, opts)` patches the program's solver for as long as it is
open and yields the options to solve with. A program is built with what
was patched at its first call, so the program's built programs are cleared
on entry and on exit.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

FAULTS = ("stale_step", "bf16_backward", "bf16_select", "half_iter")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


@contextlib.contextmanager
def planted(name: str, opts):
    from timeopt_tpu_torch.solver import compiled, ilqr

    if name not in FAULTS:
        raise KeyError(f"hopbench: no fault {name!r} (have {FAULTS})")
    saved = (compiled.curve_step, ilqr.backward_truncated, ilqr._select_curve)
    step, backward, select = saved
    compiled.clear_compiled()
    if name == "stale_step":
        def stale(system, o, prob, st, warm=False):
            if warm:
                return step(system, o, prob, st, warm=True)
            st["X"].copy_(st["X"])  # one kernel on the state, which stays as it was

        compiled.curve_step = stale
    elif name == "bf16_backward":
        ilqr.backward_truncated = lambda *a, **k: (lambda r: r._replace(K=_bf16(r.K), kappa=_bf16(r.kappa)))(
            backward(*a, **k))
    elif name == "bf16_select":
        ilqr._select_curve = lambda *a, **k: _bf16(select(*a, **k))
    try:
        yield dataclasses.replace(opts, max_iter=opts.max_iter // 2) if name == "half_iter" else opts
    finally:
        compiled.curve_step, ilqr.backward_truncated, ilqr._select_curve = saved
        compiled.clear_compiled()
