"""The control of each cell's comparison, at the cell's own horizon and
weights with a batch small enough for the CPU: the plain reference in
float32 (the precision below the float64 recursions the configuration
states) put in the program's place must come out not correct, where the
program's own answers come out correct.

    python -m pytest hopbench/tests/test_hopbench_control.py -q

On the chip, at the cells' own sizes and over a dozen seeds, the same
readings come from `python3 -m hopbench.control` (PERF.md gives them).
"""

import dataclasses

import pytest
import torch

from hopbench import harness, problems
from hopbench.reference.check import Deployment, control
from hopbench.run import options, run_cell

MAN = harness.manifest()
CELLS = [w["name"] for w in MAN["workloads"]]
SOLVED: dict = {}


def run(cell: str, in_place_of_program: bool) -> dict:
    from timeopt_tpu_torch.parallel import solve_batch_resident

    w = harness.cell(cell, MAN)
    cfg = harness.config(w["config"])
    mix = dict(harness.traffic(w["traffic"]), batch=32, in_flight=1, pool=1, judge_rows=32)
    system, opts = problems.program_system(cfg), options(cfg, mix)
    d32 = Deployment(cfg, torch.float32, "cpu")

    def solve_part(p):
        key = (cell, p.x0.numpy().tobytes())
        if key not in SOLVED:
            SOLVED[key] = solve_batch_resident(system, [p], options=opts)[0]
        res = dataclasses.replace(SOLVED[key])
        if in_place_of_program:
            res.T_star, res.J_star, res.U = control(d32, p.x0, res.U)
        return res

    return run_cell(cfg, mix, harness.limits(cell), [], harness.metrics_of(cell, MAN, "end_to_end"),
                    2**31 + 4242, 1e9, False, [torch.device("cpu")] * int(w["chips"]),
                    solve=lambda parts: [solve_part(p) for p in parts], max_batches=1)


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_where_the_program_is(cell):
    sound = run(cell, in_place_of_program=False)
    assert sound["correct"] is True, sound["checks"]
    ctrl = run(cell, in_place_of_program=True)
    assert ctrl["correct"] is False, ctrl["checks"]
    assert ctrl["checks"]["cost_gap"]["value"] > ctrl["checks"]["cost_gap"]["limit"]
