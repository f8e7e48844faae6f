"""hopbench/work.py, the frozen work counts, gives the program's own
formulas' counts (timeopt_tpu_torch/ops/work.py) at the shapes the
program's smoke test times its kernels at (the quadrotor at B=1024, N=160;
PointMass at B=1024 over its T_max = 220 steps), float64 and float32.

    python -m pytest hopbench/tests/test_hopbench_work.py -q
"""

import numpy as np
import pytest

from hopbench import work as frozen

RNG = np.random.default_rng(0)
T_QUAD = RNG.integers(40, 161, 1024).tolist()
T_PM = RNG.integers(30, 221, 1024).tolist()


def program():
    from timeopt_tpu_torch.ops import work

    return work


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("kernel,args,kw", [
    ("select_fused", (1024, 160, 12, 4, 40), {}),
    ("select_generic", (1024, 220, 4, 2, 30), {}),
    ("backward", (T_QUAD, 160, 12, 4), {}),
    ("backward", (T_PM, 240, 4, 2), {}),
    ("linesearch", ("Quadrotor", T_QUAD, 160, 12, 4, 5), {}),
    ("linesearch", ("PointMass_Navigation", T_PM, 240, 4, 2, 5), {}),
    ("linesearch", ("Quadrotor", T_QUAD * 3, 160, 12, 4, 4), {"x_start": True}),
    ("linearize", ("Quadrotor", 1024, 160, 12, 4), {}),
    ("linearize", ("PointMass_Navigation", 1024, 240, 4, 2), {}),
], ids=["select_fused", "select_generic", "backward_q", "backward_pm", "linesearch_q", "linesearch_pm",
        "linesearch_from", "linearize_q", "linearize_pm"])
def test_frozen_counts_equal_the_programs(kernel, args, kw, itemsize):
    assert getattr(frozen, kernel)(*args, **kw, itemsize=itemsize) == getattr(program(), kernel)(
        *args, **kw, itemsize=itemsize)


# the line search's bounds of the two systems as the benchmark was defined
# with them (hopbench/work.py before a system could come from a plain file):
# (flops, bytes at itemsize 8, bytes at itemsize 4, bound_ms at 8, bound_ms at 4)
DEFINED = {
    "linesearch_q": (392695910.0, 197267496.0, 98644008.0, 0.05888581970149254, 0.02944597253731343),
    "linesearch_pm": (101769920.0, 91041832.0, 45527080.0, 0.027176666268656717, 0.013590173134328358),
    "linesearch_from": (942470184.0, 528863264.0, 264462368.0, 0.15786963104477614, 0.0789439904477612),
}


@pytest.mark.parametrize("itemsize", [8, 4])
@pytest.mark.parametrize("case,args,kw", [
    ("linesearch_q", ("Quadrotor", T_QUAD, 160, 12, 4, 5), {}),
    ("linesearch_pm", ("PointMass_Navigation", T_PM, 240, 4, 2, 5), {}),
    ("linesearch_from", ("Quadrotor", T_QUAD * 3, 160, 12, 4, 4), {"x_start": True}),
], ids=lambda v: v if isinstance(v, str) else None)
def test_the_two_systems_bounds_are_as_defined_to_the_last_bit(case, args, kw, itemsize):
    got = frozen.linesearch(*args, **kw, itemsize=itemsize)
    flops, b8, b4, ms8, ms4 = DEFINED[case]
    want = (flops, b8, ms8) if itemsize == 8 else (flops, b4, ms4)
    assert (got["flops"], got["bytes"], got["bound_ms"]) == want
    assert got["bound_by"] == "bytes"


def test_peaks():
    assert (frozen.PEAK_FLOPS, frozen.PEAK_BYTES) == (67e12, 3.35e12)
    assert (frozen.PEAK_FLOPS, frozen.PEAK_BYTES) == (program().PEAK_FLOPS, program().PEAK_BYTES)
