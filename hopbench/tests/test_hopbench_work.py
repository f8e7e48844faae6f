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
], ids=["select_fused", "select_generic", "backward_q", "backward_pm", "linesearch_q", "linesearch_pm",
        "linesearch_from"])
def test_frozen_counts_equal_the_programs(kernel, args, kw, itemsize):
    assert getattr(frozen, kernel)(*args, **kw, itemsize=itemsize) == getattr(program(), kernel)(
        *args, **kw, itemsize=itemsize)


def test_peaks():
    assert (frozen.PEAK_FLOPS, frozen.PEAK_BYTES) == (67e12, 3.35e12)
    assert (frozen.PEAK_FLOPS, frozen.PEAK_BYTES) == (program().PEAK_FLOPS, program().PEAK_BYTES)
