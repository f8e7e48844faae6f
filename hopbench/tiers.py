"""Which size tier of the program's kernels a cell's traced program bound,
for the `wide.*` metrics: the counts its traced build made
(timeopt_tpu_torch/utils/trace.py::count, one `select.tier<n>` or
`backward.tier<n>` for each select or backward launch its warm-up and
captures placed, named by the tier's n bound). The wide tier is n <= 14
(csrc/lft_select.cu's wide instantiation, csrc/backward.cu's (14, 3)).
Off the card, and for a program without those counts (one older than
them), no tier reads as bound, and the `wide.*` readers return None.
"""

from __future__ import annotations

from hopbench import spans

WIDE = 14


def counts(ctx) -> dict:
    """The counts of the builds of the traced programs of the cell's traced
    window (hopbench/spans.py), summed; {} where there are none."""
    if spans.window(ctx) is None:
        return {}
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.utils import trace

    read = getattr(trace, "counts", None)
    if read is None:
        return {}
    out: dict = {}
    for p in compiled.programs():
        if getattr(p, "traced", False) and "build" in p.spans:
            for k, v in read(p.spans["build"]).items():
                out[k] = out.get(k, 0) + v
    return out


def wide(ctx, kernel: str) -> bool:
    """Whether the traced program launched `kernel` ("select" or "backward")
    at the wide tier."""
    return ctx.cached(f"tiers.{kernel}", lambda: counts(ctx).get(f"{kernel}.tier{WIDE}", 0) > 0)
