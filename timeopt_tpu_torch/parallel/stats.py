"""Batch statistics reduced across processes; port of
timeopt_tpu/parallel/stats.py.

Each process reduces its own slice of the batch on its device; under an
initialized process group (parallel/distributed.py) an all-reduce (SUM)
over the group gives every process the global numbers, so only O(T_max)
integers cross between processes.
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.parallel.distributed import all_reduce_sum


def t_star_histogram(T_stars: torch.Tensor, T_max: int, group=None) -> torch.Tensor:
    """(T_max + 1,) int64 counts of the selected horizons T* (all <= T_max),
    summed over the process group when one is initialized."""
    return all_reduce_sum(torch.bincount(T_stars.to(torch.int64), minlength=T_max + 1), group)


def batch_summary(J_stars: torch.Tensor, final_errs: torch.Tensor, success_tol: float = 0.5, group=None) -> dict:
    """The success criterion of the reference runner (finite J* and a finite
    final error <= success_tol): n, n_success (int64) and success_rate =
    n_success / max(n, 1) (float64), summed over the process group when one
    is initialized."""
    success = torch.isfinite(J_stars) & torch.isfinite(final_errs) & (final_errs <= success_tol)
    nk = torch.stack([torch.tensor(success.shape[0], device=success.device), success.sum()]).to(torch.int64)
    n, k = all_reduce_sum(nk, group)
    return {"n": n, "n_success": k, "success_rate": k.to(torch.float64) / torch.clamp(n, min=1)}
