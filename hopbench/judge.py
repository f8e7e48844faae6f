"""What decides a run's `correct`: the window's own answers against the plain
reference (hopbench/reference/), each number beside its limit.

While the window runs, `Collector.done` reads every batch's answers from
its host buffers as it completes:

- every problem of every batch counts in `attempted`; one whose J* is not
  finite or whose T* lies outside [T_min, T_max] counts in `failed`;
- the first completion of each batch of the pool keeps its T* and J* and,
  for a sample of its rows drawn from the seed (with the row of its
  largest T*, the longest rollout), the rows' U;
- every later completion of the same batch must repeat those answers bit
  for bit (the same problems, the same program): `repeat_mismatch` counts
  the batches that do not.

After the window, with the program's state freed, the reference judges the
sample (reference/check.py: `cost_gap`, `horizon_excess`, `descent_left`,
`descent_left_median`, `nonfinite`), on the device in float64, a block of
problems at a time.

The limits are the cell's, from hopbench/limits/<workload>.json; a number
without a limit there is printed and not compared.
"""

from __future__ import annotations

import numpy as np
import torch

from hopbench.reference.check import Deployment, judge, worst

BLOCK = 128  # problems the reference judges at once


class Collector:
    def __init__(self, cfg: dict, pool_size: int, batch: int, rows: int, seed: int):
        self.T_min, self.T_max = int(cfg["T_min"]), int(cfg["T_max"])
        rng = np.random.default_rng(int(seed) % 2**63)
        self.rows = [np.sort(rng.choice(batch, size=min(rows, batch), replace=False)) for _ in range(pool_size)]
        self.first: dict = {}  # pool index -> (T, J, rows, U rows)
        self.attempted = self.failed = self.repeat_mismatch = 0

    def done(self, b, slot) -> None:
        T, J = slot.T.numpy(), slot.J.numpy()
        self.attempted += T.shape[0]
        self.failed += int((~np.isfinite(J) | (T < self.T_min) | (T > self.T_max)).sum())
        p = b.pool_index
        if p not in self.first:
            rows = np.union1d(self.rows[p], [int(np.argmax(T))])
            self.first[p] = (T.copy(), J.copy(), rows, slot.U.numpy()[rows].copy())
            return
        T0, J0, rows, U0 = self.first[p]
        same = (np.array_equal(T, T0) and J.tobytes() == J0.tobytes()
                and slot.U.numpy()[rows].tobytes() == U0.tobytes())
        self.repeat_mismatch += int(not same)

    def sample(self, x0_pool: list) -> tuple:
        """(x0, T*, J*, U) of the sampled problems, on the host."""
        x0, T, J, U = [], [], [], []
        for p, (T0, J0, rows, U0) in sorted(self.first.items()):
            x0.append(x0_pool[p][rows])
            T.append(T0[rows])
            J.append(J0[rows])
            U.append(U0)
        return tuple(np.concatenate(a) for a in (x0, T, J, U))


def per_problem(dep: Deployment, x0, T, J, U) -> dict:
    """reference/check.py's per-problem numbers of the answers, judged
    BLOCK problems at a time on dep's device."""
    parts = [judge(dep, x0[i:i + BLOCK].to(dep.device), T[i:i + BLOCK], J[i:i + BLOCK].to(dep.device),
                   U[i:i + BLOCK].to(dep.device)) for i in range(0, x0.shape[0], BLOCK)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def numbers(cfg: dict, col: Collector, x0_pool: list, device) -> dict:
    """The numbers that decide `correct`, over the sample."""
    dep = Deployment(cfg, torch.float64, device)
    x0, T, J, U = (torch.as_tensor(a) for a in col.sample(x0_pool))
    return dict(worst(per_problem(dep, x0, T, J, U)), repeat_mismatch=col.repeat_mismatch, failed=col.failed,
                judged=int(x0.shape[0]))


def verdict(nums: dict, lim: dict) -> tuple:
    """(correct, checks): each limited number with its limit, in order;
    correct when every one is at most its limit and the sample is not
    empty."""
    checks = {k: {"value": nums[k], "limit": lim[k]} for k in lim if not k.startswith("_")}
    ok = nums["judged"] > 0 and all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
