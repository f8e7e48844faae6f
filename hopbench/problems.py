"""The problems of a cell: a pool of distinct batches made from the seed.

Every batch of a deployment shares the configuration's weights and differs
in its start states: x0 = the configuration's x0 + sigma_x0 * N(0, 1), drawn
for the whole pool in one call of a generator on the device seeded with the
run's seed (the perturbation of the reference code's trials, run_suite.py
CASES). The draws are float64, stored in the configuration's dtype; the
reference reads the same stored x0. Each batch is a Problem of the program
under test (timeopt_tpu_torch), on the device.
"""

from __future__ import annotations

import numpy as np
import torch

SEED_MOD = 2**63  # a generator's seed is below 2**64; any whole number maps into it


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % SEED_MOD)
    return g


def start_states(cfg: dict, batches: int, batch: int, seed: int, device) -> torch.Tensor:
    """x0 (batches, batch, n) in the configuration's dtype, on `device`."""
    f64 = dict(dtype=torch.float64, device=device)
    x0 = torch.tensor(cfg["x0"], **f64)
    sigma = torch.tensor(cfg["sigma_x0"], **f64)
    noise = torch.randn((batches, batch, x0.shape[0]), generator=generator(seed, device), **f64)
    return (x0 + sigma * noise).to(getattr(torch, cfg["dtype"]))


def program_system(cfg: dict):
    """The program's System for the configuration, its sizes held to the
    configuration's."""
    from timeopt_tpu_torch.models import get_system

    system, _ = get_system(cfg["program_system"])
    got = (system.n, system.m, system.dt)
    want = (len(cfg["x0"]), len(cfg["u_ref"]), cfg["dt"])
    if got != want:
        raise ValueError(f"hopbench: the program's {cfg['program_system']} has (n, m, dt) {got}, the "
                         f"configuration {want}")
    return system


def pool(cfg: dict, batches: int, batch: int, seed: int, device) -> list:
    """`batches` Problems of `batch` problems each, on `device`."""
    from timeopt_tpu_torch.models.base import Problem

    dtype = getattr(torch, cfg["dtype"])
    n = len(cfg["x0"])
    z = dict(dtype=dtype, device=device)
    qf = np.asarray(cfg["Qf"], np.float64)
    Qf = qf * np.eye(n) if qf.ndim == 0 else np.diag(qf)
    wrap = np.zeros(n, bool)
    wrap[list(cfg["wrap_idx"])] = True

    def rows(a, **kw):
        t = torch.as_tensor(np.asarray(a), **(kw or z))
        return t.expand((batch,) + t.shape).contiguous()

    shared = dict(xg=rows(cfg["xg"]), u_ref=rows(cfg["u_ref"]), Q=rows(np.diag(cfg["Q_diag"])),
                  R=rows(np.diag(cfg["R_diag"])), Qf=rows(Qf), w=rows(cfg["w"]),
                  wrap_mask=rows(wrap, dtype=torch.bool, device=device))
    x0 = start_states(cfg, batches, batch, seed, device)
    return [Problem(x0=x0[i].contiguous(), **shared, N=int(cfg["N"]), T_min=int(cfg["T_min"]),
                    T_max=int(cfg["T_max"])) for i in range(batches)]
