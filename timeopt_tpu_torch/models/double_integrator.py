"""1D double integrator (port of timeopt_tpu/models/double_integrator.py).

State x = [pos, vel], control u = [acc]; explicit-Euler discretization.
The same formula runs on the card in csrc/systems.cuh (`DoubleIntegrator`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.stack([x[..., 1], u[..., 0]], dim=-1)


step = euler_step_fn(xdot, DT, 2, device_id=0)

SYSTEM = System(
    name="DoubleIntegrator",
    n=2,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    sigma_x0=(0.2, 0.2),
    sigma_xg=(0.0, 0.0),
    device_id=step.device_id,
)


def default_problem(N: int = 120, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[1.0, 0.0],
        xg=[2.0, 0.0],
        u_ref=[0.0],
        Q=[[1.0, 0.0], [0.0, 0.1]],
        R=[[1e-2]],
        alpha=50.0,
        w=0.02,
        N=N,
        T_min=10,
        T_max=80,
        wrap_idx=(),
        device=device,
        dtype=dtype,
    )
