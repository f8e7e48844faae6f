"""2D point-mass navigation with soft Gaussian obstacle penalties (port of
timeopt_tpu/models/pointmass.py), the one system with an extra stage cost.

State x = [px, py, vx, vy], control u = [ax, ay]; explicit Euler at
dt = 0.05. The penalty is a scalar function of the state; the solver takes
its exact gradient and Hessian with torch.func (solver/cost.py). The same
dynamics and penalty run on the card in csrc/systems.cuh (`PointMass`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem
from timeopt_tpu_torch.ops._build import constant

DT = 0.05

# (cx, cy, radius, weight) per obstacle
OBSTACLES = (
    (-1.0, -0.5, 0.65, 6.0),
    (0.0, 0.2, 0.70, 6.0),
    (1.0, 1.0, 0.65, 6.0),
)


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 4), u (..., 2) -> (..., 4)."""
    return torch.stack([x[..., 2], x[..., 3], u[..., 0], u[..., 1]], dim=-1)


step = euler_step_fn(xdot, DT, 4, device_id=5)


def obstacle_cost(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Soft obstacle penalty sum_i w_i exp(-||p - o_i||^2 / (2 r_i^2)) of the
    position p = x[..., :2]; x (..., 4) -> (...). `u` is unused."""
    z = dict(dtype=x.dtype, device=x.device)
    centers = constant(tuple((o[0], o[1]) for o in OBSTACLES), **z)
    r = constant(tuple(o[2] for o in OBSTACLES), **z)
    weights = constant(tuple(o[3] for o in OBSTACLES), **z)
    d2 = torch.sum(torch.square(x[..., None, :2] - centers), dim=-1)
    return torch.sum(weights * torch.exp(-d2 / (2.0 * r * r)), dim=-1)


SYSTEM = System(
    name="PointMass_Navigation",
    n=4,
    m=2,
    dt=DT,
    step=step,
    xdot=xdot,
    extra_cost=obstacle_cost,
    sigma_x0=(0.1, 0.1, 0.0, 0.0),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
    device_id=step.device_id,
)


def default_problem(N: int = 240, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[-2.0, -2.0, 0.0, 0.0],
        xg=[2.0, 2.0, 0.0, 0.0],
        u_ref=[0.0, 0.0],
        Q=torch.diag(torch.tensor([0.0, 0.0, 0.15, 0.15], dtype=torch.float64)).numpy(),
        R=torch.diag(torch.tensor([0.05, 0.05], dtype=torch.float64)).numpy(),
        alpha=[250.0, 250.0, 30.0, 30.0],
        w=0.06,
        N=N,
        T_min=30,
        T_max=220,
        wrap_idx=(),
        device=device,
        dtype=dtype,
    )
