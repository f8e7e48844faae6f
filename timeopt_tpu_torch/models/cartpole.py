"""Cart-pole swing-up (port of timeopt_tpu/models/cartpole.py).

State x = [cart_pos, cart_vel, theta, theta_dot] with theta = 0 down and
pi upright (the dynamics shift it by pi into the theta = 0 upright form);
control u = [force]; explicit Euler at dt = 0.02, theta wrapped. The same
formulas run on the card in csrc/systems.cuh (`Cartpole`).
"""

from __future__ import annotations

import math

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
M_CART = 1.0
M_POLE = 0.1
LENGTH = 0.5  # half-length
TOTAL_MASS = M_CART + M_POLE
POLEMASS_LENGTH = M_POLE * LENGTH
# Division by the total mass is a multiplication by its reciprocal, as in
# the reference package.
_INV_TOTAL_MASS = 1.0 / TOTAL_MASS


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 4), u (..., 1) -> (..., 4)."""
    x_dot, th, th_dot = x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0]

    th_u = th - math.pi
    costh = torch.cos(th_u)
    sinth = torch.sin(th_u)

    temp = (force + POLEMASS_LENGTH * th_dot * th_dot * sinth) * _INV_TOTAL_MASS
    denom = LENGTH * (4.0 / 3.0 - M_POLE * costh * costh * _INV_TOTAL_MASS)

    th_acc = (G * sinth - costh * temp) / denom
    x_acc = temp - POLEMASS_LENGTH * th_acc * costh * _INV_TOTAL_MASS
    return torch.stack([x_dot, x_acc, th_dot, th_acc], dim=-1)


step = euler_step_fn(xdot, DT, 4, wrap_idx=(2,), device_id=2)

SYSTEM = System(
    name="Cartpole_SwingUp",
    n=4,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    wrap_idx=(2,),
    sigma_x0=(0.0, 0.0, 0.0, 0.0),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
    device_id=step.device_id,
)


def default_problem(N: int = 360, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[0.0, 0.0, 0.0, 0.0],
        xg=[0.0, 0.0, math.pi, 0.0],
        u_ref=[0.0],
        Q=torch.diag(torch.tensor([0.01, 0.2, 0.0, 0.2], dtype=torch.float64)).numpy(),
        R=[[0.02]],
        alpha=[5.0, 5.0, 800.0, 40.0],
        w=0.03,
        N=N,
        T_min=40,
        T_max=320,
        wrap_idx=(2,),
        device=device,
        dtype=dtype,
    )
