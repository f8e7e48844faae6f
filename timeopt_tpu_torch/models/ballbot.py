"""Ballbot balance, a body balancing on a ball (port of
timeopt_tpu/models/ballbot.py).

State x = [ball_pos, ball_vel, theta, theta_dot], control u = [wheel
torque] (force = tau / r); cart-pole-style balance dynamics with the
effective ball mass M_eff = m_ball + I_ball / r^2, theta = 0 upright;
explicit Euler at dt = 0.02, theta wrapped. The same formulas run on the
card in csrc/systems.cuh (`Ballbot`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
R_BALL = 0.12
M_BALL = 1.2
I_BALL = (2.0 / 5.0) * M_BALL * R_BALL * R_BALL
M_EFF = M_BALL + I_BALL / (R_BALL * R_BALL)
M_BODY = 2.0
L_BODY = 0.55

TOTAL_MASS = M_EFF + M_BODY
POLEMASS_LENGTH = M_BODY * L_BODY
# Division by a constant is a multiplication by its reciprocal, as in the
# reference package.
_INV_TOTAL_MASS = 1.0 / TOTAL_MASS
_INV_R_BALL = 1.0 / R_BALL


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 4), u (..., 1) -> (..., 4)."""
    x_dot, th, th_dot = x[..., 1], x[..., 2], x[..., 3]
    force = u[..., 0] * _INV_R_BALL
    s, c = torch.sin(th), torch.cos(th)
    temp = (force + POLEMASS_LENGTH * th_dot * th_dot * s) * _INV_TOTAL_MASS
    th_acc = (G * s - c * temp) / (L_BODY * (4.0 / 3.0 - M_BODY * c * c * _INV_TOTAL_MASS))
    x_acc = temp - POLEMASS_LENGTH * th_acc * c * _INV_TOTAL_MASS
    return torch.stack([x_dot, x_acc, th_dot, th_acc], dim=-1)


step = euler_step_fn(xdot, DT, 4, wrap_idx=(2,), device_id=4)

SYSTEM = System(
    name="Ballbot_Balance",
    n=4,
    m=1,
    dt=DT,
    step=step,
    xdot=xdot,
    wrap_idx=(2,),
    sigma_x0=(0.02, 0.02, 0.02, 0.02),
    sigma_xg=(0.0, 0.0, 0.0, 0.0),
    device_id=step.device_id,
)


def default_problem(N: int = 260, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[0.05, 0.0, 0.08, 0.0],
        xg=[0.0, 0.0, 0.0, 0.0],
        u_ref=[0.0],
        Q=torch.diag(torch.tensor([1.0, 0.1, 25.0, 1.0], dtype=torch.float64)).numpy(),
        R=[[0.25]],
        alpha=220.0,
        w=1e-4,
        N=N,
        T_min=60,
        T_max=200,
        wrap_idx=(2,),
        device=device,
        dtype=dtype,
    )
