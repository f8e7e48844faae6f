"""Segway balance, linearized-pendulum form (port of
timeopt_tpu/models/segway.py).

State x = [wheel_pos, wheel_vel, theta, theta_dot], control u = [torque];
the dynamics are affine in (theta, tau) with closed-form coefficients;
explicit Euler at dt = 0.02, theta wrapped. The same formulas run on the
card in csrc/systems.cuh (`Segway`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.02
G = 9.81
R_WHEEL = 0.15
M_BASE = 1.0
M_PEND = 2.0
L_PEND = 0.5
I_PEND = (1.0 / 3.0) * M_PEND * L_PEND * L_PEND

_A1 = M_BASE + M_PEND
_A2 = M_PEND * L_PEND
_A3 = I_PEND + M_PEND * L_PEND * L_PEND
_DEN = _A1 * _A3 - _A2 * _A2

A_TAU = _A3 / (R_WHEEL * _DEN) - _A2 / _DEN
A_TH = -(_A2 * M_PEND * G * L_PEND) / _DEN
B_TAU = -_A2 / (R_WHEEL * _DEN) + _A1 / _DEN
B_TH = (_A1 * M_PEND * G * L_PEND) / _DEN


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 4), u (..., 1) -> (..., 4)."""
    x_dot, th, th_dot = x[..., 1], x[..., 2], x[..., 3]
    tau = u[..., 0]
    xdd = A_TAU * tau + A_TH * th
    thdd = B_TAU * tau + B_TH * th
    return torch.stack([x_dot, xdd, th_dot, thdd], dim=-1)


step = euler_step_fn(xdot, DT, 4, wrap_idx=(2,), device_id=3)

SYSTEM = System(
    name="Segway_Balance",
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


def default_problem(N: int = 240, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[0.05, 0.0, 0.08, 0.0],
        xg=[0.0, 0.0, 0.0, 0.0],
        u_ref=[0.0],
        Q=torch.diag(torch.tensor([1.0, 0.1, 25.0, 1.0], dtype=torch.float64)).numpy(),
        R=[[0.25]],
        alpha=[20.0, 2.0, 250.0, 10.0],
        w=1e-4,
        N=N,
        T_min=40,
        T_max=200,
        wrap_idx=(2,),
        device=device,
        dtype=dtype,
    )
