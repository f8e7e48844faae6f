"""12-DoF Euler-angle quadrotor (port of timeopt_tpu/models/quadrotor.py).

State x = [pos(3), vel(3), euler(3: phi, theta, psi), omega(3)], control
u = [thrust, tau_x, tau_y, tau_z]; explicit Euler at dt = 0.05. The guard
poisons the next state with an additive NaN near the Euler singularity
(|cos theta| < 1e-3), for |omega| > 1e3, ||x|| > 1e6 or non-finite input.
The same formulas run on the card in csrc/systems.cuh (`Quadrotor`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05
MASS = 1.0
G = 9.81
IX, IY, IZ = 0.02, 0.02, 0.04
KV, KW = 0.05, 0.01

COS_PITCH_MIN = 1e-3
OMG_ABS_MAX = 1e3
STATE_NORM_MAX = 1e6

# Division by the inertia is a multiplication by its reciprocal, as in the
# reference package.
_INV_IX, _INV_IY, _INV_IZ = 1.0 / IX, 1.0 / IY, 1.0 / IZ


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 12), u (..., 4) -> (..., 12). The terms keep the reference's
    matrix-product form (`- 0.0`, `0.0 * wx`), so a non-finite rate reaches
    the same entries (0 * inf = NaN) and the rounding order is the same."""
    vx, vy, vz = x[..., 3], x[..., 4], x[..., 5]
    phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
    wx, wy, wz = x[..., 9], x[..., 10], x[..., 11]
    thrust = u[..., 0]

    sph, cph = torch.sin(phi), torch.cos(phi)
    sth, cth = torch.sin(th), torch.cos(th)
    sps, cps = torch.sin(psi), torch.cos(psi)
    tm = thrust / MASS
    # thrust along the body z-axis (third column of Rz(psi) Ry(th) Rx(phi))
    acc_x = tm * (cps * sth * cph + sps * sph) - 0.0 - KV * vx
    acc_y = tm * (sps * sth * cph - cps * sph) - 0.0 - KV * vy
    acc_z = tm * (cth * cph) - G - KV * vz

    tth = torch.tan(th)
    sec = 1.0 / torch.cos(th)
    # Euler-angle rates T(phi, th) @ omega
    phid = wx + sph * tth * wy + cph * tth * wz
    thd = 0.0 * wx + cph * wy + (-sph) * wz
    psid = 0.0 * wx + sph * sec * wy + cph * sec * wz

    # omega x (I omega), I diagonal
    jx, jy, jz = IX * wx, IY * wy, IZ * wz
    cx = wy * jz - wz * jy
    cy = wz * jx - wx * jz
    cz = wx * jy - wy * jx
    omx = (u[..., 1] - cx) * _INV_IX - KW * wx
    omy = (u[..., 2] - cy) * _INV_IY - KW * wy
    omz = (u[..., 3] - cz) * _INV_IZ - KW * wz

    return torch.stack(
        [vx, vy, vz, acc_x, acc_y, acc_z, phid, thd, psid, omx, omy, omz], dim=-1
    )


def guard(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(...,) bool: True where (x, u) is invalid and the step is poisoned."""
    th = x[..., 7]
    omg = x[..., 9:12]
    return (
        (~torch.isfinite(x).all(dim=-1))
        | (~torch.isfinite(u).all(dim=-1))
        | (torch.sqrt(torch.sum(torch.square(x), dim=-1)) > STATE_NORM_MAX)
        | (torch.abs(torch.cos(th)) < COS_PITCH_MIN)
        | (torch.abs(omg) > OMG_ABS_MAX).any(dim=-1)
    )


step = euler_step_fn(xdot, DT, 12, wrap_idx=(), guard=guard, device_id=1)

SYSTEM = System(
    name="Quadrotor",
    n=12,
    m=4,
    dt=DT,
    step=step,
    xdot=xdot,
    guard=guard,
    sigma_x0=(0.4, 0.4, 0.4) + (0.0,) * 9,
    sigma_xg=(0.0,) * 12,
    device_id=step.device_id,
)


def default_problem(N: int = 160, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=[2.0, 2.0, 2.0] + [0.0] * 9,
        xg=[0.0] * 12,
        u_ref=[MASS * G, 0.0, 0.0, 0.0],
        Q=torch.diag(torch.tensor([5.0, 5, 5, 1, 1, 1, 20, 20, 10, 1, 1, 1], dtype=torch.float64)).numpy(),
        R=torch.diag(torch.tensor([1e-3, 1e-2, 1e-2, 1e-2], dtype=torch.float64)).numpy(),
        alpha=300.0,
        w=0.005,
        N=N,
        T_min=40,
        T_max=160,
        wrap_idx=(6, 7, 8),
        device=device,
        dtype=dtype,
    )
