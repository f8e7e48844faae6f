"""6-DoF powered-descent lander with free final time (Szmuk and Acikmese,
"Successive Convexification for 6-DoF Mars Rocket Powered Landing with
Free-Final-Time", AIAA GNC 2018, arXiv:1802.03827, section II), in the
paper's non-dimensional units.

State x = [m, r_I (3), v_I (3), q_B/I (4, scalar first), omega_B (3)],
control u = T_B, the thrust vector in the body frame:

    m'     = -alpha_m ||T_B||
    r_I'   = v_I
    v_I'   = C_I/B(q) T_B / m + g_I,          g_I = -e_x (x points up)
    q'     = 0.5 Omega(omega_B) q
    omega' = J_B^-1 (r_T,B x T_B - omega_B x (J_B omega_B)),  r_T,B = -l e_x

Explicit Euler at dt = 0.05, as every system here, with no quaternion
renormalization. HOP-DDP takes stage costs, not constraints: the paper's
tilt, glide-slope, gimbal, rate and thrust-magnitude constraints are
dropped, and its dry-mass constraint m >= m_dry becomes the guard, which
poisons the step with an additive NaN, as does a thrust below THRUST_EPS
(where d||T||/dT is not finite) and a non-finite input. The same formulas,
in the same order, run on the card in csrc/systems.cuh (`Rocket6DoF`).
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System, euler_step_fn, make_problem

DT = 0.05
M_WET, M_DRY = 2.0, 1.0
G = 1.0  # g_I = -G e_x
ALPHA_M = 0.01  # mass flow per unit thrust
JX, JY, JZ = 0.01, 0.01, 0.01  # J_B, diagonal
INV_JX, INV_JY, INV_JZ = 1.0 / JX, 1.0 / JY, 1.0 / JZ
RX, RY, RZ = -0.01, 0.0, 0.0  # r_T,B: the gimbal point, l below the centre of mass
THRUST_EPS = 1e-6


def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """x (..., 14), u (..., 3) -> (..., 14). The constant terms are kept in
    product form (RY * tz, a cross product's zero entries), so a non-finite
    input reaches the same entries as on the card."""
    m = x[..., 0]
    vx, vy, vz = x[..., 4], x[..., 5], x[..., 6]
    q0, q1, q2, q3 = x[..., 7], x[..., 8], x[..., 9], x[..., 10]
    wx, wy, wz = x[..., 11], x[..., 12], x[..., 13]
    tx, ty, tz = u[..., 0], u[..., 1], u[..., 2]

    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    mdot = -ALPHA_M * tn

    # C_I/B(q) T_B: the body thrust in the inertial frame
    ax = (1.0 - 2.0 * (q2 * q2 + q3 * q3)) * tx + 2.0 * (q1 * q2 - q0 * q3) * ty + 2.0 * (q1 * q3 + q0 * q2) * tz
    ay = 2.0 * (q1 * q2 + q0 * q3) * tx + (1.0 - 2.0 * (q1 * q1 + q3 * q3)) * ty + 2.0 * (q2 * q3 - q0 * q1) * tz
    az = 2.0 * (q1 * q3 - q0 * q2) * tx + 2.0 * (q2 * q3 + q0 * q1) * ty + (1.0 - 2.0 * (q1 * q1 + q2 * q2)) * tz
    vdx = ax / m - G
    vdy = ay / m
    vdz = az / m

    # 0.5 Omega(omega) q
    qd0 = 0.5 * (-wx * q1 - wy * q2 - wz * q3)
    qd1 = 0.5 * (wx * q0 + wz * q2 - wy * q3)
    qd2 = 0.5 * (wy * q0 - wz * q1 + wx * q3)
    qd3 = 0.5 * (wz * q0 + wy * q1 - wx * q2)

    # r_T x T and omega x (J omega), J diagonal
    mx = RY * tz - RZ * ty
    my = RZ * tx - RX * tz
    mz = RX * ty - RY * tx
    jx, jy, jz = JX * wx, JY * wy, JZ * wz
    cx = wy * jz - wz * jy
    cy = wz * jx - wx * jz
    cz = wx * jy - wy * jx
    wdx = (mx - cx) * INV_JX
    wdy = (my - cy) * INV_JY
    wdz = (mz - cz) * INV_JZ

    return torch.stack([mdot, vx, vy, vz, vdx, vdy, vdz, qd0, qd1, qd2, qd3, wdx, wdy, wdz], dim=-1)


def guard(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """(...,) bool: True where the step is poisoned: a non-finite input,
    the mass below the dry mass, or a thrust below THRUST_EPS."""
    tx, ty, tz = u[..., 0], u[..., 1], u[..., 2]
    tn = torch.sqrt(tx * tx + ty * ty + tz * tz)
    return (
        (~torch.isfinite(x).all(dim=-1))
        | (~torch.isfinite(u).all(dim=-1))
        | (x[..., 0] < M_DRY)
        | (tn < THRUST_EPS)
    )


step = euler_step_fn(xdot, DT, 14, wrap_idx=(), guard=guard, device_id=6)

# The start of the paper's example: wet mass, 4 up and 4 across, moving
# across and sideways at 2, upright and at rest; the goal: the pad, a
# touchdown speed of 0.1 down, upright and at rest, the mass still wet (the
# mass term of the cost stands in for the paper's fuel objective).
X0 = (M_WET, 4.0, 4.0, 0.0, 0.0, -2.0, -2.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
XG = (M_WET, 0.0, 0.0, 0.0, -0.1, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
U_REF = (M_WET * G, 0.0, 0.0)  # hover thrust along body x
Q_DIAG = (1.0, 2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 1.0, 10.0, 10.0, 10.0, 1.0, 1.0, 1.0)
R_DIAG = (8.0, 10.0, 10.0)  # the largest thrust under the paper's bound of 5
QF = 300.0
W = 0.04

SYSTEM = System(
    name="Rocket6DoF",
    n=14,
    m=3,
    dt=DT,
    step=step,
    xdot=xdot,
    guard=guard,
    sigma_x0=(0.0, 0.2, 0.2, 0.2, 0.1, 0.1, 0.1) + (0.0,) * 7,
    sigma_xg=(0.0,) * 14,
    device_id=step.device_id,
    kernel_rollout=True,  # 200 Euler steps of ~40 small torch ops each, otherwise
)


def default_problem(N: int = 200, device="cuda", dtype=torch.float64) -> Problem:
    return make_problem(
        x0=list(X0),
        xg=list(XG),
        u_ref=list(U_REF),
        Q=torch.diag(torch.tensor(Q_DIAG, dtype=torch.float64)).numpy(),
        R=torch.diag(torch.tensor(R_DIAG, dtype=torch.float64)).numpy(),
        alpha=QF,
        w=W,
        N=N,
        T_min=40,
        T_max=200,
        wrap_idx=(),
        device=device,
        dtype=dtype,
    )
