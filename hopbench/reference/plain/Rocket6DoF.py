"""The 6-DoF powered-descent lander, plain: the dynamics of Szmuk and
Acikmese, "Successive Convexification for 6-DoF Mars Rocket Powered Landing
with Free-Final-Time" (AIAA GNC 2018, arXiv:1802.03827), section II, in
the paper's non-dimensional units, written again in plain PyTorch for a
batch of states (x (..., 14), u (..., 3)), in the dtype of the inputs. It
imports nothing of the program under test.

x = [m, r_I (3), v_I (3), q_B/I (4, scalar first), omega_B (3)], u = T_B:

    m'     = -alpha_m ||T_B||
    r_I'   = v_I
    v_I'   = C_I/B(q) T_B / m + g_I,          g_I = -e_x
    q'     = 0.5 Omega(omega_B) q
    omega' = J_B^-1 (r_T,B x T_B - omega_B x (J_B omega_B)),  r_T,B = -l e_x

Departures from the paper, each forced by the solver (HOP-DDP takes stage
costs, not constraints, and steps by explicit Euler):

- the tilt, glide-slope, gimbal, angular-rate and thrust-magnitude bounds
  are dropped;
- the dry-mass bound m >= m_dry is the guard: the step is poisoned (all
  NaN) below it, as it is where ||T_B|| < 1e-6 (d||T||/dT is not finite at
  0) or an input is not finite;
- the paper's aerodynamic and back-pressure terms are left out;
- the step is explicit Euler with no quaternion renormalization;
- the free final time is the horizon T (w T for the paper's time of
  flight), and the fuel objective is the cost's tracking of the mass
  against the wet mass.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class Rocket6DoF:
    name = "Rocket6DoF"
    n, m = 14, 3
    m_dry = 1.0
    g_I = (-1.0, 0.0, 0.0)
    alpha_m = 0.01
    J_B = (0.01, 0.01, 0.01)
    r_T = (-0.01, 0.0, 0.0)
    thrust_eps = 1e-6
    # operations of one evaluation (hopbench/work.py's rules: a multiply or
    # an add 1, a square root 1): ||T|| 6 and m' 1; C_I/B from q 39 and its
    # product with T 15; v' 4; q' 24 (Omega q 20, the half 4); r_T x T 9,
    # J omega 3, omega x J omega 9, omega' 6
    xdot_flops = 6 + 1 + 39 + 15 + 4 + 24 + 9 + 3 + 9 + 6
    guard_flops = 6 + 2  # ||T|| and the two bounds
    extra_cost_flops = 0

    @staticmethod
    def _const(vals, x):
        return torch.tensor(vals, dtype=x.dtype, device=x.device)

    @classmethod
    def rotation(cls, q: torch.Tensor) -> torch.Tensor:
        """C_I/B (..., 3, 3) of the unit quaternion q_B/I (..., 4), scalar first."""
        q0, q1, q2, q3 = q.unbind(-1)
        rows = [1 - 2 * (q2 * q2 + q3 * q3), 2 * (q1 * q2 - q0 * q3), 2 * (q1 * q3 + q0 * q2),
                2 * (q1 * q2 + q0 * q3), 1 - 2 * (q1 * q1 + q3 * q3), 2 * (q2 * q3 - q0 * q1),
                2 * (q1 * q3 - q0 * q2), 2 * (q2 * q3 + q0 * q1), 1 - 2 * (q1 * q1 + q2 * q2)]
        return torch.stack(rows, -1).reshape(*q.shape[:-1], 3, 3)

    @staticmethod
    def omega_matrix(w: torch.Tensor) -> torch.Tensor:
        """Omega(w) (..., 4, 4) of the quaternion kinematics q' = 0.5 Omega(w) q."""
        wx, wy, wz = w.unbind(-1)
        z = torch.zeros_like(wx)
        rows = [z, -wx, -wy, -wz, wx, z, wz, -wy, wy, -wz, z, wx, wz, wy, -wx, z]
        return torch.stack(rows, -1).reshape(*w.shape[:-1], 4, 4)

    @classmethod
    def xdot(cls, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        mass, v, q, w = x[..., :1], x[..., 4:7], x[..., 7:11], x[..., 11:14]
        J = cls._const(cls.J_B, x)
        mdot = -cls.alpha_m * torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        vdot = (cls.rotation(q) @ u[..., None])[..., 0] / mass + cls._const(cls.g_I, x)
        qdot = 0.5 * (cls.omega_matrix(w) @ q[..., None])[..., 0]
        torque = torch.linalg.cross(cls._const(cls.r_T, x).expand(u.shape), u)
        wdot = (torque - torch.linalg.cross(w, J * w)) / J
        return torch.cat([mdot, v, vdot, qdot, wdot], dim=-1)

    @classmethod
    def guard(cls, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return ((~torch.isfinite(x).all(-1)) | (~torch.isfinite(u).all(-1)) | (x[..., 0] < cls.m_dry)
                | (torch.linalg.vector_norm(u, dim=-1) < cls.thrust_eps))

    @staticmethod
    def extra_cost(x: torch.Tensor):
        return None


SYSTEM = Rocket6DoF
