"""Plain copies of the benchmark's two systems, frozen with the benchmark.

The formulas of the paper's reference code (dmmsjtu-umich/time-opt-ilqr,
systems.py: make_quadrotor and make_pointmass_navigation), written again in
plain PyTorch for a batch of states: x (..., n), u (..., m). Every function
runs in the dtype of its inputs, float64 for the reference and float32 for
the precision control. Nothing here is shared with the program under test.
"""

from __future__ import annotations

import math

import torch


def angle_normalize(a: torch.Tensor) -> torch.Tensor:
    """Angles to [-pi, pi): floored modulo, as numpy's `%`."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def wrap(e: torch.Tensor, wrap_idx: tuple) -> torch.Tensor:
    """e with its angular components (wrap_idx) normalized."""
    if not wrap_idx:
        return e
    mask = torch.zeros(e.shape[-1], dtype=torch.bool, device=e.device)
    mask[list(wrap_idx)] = True
    return torch.where(mask, angle_normalize(e), e)


class Quadrotor:
    """12-DoF Euler-angle quadrotor (systems.py:119-230). x = [p (3), v (3),
    phi, theta, psi, omega (3)], u = [thrust, tau (3)]. R = Rz(psi) Ry(theta)
    Rx(phi); p' = v, v' = (thrust / m) R e3 - g e3 - kv v, the Euler rates
    T(phi, theta) omega, omega' = I^-1 (tau - omega x I omega) - kw omega.
    The next state is all NaN where (x, u) is not finite, |cos theta| <
    1e-3, any |omega_i| > 1e3 or ||x|| > 1e6 (systems.py:165-191)."""

    name = "quadrotor"
    n, m = 12, 4
    mass, g = 1.0, 9.81
    inertia = (0.02, 0.02, 0.04)
    kv, kw = 0.05, 0.01
    cos_pitch_min, omega_max, norm_max = 1e-3, 1e3, 1e6

    @classmethod
    def xdot(cls, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        v = x[..., 3:6]
        phi, th, psi = x[..., 6], x[..., 7], x[..., 8]
        om = x[..., 9:12]
        cf, sf = torch.cos(phi), torch.sin(phi)
        ct, st = torch.cos(th), torch.sin(th)
        cp, sp = torch.cos(psi), torch.sin(psi)
        z = torch.zeros_like(phi)
        o = torch.ones_like(phi)
        Rz = torch.stack([cp, -sp, z, sp, cp, z, z, z, o], -1).reshape(*phi.shape, 3, 3)
        Ry = torch.stack([ct, z, st, z, o, z, -st, z, ct], -1).reshape(*phi.shape, 3, 3)
        Rx = torch.stack([o, z, z, z, cf, -sf, z, sf, cf], -1).reshape(*phi.shape, 3, 3)
        R = Rz @ Ry @ Rx
        e3 = torch.zeros(3, dtype=x.dtype, device=x.device)
        e3[2] = 1.0
        acc = (u[..., :1] / cls.mass) * R[..., :, 2] - cls.g * e3 - cls.kv * v
        tt, sec = torch.tan(th), 1.0 / ct
        T = torch.stack([o, sf * tt, cf * tt, z, cf, -sf, z, sf * sec, cf * sec], -1).reshape(*phi.shape, 3, 3)
        eul = (T @ om[..., None])[..., 0]
        inertia = torch.tensor(cls.inertia, dtype=x.dtype, device=x.device)
        omd = (u[..., 1:4] - torch.linalg.cross(om, inertia * om)) / inertia - cls.kw * om
        return torch.cat([v, acc, eul, omd], dim=-1)

    @classmethod
    def guard(cls, x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return ((~torch.isfinite(x).all(-1)) | (~torch.isfinite(u).all(-1))
                | (torch.linalg.vector_norm(x, dim=-1) > cls.norm_max)
                | (torch.cos(x[..., 7]).abs() < cls.cos_pitch_min)
                | (x[..., 9:12].abs() > cls.omega_max).any(-1))

    @staticmethod
    def extra_cost(x: torch.Tensor):
        return None


class PointMass:
    """2-D point mass among soft Gaussian obstacles (systems.py:237-296):
    x = [px, py, vx, vy], u = [ax, ay], double-integrator dynamics, no
    guard, and the extra stage cost sum_i w_i exp(-||p - c_i||^2 / (2
    r_i^2)) with its hand-derived gradient and Hessian in the position."""

    name = "pointmass"
    n, m = 4, 2
    obstacles = ((-1.0, -0.5, 0.65, 6.0), (0.0, 0.2, 0.70, 6.0), (1.0, 1.0, 0.65, 6.0))  # (cx, cy, r, w)

    @staticmethod
    def xdot(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.cat([x[..., 2:4], u], dim=-1)

    @staticmethod
    def guard(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        return torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)

    @classmethod
    def extra_cost(cls, x: torch.Tensor):
        """(c (...), c_x (..., n), c_xx (..., n, n)) of the obstacle cost."""
        c = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        cx = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        cxx = torch.zeros(x.shape + (x.shape[-1],), dtype=x.dtype, device=x.device)
        eye = torch.eye(2, dtype=x.dtype, device=x.device)
        for ox, oy, r, w in cls.obstacles:
            d = x[..., :2] - torch.tensor((ox, oy), dtype=x.dtype, device=x.device)
            s2 = r * r
            g = w * torch.exp(-(d * d).sum(-1) / (2.0 * s2))
            c = c + g
            cx[..., :2] += (-g / s2)[..., None] * d
            cxx[..., :2, :2] += g[..., None, None] * (d[..., :, None] * d[..., None, :] / (s2 * s2) - eye / s2)
        return c, cx, cxx


SYSTEMS = {cls.name: cls for cls in (Quadrotor, PointMass)}


def step(system, x: torch.Tensor, u: torch.Tensor, dt: float) -> torch.Tensor:
    """Explicit Euler x + dt xdot(x, u), all NaN where the guard holds."""
    xn = x + dt * system.xdot(x, u)
    return torch.where(system.guard(x, u)[..., None], torch.full_like(xn, float("nan")), xn)
