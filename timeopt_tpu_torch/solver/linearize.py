"""Trajectory linearization (port of timeopt_tpu/solver/linearize.py): exact
Jacobians by forward-mode AD (the default, one `jacfwd` over the joint
(x, u) input), and the reference's central and forward finite-difference
stencils, kept for parity. Both are batched over all B*N steps at once.

On the card, the exact Jacobians of a registry system's step (one that
carries a `device_id`, models/base.py::euler_step_fn) come from the
hand-written kernel of ops/cuda_linearize.py: forward-mode dual arithmetic
on the system's own device dynamics, the same values as linearize_ad."""

from __future__ import annotations

import torch

from timeopt_tpu_torch.ops import _build, cuda_linearize


def linearize_ad(step, X: torch.Tensor, U: torch.Tensor):
    """Exact Jacobians A_k = df/dx, B_k = df/du along (X, U).

    X: (B, N+1, n); U: (B, N, m). Returns A (B, N, n, n), B (B, N, n, m)."""
    Bsz, Np1, n = X.shape
    N, m = Np1 - 1, U.shape[-1]
    xu = torch.cat([X[:, :-1], U], dim=-1).reshape(Bsz * N, n + m)

    def joint(v):
        return step(v[:n], v[n:])

    # (B*N, n, n+m) in the problem dtype: torch's forward AD promotes the
    # tangent of a 0-dim float32 tensor times a Python float to float64
    # (x[..., i] * dt under vmap), so a float32 Jacobian may come out float64
    J = torch.func.vmap(torch.func.jacfwd(joint))(xu).to(X.dtype)
    return J[..., :n].reshape(Bsz, N, n, n), J[..., n:].reshape(Bsz, N, n, m)


def _fd_steps(v: torch.Tensor, eps: float, rel: float) -> torch.Tensor:
    """Per-dimension step max(eps, rel max(1, |v|))."""
    return torch.clamp(rel * torch.clamp(v.abs(), min=1.0), min=eps)


def linearize_fd(step, X, U, *, mode: str = "central", epsx=1e-5, epsu=1e-5, relx=1e-6, relu=1e-6):
    """Finite-difference Jacobians with relative per-dimension steps h.

    mode="central": (f(x + h e_i) - f(x - h e_i)) / 2h.
    mode="forward": (f(x + h e_i) - f(x)) / h, with every entry of a step's
    A and B NaN where its base evaluation f(x) is not finite.
    X: (B, N+1, n); U: (B, N, m). Returns A (B, N, n, n), B (B, N, n, m)."""
    Bsz, Np1, n = X.shape
    N, m = Np1 - 1, U.shape[-1]
    x, u = X[:, :-1].reshape(-1, n), U.reshape(-1, m)
    hx, hu = _fd_steps(x, epsx, relx), _fd_steps(u, epsu, relu)
    Dx, Du = torch.diag_embed(hx), torch.diag_embed(hu)  # row i = h_i e_i
    x_n, u_n = x[:, None].expand(-1, n, -1), u[:, None].expand(-1, n, -1)
    x_m, u_m = x[:, None].expand(-1, m, -1), u[:, None].expand(-1, m, -1)
    if mode == "central":
        A = (step(x_n + Dx, u_n) - step(x_n - Dx, u_n)) / (2.0 * hx[..., None])
        B = (step(x_m, u_m + Du) - step(x_m, u_m - Du)) / (2.0 * hu[..., None])
    elif mode == "forward":
        f0 = step(x, u)
        A = (step(x_n + Dx, u_n) - f0[:, None]) / hx[..., None]
        B = (step(x_m, u_m + Du) - f0[:, None]) / hu[..., None]
        bad = ~torch.isfinite(f0).all(dim=-1)
        poison = torch.where(bad, float("nan"), 0.0).to(X.dtype)[:, None, None]
        A, B = A + poison, B + poison
    else:
        raise ValueError(f"unknown fd mode {mode!r}")
    return (A.transpose(-1, -2).reshape(Bsz, N, n, n).contiguous(),
            B.transpose(-1, -2).reshape(Bsz, N, n, m).contiguous())


def linearize(step, X: torch.Tensor, U: torch.Tensor, mode: str = "ad"):
    """Dispatch: mode in {"ad", "central", "forward"}. "ad" on card tensors,
    for a step that carries a device_id, launches the Jacobian kernel
    (ops/cuda_linearize.py); on CPU tensors, or for a step without one (a
    user's own System), it runs linearize_ad."""
    if mode == "ad":
        device_id = getattr(step, "device_id", None)
        if device_id is not None and _build.on_card(X, "linearize"):
            return cuda_linearize.jacobians(device_id, step.euler_ingredients[1], X, U)
        return linearize_ad(step, X, U)
    return linearize_fd(step, X, U, mode=mode)
