"""Latency-mode propagator select (scan_mode="assoc_df"): a Hillis-Steele
prefix scan over the time axis; port of timeopt_tpu/solver/select_assoc.py.

The sequential select walks a problem's N steps one after another. This
module parallelizes one solve over its own horizon instead:

- the LFT elements (E, F, G) of all N steps at once;
- the prefix composition as a Hillis-Steele inclusive scan: ceil(log2 N)
  rounds, each one batched compose over the steps (O(N log N) composes
  instead of N - 1, at depth log N instead of N);
- all N factored terminal queries in one call of ops/cuda_lft_query.py
  (the query kernel on the card, its plain version on the CPU).

The element and the compose are the JAX module's math (ops/lft_df.py):
every inverse acts through an unpivoted LDL' factor of the SPD matrix plus
one jitter (1e-9), as trisolves and pivot scalings, and the symmetric
products are quadratic forms U' D^-1 U. Explicit Gauss-Jordan inverses
(horizon.py's lft_elements / lft_compose) lose the digits this recursion
needs where kappa(Q_aug) is large: on the cart-pole's and the ballbot's
oracle problems they pick other horizons, which the LDL' form does not.

The JAX module runs this math in double-single (df32) arithmetic with time
on the TPU's lane axis, because the TPU has no float64 and plain float32
picks wrong horizons. That is TPU mechanics: the port runs it in float64
(the H100 has float64 units), with time on axis 1 of the usual
(B, N, p, p) layout, on float32 problems too (float32 blocks and C in,
float32 J out). The mode keeps its name, so a SolveOptions carries
over between the packages.
"""

from __future__ import annotations

import torch

from timeopt_tpu_torch.ops import cuda_lft_query
from timeopt_tpu_torch.ops.linalg import sym
from timeopt_tpu_torch.solver.horizon import LFTElements, brb

JITTER = 1e-9


def ldl(A: torch.Tensor, jitter: float) -> tuple:
    """Unpivoted LDL' of A + jitter I over the trailing (p, p) axes (the
    pivot order of a pivot-free elimination): L unit lower (..., p, p) and
    the reciprocal pivots inv_d (..., p)."""
    p = A.shape[-1]
    eye = torch.eye(p, dtype=A.dtype, device=A.device)
    M = A + jitter * eye
    L = eye.expand(A.shape).clone()
    inv_d = []
    for i in range(p):
        inv = 1.0 / M[..., i, i]
        inv_d.append(inv)
        if i + 1 < p:
            lcol = M[..., i + 1:, i] * inv[..., None]
            L[..., i + 1:, i] = lcol
            M[..., i + 1:, :] -= lcol[..., :, None] * M[..., i, None, :]
    return L, torch.stack(inv_d, dim=-1)


def solve_unit_lower(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """L^-1 R for unit-lower L (..., p, p), R (..., p, k): forward
    substitution, right-looking (each final row updates the rows below)."""
    Z = R.clone()
    for i in range(L.shape[-1] - 1):
        Z[..., i + 1:, :] -= L[..., i + 1:, i, None] * Z[..., i, None, :]
    return Z


def solve_unit_lower_t(L: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """L'^-1 R for unit-lower L: back substitution, right-looking."""
    Z = R.clone()
    for i in range(L.shape[-1] - 1, 0, -1):
        Z[..., :i, :] -= L[..., i, :i, None] * Z[..., i, None, :]
    return Z


def lft_elements_time(A_aug, B_aug, Q_aug, R_inv) -> LFTElements:
    """The elements of all steps at once, through Q's LDL' factor
    (ops/lft_df.py::df_lft_element_ldl): Z = L^-1 [A' | I],
    G = sym(Z_A' D^-1 Z_A + B R^-1 B'), [F | E] = L'^-1 D^-1 Z, E symmetrized;
    i.e. E = (Q + jitter I)^-1, F = E A', G = A E A' + B R^-1 B'.
    A_aug, Q_aug (B, N, p, p), B_aug (B, N, p, m), R_inv (B, m, m) ->
    (E, F, G), each (B, N, p, p)."""
    p = A_aug.shape[-1]
    L, inv_d = ldl(Q_aug, JITTER)
    eye = torch.eye(p, dtype=A_aug.dtype, device=A_aug.device).expand(A_aug.shape)
    Z = solve_unit_lower(L, torch.cat([A_aug.transpose(-1, -2), eye], dim=-1))
    Zs = Z * inv_d[..., :, None]
    G = sym(Z[..., :p].transpose(-1, -2) @ Zs[..., :p] + brb(B_aug, R_inv))
    FE = solve_unit_lower_t(L, Zs)
    return LFTElements(E=sym(FE[..., p:]), F=FE[..., :p], G=G)


def lft_compose_ldl(first: LFTElements, second: LFTElements) -> LFTElements:
    """Composition (first, then second) through the LDL' factor of
    E2 + G1 + jitter I (ops/lft_df.py::df_lft_compose): with
    [U | V] = Lw^-1 [F1' | F2], E = sym(E1 - U' D^-1 U), F = (D^-1 U)' V,
    G = sym(G2 - V' D^-1 V); W = (E2 + G1 + jitter I)^-1 is never formed."""
    E1, F1, G1 = first
    E2, F2, G2 = second
    p = E1.shape[-1]
    Lw, inv_d = ldl(E2 + G1, JITTER)
    UV = solve_unit_lower(Lw, torch.cat([F1.transpose(-1, -2), F2], dim=-1))
    UVs = UV * inv_d[..., :, None]
    U, Us, V, Vs = UV[..., :p], UVs[..., :p], UV[..., p:], UVs[..., p:]
    return LFTElements(E=sym(E1 - U.transpose(-1, -2) @ Us), F=Us.transpose(-1, -2) @ V,
                       G=sym(G2 - V.transpose(-1, -2) @ Vs))


def lft_prefix_scan_hillis_steele(elems: LFTElements) -> LFTElements:
    """Inclusive prefix scan over the step axis (axis 1): round d composes
    each step k >= 2^d with step k - 2^d on its left (first, then second),
    so after ceil(log2 N) rounds step k holds elem_0 o ... o elem_k. Steps
    k < 2^d keep their value: the compose monoid has no finite identity
    element in the (E, F, G) parametrization (its identity is a limit
    point), so the scan masks instead of padding. The shift is a slice, so
    nothing outside the steps is ever composed."""
    pre = elems
    N = elems.E.shape[1]
    s = 1
    while s < N:
        comp = lft_compose_ldl(LFTElements(*(x[:, : N - s] for x in pre)), LFTElements(*(x[:, s:] for x in pre)))
        pre = LFTElements(*(torch.cat([x[:, :s], c], dim=1) for x, c in zip(pre, comp)))
        s *= 2
    return pre


def propagator_select_assoc(A_aug, B_aug, Q_aug, R_inv, C, t_min: int) -> torch.Tensor:
    """The whole latency-mode select: blocks and factored terminal C
    (B, N, n, p) -> J (B, N) in C's dtype, unscaled, +inf below t_min. The
    elements and the rounds run in float64 (on float32 blocks, upcast);
    the query kernel takes C as it is and rounds J once."""
    blocks = (t.double() for t in (A_aug, B_aug, Q_aug, R_inv))
    pre = lft_prefix_scan_hillis_steele(lft_elements_time(*blocks))
    J = cuda_lft_query.lft_query(*(t.contiguous() for t in pre), C.contiguous(), jitter=JITTER, levels=1)
    Ts = torch.arange(1, J.shape[1] + 1, device=J.device)
    return torch.where(Ts >= t_min, J, torch.full_like(J, float("inf")))
