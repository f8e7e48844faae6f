"""Horizon selection by the LFT propagator sweep (HOP-DDP); port of the
propagator half of timeopt_tpu/solver/horizon.py.

Each step contributes an information-form LFT element (E, F, G); prefix
composition of the elements is a sequential loop over the steps here, and
the factored terminal query gives J(T) for every candidate horizon at once.
All functions take a leading batch axis B. The phase has two dispatch
points, each the plain version below on the CPU and a hand-written kernel
on the card: `propagator_select_fused` (ops/cuda_lft.py) for a stationary
stage cost, `propagator_select_generic` (ops/cuda_lft_generic.py) for the
assembled blocks of an extra stage cost.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.ops import cuda_lft, cuda_lft_generic
from timeopt_tpu_torch.ops.linalg import psd_inv, psd_solve, sym


class LFTElements(NamedTuple):
    E: torch.Tensor  # (B, N, p, p)
    F: torch.Tensor  # (B, N, p, p)
    G: torch.Tensor  # (B, N, p, p)


def lft_elements(A_aug, B_aug, Q_aug, R_inv, *, psd_levels: int = 2) -> LFTElements:
    """Per-step element: E = Q_aug^-1, F = E A', G = A E A' + B R^-1 B'.
    A_aug, Q_aug (B, N, p, p); B_aug (B, N, p, m); R_inv (B, m, m)."""
    E = psd_inv(Q_aug, levels=psd_levels)
    F = E @ A_aug.transpose(-1, -2)
    BRB = torch.einsum("bkim,bmn,bkjn->bkij", B_aug, R_inv, B_aug)
    return LFTElements(E=E, F=F, G=sym(A_aug @ F + BRB))


def lft_compose(first: LFTElements, second: LFTElements, *, psd_levels: int = 2) -> LFTElements:
    """Composition of LFT elements (first, then second):
      W = (E2 + G1)^-1,  E = E1 - F1 W F1',  F = F1 W F2,  G = G2 - F2' W F2."""
    E1, F1, G1 = first
    E2, F2, G2 = second
    W = psd_inv(E2 + G1, levels=psd_levels)
    F1W = F1 @ W
    E = sym(E1 - F1W @ F1.transpose(-1, -2))
    F = F1W @ F2
    G = sym(G2 - F2.transpose(-1, -2) @ W @ F2)
    return LFTElements(E=E, F=F, G=G)


def lft_prefix_scan(elems: LFTElements, *, psd_levels: int = 2) -> LFTElements:
    """All prefix compositions elem_0 o ... o elem_k for k = 0..N-1, as a
    sequential loop over the step axis (axis 1)."""
    carry = LFTElements(*(x[:, 0] for x in elems))
    out = [carry]
    for k in range(1, elems.E.shape[1]):
        carry = lft_compose(carry, LFTElements(*(x[:, k] for x in elems)), psd_levels=psd_levels)
        out.append(carry)
    return LFTElements(*(torch.stack(t, dim=1) for t in zip(*out)))


def propagator_J_curve_factored(prefixes: LFTElements, C: torch.Tensor, *, psd_levels: int = 2) -> torch.Tensor:
    """Exact inverse-free terminal query. With QT = C'C (C = L'[I e_t]),
      X0 = E - (F C') (I + C G C')^-1 (C F')
    and J(T) = 0.5 (X0^-1)[p-1, p-1]. C: (B, N, n, p) -> J (B, N)."""
    Eb, Fb, Gb = prefixes
    n = C.shape[-2]
    Ct = C.transpose(-1, -2)
    S = torch.eye(n, dtype=C.dtype, device=C.device) + C @ Gb @ Ct
    FC = Fb @ Ct
    Y = psd_solve(S, FC.transpose(-1, -2), jitter=0.0, levels=psd_levels)
    X0 = sym(Eb - FC @ Y)
    z0 = torch.zeros(X0.shape[:-1], dtype=X0.dtype, device=X0.device)
    z0[..., -1] = 1.0
    y = psd_solve(X0, z0, levels=psd_levels)
    return 0.5 * y[..., -1]


def select_generic_plain(A_aug, B_aug, Q_aug, R_inv, C) -> torch.Tensor:
    """Plain version of the generic select: J (B, N), unscaled, every horizon
    evaluated (the kernel writes +inf below T_min instead). A_aug, Q_aug
    (B, N, p, p), B_aug (B, N, p, m), R_inv (B, m, m), C (B, N, n, p)."""
    elems = lft_elements(A_aug, B_aug, Q_aug, R_inv, psd_levels=1)
    pre = lft_prefix_scan(elems, psd_levels=1)
    return propagator_J_curve_factored(pre, C, psd_levels=1)


def _assemble_from_fused(A, Bm, vecs, scal, Qq, R_inv, Lt):
    """Augmented blocks from the fused inputs (same arithmetic as the JAX
    build_augmented + build_terminal_factors after scaling)."""
    e, en, atil, Qe = vecs.unbind(dim=2)
    corner, inv_sk, s_kp1, inv_skp1 = scal.unbind(dim=-1)
    Bsz, N, n = e.shape
    m = Bm.shape[-1]
    z = dict(dtype=e.dtype, device=e.device)

    Q_aug = torch.zeros((Bsz, N, n + 1, n + 1), **z)
    Q_aug[:, :, :n, :n] = Qq[:, None]
    Q_aug[:, :, :n, n] = Qe * inv_sk[..., None]
    Q_aug[:, :, n, :n] = Qe * inv_sk[..., None]
    Q_aug[:, :, n, n] = corner * inv_sk * inv_sk

    A_aug = torch.zeros((Bsz, N, n + 1, n + 1), **z)
    A_aug[:, :, :n, :n] = A
    A_aug[:, :, :n, n] = atil * inv_sk[..., None]
    A_aug[:, :, n, n] = s_kp1 * inv_sk

    B_aug = torch.zeros((Bsz, N, n + 1, m), **z)
    B_aug[:, :, :n, :] = Bm

    Le = torch.einsum("bkj,bij->bki", en, Lt)  # Lt e_{k+1}
    C = torch.cat(
        [Lt[:, None].expand(Bsz, N, n, n), (Le * inv_skp1[..., None])[..., None]], dim=-1
    )
    return A_aug, B_aug, Q_aug, C


def select_fused_plain(A, Bm, vecs, scal, Qq, R_inv, Lt) -> torch.Tensor:
    """Plain version of the fused select: J (B, N), unscaled, every horizon
    evaluated (the kernel writes +inf below T_min instead)."""
    A_aug, B_aug, Q_aug, C = _assemble_from_fused(A, Bm, vecs, scal, Qq, R_inv, Lt)
    return select_generic_plain(A_aug, B_aug, Q_aug, R_inv, C)


def propagator_select_fused(A, Bm, vecs, scal, Qq, R_inv, Lt, t_min: int) -> torch.Tensor:
    """The select phase's dispatch point: J (B, N) of the fused inputs."""
    return cuda_lft.propagator_select_fused(A, Bm, vecs, scal, Qq, R_inv, Lt, t_min=t_min)


def propagator_select_generic(A_aug, B_aug, Q_aug, R_inv, C, t_min: int) -> torch.Tensor:
    """The select phase's dispatch point for assembled blocks: J (B, N)."""
    return cuda_lft_generic.propagator_select_generic(A_aug, B_aug, Q_aug, R_inv, C, t_min=t_min)
