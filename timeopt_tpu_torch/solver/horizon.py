"""Horizon selection: the LFT propagator sweep (HOP-DDP) and the brute-force
curve; port of timeopt_tpu/solver/horizon.py.

Each step contributes an information-form LFT element (E, F, G); prefix
composition of the elements is a sequential loop over the steps or, with
mode="associative", the up-sweep/down-sweep tree of `lax.associative_scan`
(ceil(log2 N) levels of batched composes), and the terminal query gives
J(T) for every candidate horizon at once. All functions take a leading
batch axis B. The propagator has four dispatch points, each the plain
version below on the CPU and a hand-written kernel on the card:

- `propagator_select_fused` (ops/cuda_lft.py): the solve's select for a
  stationary stage cost;
- `propagator_select_generic` (ops/cuda_lft_generic.py): the solve's select
  on the assembled blocks of an extra stage cost;
- `propagator_select`, the unfused select (consistency_check,
  terminal_mode="inverse" and scan_mode="associative"): every prefix from
  ops/cuda_lft_scan.py (or the plain associative scan), then the factored
  query of ops/cuda_lft_query.py or the plain inverse query.

On float32 blocks (the float32 path) the unfused select stores what the JAX
package's float32 select takes in and gives out, blocks, C or QT and J in
float32, and keeps every recursion in float64: B R^-1 B' is formed in
float64 and rounded once, the prefixes (the scan kernel's float32 entry,
or the associative scan on the upcast blocks) stay float64, and J is
rounded to float32 once, on the way out of the query.

The brute force (`bruteforce_J_curve`) has no kernel in the JAX package and
stays plain PyTorch: one reverse loop over the steps that carries the value
expansion of every candidate horizon at once.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from timeopt_tpu_torch.ops import _build, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan
from timeopt_tpu_torch.ops.linalg import psd_inv, psd_solve, sym
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.ops.wrap import wrap_error


class LFTElements(NamedTuple):
    E: torch.Tensor  # (B, N, p, p)
    F: torch.Tensor  # (B, N, p, p)
    G: torch.Tensor  # (B, N, p, p)


def brb(B_aug: torch.Tensor, R_inv: torch.Tensor) -> torch.Tensor:
    """B_aug R^-1 B_aug' (B, N, p, p) for B_aug (B, N, p, m), R_inv (B, m, m),
    formed in float64 (on float32 inputs rounded to float32 once)."""
    return _build.in_f64(torch.einsum, "bkim,bmn,bkjn->bkij", B_aug, R_inv, B_aug)


def lft_elements_brb(A_aug, BRB, Q_aug, *, psd_levels: int = 2, jitter: float = 1e-9) -> LFTElements:
    """Per-step element: E = Q_aug^-1, F = E A', G = sym(A E A' + BRB).
    A_aug, BRB, Q_aug (B, N, p, p)."""
    E = psd_inv(Q_aug, jitter=jitter, levels=psd_levels)
    F = E @ A_aug.transpose(-1, -2)
    return LFTElements(E=E, F=F, G=sym(A_aug @ F + BRB))


def lft_elements(A_aug, B_aug, Q_aug, R_inv, *, psd_levels: int = 2) -> LFTElements:
    """Per-step element: E = Q_aug^-1, F = E A', G = A E A' + B R^-1 B'.
    A_aug, Q_aug (B, N, p, p); B_aug (B, N, p, m); R_inv (B, m, m)."""
    return lft_elements_brb(A_aug, brb(B_aug, R_inv), Q_aug, psd_levels=psd_levels)


def lft_compose(first: LFTElements, second: LFTElements, *, psd_levels: int = 2, jitter: float = 1e-9) -> LFTElements:
    """Composition of LFT elements (first, then second):
      W = (E2 + G1)^-1,  E = E1 - F1 W F1',  F = F1 W F2,  G = G2 - F2' W F2."""
    E1, F1, G1 = first
    E2, F2, G2 = second
    W = psd_inv(E2 + G1, jitter=jitter, levels=psd_levels)
    F1W = F1 @ W
    E = sym(E1 - F1W @ F1.transpose(-1, -2))
    F = F1W @ F2
    G = sym(G2 - F2.transpose(-1, -2) @ W @ F2)
    return LFTElements(E=E, F=F, G=G)


def lft_prefix_scan(
    elems: LFTElements, *, mode: str = "sequential", psd_levels: int = 2, jitter: float = 1e-9
) -> LFTElements:
    """All prefix compositions elem_0 o ... o elem_k for k = 0..N-1 along the
    step axis (axis 1): a sequential loop, or with mode="associative" the
    tree of `_associative_scan`."""
    if mode == "associative":
        return _associative_scan(elems, psd_levels, jitter)
    if mode != "sequential":
        raise ValueError(f"unknown scan mode {mode!r}")
    carry = LFTElements(*(x[:, 0] for x in elems))
    out = [carry]
    for k in range(1, elems.E.shape[1]):
        carry = lft_compose(carry, LFTElements(*(x[:, k] for x in elems)), psd_levels=psd_levels, jitter=jitter)
        out.append(carry)
    return LFTElements(*(torch.stack(t, dim=1) for t in zip(*out)))


def _associative_scan(elems: LFTElements, psd_levels: int, jitter: float) -> LFTElements:
    """The algorithm of `lax.associative_scan` (the JAX package's
    scan_mode="associative"): compose adjacent pairs (first, then second),
    scan the half recursively, which gives the odd positions, then compose
    each odd prefix with the next element for the even positions. Each level
    is one batched compose over all its pairs; ceil(log2 N) levels."""
    N = elems.E.shape[1]
    if N < 2:
        return elems
    compose = lambda a, b: lft_compose(a, b, psd_levels=psd_levels, jitter=jitter)  # noqa: E731
    pairs = compose(LFTElements(*(x[:, 0:N - 1:2] for x in elems)), LFTElements(*(x[:, 1::2] for x in elems)))
    odd = _associative_scan(pairs, psd_levels, jitter)  # prefixes 1, 3, 5, ...
    head = odd if N % 2 else LFTElements(*(x[:, :-1] for x in odd))
    even = compose(head, LFTElements(*(x[:, 2::2] for x in elems)))  # prefixes 2, 4, ...
    out = []
    for x, e, o in zip(elems, even, odd):
        y = torch.empty_like(x)
        y[:, 0] = x[:, 0]
        y[:, 2::2] = e
        y[:, 1::2] = o
        out.append(y)
    return LFTElements(*out)


def propagator_J_curve_factored(
    prefixes: LFTElements, C: torch.Tensor, *, psd_levels: int = 2, jitter: float = 1e-9
) -> torch.Tensor:
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
    return 0.5 * _last_solve(X0, psd_levels, jitter)


def _last_solve(X0: torch.Tensor, psd_levels: int, jitter: float = 1e-9) -> torch.Tensor:
    """Last component of the solve X0 y = e_{p-1} (= (X0^-1)[p-1, p-1])."""
    p = X0.shape[-1]
    # e_{p-1} from eye, not by item assignment, which makes a tensor of the
    # Python number (refused by solver/compiled.py's CaptureGuard)
    z0 = torch.eye(p, dtype=X0.dtype, device=X0.device)[-1].expand(X0.shape[:-1])
    return psd_solve(X0, z0, jitter=jitter, levels=psd_levels)[..., -1]


def propagator_J_curve(prefixes: LFTElements, QT: torch.Tensor, *, psd_levels: int = 2) -> torch.Tensor:
    """Reference-parity terminal query: inverts the regularized homogeneous
    terminal block QT (B, N, p, p) (build_terminal_blocks),
      X0 = E - F (QT^-1 + G)^-1 F',  J(T) = 0.5 (X0^-1)[p-1, p-1].
    QT is rank-deficient by construction, so this query carries the
    reference's O(1e-4) regularization error. In float64 on the float64
    prefixes, J in QT's dtype: on float32 QT, QT upcast and J rounded once."""
    Eb, Fb, Gb = prefixes
    Xt = psd_inv(QT.double(), levels=psd_levels)
    Wt = psd_inv(Xt + Gb, levels=psd_levels)
    X0 = sym(Eb - Fb @ Wt @ Fb.transpose(-1, -2))
    return (0.5 * _last_solve(X0, psd_levels)).to(QT.dtype)


def propagator_select_prefixes(A_aug, B_aug, Q_aug, R_inv, *, scan_mode: str = "sequential",
                               psd_levels: int = 2) -> LFTElements:
    """Every prefix (E, F, G) of the blocks, float64: the scan kernel
    (scan_mode="sequential"; its float32 entry on float32 blocks), or the
    plain associative scan ("associative") on the blocks upcast to float64."""
    if scan_mode == "sequential":
        return LFTElements(*cuda_lft_scan.lft_scan(
            A_aug.contiguous(), brb(B_aug, R_inv).contiguous(), Q_aug.contiguous(), levels=psd_levels
        ))
    elems = lft_elements(*(t.double() for t in (A_aug, B_aug, Q_aug, R_inv)), psd_levels=psd_levels)
    return lft_prefix_scan(elems, mode=scan_mode, psd_levels=psd_levels)


@full_matmul_precision
def propagator_select(
    A_aug, B_aug, Q_aug, R_inv, terminal, *, psd_levels: int = 2, terminal_mode: str = "factored",
    scan_mode: str = "sequential",
) -> torch.Tensor:
    """The unfused propagator sweep: blocks -> J(T), T = 1..N (B, N),
    unscaled, in the terminal's dtype. The prefixes come from the scan
    kernel (scan_mode="sequential") or the plain associative scan
    ("associative"); `terminal` is C from build_terminal_factors
    (terminal_mode="factored", the query kernel) or QT from
    build_terminal_blocks ("inverse", the plain inverse query). TF32 is off
    inside (ops/precision.py), as in the JAX package's propagator_select."""
    pre = propagator_select_prefixes(A_aug, B_aug, Q_aug, R_inv, scan_mode=scan_mode, psd_levels=psd_levels)
    if terminal_mode == "factored":
        return cuda_lft_query.lft_query(*(t.contiguous() for t in pre), terminal.contiguous(), levels=psd_levels)
    if terminal_mode == "inverse":
        return propagator_J_curve(pre, terminal, psd_levels=psd_levels)
    raise ValueError(f"unknown terminal_mode {terminal_mode!r}")


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


# ---------------------------------------------------------------------------
# Brute force
# ---------------------------------------------------------------------------


def _value_expansion_arrays(A, B, lx, lu, l0, Qstage, eTs, QfT, R, T, *, lm_lambda=1e-6, psd_levels=2):
    """V0(0) of the full quadratic value expansion with the terminal at step
    T, for K candidate horizons T (B, K) of each problem at once: one masked
    reverse loop over the N steps carrying (Vx, Vxx, V0) of shape (B, K, ...).
    The per-step inputs broadcast over the candidate axis. A (B, N, n, n),
    B (B, N, n, m), lx (B, N, n), lu (B, N, m), l0 (B, N), Qstage
    (B, N, n, n), eTs[:, k] = wrap(x_{k+1} - xg) (B, N, n), QfT = sym(Qf)
    and R (B, ., .) -> V0 (B, K)."""
    Bsz, N, n, _ = A.shape
    m = B.shape[-1]
    K = T.shape[1]
    z = dict(dtype=A.dtype, device=A.device)
    lam_I = lm_lambda * torch.eye(m, **z)
    QfeT = torch.einsum("bij,bkj->bki", QfT, eTs)  # QfT eT
    V0T = 0.5 * torch.einsum("bki,bki->bk", eTs, QfeT)
    Vx = torch.zeros((Bsz, K, n), **z)
    Vxx = torch.zeros((Bsz, K, n, n), **z)
    V0 = torch.zeros((Bsz, K), **z)
    R = R[:, None]
    for k in range(N - 1, -1, -1):
        is_term = T == k + 1
        Vx = torch.where(is_term[..., None], QfeT[:, k, None], Vx)
        Vxx = torch.where(is_term[..., None, None], QfT[:, None], Vxx)
        V0 = torch.where(is_term, V0T[:, k, None], V0)

        Ak, Bk = A[:, k, None], B[:, k, None]
        AkT, BkT = Ak.transpose(-1, -2), Bk.transpose(-1, -2)
        Qx = lx[:, k, None] + (AkT @ Vx[..., None])[..., 0]
        Qu = lu[:, k, None] + (BkT @ Vx[..., None])[..., 0]
        BV = BkT @ Vxx
        Qxx = Qstage[:, k, None] + AkT @ Vxx @ Ak
        Quu = R + BV @ Bk
        Qux = BV @ Ak

        Quu_reg = sym(Quu) + lam_I
        yu = psd_solve(Quu_reg, Qu, levels=psd_levels)
        Yx = psd_solve(Quu_reg, Qux, levels=psd_levels)
        QuxT = Qux.transpose(-1, -2)
        Vx_new = Qx - (QuxT @ yu[..., None])[..., 0]
        Vxx_new = sym(Qxx - QuxT @ Yx)
        V0_new = l0[:, k, None] + V0 - 0.5 * (Qu * yu).sum(-1)

        active = k < T
        Vx = torch.where(active[..., None], Vx_new, Vx)
        Vxx = torch.where(active[..., None, None], Vxx_new, Vxx)
        V0 = torch.where(active, V0_new, V0)
    return V0


def _bruteforce_inputs(system, prob, X, U):
    from timeopt_tpu_torch.solver.backward import stage_expansion

    _, _, lx, lu, l0, Qstage = stage_expansion(system, prob, X, U)
    eTs = wrap_error(X[:, 1:] - prob.xg[:, None], prob.wrap_mask[:, None])
    return lx, lu, l0, Qstage, eTs, sym(prob.Qf), prob.R


def value_expansion_V0(system, prob, A, B, X, U, T, *, lm_lambda: float = 1e-6, psd_levels: int = 2) -> torch.Tensor:
    """V0(0) of the full quadratic value expansion with the terminal at
    step T (B,) of each problem -> (B,)."""
    args = _bruteforce_inputs(system, prob, X, U)
    return _build.in_f64(_value_expansion_arrays, A, B, *args, T[:, None], lm_lambda=lm_lambda,
                         psd_levels=psd_levels)[:, 0]


def bruteforce_J_curve(system, prob, A, B, X, U, *, lm_lambda: float = 1e-6, psd_levels: int = 2) -> torch.Tensor:
    """J(T) for every T = 1..N of the given window (A, B, U (B, N, .),
    X (B, N+1, n)): the exact quadratic-model curve (B, N), with no T_min
    mask (argmin_T applies it). On float32 inputs the recursion runs in
    float64 and the curve comes back in float32 (the counterpart of the JAX
    package's df32 brute force, solver/bruteforce_df.py)."""
    Bsz, N = U.shape[:2]
    T = torch.arange(1, N + 1, device=X.device).expand(Bsz, N)
    args = _bruteforce_inputs(system, prob, X, U)
    return _build.in_f64(_value_expansion_arrays, A, B, *args, T, lm_lambda=lm_lambda, psd_levels=psd_levels)
