"""Propagator and brute-force consistency check (port of
timeopt_tpu/solver/verify.py): the propagator's J(T) curve beside the exact
quadratic-model curve of the brute force on the same trajectories, the
`consistency_max_abs` / `consistency_rmse` columns of the suite runner.

The propagator curve comes from the unfused select
(solver/horizon.py::propagator_select with the factored query), so on the
card it runs the prefix-scan and terminal-query kernels. On a float32
trajectory both curves are float32, as in the JAX function: the blocks,
C and the propagator's J in float32 around float64 recursions (the
kernels' float32 entries), and the brute force's float64 recursion with
its curve rounded to float32 (horizon.bruteforce_J_curve)."""

from __future__ import annotations

import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
from timeopt_tpu_torch.solver.horizon import bruteforce_J_curve, propagator_select
from timeopt_tpu_torch.solver.linearize import linearize


@full_matmul_precision
def consistency_check(
    system: System,
    prob: Problem,
    X: torch.Tensor,
    U: torch.Tensor,
    *,
    linearize_mode: str = "ad",
    psd_levels: int = 2,
    lm_lambda: float = 1e-6,
) -> dict:
    """Compare the propagator and brute-force J(T) curves on a batch of
    trajectories X (B, N+1, n), U (B, N, m).

    Returns dict(max_abs (B,), rmse (B,), J_prop (B, T_max), J_bf
    (B, T_max)), the differences taken over T in [T_min, T_max]. With the
    brute force's regularization lm_lambda = 1e-6 the difference is that
    regularization; with lm_lambda = 0 the factored propagator matches the
    exact quadratic model up to the q_reg and jitter regularization. TF32
    is off inside (ops/precision.py)."""
    Tm = prob.T_max
    A, B = linearize(system.step, X, U, linearize_mode)
    Xh, Uh, Ah, Bh = X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], B[:, :Tm]

    blocks = build_augmented(system, prob, Xh, Uh, Ah, Bh, psd_levels=psd_levels)
    C = build_terminal_factors(prob, Xh, s=blocks.s)
    J_prop = blocks.s[:, :1] ** 2 * propagator_select(
        blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv, C, psd_levels=psd_levels, terminal_mode="factored"
    )
    J_bf = bruteforce_J_curve(system, prob, Ah, Bh, Xh, Uh, psd_levels=psd_levels, lm_lambda=lm_lambda)

    d = (J_prop - J_bf)[:, prob.T_min - 1 :]
    return {
        "max_abs": d.abs().amax(dim=1),
        "rmse": torch.sqrt(torch.mean(torch.square(d), dim=1)),
        "J_prop": J_prop,
        "J_bf": J_bf,
    }
