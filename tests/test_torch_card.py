"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU (marker `cuda`) and skips without one.
The file imports torch and numpy only, so it runs where JAX is absent:

    python -m pytest tests/test_torch_card.py --noconftest -q

Inputs come from the port's own CPU path (rollout, AD linearization) at a
small size, then move to the card. Tolerances are those of chip_smoke.py:
select J (fused or generic) within rtol 1e-9 for T >= T_min; prefix scan
E, F, G within 1e-9 of each matrix's largest entry, the query J and the
scan + query J within rtol 1e-9 for T >= T_min; backward kappa/K within
rtol 1e-9 / atol 1e-12 with identical ok; line search X, U, J within
rtol 1e-10 / atol 1e-12 with identical acceptance. The kernels contract
FMAs and use the device's sin/cos/tan, so they are not bitwise equal to the
plain versions.

Two inputs need more room, for reasons outside the kernels. On an iterate
with noisy controls the select's plain version (explicit inverses, the JAX
reference's algorithm) itself loses digits: against a long-double run of
the same math it is off by up to 2.8e-8 where the kernel's solve-based
compose is off by 2e-10, so there the bound is rtol 1e-7. A diverging
rollout amplifies the last-bit differences without bound, so the line
search compares trajectories only where an alpha improves on J_old.

The scan's and the query's float32 entries are held to their plain
versions as above (J within F32_RTOL, one float32 rounding) and to their
float64 entries on the upcast inputs bit for bit.

The line search's start-state entry (the one-pass method's shifted-gain
rollouts start at X_ext[:, S], not at row 0 of their reference rows) is
held to the plain version at the same tolerance, and one-pass solves on
the card to the CPU's. So are latency-mode solves (scan_mode
"associative" and "assoc_df": plain torch scans, then the query kernel),
and parallel/'s sharded solve and select over every card to the
unsharded ones (rtol 1e-12).

A system with device_id None runs the line-search kernel generated from its
own functions (ops/dyngen.py): held to the plain version as above and to
the registry system's hand-written kernel within rtol 1e-12, and its
solves to the CPU's.

The Jacobian kernel (csrc/linearize.cu) is held to linearize_ad run in
float64 on the same card inputs: the same non-finite entries, rtol 1e-12
at float64 and half a float32 spacing more at float32; a captured
quadrotor solve with it inside to its eager driver, bit for bit.

The 6-DoF lander (Rocket6DoF, n = 14, m = 3) takes the fused select's wide
size tier and the backward pass's (14, 3): its rows join the select,
backward, line-search, float32 and Jacobian tests above at their
tolerances, and a traced lander build counts the wide tier. Its initial
rollout, one launch of the line-search kernel, is held to rollout's torch
steps at the line search's tolerances.

The fused select's sweeps divide a zero by x * pv (warpmat.cuh quot): at
each of its size tiers it is also held, at the select's rtol 1e-9, on
random step inputs with exact zeros inside the matrices and negative
pivots (chip_smoke.random_fused_args).
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.ops import _build, cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan
from timeopt_tpu_torch.solver.augmented import build_augmented, build_fused_inputs, build_terminal_factors
from timeopt_tpu_torch.solver.horizon import brb
from timeopt_tpu_torch.solver.backward import backward_inputs
from timeopt_tpu_torch.solver.cost import argmin_T, cost_true, rollout
from timeopt_tpu_torch.solver.forward import select_first_improving
from timeopt_tpu_torch.solver.ilqr import SolveOptions, broadcast_problem, solve_batch
from timeopt_tpu_torch.solver.linearize import linearize

pytestmark = pytest.mark.cuda
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.05)


def _chip_smoke():
    """chip_smoke.py, for its random inputs of shapes no system has."""
    spec = importlib.util.spec_from_file_location("chip_smoke_card", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _settle():
    """Book the launches of the captured solves run so far (a card solve's
    books are settled from the device's loop counters when read)."""
    from timeopt_tpu_torch.solver import compiled

    compiled.settle_launches()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda", 0)


def _iterate(case, B=4, N=32, seed=0, noise=0.05):
    """Problems and a nominal (u_ref plus noise) with its Jacobians, built on
    the CPU."""
    system, mk = get_system(case)
    base = mk(N=N, device="cpu").replace(T_min=N // 4, T_max=N)
    rng = np.random.default_rng(seed)
    x0 = base.x0.numpy() + np.asarray(system.sigma_x0) * rng.standard_normal((B, system.n))
    probs = broadcast_problem(base, B).replace(x0=torch.as_tensor(x0))
    U = probs.u_ref[:, None] + noise * torch.as_tensor(rng.standard_normal((B, N, system.m)))
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    return system, probs, X, U.contiguous(), A.contiguous(), Bj.contiguous()


def _close(a, b, rtol, atol):
    assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    f = torch.isfinite(a)
    assert bool(((a - b).abs() <= atol + rtol * b.abs())[f].all()), (a - b).abs()[f].max().item()


@pytest.mark.parametrize("case,noise,rtol", [("Quadrotor", 0.0, 1e-9), ("Quadrotor", 0.05, 1e-7),
                                             ("DoubleIntegrator", 0.05, 1e-9), ("Rocket6DoF", 0.0, 1e-9),
                                             ("Rocket6DoF", 0.05, 1e-7)])
def test_select_kernel_matches_plain(dev, case, noise, rtol):
    system, probs, X, U, A, Bj = _iterate(case, noise=noise)
    fi = build_fused_inputs(system, probs, X, U, A, Bj, psd_levels=1)
    args = [t.contiguous().to(dev) for t in (fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)]
    n0 = cuda_lft.LAUNCHES
    J_k = cuda_lft.propagator_select_fused(*args, t_min=probs.T_min)
    assert cuda_lft.LAUNCHES == n0 + 1
    J_p = cuda_lft.select_fused_plain(*args)
    t = probs.T_min - 1
    assert torch.isinf(J_k[:, :t]).all()
    _close(J_k[:, t:], J_p[:, t:], rtol, 0.0)
    s0 = fi.s[:, :1].to(dev) ** 2
    assert torch.equal(argmin_T(s0 * J_k, probs.T_min, probs.T_max), argmin_T(s0 * J_p, probs.T_min, probs.T_max))


@pytest.mark.parametrize("case,noise,B,t_min", [
    ("PointMass_Navigation", 0.0, 4, None), ("PointMass_Navigation", 0.05, 4, None), ("Quadrotor", 0.0, 4, None),
    ("DoubleIntegrator", 0.05, 37, 1), ("DoubleIntegrator", 0.05, 37, "N"),
    ("Cartpole_SwingUp", 0.0, 37, 1), ("Cartpole_SwingUp", 0.0, 37, "N"),
])
def test_generic_select_kernel_matches_plain(dev, case, noise, B, t_min):
    """PointMass iterates (its obstacle Hessian makes Q_aug vary with k) and
    the quadrotor's assembled blocks, which have no extra cost, exercise the
    largest p = 13, m = 4; the double integrator (p = 3) and the cart-pole
    (p = 5, m = 1) at B = 37 leave the last block half full (two problems
    a block at p = 3 and 5), with T_min = 1 (every step queried) and N (one
    query). On the cart-pole's blocks the plain version (explicit inverses)
    loses digits at the zero theta weight (1e-2 to 0.4 relative here), so
    the kernel's J is held to the scan+query kernel chain, which takes the
    kernel's operation order in other code (chip_smoke.py's CHAIN_BOUND,
    rtol 1e-12), and to a long-double run of its own math, with its argmin
    T* (chip_smoke.py's WITNESS_SELECT_REL)."""
    system, probs, X, U, A, Bj = _iterate(case, B=B, N=64 if case == "PointMass_Navigation" else 32, noise=noise)
    t_min = {None: probs.T_min, "N": probs.N}.get(t_min, t_min)
    blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=1)
    C = build_terminal_factors(probs, X, s=blk.s)
    args = [t.contiguous().to(dev) for t in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C)]
    n0 = cuda_lft_generic.LAUNCHES
    J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=t_min)
    assert cuda_lft_generic.LAUNCHES == n0 + 1
    t = t_min - 1
    assert torch.isinf(J_k[:, :t]).all()
    J_p = cuda_lft_generic.select_generic_plain(*args)
    if case == "Cartpole_SwingUp":
        pre = cuda_lft_scan.lft_scan(args[0], brb(args[1], args[3]), args[2], levels=1)
        _close(J_k[:, t:], cuda_lft_query.lft_query(*pre, args[4], levels=1)[:, t:], 1e-12, 0.0)
        # the long-double witness of the kernel's math (chip_smoke.py's
        # WITNESS_SELECT_REL): J within 1e-3, argmin T* equal or tied
        # within 1e-9 of the witness's J
        J_w = _chip_smoke().select_generic_longdouble(args, torch.arange(B)).to(dev)
        _close(J_k[:, t:], J_w[:, t:], 1e-3, 0.0)
        s0 = blk.s[:, :1].to(dev) ** 2
        T_k, T_w = argmin_T(s0 * J_k, t_min, probs.T_max), argmin_T(s0 * J_w, t_min, probs.T_max)
        rows = torch.arange(B, device=dev)
        Jk, Jw = J_w[rows, T_k - 1], J_w[rows, T_w - 1]
        assert bool(((T_k == T_w) | ((Jk - Jw).abs() <= 1e-9 * Jw.abs())).all())
        return
    _close(J_k[:, t:], J_p[:, t:], 1e-9, 0.0)
    s0 = blk.s[:, :1].to(dev) ** 2
    assert torch.equal(argmin_T(s0 * J_k, t_min, probs.T_max), argmin_T(s0 * J_p, t_min, probs.T_max))


@pytest.mark.parametrize("p,m,t_min", [(4, 1, 1), (2, 1, 1), (9, 3, "N"), (13, 8, 1)])
def test_generic_select_run_time_sizes_match_plain(dev, p, m, t_min):
    """p other than the registry's 3 and 5 takes the kernel's run-time-size
    path: random well-conditioned blocks (chip_smoke.random_select_args) at
    B = 37, against the plain version within rtol 1e-9."""
    cs = _chip_smoke()
    N = 24
    t_min = N if t_min == "N" else t_min
    args = cs.random_select_args(p, m, 37, N, dev)
    J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=t_min)
    assert torch.isinf(J_k[:, : t_min - 1]).all()
    _close(J_k[:, t_min - 1 :], cuda_lft_generic.select_generic_plain(*args)[:, t_min - 1 :], 1e-9, 0.0)


def ladder_inputs():
    """Prefix-scan blocks (A_aug, BRB, Q_aug) and query inputs (E, F, G, C)
    whose first jitter rung is singular. With A_aug = 0 and BRB = 0, G = 0,
    so the step-1 compose inverts sym(E_1) + 1e-9 I with E_1 = (-1e9 I)^-1,
    which is exactly -1e-9 I: zero. Q_aug at step 2 is -1e-9 I, so its
    element's first rung is zero too. The query's X0 = E when F = 0, and
    E = -1e-9 I at one (b, t) makes its first rung zero."""
    B, N, p = 2, 3, 3
    eye = np.eye(p)
    A = np.zeros((B, N, p, p))
    BRB = np.zeros((B, N, p, p))
    Q = np.stack([eye, -1e9 * eye, -1e-9 * eye])[None].repeat(B, 0)
    Q[1, 2] = 2.0 * eye
    E = np.broadcast_to(eye, (B, N, p, p)).copy()
    E[0, 1] = -1e-9 * eye
    C = np.concatenate([np.eye(p - 1), np.ones((p - 1, 1))], axis=1)[None, None].repeat(B, 0).repeat(N, 1)
    return A, BRB, Q, (E, np.zeros_like(E), np.zeros_like(E), C)


def _normwise(k, p):
    """Largest |k - p| of each trailing matrix over its largest |p|."""
    return ((k - p).abs().amax(dim=(-1, -2)) / p.abs().amax(dim=(-1, -2))).max().item()


@pytest.mark.parametrize("case,levels", [("Quadrotor", 1), ("Quadrotor", 2), ("DoubleIntegrator", 2)])
def test_scan_and_query_kernels_match_plain(dev, case, levels):
    system, probs, X, U, A, Bj = _iterate(case, noise=0.0)
    blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=levels)
    C = build_terminal_factors(probs, X, s=blk.s).to(dev)
    args = [t.contiguous().to(dev) for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)]
    n0 = (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES)
    pre_k = cuda_lft_scan.lft_scan(*args, levels=levels)
    pre_p = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    for k, p in zip(pre_k, pre_p):
        assert _normwise(k, p) <= 1e-9
    J_k = cuda_lft_query.lft_query(*pre_k, C, levels=levels)
    assert (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    J_p = cuda_lft_query.lft_query_plain(*pre_p, C, levels=levels)
    t = probs.T_min - 1
    # the query alone on the plain prefixes, then the whole kernel chain
    _close(cuda_lft_query.lft_query(*pre_p, C, levels=levels)[:, t:], J_p[:, t:], 1e-9, 0.0)
    _close(J_k[:, t:], J_p[:, t:], 1e-9, 0.0)
    s0 = blk.s[:, :1].to(dev) ** 2
    assert torch.equal(argmin_T(s0 * J_k, probs.T_min, probs.T_max), argmin_T(s0 * J_p, probs.T_min, probs.T_max))


@pytest.mark.parametrize("levels", [1, 2])
def test_scan_and_query_ladder_on_the_card(dev, levels):
    A, BRB, Q, qargs = ladder_inputs()
    args = [torch.as_tensor(x, device=dev) for x in (A, BRB, Q)]
    for k, p in zip(cuda_lft_scan.lft_scan(*args, levels=levels), cuda_lft_scan.lft_scan_plain(*args, levels=levels)):
        _close(k, p, 1e-12, 0.0)
    q = [torch.as_tensor(x, device=dev) for x in qargs]
    J_k = cuda_lft_query.lft_query(*q, levels=levels)
    _close(J_k, cuda_lft_query.lft_query_plain(*q, levels=levels), 1e-12, 0.0)
    assert bool(torch.isfinite(J_k).all()) == (levels == 2)


def _scan_query_vs_plain(args, C, levels):
    """The scan and query kernels against their plain versions on the card:
    (scan kernel, plain scan, query kernel on the plain prefixes, plain
    query), one launch of each kernel."""
    n0 = (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES)
    pre_k = cuda_lft_scan.lft_scan(*args, levels=levels)
    pre_p = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    J_k = cuda_lft_query.lft_query(*pre_p, C, levels=levels)
    assert (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    return pre_k, pre_p, J_k, cuda_lft_query.lft_query_plain(*pre_p, C, levels=levels)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("p,m,N", [(4, 1, 48), (9, 3, 48), (2, 1, 24), (13, 4, 1), (3, 1, 1), (5, 2, 2)])
def test_scan_and_query_kernels_on_random_blocks(dev, p, m, N, levels):
    """Random well-conditioned blocks (chip_smoke.random_select_args) at
    B = 37, so the scan's last block of two problems holds one: p = 2, 4
    and 9 take the kernels' run-time-size paths, and N = 1 and 2 the
    shortest scans. Prefixes within 1e-9 of each matrix's largest entry, J
    within rtol 1e-9."""
    A, Bm, Q, Ri, C = _chip_smoke().random_select_args(p, m, 37, N, dev)
    pre_k, pre_p, J_k, J_p = _scan_query_vs_plain((A, brb(Bm, Ri).contiguous(), Q), C, levels)
    for k, q in zip(pre_k, pre_p):
        assert k.shape == (37, N, p, p) and _normwise(k, q) <= 1e-9
    _close(J_k, J_p, 1e-9, 0.0)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("p", [4, 5, 13])
def test_scan_and_query_kernels_take_rung_two(dev, p, levels):
    """chip_smoke.random_rung2_args at B = 37: rung 1 fails in the element
    at a quarter of the steps of every third problem, in the compose and the
    query at every step of another third. At levels 1 the same problems'
    prefixes are non-finite in kernel and plain; at levels 2 everything is
    finite, each prefix matrix within 1e-7 of its largest entry (a zero
    matrix exactly zero) and J within rtol 1e-9 of the plain versions. The
    prefixes' room: rung 2 inverts sym(Q_aug) + 1e-5 I with a 1e-5 pivot
    beside O(1) entries, where the plain version's explicit inverse and the
    kernel's solve differ by up to 7.9e-9 normwise (p = 5, levels 2, on the
    card)."""
    args, C = _chip_smoke().random_rung2_args(p, 37, 48, dev)
    pre_k, pre_p, J_k, J_p = _scan_query_vs_plain(args, C, levels)
    for k, q in zip(pre_k, pre_p):
        fin = torch.isfinite(q).all(dim=-1).all(dim=-1)
        assert torch.equal(torch.isfinite(k).all(dim=-1).all(dim=-1), fin)
        assert bool(fin.all()) == (levels == 2)
        d, ref = (k - q).abs().amax(dim=(-1, -2)), q.abs().amax(dim=(-1, -2))
        assert bool((d[fin] <= 1e-7 * ref[fin]).all())
    if levels == 2:
        assert bool(torch.isfinite(J_k).all())
    _close(J_k, J_p, 1e-9, 0.0)


def test_scan_and_query_take_one_or_two_levels_on_the_card(dev):
    x = torch.zeros((1, 2, 3, 3), dtype=torch.float64, device=dev)
    with pytest.raises(ValueError):
        cuda_lft_scan.lft_scan(x, x, x, levels=3)
    with pytest.raises(ValueError):
        cuda_lft_query.lft_query(x, x, x, x[..., :2, :], levels=0)


@pytest.mark.parametrize("case,variant", [("Quadrotor", v) for v in ("T1", "Tmid", "TN", "nonpd", "nonfinite_eT", "T0")]
                         + [(c, "mixed") for c in ("DoubleIntegrator", "Cartpole_SwingUp", "Quadrotor", "Segway_Balance",
                                                   "Ballbot_Balance", "PointMass_Navigation", "Rocket6DoF")]
                         + [("Rocket6DoF", v) for v in ("Tmid", "nonpd")])
def test_backward_kernel_matches_plain(dev, case, variant):
    """The quadrotor's edges at B = 4, and every system at B = 37 ("mixed":
    four problems a block, the last block with one) with T* that differ
    between the problems of a block: 0, N, N/2, 1, N - 1, 3 and N + 2."""
    B = 37 if variant == "mixed" else 4
    system, probs, X, U, A, Bj = _iterate(case, B=B)
    N = U.shape[1]
    Tst = {"T1": [1] * 4, "TN": [N] * 4, "T0": [0, 3, 5, 7],
           "mixed": [(0, N, N // 2, 1, N - 1, 3, N + 2)[i % 7] for i in range(B)]}.get(variant, [N // 2, 7, N - 3, 11])
    lm = torch.full((B,), 1e-3, dtype=torch.float64)
    if variant == "nonpd":
        lm[0] = -1e4
    if variant == "nonfinite_eT":
        X = X.clone()
        X[1, Tst[1], 2] = float("nan")
    args = [A, Bj, *backward_inputs(system, probs, X, U), torch.tensor(Tst), lm]
    args = [a.to(dev) for a in args]
    kap_k, K_k, ok_k = cuda_backward.backward_truncated_core(*args)
    kap_p, K_p, ok_p = cuda_backward.backward_plain(*args)
    assert torch.equal(ok_k, ok_p)
    _close(kap_k, kap_p, 1e-9, 1e-12)
    _close(K_k, K_p, 1e-9, 1e-12)


@pytest.mark.parametrize("n,m", [(3, 1), (6, 5), (1, 1), (12, 8), (8, 2)])
def test_backward_run_time_sizes_match_plain(dev, n, m):
    """(n, m) other than the registry's takes the kernel's run-time-size
    path: random inputs (chip_smoke.random_backward_args) at B = 37 with T*
    from 0 to N + 2 mixed in a block, against the plain version as above."""
    args = _chip_smoke().random_backward_args(n, m, 37, 24, dev)
    kap_k, K_k, ok_k = cuda_backward.backward_truncated_core(*args)
    kap_p, K_p, ok_p = cuda_backward.backward_plain(*args)
    assert torch.equal(ok_k, ok_p)
    _close(kap_k, kap_p, 1e-9, 1e-12)
    _close(K_k, K_p, 1e-9, 1e-12)


@pytest.mark.parametrize("case,kappa_scale", [("Quadrotor", 1.0), ("Quadrotor", 30.0), ("Quadrotor", 1e6),
                                              ("DoubleIntegrator", 1.0), ("Cartpole_SwingUp", 1.0),
                                              ("Segway_Balance", 1.0), ("Ballbot_Balance", 1.0),
                                              ("PointMass_Navigation", 1.0), ("Rocket6DoF", 1.0), ("Rocket6DoF", 30.0)])
def test_linesearch_kernel_matches_plain(dev, case, kappa_scale):
    system, probs, X, U, A, Bj = _iterate(case)
    N = U.shape[1]
    Tst = torch.tensor([N // 2, 7, N - 3, 11])
    lm = torch.full((4,), 1e-3, dtype=torch.float64)
    kap, K, _ = cuda_backward.backward_plain(A, Bj, *backward_inputs(system, probs, X, U), Tst, lm)
    p = probs.to(dev)
    args = (system, p, X.to(dev), U.to(dev), K.to(dev), (kappa_scale * kap).to(dev), Tst.to(dev), ALPHAS)
    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*args)
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*args)
    J_old = cost_true(system, p, args[2], args[3], args[6])
    improving = Js_p < J_old[:, None]
    assert torch.equal(Js_k < J_old[:, None], improving)
    for k, q in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)):
        _close(k[improving], q[improving], 1e-10, 1e-12)
    sel_k = select_first_improving(args[2], args[3], Xs_k, Us_k, Js_k, J_old)
    sel_p = select_first_improving(args[2], args[3], Xs_p, Us_p, Js_p, J_old)
    assert torch.equal(sel_k.accepted, sel_p.accepted)
    for k, q in zip(sel_k[:3], sel_p[:3]):
        _close(k, q, 1e-10, 1e-12)


@pytest.mark.parametrize("case,B,N,t_min,noise", [
    ("DoubleIntegrator", 3, 33, 1, 0.05),  # p = 3; N odd: the last step takes ring slot 0
    ("DoubleIntegrator", 2, 32, 32, 0.05),  # T_min = N: one query, at the last step
    ("Quadrotor", 3, 33, 1, 0.0),  # p = 13, every step queried
    ("Quadrotor", 1, 31, 31, 0.0),  # a single problem, T_min = N
    ("Quadrotor", 2, 2, 1, 0.0),  # N = 2: the rings never wrap
    ("Rocket6DoF", 3, 33, 1, 0.0),  # p = 15, the wide tier, every step queried
    ("Rocket6DoF", 2, 2, 1, 0.05),  # the wide tier, N = 2
])
def test_select_kernel_edges_match_plain(dev, case, B, N, t_min, noise):
    """The select's pipeline (element, compose and query warps handing
    ring slots over) at the edges of its schedule, against the plain
    version within rtol 1e-9 (the kernel's solve-based sweeps against the
    plain explicit inverses, as test_select_kernel_matches_plain)."""
    system, probs, X, U, A, Bj = _iterate(case, B=B, N=N, noise=noise)
    fi = build_fused_inputs(system, probs, X, U, A, Bj, psd_levels=1)
    args = [t.contiguous().to(dev) for t in (fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)]
    J_k = cuda_lft.propagator_select_fused(*args, t_min=t_min)
    J_p = cuda_lft.select_fused_plain(*args)
    assert torch.isinf(J_k[:, : t_min - 1]).all()
    _close(J_k[:, t_min - 1 :], J_p[:, t_min - 1 :], 1e-9, 0.0)


@pytest.mark.parametrize("n,m", [(4, 2), (12, 4), (14, 3)])  # p = 5, 13, 15: the narrow, registry and wide tiers
def test_select_kernel_on_exact_zeros_and_negative_pivots(dev, n, m):
    """The select's sweeps where zeros skip the division (x * pv for a zero
    x, the same bits) at every size tier: random step inputs with zero rows
    of A, a zero column of B and the stage cost negated, so that every
    compose pivot is negative and the zero quotients carry a sign
    (chip_smoke.random_fused_args), against the plain version within
    chip_smoke's SELECT_BOUND of the quadrotor, with the same argmin."""
    cs = _chip_smoke()
    B, N = 5, 33
    args = cs.random_fused_args(n, m, B, N, dev, negated=True)
    A, Bm, Qq = args[0], args[1], args[4]
    assert cuda_lft.tier(n, m) == n
    assert bool((A[..., 0, :] == 0).all() and (A[..., n - 2, :] == 0).all() and (Bm[..., 0] == 0).all())
    assert torch.linalg.eigvalsh(Qq).max().item() < 0
    J_k = cuda_lft.propagator_select_fused(*args, t_min=1)
    J_p = cuda_lft.select_fused_plain(*args)
    kind, rtol = cs.SELECT_BOUND["Quadrotor"]
    assert kind == "rel"
    _close(J_k, J_p, rtol, 0.0)
    assert torch.equal(argmin_T(J_k, 1, N), argmin_T(J_p, 1, N))


@pytest.mark.parametrize("case,B,alphas,poison", [
    ("DoubleIntegrator", 17, ALPHAS, False),  # group width 2: 16 problems a block, the second block ragged
    ("Cartpole_SwingUp", 9, ALPHAS, False),  # width 4: 8 problems a block
    ("PointMass_Navigation", 9, (1.0,), False),  # width 4, one alpha
    ("Quadrotor", 3, ALPHAS + (0.02, 0.01), False),  # width 16, 2 problems a block, alphas over two blocks
    ("Quadrotor", 3, ALPHAS, True),  # rollouts the guard poisons with NaN
    ("Rocket6DoF", 3, ALPHAS + (0.02, 0.01), False),  # width 16 on the lander's struct, alphas over two blocks
])
def test_linesearch_kernel_edges_match_plain(dev, case, B, alphas, poison):
    """The grouped line search at the edges of its layout: every group
    width, blocks the batch does not fill, more alphas than a block holds,
    T* = 0, T* = N - 1 (the terminal cost at the last step), T* = N and
    T* > N (the terminal row clipped to N). X, U, J within rtol 1e-10 /
    atol 1e-12 on the improving alphas (a diverging rollout amplifies
    last-bit differences without bound), the same infinite costs, and with
    `poison` the same rollouts carrying NaN."""
    N = 24
    system, probs, X, U, A, Bj = _iterate(case, B=B, N=N)
    T = torch.tensor([[0, N - 1, N, N + 5, N // 2][i % 5] for i in range(B)])
    lm = torch.full((B,), 1e-3, dtype=torch.float64)
    kap, K, _ = cuda_backward.backward_plain(A, Bj, *backward_inputs(system, probs, X, U), T.clamp(max=N), lm)
    if poison:
        kap = 1e6 * kap
    p = probs.to(dev)
    args = (system, p, X.to(dev), U.to(dev), K.to(dev), kap.to(dev), T.to(dev), alphas)
    n0 = cuda_forward.LAUNCHES
    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*args)
    assert cuda_forward.LAUNCHES == n0 + 1
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*args)
    assert torch.equal(torch.isinf(Js_k), torch.isinf(Js_p)) and bool(torch.isinf(Js_k[T.to(dev) == 0]).all())
    nan_k = torch.isnan(Xs_k).flatten(2).any(-1)
    assert torch.equal(nan_k, torch.isnan(Xs_p).flatten(2).any(-1))
    assert bool(nan_k.any()) == poison
    J_old = cost_true(system, p, args[2], args[3], args[6])
    improving = Js_p < J_old[:, None]
    assert torch.equal(Js_k < J_old[:, None], improving)
    for k, q in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)):
        _close(k[improving], q[improving], 1e-10, 1e-12)


@pytest.mark.parametrize("case", ["Quadrotor", "PointMass_Navigation"])
@pytest.mark.parametrize("how", ["strided", "copy"])
def test_linesearch_kernel_start_state_matches_plain(dev, case, how):
    """Start states other than X[:, 0]: row 2 of X, as a strided view of X
    (rows (N+1) n apart) or as a contiguous copy, moved by 1e-3 N(0, 1)."""
    system, probs, X, U, A, Bj = _iterate(case)
    N = U.shape[1]
    Tst = torch.tensor([N // 2, 7, N - 3, 11])
    lm = torch.full((4,), 1e-3, dtype=torch.float64)
    kap, K, _ = cuda_backward.backward_plain(A, Bj, *backward_inputs(system, probs, X, U), Tst, lm)
    rng = np.random.default_rng(3)
    Xd = X.clone()
    Xd[:, 2] += 1e-3 * torch.as_tensor(rng.standard_normal(Xd[:, 2].shape))
    p = probs.to(dev)
    Xd = Xd.to(dev)
    x_start = Xd[:, 2] if how == "strided" else Xd[:, 2].contiguous()
    assert (x_start.stride(0) == (N + 1) * system.n) == (how == "strided")
    args = (system, p, X.to(dev), U.to(dev), K.to(dev), kap.to(dev), Tst.to(dev), ALPHAS)
    n0 = cuda_forward.LAUNCHES
    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*args, x_start=x_start)
    assert cuda_forward.LAUNCHES == n0 + 1
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*args, x_start=x_start)
    assert torch.equal(Xs_k[:, :, 0], x_start[:, None].expand(-1, len(ALPHAS), -1))
    J_old = cost_true(system, p, args[2], args[3], args[6])
    improving = Js_p < J_old[:, None]
    assert torch.equal(Js_k < J_old[:, None], improving) and bool(improving.any())
    for k, q in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)):
        _close(k[improving], q[improving], 1e-10, 1e-12)


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_onepass_solve_on_the_card_matches_cpu(dev, case):
    """The one-pass method on the card (backward and line-search kernels,
    the line search also from start states) against the CPU's plain path."""
    system, mk = get_system(case)
    base = (mk(N=24, device="cpu").replace(T_min=4, T_max=16) if case == "DoubleIntegrator"
            else mk(N=40, device="cpu").replace(T_min=10, T_max=40))
    rng = np.random.default_rng(2)
    sigma = torch.as_tensor(system.sigma_x0 if case != "DoubleIntegrator" else (0.2, 0.2))
    probs = broadcast_problem(base, 3).replace(x0=base.x0 + sigma * torch.as_tensor(rng.standard_normal((3, system.n))))
    opts = SolveOptions(method="onepass", max_iter=4, S_window=5)
    counts = (cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)
    got = solve_batch(system, probs.to(dev), options=opts)
    _settle()
    assert all(c1 > c0 for c0, c1 in zip(counts, (cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)))
    want = solve_batch(system, probs, options=opts)
    for f in ("T_star", "n_accept", "n_fallback"):
        assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), f
    _close(got.J_star.cpu(), want.J_star, 1e-8, 0.0)


F32_RTOL = 3e-7  # kernel and plain agree to ~1e-9 in float64; each rounds to float32 once (1 ulp = 1.2e-7)


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator", "Cartpole_SwingUp", "PointMass_Navigation",
                                  "Rocket6DoF"])
def test_float32_kernels_match_plain(dev, case):
    """The float32 instantiations (float32 in device memory, float64 in
    registers) of the select (fused, or generic for PointMass), the
    backward pass and both line-search entries against their plain versions
    (float64 on the float32 values, rounded once): within F32_RTOL, the
    same non-finite pattern, ok and acceptance identical. Inputs: the
    float64 iterate cast to float32, the select's at the float32 default
    q_reg 1e-5."""
    system, probs, X, U, A, Bj = _iterate(case, B=5)
    f32 = lambda t: t.float().contiguous().to(dev)  # noqa: E731
    p32 = probs.replace(**{f: (t.float() if t.is_floating_point() else t).to(dev) for f, t in probs.tensors().items()})
    t = probs.T_min - 1
    if system.extra_cost is None:
        fi = build_fused_inputs(system, probs, X, U, A, Bj, q_reg=1e-5, psd_levels=1)
        args = [f32(a) for a in (fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)]
        mod, J_p = cuda_lft, cuda_lft.select_fused_plain(*args)
        n0 = mod.LAUNCHES
        J_k = cuda_lft.propagator_select_fused(*args, t_min=probs.T_min)
    else:
        blk = build_augmented(system, probs, X, U, A, Bj, q_reg=1e-5, psd_levels=1)
        args = [f32(a) for a in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, build_terminal_factors(probs, X, s=blk.s))]
        mod, J_p = cuda_lft_generic, cuda_lft_generic.select_generic_plain(*args)
        n0 = mod.LAUNCHES
        J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=probs.T_min)
    assert mod.LAUNCHES == n0 + 1 and J_k.dtype == torch.float32 and torch.isinf(J_k[:, :t]).all()
    _close(J_k[:, t:], J_p[:, t:], F32_RTOL, 0.0)

    N = U.shape[1]
    Tst = torch.tensor([N // 2, 7, N - 3, 11, 0], device=dev)
    bw = [f32(a) for a in (A, Bj, *backward_inputs(system, probs, X, U))] + [Tst, torch.full((5,), 1e-3, device=dev)]
    kap_k, K_k, ok_k = cuda_backward.backward_truncated_core(*bw)
    kap_p, K_p, ok_p = cuda_backward.backward_plain(*bw)
    assert kap_k.dtype == K_k.dtype == torch.float32 and torch.equal(ok_k, ok_p) and ok_k.tolist()[-1] is False
    _close(kap_k, kap_p, F32_RTOL, 1e-12)
    _close(K_k, K_p, F32_RTOL, 1e-12)

    J_old = cost_true(system, p32, f32(X), f32(U), Tst)
    for x_start in (None, f32(X[:, 0] + 0.01)):
        args = (system, p32, f32(X), f32(U), K_p, kap_p, Tst, ALPHAS)
        Xs_k, Us_k, Js_k = cuda_forward.linesearch(*args, x_start=x_start)
        Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*args, x_start=x_start)
        assert Xs_k.dtype == Us_k.dtype == Js_k.dtype == torch.float32
        improving = Js_p < J_old[:, None]
        assert torch.equal(Js_k < J_old[:, None], improving) and bool(improving.any())
        for k, q in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)):
            _close(k[improving], q[improving], F32_RTOL, 1e-12)


def _bits(a):
    return a.contiguous().view(torch.int64 if a.dtype == torch.float64 else torch.int32)


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("shape", ["Quadrotor", "DoubleIntegrator", "random p=4", "random p=9"])
def test_float32_scan_and_query_match_plain_and_the_float64_entries(dev, shape, levels):
    """The float32 entries of the scan and the query (float32 blocks and C
    read from device memory, float64 arithmetic, float64 prefixes, J
    rounded to float32 once), on a registry shape (p = 13, 3) and on the
    run-time-size path (p = 4, 9; B = 37, so the scan's last block holds
    one problem): against their plain versions, prefixes within 1e-9 of
    each matrix's largest entry and J within F32_RTOL; and bit for bit
    equal to the float64 entries on the upcast inputs (the float32 to
    float64 conversion is exact and the arithmetic the same code), J to the
    float64 J rounded once."""
    if shape.startswith("random"):
        A, Bm, Q, Ri, C = _chip_smoke().random_select_args(int(shape[-1]), 2, 37, 48, dev)
        args = [t.float().contiguous() for t in (A, brb(Bm, Ri), Q)]
        C, t = C.float().contiguous(), 0
    else:
        system, probs, X, U, A, Bj = _iterate(shape, noise=0.0)
        blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=levels)
        C = build_terminal_factors(probs, X, s=blk.s).float().contiguous().to(dev)
        args = [x.float().contiguous().to(dev) for x in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)]
        t = probs.T_min - 1
    n0 = (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES)
    pre = cuda_lft_scan.lft_scan(*args, levels=levels)
    J = cuda_lft_query.lft_query(*pre, C, levels=levels)
    assert (cuda_lft_scan.LAUNCHES, cuda_lft_query.LAUNCHES) == (n0[0] + 1, n0[1] + 1)
    assert all(x.dtype == torch.float64 for x in pre) and J.dtype == torch.float32
    pre_p = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    for k, q in zip(pre, pre_p):
        assert _normwise(k, q) <= 1e-9
    _close(J[:, t:], cuda_lft_query.lft_query_plain(*pre_p, C, levels=levels)[:, t:], F32_RTOL, 0.0)
    pre64 = cuda_lft_scan.lft_scan(*(x.double() for x in args), levels=levels)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(pre, pre64))
    J64 = cuda_lft_query.lft_query(*pre, C.double(), levels=levels)
    assert torch.equal(_bits(J), _bits(J64.float()))


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_float32_solve_on_the_card_matches_cpu(dev, case):
    """A float32 solve on the card against the CPU's (plain versions, the
    same float64 arithmetic): T* and acceptances identical, J* within
    rtol 1e-5 (float32 results, different rounding paths in between)."""
    system, mk = get_system(case)
    base = (mk(N=24, device="cpu", dtype=torch.float32).replace(T_min=4, T_max=16) if case == "DoubleIntegrator"
            else mk(N=40, device="cpu", dtype=torch.float32).replace(T_min=10, T_max=40))
    rng = np.random.default_rng(1)
    sigma = torch.as_tensor(system.sigma_x0 if case != "DoubleIntegrator" else (0.2, 0.2))
    x0 = base.x0 + (sigma * torch.as_tensor(rng.standard_normal((3, system.n)))).float()
    probs = broadcast_problem(base, 3).replace(x0=x0)
    opts = SolveOptions(max_iter=6)
    select = cuda_lft if system.extra_cost is None else cuda_lft_generic
    counts = (select.LAUNCHES, cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)
    got = solve_batch(system, probs.to(dev), options=opts)
    _settle()
    assert all(c1 > c0 for c0, c1 in zip(counts, (select.LAUNCHES, cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)))
    want = solve_batch(system, probs, options=opts)
    assert got.J_star.dtype == torch.float32 and got.X.dtype == torch.float32
    assert torch.equal(got.T_star.cpu(), want.T_star) and torch.equal(got.n_accept.cpu(), want.n_accept)
    _close(got.J_star.cpu(), want.J_star, 1e-5, 0.0)


def test_float32_on_the_card_raises(dev):
    """What the float32 entries refuse: float32 prefixes into the query (the
    prefixes are float64 on both paths), a scan's blocks of mixed dtypes;
    and float16 on every kernel."""
    x = torch.zeros((1, 2, 2, 2), dtype=torch.float32, device=dev)
    with pytest.raises(TypeError):
        cuda_lft_query.lft_query(x, x, x, x[..., :1, :], levels=1)
    with pytest.raises(TypeError):
        cuda_lft_scan.lft_scan(x, x.double(), x, levels=1)
    h = x.half()
    with pytest.raises(TypeError):
        cuda_lft_scan.lft_scan(h, h, h, levels=1)
    with pytest.raises(TypeError):
        cuda_lft.propagator_select_fused(h, h, h, h, h, h, h, t_min=1)
    with pytest.raises(TypeError):
        cuda_backward.backward_truncated_core(*([h] * 12))


@pytest.mark.parametrize("case", ["DoubleIntegrator", "Quadrotor", "PointMass_Navigation"])
def test_system_without_device_dynamics_raises(dev, case):
    """A system with device_id None launches the line-search kernel
    generated from its own functions (ops/dyngen.py, built at this first
    call), counted on dyngen.LAUNCHES, at both entries: within rtol 1e-10 /
    atol 1e-12 of the plain version on the improving alphas, and within
    rtol 1e-12 of the registry system's hand-written kernel. (The name is
    the one this test had while such a system raised on the card.)"""
    from timeopt_tpu_torch.ops import dyngen

    system, probs, X, U, A, Bj = _iterate(case)
    nodev = dataclasses.replace(system, device_id=None)
    N = U.shape[1]
    T = torch.tensor([N // 2, 7, N - 3, N])
    lm = torch.full((4,), 1e-3, dtype=torch.float64)
    kap, K, _ = cuda_backward.backward_plain(A, Bj, *backward_inputs(system, probs, X, U), T, lm)
    p = probs.to(dev)
    args = (p, X.to(dev), U.to(dev), K.to(dev), kap.to(dev), T.to(dev), ALPHAS)
    J_old = cost_true(system, p, args[1], args[2], args[5])
    for x_start in (None, args[1][:, 0].contiguous()):
        n0, h0 = dyngen.LAUNCHES, cuda_forward.LAUNCHES
        got = cuda_forward.linesearch(nodev, *args, x_start=x_start)
        assert (dyngen.LAUNCHES, cuda_forward.LAUNCHES) == (n0 + 1, h0)
        hand = cuda_forward.linesearch(system, *args, x_start=x_start)
        plain = cuda_forward.linesearch_plain(system, *args, x_start=x_start)
        improving = plain[2] < J_old[:, None]
        assert torch.equal(got[2] < J_old[:, None], improving) and torch.equal(hand[2] < J_old[:, None], improving)
        for k, q, h in zip(got, plain, hand):
            _close(k[improving], q[improving], 1e-10, 1e-12)
            _close(k[improving], h[improving], 1e-12, 0.0)


@pytest.mark.parametrize("method", ["propagator", "onepass"])
def test_system_without_device_dynamics_solve_raises_on_the_card(dev, method):
    """solve_batch of a system with device_id None on the card runs the
    generated line search (and never the plain one) and matches its CPU
    solve: T* and n_accept identical, J* within rtol 1e-8. (The name is
    the one this test had while such a solve raised on the card.)"""
    from timeopt_tpu_torch.ops import dyngen
    from timeopt_tpu_torch.solver import forward

    system, probs = _small_batch("DoubleIntegrator", 5)
    nodev = dataclasses.replace(system, name="DI_nodev", device_id=None)
    opts = SolveOptions(method=method, max_iter=3, psd_levels=1, S_window=5)
    counts = (dyngen.LAUNCHES, cuda_forward.LAUNCHES)
    plain = forward.rollout_with_gains
    forward.rollout_with_gains = None  # the plain line search must not run on the card
    try:
        got = solve_batch(nodev, probs.to(dev), options=opts)
    finally:
        forward.rollout_with_gains = plain
    _settle()
    assert dyngen.LAUNCHES > counts[0] and cuda_forward.LAUNCHES == counts[1]
    want = solve_batch(nodev, probs, options=opts)
    assert torch.equal(got.T_star.cpu(), want.T_star) and torch.equal(got.n_accept.cpu(), want.n_accept)
    _close(got.J_star.cpu(), want.J_star, 1e-8, 0.0)


def test_argmin_T_on_the_card_matches_cpu(dev):
    curves = torch.tensor([[3.0, float("nan"), 1.0, 1.0], [4.0, 2.0, 2.0, 5.0], [float("inf"), 1.0, 0.5, 0.5]],
                          dtype=torch.float64)
    for T_min, T_max in ((1, 4), (2, 4), (3, 4)):
        assert torch.equal(argmin_T(curves.to(dev), T_min, T_max).cpu(), argmin_T(curves, T_min, T_max))


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_solve_on_the_card_matches_cpu(dev, case):
    system, mk = get_system(case)
    base = (mk(N=24, device="cpu").replace(T_min=4, T_max=16) if case == "DoubleIntegrator"
            else mk(N=40, device="cpu").replace(T_min=10, T_max=40))
    rng = np.random.default_rng(1)
    sigma = torch.as_tensor(system.sigma_x0 if case != "DoubleIntegrator" else (0.2, 0.2))
    probs = broadcast_problem(base, 3).replace(x0=base.x0 + sigma * torch.as_tensor(rng.standard_normal((3, system.n))))
    opts = SolveOptions(max_iter=6, psd_levels=1)
    select = cuda_lft if system.extra_cost is None else cuda_lft_generic
    counts = (select.LAUNCHES, cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)
    got = solve_batch(system, probs.to(dev), options=opts)
    _settle()
    assert all(c1 > c0 for c0, c1 in zip(counts, (select.LAUNCHES, cuda_backward.LAUNCHES, cuda_forward.LAUNCHES)))
    want = solve_batch(system, probs, options=opts)
    assert torch.equal(got.T_star.cpu(), want.T_star) and torch.equal(got.n_accept.cpu(), want.n_accept)
    _close(got.J_star.cpu(), want.J_star, 1e-8, 0.0)


def _small_batch(case, seed):
    system, mk = get_system(case)
    base = (mk(N=24, device="cpu").replace(T_min=4, T_max=16) if case == "DoubleIntegrator"
            else mk(N=40, device="cpu").replace(T_min=10, T_max=40))
    rng = np.random.default_rng(seed)
    sigma = torch.as_tensor(system.sigma_x0 if case != "DoubleIntegrator" else (0.2, 0.2))
    return system, broadcast_problem(base, 3).replace(
        x0=base.x0 + sigma * torch.as_tensor(rng.standard_normal((3, system.n))))


@pytest.mark.parametrize("mode", ["associative", "assoc_df"])
@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_latency_mode_on_the_card_matches_cpu(dev, case, mode):
    """Latency mode on the card (plain torch scans, then the query kernel;
    no sequential select kernel) against the CPU's plain path."""
    system, probs = _small_batch(case, 3)
    opts = SolveOptions(max_iter=6, psd_levels=1, scan_mode=mode)
    counts = (cuda_lft.LAUNCHES, cuda_lft_generic.LAUNCHES, cuda_lft_query.LAUNCHES)
    got = solve_batch(system, probs.to(dev), options=opts)
    _settle()
    assert (cuda_lft.LAUNCHES, cuda_lft_generic.LAUNCHES) == counts[:2] and cuda_lft_query.LAUNCHES > counts[2]
    want = solve_batch(system, probs, options=opts)
    assert torch.equal(got.T_star.cpu(), want.T_star) and torch.equal(got.n_accept.cpu(), want.n_accept)
    _close(got.J_star.cpu(), want.J_star, 1e-8, 0.0)


def test_sharded_solve_and_select_on_the_card(dev):
    """parallel/ over every card: the sharded solve and the hs-sharded
    select equal the unsharded ones (T* identical, J* and J(T) within rtol
    1e-12)."""
    from timeopt_tpu_torch.parallel import make_mesh, propagator_select_sharded, solve_batch_sharded

    system, probs = _small_batch("DoubleIntegrator", 4)
    probs = probs.to(dev)
    opts = SolveOptions(max_iter=6, psd_levels=1)
    got = solve_batch_sharded(system, probs, options=opts, mesh=make_mesh())
    want = solve_batch(system, probs, options=opts)
    assert torch.equal(got.T_star, want.T_star) and torch.equal(got.T_ties, want.T_ties)
    _close(got.J_star, want.J_star, 1e-12, 0.0)
    X, U = want.X[:, :17], want.U[:, :16]
    A, Bj = linearize(system.step, want.X, want.U)
    blk = build_augmented(system, probs, X, U, A[:, :16], Bj[:, :16])
    C = build_terminal_factors(probs, X, s=blk.s)
    from timeopt_tpu_torch.solver.horizon import propagator_select

    mesh = make_mesh(axis_names=("dp", "hs"), shape=(1, torch.cuda.device_count()))
    for mode in ("sequential", "associative"):
        J = propagator_select_sharded(blk, C, mesh, scan_mode=mode)
        _close(J, propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, scan_mode=mode), 1e-12, 0.0)


def _bitwise(got, want):
    for f in dataclasses.fields(got):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        if a.is_floating_point():
            assert torch.equal(torch.isnan(a), torch.isnan(b)), f.name
            a, b = torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)
        assert torch.equal(a, b), f.name


@pytest.mark.parametrize("method", ["propagator", "bruteforce", "onepass", "onepass-newton"])
@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_captured_solve_equals_the_eager_driver(dev, case, method):
    """solve_batch on the card (one launch of the loop graph around the
    captured init and step graphs) against the eager driver _solve_traced on
    the same card: every result field bit for bit, twice (a refilled
    program), with the same kernel launches per solve once settled. "onepass-newton" takes the Newton preimages, whose
    torch.linalg.solve_ex is captured too."""
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare

    mods = (cuda_lft, cuda_lft_generic, cuda_backward, cuda_forward, cuda_lft_query, cuda_lft_scan)
    system, probs = _small_batch(case, 6)
    probs, U = prepare(probs.to(dev), None)
    preimage = "newton" if method == "onepass-newton" else "fixedpoint"
    opts = SolveOptions(method=method.split("-")[0], max_iter=6, psd_levels=1, S_window=5, onepass_preimage=preimage)
    compiled.clear_compiled()
    solve_batch(system, probs, options=opts)  # builds the program
    compiled.settle_launches()
    counts = [m.LAUNCHES for m in mods]
    got = solve_batch(system, probs, options=opts)
    compiled.settle_launches()
    captured = [m.LAUNCHES - c for m, c in zip(mods, counts)]
    counts = [m.LAUNCHES for m in mods]
    want = compiled._solve_traced(system, opts, probs, U)
    eager = [m.LAUNCHES - c for m, c in zip(mods, counts)]
    _bitwise(got, want)
    assert captured == eager and sum(eager) > 0
    assert len(compiled.programs()) == 1 and compiled.programs()[0].graphs is not None
    _bitwise(solve_batch(system, probs, options=opts), want)


def test_captured_launch_counts_equal_eager_under_replay(dev):
    """The launch counts of a captured solve, settled from the loop's
    counters, equal the eager solve's, module by module, at float32 and in the inverse query too (the scan kernel)."""
    from timeopt_tpu_torch.solver import compiled

    mods = (cuda_lft, cuda_lft_generic, cuda_backward, cuda_forward, cuda_lft_query, cuda_lft_scan)
    system, probs = _small_batch("DoubleIntegrator", 7)
    compiled.clear_compiled()
    for dtype, kw in ((torch.float32, {}), (torch.float64, dict(terminal_mode="inverse"))):
        p = _build.cast(probs, dtype).to(dev)
        opts = SolveOptions(max_iter=6, psd_levels=1, **kw)
        runs = []
        for fn in (lambda: solve_batch(system, p, options=opts),) * 2 + (
                lambda: compiled._solve_traced(system, opts, p, p.u_ref[:, None].expand(-1, p.N, -1).contiguous()),):
            compiled.settle_launches()
            before = [m.LAUNCHES for m in mods]
            fn()
            compiled.settle_launches()
            runs.append([m.LAUNCHES - b for m, b in zip(mods, before)])
        assert runs[1] == runs[2], runs  # the first call also warmed up and captured
        assert runs[0][2] == runs[2][2] + 2  # the warm-up: one init and one step, one backward each


def test_host_read_in_a_system_raises_on_the_card(dev):
    """A System whose step reads a tensor to the host (.item()) solves on the
    CPU (eagerly) and makes solve_batch raise on the card, naming the op and
    the line, instead of running eagerly there."""
    from timeopt_tpu_torch.solver.compiled import CaptureError

    base, probs = _small_batch("DoubleIntegrator", 8)
    step = lambda x, u: base.step(x, u) * (1.0 + 0.0 * float(x.sum()))  # noqa: E731
    system = dataclasses.replace(base, name="DI_host_read", step=step)
    opts = SolveOptions(max_iter=3, psd_levels=1, linearize_mode="central")  # the step outside vmap
    solve_batch(system, probs, options=opts)
    with pytest.raises(CaptureError, match="_local_scalar_dense") as err:
        solve_batch(system, probs.to(dev), options=opts)
    assert "test_torch_card.py" in str(err.value)
    got = solve_batch(base, probs.to(dev), options=opts)  # the card still solves
    assert torch.isfinite(got.J_star).all()


def _quadrotor_sets(dev, B: int, seeds, dtype=torch.float32):
    """The quadrotor's default problem at B, x0[:, :3] perturbed by 0.4
    N(0, 1) draws of each seed (bench.py's rule), on the card."""
    system, mk = get_system("Quadrotor")
    base = mk(device="cpu", dtype=dtype)
    out = []
    for seed in seeds:
        x0 = np.tile(base.x0.double().numpy(), (B, 1))
        x0[:, :3] += 0.4 * np.random.default_rng(seed).standard_normal((B, 3))
        out.append(broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, dtype=dtype)).to(dev))
    return system, out


def test_warm_solve_reads_nothing_back(dev, monkeypatch):
    """A warmed solve_batch on the card is one launch of the loop graph:
    under torch.cuda.set_sync_debug_mode("error") it raises nothing, and
    its result and its launches equal the eager driver's; the steps on the
    loop's counter (read after) and the loop_cond launches booked from the
    counters are the steps the eager driver takes, counted in its bodies."""
    from timeopt_tpu_torch.ops import cuda_loop
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare

    system, (probs,) = _quadrotor_sets(dev, 64, [0])
    opts = SolveOptions(max_iter=12, psd_levels=1)
    solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    compiled.settle_launches()
    before = [m.LAUNCHES for m in compiled._launch_modules()] + [cuda_loop.LAUNCHES]
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = solve_batch(system, probs, options=opts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    p, U = prepare(probs, None)
    prog = compiled.program(system, opts, p, U)
    steps = prog.iterations()
    compiled.settle_launches()
    captured = [m.LAUNCHES - b for m, b in zip(list(compiled._launch_modules()) + [cuda_loop], before)]
    before = [m.LAUNCHES for m in compiled._launch_modules()]
    plain, taken = compiled.bodies, []

    def counted(o):
        b = plain(o)
        return compiled.Bodies(b.state, b.init, lambda *a: (taken.append(1), b.step(*a)))

    monkeypatch.setattr(compiled, "bodies", counted)
    want = compiled._solve_traced(system, opts, p, U)
    eager = [m.LAUNCHES - b for m, b in zip(compiled._launch_modules(), before)]
    _bitwise(got, want)
    assert captured[:-1] == eager and 0 < len(taken) <= 12
    assert steps == len(taken) and captured[-1] == 1 + len(taken)


def test_resident_solve_over_every_card_reads_nothing_back(dev):
    """parallel.solve_batch_resident over every card (one chunk a card, as
    bench_torch.py's default), warmed: under
    torch.cuda.set_sync_debug_mode("error") it raises nothing, and each
    chunk's result is bitwise its own solve_batch."""
    from timeopt_tpu_torch.parallel import make_mesh, shard_problems, solve_batch_resident

    cards = torch.cuda.device_count()
    system, (probs,) = _quadrotor_sets("cpu", 16 * cards, [7])
    parts = shard_problems(probs, make_mesh())
    assert [q.x0.device.index for q in parts] == list(range(cards))
    opts = SolveOptions(max_iter=12, psd_levels=1)
    solve_batch_resident(system, parts, options=opts)
    for i in range(cards):
        torch.cuda.synchronize(i)
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = solve_batch_resident(system, parts, options=opts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for r, q in zip(got, parts):
        _bitwise(r, solve_batch(system, q, options=opts))


def test_four_queued_solves_on_one_program(dev):
    """Four solves of four different problem sets queued on one program
    with no sync between them: each result bitwise that set's solve run
    alone."""
    system, sets = _quadrotor_sets(dev, 64, range(4))
    opts = SolveOptions(max_iter=12, psd_levels=1)
    alone = []
    for probs in sets:
        alone.append(solve_batch(system, probs, options=opts))
        torch.cuda.synchronize()
    queued = [solve_batch(system, probs, options=opts) for probs in sets]
    torch.cuda.synchronize()
    for got, want in zip(queued, alone):
        _bitwise(got, want)
    assert len({float(r.J_star.sum()) for r in queued}) == 4


def test_eviction_with_a_launch_queued(dev, monkeypatch):
    """A program dropped from the cache while its launch may still be
    queued (the next program's build comes right after it): its device is
    synchronized before its graphs go, and its result stays its solve."""
    from timeopt_tpu_torch.solver import compiled

    compiled.clear_compiled()
    monkeypatch.setattr(compiled, "MAX_PROGRAMS", 1)
    system, (probs,) = _quadrotor_sets(dev, 64, [5])
    opts = SolveOptions(max_iter=12, psd_levels=1)
    got = solve_batch(system, probs, options=opts)
    solve_batch(system, probs, options=SolveOptions(max_iter=11, psd_levels=1))  # evicts the first
    assert len(compiled.programs()) == 1
    from timeopt_tpu_torch.solver.ilqr import prepare

    _bitwise(got, compiled._solve_traced(system, opts, *prepare(probs, None)))
    compiled.clear_compiled()


# ---------------------------------------------------------------------------
# Tracing (utils/trace.py): stamps inside the loop graph, one clock
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["Quadrotor", "PointMass_Navigation"])
def test_traced_program_is_bitwise_the_untraced(dev, case):
    """A program built with tracing on (its captures holding the stamp
    kernels, inside the loop graph's WHILE body) answers bitwise as the
    program built with tracing off, and its rows name every step it ran."""
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare
    from timeopt_tpu_torch.utils import trace

    if case == "Quadrotor":
        system, (probs,) = _quadrotor_sets(dev, 64, [21])
    else:
        system, probs, _, _, _, _ = _iterate(case, B=64, N=64, seed=21)
        probs = probs.to(dev)
    opts = SolveOptions(max_iter=12, psd_levels=1)
    want = solve_batch(system, probs, options=opts)
    trace.reset()
    with trace.recording(dev):
        got = solve_batch(system, probs, options=opts)
        prog = compiled.program(system, opts, *prepare(probs, None))
        steps = prog.iterations()
    torch.cuda.synchronize()
    _bitwise(got, want)
    assert prog.traced and prog.stamps["init"] > 0 and prog.stamps["step"] > 0
    recs = [r for r in trace.records() if r.track == "device" and r.program == prog.id]
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == ["init"] + ["step"] * steps
    assert [r.iteration for r in tops] == [-1] + list(range(steps))
    assert trace.dropped() == 0
    compiled.clear_compiled()


def test_untraced_build_captures_no_stamp(dev):
    """With tracing off a build launches and captures no stamp (the stamp
    wrapper's launch book stays as it was, nothing booked per capture);
    with tracing on each capture holds stamps, and a solve books them."""
    from timeopt_tpu_torch.ops import cuda_trace
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare
    from timeopt_tpu_torch.utils import trace

    compiled.clear_compiled()
    system, (probs,) = _quadrotor_sets(dev, 32, [22])
    opts = SolveOptions(max_iter=4, psd_levels=1)
    before = cuda_trace.LAUNCHES
    solve_batch(system, probs, options=opts)
    compiled.settle_launches()
    prog = compiled.program(system, opts, *prepare(probs, None))
    assert cuda_trace.LAUNCHES == before and prog.stamps == {"init": 0, "step": 0} and prog.log is None
    with trace.recording(dev):
        solve_batch(system, probs, options=opts)
        traced = compiled.program(system, opts, *prepare(probs, None))
    compiled.settle_launches()
    assert traced is not prog and traced.stamps["init"] > 0 and traced.stamps["step"] > 0
    compiled.clear_compiled()


def test_stamps_lie_within_their_calls_on_one_clock(dev):
    """Four queued solves, traced: each launch's first and last device
    stamps, on the host's clock fitted by calibrate(), lie between the
    host's enqueue of its call and the host's sight of its completion,
    within the calibration's uncertainty, which is under 50 us; the
    clock's resolution is reported."""
    import time

    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.utils import trace

    system, sets = _quadrotor_sets(dev, 64, range(30, 34))
    opts = SolveOptions(max_iter=12, psd_levels=1)
    trace.reset()
    with trace.recording(dev):
        solve_batch(system, sets[0], options=opts)  # builds the traced program
        torch.cuda.synchronize()
        trace.drain()
        marks = []
        for probs in sets:
            t0 = time.perf_counter_ns()
            res = solve_batch(system, probs, options=opts)
            ev = torch.cuda.Event()
            ev.record()
            marks.append((t0, ev, res))
        done = []
        for t0, ev, _ in marks:
            ev.synchronize()
            done.append((t0, time.perf_counter_ns()))
    cal = trace.calibration()
    print(f"[trace clock] {torch.cuda.get_device_name(dev)}: {cal}")
    assert 0 < cal["uncertainty_ns"] < 50_000 and cal["resolution_ns"] > 0
    recs = [r for r in trace.records() if r.track == "device"]
    prog = max(r.program for r in recs)
    for launch, (t0, t1) in enumerate(done, start=1):
        mine = [r for r in recs if r.program == prog and r.launch == launch]
        first, last = min(r.t0 for r in mine), max(r.t1 for r in mine)
        unc = cal["uncertainty_ns"]
        assert trace.device_ns(t0) - unc <= first < last <= trace.device_ns(t1) + unc, launch
    compiled.clear_compiled()


# ---- the Jacobian kernel of the registry systems (csrc/linearize.cu)

REGISTRY = ("DoubleIntegrator", "Quadrotor", "Cartpole_SwingUp", "Segway_Balance", "Ballbot_Balance",
            "PointMass_Navigation", "Rocket6DoF")


def _linearize_inputs(case, dev, dtype):
    """A real iterate's X, U of the case (B=4, N=32) on the card in dtype,
    with a NaN state entry (problem 1, step 5, the last state) and a NaN
    control (problem 3, step 7) and, on the quadrotor, a guarded pitch
    (problem 2, step 3: |cos theta| < 1e-3, the step poisoned, its
    Jacobian finite)."""
    system, _, X, U, _, _ = _iterate(case)
    X, U = X.clone(), U.clone()
    X[1, 5, system.n - 1] = float("nan")
    U[3, 7, 0] = float("nan")
    if case == "Quadrotor":
        X[2, 3, 7] = np.pi / 2 - 5e-4
    return system, X.to(dev, dtype), U.to(dev, dtype)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", REGISTRY)
def test_linearize_kernel_matches_ad(dev, case, dtype):
    """linearize (mode "ad") of a registry system's step on the card is one
    launch of the Jacobian kernel, held to linearize_ad (vmap(jacfwd)) in
    float64 on the same card inputs (upcast where float32): the same
    non-finite entries, and the finite ones within rtol 1e-12 (atol 1e-15)
    at float64, within half a float32 spacing of the float64 AD value plus
    that margin at float32 (one rounding of the float64 Jacobian). The
    guarded quadrotor state keeps a finite Jacobian. Rows a batch stride
    apart (a view, as one-pass's X_ext[:, :S + 1]) give the same bits as
    the whole arrays' first steps."""
    from timeopt_tpu_torch.ops import cuda_linearize
    from timeopt_tpu_torch.solver.linearize import linearize_ad

    system, X, U = _linearize_inputs(case, dev, dtype)
    before = cuda_linearize.LAUNCHES
    A, Bj = linearize(system.step, X, U)
    assert cuda_linearize.LAUNCHES == before + 1
    wA, wB = linearize_ad(system.step, X.double(), U.double())
    if case == "Quadrotor":
        assert bool(torch.isfinite(A[2, 3]).all()) and A[2, 3].abs().max().item() > 100.0
    for g, w in ((A, wA), (Bj, wB)):
        assert g.dtype == dtype and g.is_contiguous() and g.shape == w.shape
        assert torch.equal(torch.isfinite(g), torch.isfinite(w))
        f = torch.isfinite(w)
        g, w = g.double()[f], w[f]
        room = 1e-12 * w.abs() + 1e-15
        if dtype == torch.float32:
            w32 = w.float().abs()
            room = room + 0.5 * (torch.nextafter(w32, torch.full_like(w32, float("inf"))) - w32).double()
        assert bool(((g - w).abs() <= room).all()), ((g - w).abs() - room).max().item()
    Av, Bv = linearize(system.step, X[:, :9], U[:, :8])
    assert torch.equal(Av.nan_to_num(7.0), A[:, :8].nan_to_num(7.0))
    assert torch.equal(Bv.nan_to_num(7.0), Bj[:, :8].nan_to_num(7.0))


def test_linearize_kernel_refuses(dev):
    """The kernel's wrapper launches or raises: CPU tensors, float16, rows
    that are not contiguous, and a system id whose sizes are not the
    inputs' all raise, and nothing is counted."""
    from timeopt_tpu_torch.ops import cuda_linearize

    system, X, U = _linearize_inputs("Quadrotor", dev, torch.float64)
    before = cuda_linearize.LAUNCHES
    with pytest.raises(ValueError):
        cuda_linearize.jacobians(1, system.dt, X.cpu(), U.cpu())
    with pytest.raises(TypeError):
        cuda_linearize.jacobians(1, system.dt, X.half(), U.half())
    with pytest.raises(TypeError):
        cuda_linearize.jacobians(1, system.dt, X, U.float())
    with pytest.raises(ValueError):
        cuda_linearize.jacobians(1, system.dt, X.transpose(0, 1).contiguous().transpose(0, 1), U)
    with pytest.raises(RuntimeError):
        cuda_linearize.jacobians(0, system.dt, X, U)  # the double integrator's sizes are not these
    assert cuda_linearize.LAUNCHES == before


def test_captured_quadrotor_solve_takes_the_jacobian_kernel(dev, monkeypatch):
    """A float32 quadrotor solve_batch on the card (the main path) with the
    Jacobian kernel captured inside: every field bitwise its eager driver
    _solve_traced, one kernel launch for init and one a step, the same on
    both drivers, and linearize_ad never run."""
    from timeopt_tpu_torch.ops import cuda_linearize
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver import linearize as lin
    from timeopt_tpu_torch.solver.ilqr import prepare

    def refused(*a, **k):
        raise AssertionError("linearize_ad ran on the card for a registry system")

    monkeypatch.setattr(lin, "linearize_ad", refused)
    system, (probs,) = _quadrotor_sets(dev, 32, [11])
    opts = SolveOptions(max_iter=12, psd_levels=1)
    compiled.clear_compiled()
    solve_batch(system, probs, options=opts)  # builds the program
    compiled.settle_launches()
    before = cuda_linearize.LAUNCHES
    got = solve_batch(system, probs, options=opts)
    p, U = prepare(probs, None)
    steps = compiled.program(system, opts, p, U).iterations()
    compiled.settle_launches()
    captured = cuda_linearize.LAUNCHES - before
    before = cuda_linearize.LAUNCHES
    want = compiled._solve_traced(system, opts, p, U)
    _bitwise(got, want)
    assert captured == cuda_linearize.LAUNCHES - before == 1 + steps and steps > 0


# ---- the 6-DoF lander: the wide size tier on the solve's path


def test_traced_rocket_build_counts_the_wide_tier(dev, monkeypatch):
    """A float32 lander solve (B = 64, N = 48) on the card: a traced
    program's build counts its select and backward launches at the wide
    tier (utils/trace.py::count), an untraced one counts nothing, and the
    two give the same bits; the solve never runs linearize_ad (vmap(jacfwd))
    or a generated line search, and every answer is finite."""
    from timeopt_tpu_torch.ops import cuda_linearize, dyngen
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver import linearize as lin
    from timeopt_tpu_torch.utils import trace

    def refused(*a, **k):
        raise AssertionError("linearize_ad ran on the card for the lander")

    monkeypatch.setattr(lin, "linearize_ad", refused)

    system, mk = get_system("Rocket6DoF")
    base = mk(N=48, device=dev, dtype=torch.float32).replace(T_min=12, T_max=48)
    rng = np.random.default_rng(5)
    x0 = base.x0.double().cpu().numpy() + np.asarray(system.sigma_x0) * rng.standard_normal((64, 14))
    probs = broadcast_problem(base, 64).replace(x0=torch.as_tensor(x0, dtype=torch.float32, device=dev))
    opts = SolveOptions(max_iter=6)
    compiled.clear_compiled()
    trace.reset()
    lin0, gen0 = cuda_linearize.LAUNCHES, dyngen.LAUNCHES
    plain = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize(dev)
    with trace.recording(dev):
        traced = solve_batch(system, probs, options=opts)
        torch.cuda.synchronize(dev)
    progs = compiled.programs()
    _settle()
    counted = {p.traced: trace.counts(p.spans["build"]) for p in progs}
    assert counted[False] == {}
    assert counted[True].get("select.tier14", 0) >= 2 and counted[True].get("backward.tier14", 0) >= 2
    assert set(counted[True]) == {"select.tier14", "backward.tier14"}
    assert cuda_linearize.LAUNCHES > lin0 and dyngen.LAUNCHES == gen0
    _bitwise(traced, plain)
    assert bool(torch.isfinite(plain.J_star).all()) and bool(((plain.T_star >= 12) & (plain.T_star <= 48)).all())
    compiled.clear_compiled()
    trace.reset()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_rocket_kernel_rollout_matches_rollout(dev, dtype):
    """The lander's initial rollout on the card (solver/cost.py::
    rollout_kernel: one launch of the line-search kernel at T* = 0) against
    rollout's torch steps on the same card inputs: the same NaN states (a
    NaN control, a guarded zero thrust, a state past the norm guard), the
    finite ones within the line search's rtol 1e-10 / atol 1e-12 at
    float64 and F32_RTOL at float32."""
    from timeopt_tpu_torch.solver.cost import rollout_kernel

    system, mk = get_system("Rocket6DoF")
    assert system.kernel_rollout
    B, N = 6, 40
    base = mk(N=N, device=dev, dtype=dtype)
    rng = np.random.default_rng(11)
    x0 = base.x0.double().cpu().numpy() + np.asarray(system.sigma_x0) * rng.standard_normal((B, 14))
    probs = broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, dtype=dtype, device=dev))
    U = probs.u_ref[:, None].expand(B, N, 3) + 0.3 * torch.as_tensor(rng.standard_normal((B, N, 3)), dtype=dtype,
                                                                       device=dev)
    U[1, 7, 0] = float("nan")
    U[2, 5] = 0.0
    U[3, 9, 0] = 1e9
    before = cuda_forward.LAUNCHES
    got = rollout_kernel(system, probs, probs.x0, U)
    assert cuda_forward.LAUNCHES == before + 1
    want = rollout(system, probs, probs.x0, U)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert bool(torch.isnan(got[1:4, -1]).all()) and bool(torch.isfinite(got[[0, 4, 5]]).all())
    rtol, atol = (1e-10, 1e-12) if dtype == torch.float64 else (F32_RTOL, 1e-12)
    torch.testing.assert_close(got, want, rtol=rtol, atol=atol, equal_nan=True)
