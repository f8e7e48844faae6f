"""chip_smoke.py's long-double witnesses and its random inputs of shapes no
system has, on the CPU.

`backward_longdouble` recomputes the plain backward's math in numpy long
double; the card holds the backward kernel against it where the kernel and
its plain version differ (PointMass at B=1024). `select_generic_longdouble`
recomputes the generic select kernel's math (its solve-based order) in long
double; the card holds the kernel's argmin T* to it where the plain version
loses digits (the cart-pole's blocks). `scan_longdouble` recomputes the prefix-scan kernel's math in long double;
the card holds the scan kernel's prefixes to it where the plain scan loses
digits (the cart-pole's and PointMass's oracle iterates). `random_backward_args`
and `random_select_args` feed the kernels' run-time-size paths,
`random_rung2_args` the jitter ladder's second rung. These tests need no
card.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from timeopt_tpu_torch.ops import cuda_backward, cuda_lft_generic, cuda_lft_scan
from timeopt_tpu_torch.ops.linalg import psd_inv
from timeopt_tpu_torch.solver.augmented import build_augmented
from timeopt_tpu_torch.solver.horizon import brb
from timeopt_tpu_torch.solver.cost import rollout
from timeopt_tpu_torch.solver.ilqr import default_U_init
from timeopt_tpu_torch.solver.linearize import linearize
from timeopt_tpu_torch.models import get_system

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_witness", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


cs = _chip_smoke()


def _all_rows(args):
    return torch.arange(args[0].shape[0])


@pytest.mark.parametrize("n,m", [(3, 1), (6, 5), (4, 2), (12, 4), (1, 1)])
def test_longdouble_witness_matches_plain_on_random_inputs(n, m):
    args = cs.random_backward_args(n, m, 9, 20, CPU)
    kap_p, K_p, _ = cuda_backward.backward_plain(*args)
    kap_w, K_w = cs.backward_longdouble(args, _all_rows(args))
    assert cs.within(kap_p, kap_w, 1e-9, 1e-12)
    assert cs.within(K_p, K_w, 1e-9, 1e-12)


@pytest.mark.parametrize("case", ["DoubleIntegrator", "PointMass_Navigation"])
def test_longdouble_witness_matches_plain_on_an_iterate(case):
    """A solve's first iterate (U = u_ref) of a small problem set, at the
    plain T* of the middle of the horizon, rows picked out of order."""
    system, mk = get_system(case)
    probs = cs.oracle_problems(system, mk, 5, CPU)
    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    T = torch.tensor([probs.N // 2, probs.N, 1, 0, probs.N - 3])
    args = cs.backward_args(system, probs, X, U, A, Bj, T, 1e-3)
    kap_p, K_p, _ = cuda_backward.backward_plain(*args)
    rows = torch.tensor([4, 0, 1])
    kap_w, K_w = cs.backward_longdouble(args, rows)
    assert cs.within(kap_p[rows], kap_w, 1e-9, 1e-12)
    assert cs.within(K_p[rows], K_w, 1e-9, 1e-12)


def test_witness_gate_passes_the_plain_version_and_fails_a_perturbed_one():
    args = cs.random_backward_args(4, 2, 8, 16, CPU)
    kap, K, _ = cuda_backward.backward_plain(*args)
    cs.witness_backward(args, (kap, K), (kap, K), 1e-8, "plain as kernel")
    with pytest.raises(RuntimeError, match="long-double"):
        cs.witness_backward(args, (kap * (1 + 1e-6), K), (kap, K), 1e-8, "perturbed kernel")


def test_random_backward_args_are_seeded_and_well_formed():
    a = cs.random_backward_args(6, 5, 7, 11, CPU)
    b = cs.random_backward_args(6, 5, 7, 11, CPU)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    shapes = [(7, 11, 6, 6), (7, 11, 6, 5), (7, 11, 6), (7, 11, 5), (7, 11, 6, 6), (7, 11, 6), (7, 11), (7, 11),
              (7, 6, 6), (7, 5, 5), (7,), (7,)]
    assert [tuple(x.shape) for x in a] == shapes
    for S in (a[4], a[8], a[9]):  # Qstage, Qf, R: exactly symmetric, positive definite
        assert torch.equal(S, S.transpose(-1, -2))
        assert bool((torch.linalg.eigvalsh(S) > 0).all())
    assert a[10].tolist() == [0, 11, 5, 1, 10, 3, 13]
    assert a[10].dtype == torch.int64 and all(x.dtype == torch.float64 for i, x in enumerate(a) if i != 10)


@pytest.mark.parametrize("p,m", [(4, 1), (9, 3)])
def test_random_select_args_are_augmented_blocks(p, m):
    A, Bm, Q, Rinv, C = cs.random_select_args(p, m, 5, 6, CPU)
    n = p - 1
    assert (A.shape, Bm.shape, Q.shape, Rinv.shape, C.shape) == ((5, 6, p, p), (5, 6, p, m), (5, 6, p, p), (5, m, m),
                                                                 (5, 6, n, p))
    assert bool((A[..., n, :n] == 0).all()) and bool((A[..., n, n] == 1).all()) and bool((Bm[..., n, :] == 0).all())
    for S in (Q, Rinv):
        assert torch.equal(S, S.transpose(-1, -2))
        assert bool((torch.linalg.eigvalsh(S) > 0).all())
    J = cuda_lft_generic.select_generic_plain(A, Bm, Q, Rinv, C)
    assert bool(torch.isfinite(J).all()) and bool((J > 0).all())


def test_off_registry_shapes_are_off_the_registry():
    """The random shapes must reach the kernels' run-time-size paths: no
    system of the registry has them."""
    shapes = {(s.n, s.m) for s in (get_system(c)[0] for c in cs.CASES)}
    assert not shapes & set(cs.OFF_REGISTRY_BACKWARD)
    assert not {n + 1 for n, _ in shapes} & {p for p, _ in cs.OFF_REGISTRY_SELECT}
    assert np.all([m <= 8 and n <= 12 for n, m in cs.OFF_REGISTRY_BACKWARD])


@pytest.mark.parametrize("p,m", [(4, 1), (9, 3), (5, 2)])
def test_longdouble_select_matches_plain_on_random_blocks(p, m):
    args = cs.random_select_args(p, m, 5, 24, CPU)
    J_p = cuda_lft_generic.select_generic_plain(*args)
    J_w = cs.select_generic_longdouble(args, torch.arange(5))
    assert cs.within(J_p, J_w, 1e-12, 0.0)


def _blocks(case: str, B: int, N: int):
    """The assembled blocks of a first iterate (U = u_ref) of B problems
    whose x0 draws are those of the oracle sets, cut to N steps."""
    system, mk = get_system(case)
    probs = cs.oracle_problems(system, mk, B, CPU)
    probs = probs.replace(N=N, T_min=N // 4, T_max=N) if N < probs.N else probs
    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    args, s = cs.generic_block_args(system, probs, X, U, A, Bj)
    return probs, args, s


def test_longdouble_select_is_near_plain_where_it_keeps_its_digits():
    """The quadrotor's blocks, where the plain version keeps its digits
    (2e-9 relative, chip_smoke.py's GENERIC_BLOCKS_BOUND)."""
    probs, args, _ = _blocks("Quadrotor", 3, 160)
    t = probs.T_min - 1
    J_p = cuda_lft_generic.select_generic_plain(*args)
    J_w = cs.select_generic_longdouble(args, torch.arange(3))
    assert cs.within(J_p[:, t:], J_w[:, t:], 2e-9, 0.0)


def test_select_witness_fails_the_plain_version_where_it_loses_digits():
    """On the cart-pole's blocks the plain version (explicit inverses) loses
    digits at the zero theta weight, and its argmin T* is not tied to the
    long-double witness's: the witness gate fails it and passes the
    witness itself."""
    probs, args, s = _blocks("Cartpole_SwingUp", 3, 32)
    J_p = cuda_lft_generic.select_generic_plain(*args)
    J_w = cs.select_generic_longdouble(args, torch.arange(3))
    cs.witness_select(args, J_w, J_p, s, probs, "witness as kernel")
    with pytest.raises(RuntimeError, match="long-double"):
        cs.witness_select(args, J_p, J_p, s, probs, "plain as kernel")
    t = probs.T_min - 1
    assert ((J_p - J_w).abs() / J_w.abs())[:, t:].max().item() > 10 * cs.WITNESS_SELECT_REL


@pytest.mark.parametrize("B,N", [(3, 32), (8, 360)])
def test_kernel_order_in_double_is_within_the_witness_bound(B, N):
    """The generic select kernel's solve-based order run in float64 (as the
    kernel runs it) stays within a fifth of chip_smoke.py's
    WITNESS_SELECT_REL of its long-double run on the cart-pole's blocks, its
    argmin T* tied, where the plain version (explicit inverses) is off by
    more than 10x the bound."""
    probs, args, s = _blocks("Cartpole_SwingUp", B, N)
    rows, t = torch.arange(B), probs.T_min - 1
    J_w = cs.select_generic_longdouble(args, rows)
    J_d = cs.select_generic_longdouble(args, rows, dtype=np.float64)
    J_p = cuda_lft_generic.select_generic_plain(*args)
    assert ((J_d - J_w).abs() / J_w.abs())[:, t:].max().item() <= cs.WITNESS_SELECT_REL / 5
    cs.witness_select(args, J_d, J_p, s, probs, "kernel order in double")
    assert ((J_p - J_w).abs() / J_w.abs())[:, t:].max().item() > 10 * cs.WITNESS_SELECT_REL


def _scan_args(p, m, B, N):
    A, Bm, Q, Ri, _ = cs.random_select_args(p, m, B, N, CPU)
    return A, brb(Bm, Ri), Q


@pytest.mark.parametrize("levels", [1, 2])
@pytest.mark.parametrize("p,m", [(4, 1), (9, 3), (5, 2), (13, 4)])
def test_longdouble_scan_matches_plain_on_random_blocks(p, m, levels):
    """On well-conditioned blocks the plain scan (explicit inverses) and the
    long-double witness of the kernel's solve-based order agree within
    1e-12 of each matrix's largest entry."""
    args = _scan_args(p, m, 5, 24)
    plain = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    wit = cs.scan_longdouble(args, torch.arange(5), levels=levels)
    for x, w in zip(plain, wit):
        assert cs.normwise(x, w, "plain vs witness") <= 1e-12


def test_scan_witness_gate_passes_the_plain_scan_and_fails_a_perturbed_one():
    args = _scan_args(5, 2, 4, 16)
    pre = cuda_lft_scan.lft_scan_plain(*args, levels=2)
    read = cs.witness_scan(args, pre, pre, 2, 1e-10, "plain as kernel")
    assert max(read["kernel"]) <= 1e-12
    bent = (pre[0], pre[1] * (1 + 1e-8), pre[2])
    with pytest.raises(RuntimeError, match="long-double"):
        cs.witness_scan(args, bent, pre, 2, 1e-10, "perturbed kernel")


@pytest.mark.parametrize("p", [4, 5, 13])
def test_rung2_args_are_seeded_and_take_the_second_rung(p):
    """random_rung2_args: the same draw from the same seed; the rung-1
    element inverse is non-finite exactly at the steps of every third problem
    whose Q_aug[0, 0] is -jitter; the plain scan at levels 1 leaves those
    problems and those of the compose construction non-finite and the
    others finite, and at levels 2 (rung 2 taken) everything finite, within
    1e-9 of the long-double witness."""
    B, N = 7, 10
    (A, BRB, Q), C = cs.random_rung2_args(p, B, N, CPU)
    (A2, BRB2, Q2), C2 = cs.random_rung2_args(p, B, N, CPU)
    assert all(torch.equal(x, y) for x, y in zip((A, BRB, Q, C), (A2, BRB2, Q2, C2)))
    assert C.shape == (B, N, p - 1, p) and not torch.equal(cs.random_rung2_args(p, B, N, CPU, seed=1)[0][2], Q)
    kind = torch.arange(B) % 3
    flagged = (Q[..., 0, 0] == -1e-9) & (kind == 1)[:, None]
    assert bool(flagged[kind == 1][:, 0].all()) and not bool(flagged[kind != 1].any())
    rung1_bad = ~torch.isfinite(psd_inv(Q, levels=1)).all(dim=-1).all(dim=-1)
    assert torch.equal(rung1_bad, flagged)
    for levels in (1, 2):
        pre = cuda_lft_scan.lft_scan_plain(A, BRB, Q, levels=levels)
        fin = torch.isfinite(pre[0]).all(dim=-1).all(dim=-1).all(dim=-1)
        assert fin.tolist() == ([True] * B if levels == 2 else (kind == 0).tolist())
    wit = cs.scan_longdouble((A, BRB, Q), torch.arange(B), levels=2)
    for x, w in zip(pre, wit):
        assert cs.normwise(x, w, "plain vs witness at rung 2") <= 1e-9


@pytest.mark.parametrize("case", ["Cartpole_SwingUp", "PointMass_Navigation"])
def test_scan_kernel_order_in_double_is_within_the_witness_bound(case):
    """chip_smoke.py's SCAN_WITNESS_NORM on the oracle's final (X, U): the
    scan kernel's solve-based order run in float64 (as the kernel runs it)
    stays within a fifth of the bound of its long-double run, and the plain
    scan (explicit inverses) is off by more than the bound."""
    system, mk = get_system(case)
    orc = cs.load_oracle(case)
    probs = cs.oracle_problems(system, mk, 128, CPU)
    X, U = (torch.as_tensor(orc[k]) for k in ("X", "U"))
    A, Bj = linearize(system.step, X, U)
    blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=2)
    args = [t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)]
    rows = np.arange(128)
    wit = cs.scan_longdouble(args, rows)
    dbl = cs.scan_longdouble(args, rows, dtype=np.float64)
    plain = cuda_lft_scan.lft_scan_plain(*args, levels=2)
    bound = cs.SCAN_WITNESS_NORM[case]
    assert max(cs.normwise(x, w, "kernel order") for x, w in zip(dbl, wit)) <= bound / 5
    assert max(cs.normwise(x, w, "plain") for x, w in zip(plain, wit)) > bound
