"""Parity of the port's latency mode with the JAX package in f64 on the CPU:
scan_mode="associative" (solver/horizon.py's tree of lax.associative_scan)
and scan_mode="assoc_df" (solver/select_assoc.py, a Hillis-Steele scan over
the steps; the JAX module runs it in double-double on f64 inputs, the port
in float64).

Inputs: the assembled blocks of random LTV problems (tests/helpers.py),
N = 12, 16 and 17 (17 leaves a partial last round of the Hillis-Steele
scan and an odd level of the tree). Tolerances are the JAX package's own
(tests/test_select_assoc.py): elements, prefixes and J within rtol 1e-10,
atol 1e-12 (prefix matrices: of each matrix's largest entry); end to end
T* identical, J* within rtol 1e-9, X within rtol 1e-7 / atol 1e-9.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import random_ltv_problem, tiny_double_integrator
from tests.torch_helpers import T, iterate, problems, to_torch_problem
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu.solver import select_assoc as jsa
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.models.base import System as TorchSystem
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import horizon as thor
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver import select_assoc as tsa
from timeopt_tpu_torch.utils.timing import profile_solve

torch.set_num_threads(1)
RTOL, ATOL = 1e-10, 1e-12


@functools.lru_cache(maxsize=None)
def _blocks(N, B=2, seed=90):
    """B random LTV problems (one each) with their rolled-out nominal: the
    port's assembled blocks (A_aug, B_aug, Q_aug, R_inv, C, QT) as CPU
    tensors with a leading batch axis, and each problem's JAX
    (AugmentedBlocks, C, QT) of the same numbers."""
    rng = np.random.default_rng(seed + N)
    rows = []
    for _ in range(B):
        _, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=3, m=2, N=N)
        At, Bt = T(Ad), T(Bd)
        system = TorchSystem(name="ltv", n=3, m=2, dt=0.1, step=lambda x, u, At=At, Bt=Bt: x @ At.T + u @ Bt.T,
                             xdot=None)
        tp = to_torch_problem(jilqr.broadcast_problem(prob, 1))
        Xt, Ut = T(X)[None], T(U)[None]
        blk = taug.build_augmented(system, tp, Xt, Ut, At.expand(1, N, 3, 3), Bt.expand(1, N, 3, 2))
        C = taug.build_terminal_factors(tp, Xt, s=blk.s)
        QT = taug.build_terminal_blocks(tp, Xt, s=blk.s)
        rows.append((blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, QT))
    port = [torch.cat(x) for x in zip(*rows)]
    jax_in = [(jaug.AugmentedBlocks(*(jnp.asarray(t[b].numpy()) for t in port[:4])),
               jnp.asarray(port[4][b].numpy()), jnp.asarray(port[5][b].numpy())) for b in range(B)]
    return jax_in, port


def _normwise_close(got, want, label):
    """Each (p, p) matrix within rtol of its largest entry, plus atol."""
    d = np.abs(got - want).max(axis=(-1, -2))
    ref = np.abs(want).max(axis=(-1, -2))
    assert np.all(d <= ATOL + RTOL * ref), (label, float((d / ref).max()))


def _dd(x):
    """A double-double (hi, lo) pair of (p, p, N) arrays -> (N, p, p) numpy."""
    return np.transpose(np.asarray(x[0]) + np.asarray(x[1]), (2, 0, 1))


@pytest.mark.parametrize("N", [12, 16, 17])
def test_elements_and_hillis_steele_prefixes_match_jax(N):
    """Elements and prefixes against the JAX module's at every N; J against
    the port's sequential select at every N and against the JAX module's
    at N = 17 (its eager query costs seconds a shape)."""
    jax_in, (A, Bm, Q, Ri, C, _) = _blocks(N)
    elems = tsa.lft_elements_time(A, Bm, Q, Ri)
    pre = tsa.lft_prefix_scan_hillis_steele(elems)
    J = tsa.propagator_select_assoc(A, Bm, Q, Ri, C, t_min=1)
    np.testing.assert_allclose(J.numpy(), thor.select_generic_plain(A, Bm, Q, Ri, C).numpy(), rtol=RTOL, atol=ATOL)
    for b, (blk, jC, _) in enumerate(jax_in):
        je = jsa.lft_elements_lanes_df(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv)
        jp = jsa.lft_prefix_scan_assoc_df(je)
        for name, g, w in zip("EFG", elems, je):
            _normwise_close(g[b].numpy(), _dd(w), f"element {name}")
        for name, g, w in zip("EFG", pre, jp):
            _normwise_close(g[b].numpy(), _dd(w), f"prefix {name}")
        if N == 17:
            jJ = jsa.propagator_select_assoc_df(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, jC)
            np.testing.assert_allclose(J[b].numpy(), np.asarray(jJ), rtol=RTOL, atol=ATOL)


def _jax_associative(blk, C):
    pre = jhor.lft_prefix_scan(jhor.lft_elements(blk), mode="associative")
    return pre, jhor.propagator_J_curve_factored(pre, C)


def test_associative_prefix_scan_matches_jax():
    """N = 17: an odd length at the first level of the tree and at the
    third. The JAX prefixes and factored query jitted over the batch; its
    inverse query eagerly on those prefixes: it inverts the rank-deficient
    QT (kappa ~1e12), where XLA's fusions under jit alone move J by 2e-7
    relative."""
    jax_in, (A, Bm, Q, Ri, C, QT) = _blocks(17)
    stacked = [jax.tree.map(lambda *x: jnp.stack(x), *col) for col in zip(*jax_in)]
    jpre, jJf = jax.jit(jax.vmap(_jax_associative))(*stacked[:2])
    jJi = np.stack([np.asarray(jhor.propagator_J_curve(jhor.LFTElements(*(x[b] for x in jpre)), jQT))
                    for b, (_, _, jQT) in enumerate(jax_in)])
    pre = thor.lft_prefix_scan(thor.lft_elements(A, Bm, Q, Ri), mode="associative")
    seq = thor.lft_prefix_scan(thor.lft_elements(A, Bm, Q, Ri))
    for name, g, s, w in zip("EFG", pre, seq, jpre):
        _normwise_close(g.numpy(), np.asarray(w), f"prefix {name}")
        _normwise_close(g.numpy(), s.numpy(), f"prefix {name} vs sequential")
    for mode, term, want in (("factored", C, jJf), ("inverse", QT, jJi)):
        J = thor.propagator_select(A, Bm, Q, Ri, term, terminal_mode=mode, scan_mode="associative")
        np.testing.assert_allclose(J.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_assoc_df_keeps_its_digits_on_the_cartpole():
    """An ill-conditioned iterate: the cart-pole's zero theta weight with
    q_reg 1e-9 (kappa(Q_aug) ~1e9 and beyond), noisy controls, N 64. The
    port's LDL'-based select stays within rtol 1e-3 of the JAX module's
    (double-double on these f64 inputs) with the same argmin; explicit
    Gauss-Jordan inverses in the same scan (horizon.py's lft_elements and
    lft_compose) are off by ~0.5 there, with another argmin."""
    js, ts, jp, tp = problems("Cartpole_SwingUp", 1, 64, 16, 64, seed=5)
    X, U, A, Bm = (T(a) for a in iterate(js, jp, seed=6))
    blk = taug.build_augmented(ts, tp, X, U, A, Bm, q_reg=1e-9, psd_levels=1)
    args = (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, taug.build_terminal_factors(tp, X, s=blk.s))
    J = tsa.propagator_select_assoc(*args, t_min=16)[0, 15:].numpy()
    want = np.asarray(jsa.propagator_select_assoc_df(*(jnp.asarray(t[0].numpy()) for t in args)))[15:]
    np.testing.assert_allclose(J, want, rtol=1e-3)
    assert np.argmin(J) == np.argmin(want)


def test_assoc_t_min_mask():
    _, (A, Bm, Q, Ri, C, _) = _blocks(12)
    J = tsa.propagator_select_assoc(A, Bm, Q, Ri, C, t_min=5)
    assert torch.isinf(J[:, :4]).all() and torch.isfinite(J[:, 4:]).all()
    np.testing.assert_array_equal(J[:, 4:].numpy(), tsa.propagator_select_assoc(A, Bm, Q, Ri, C, t_min=1)[:, 4:])


def _tiny_di(B=2):
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(91)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp)


@pytest.mark.parametrize("mode", ["associative", "assoc_df"])
@pytest.mark.parametrize("case", ["tiny_di", "pointmass"])
def test_solve_matches_jax_same_scan_mode(case, mode):
    if case == "tiny_di":
        js, ts, jp, tp = _tiny_di()
        max_iter = 6
    else:
        js, ts, jp, tp = problems("PointMass_Navigation", 2, 30, 10, 30, seed=92)
        max_iter = 3
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=max_iter, scan_mode=mode))
    got = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=max_iter, scan_mode=mode))
    np.testing.assert_array_equal(got.T_star.numpy(), np.asarray(want.T_star))
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-9)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), rtol=1e-7, atol=1e-9)
    assert int(got.n_accept.min()) >= 1
    seq = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=max_iter))
    np.testing.assert_array_equal(got.T_star.numpy(), seq.T_star.numpy())
    np.testing.assert_allclose(got.J_star.numpy(), seq.J_star.numpy(), rtol=1e-9)


@pytest.mark.parametrize("mode", ["associative", "assoc_df"])
def test_phase_timers_take_the_scan_mode(mode):
    _, ts, _, tp = _tiny_di(B=1)
    opts = tilqr.SolveOptions(max_iter=6, scan_mode=mode)
    result, timers = profile_solve(ts, tp, opts)
    res = tilqr.solve(ts, tp, options=opts)
    assert result["T_star"] == int(res.T_star) and timers["select"] > 0
    np.testing.assert_allclose(result["J_hist"][-1], float(res.J_star), rtol=1e-8)


def test_scan_mode_options_are_checked():
    _, ts, _, tp = _tiny_di(B=1)
    with pytest.raises(ValueError, match="requires terminal_mode='factored'"):
        tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=1, scan_mode="assoc_df", terminal_mode="inverse"))
    with pytest.raises(ValueError, match="unknown scan_mode"):
        tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=1, scan_mode="parallel"))
    with pytest.raises(ValueError, match="unknown scan mode"):
        thor.lft_prefix_scan(thor.LFTElements(*[torch.zeros(1, 2, 3, 3)] * 3), mode="parallel")
    # the brute force ignores scan_mode, as in the JAX package
    bf = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=2, method="bruteforce"))
    bf_assoc = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=2, method="bruteforce",
                                                                     scan_mode="assoc_df", terminal_mode="inverse"))
    assert torch.equal(bf.T_star, bf_assoc.T_star) and torch.equal(bf.J_star, bf_assoc.J_star)
