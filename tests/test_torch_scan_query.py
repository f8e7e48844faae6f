"""Parity of the plain versions of the port's prefix-scan and terminal-query
kernels (ops/cuda_lft_scan.py, ops/cuda_lft_query.py) with the JAX
reference in f64 on the CPU: the TPU kernels lft_scan_lanes and
lft_query_lanes run in interpret mode (one jitter, psd_levels = 1), and the
XLA path they stand for (lft_prefix_scan(lft_elements(...)),
propagator_J_curve_factored, propagator_J_curve) at psd_levels 1 and 2.

Inputs: the assembled blocks of random LTV problems (tests/helpers.py),
which are well conditioned, so everything agrees within rtol 1e-9. One
constructed input makes the first jitter rung of the element, the compose
and the query singular, to exercise the ladder.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import random_ltv_problem
from tests.test_torch_card import ladder_inputs
from tests.torch_helpers import T
from timeopt_tpu.models.base import System as JaxSystem
from timeopt_tpu.ops.pallas_lft import lft_query_lanes, lft_scan_lanes
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu_torch.ops import cuda_lft_query, cuda_lft_scan
from timeopt_tpu_torch.solver import horizon as thor

torch.set_num_threads(1)
RTOL = 1e-9


def _blocks(B=8, n=3, m=2, N=6, seed=60):
    """A_aug, B_aug, Q_aug, R_inv, C (factored) and QT (inverse) of B random
    LTV problems, numpy with a leading batch axis."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(B):
        step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=n, m=m, N=N)
        system = JaxSystem(name=f"ltv{i}", n=n, m=m, dt=0.1, step=step)
        A = jnp.broadcast_to(jnp.asarray(Ad), (N, n, n))
        Bm = jnp.broadcast_to(jnp.asarray(Bd), (N, n, m))
        blk = jaug.build_augmented(system, prob, jnp.asarray(X), jnp.asarray(U), A, Bm)
        C = jaug.build_terminal_factors(prob, jnp.asarray(X), s=blk.s)
        QT = jaug.build_terminal_blocks(prob, jnp.asarray(X), s=blk.s)
        out.append([np.asarray(a) for a in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, QT)])
    return [np.stack(x) for x in zip(*out)]


def _lanes(x):
    return jnp.asarray(np.transpose(x, (1, 2, 3, 0)))


def _unlanes(x):
    return np.transpose(np.asarray(x), (3, 0, 1, 2))


def _xla_prefixes(A_aug, B_aug, Q_aug, R_inv, levels):
    def one(a, b, q, r):
        el = jhor.lft_elements(jaug.AugmentedBlocks(a, b, q, r), psd_levels=levels)
        return tuple(jhor.lft_prefix_scan(el, psd_levels=levels))

    return [np.asarray(x) for x in jax.vmap(one)(*(jnp.asarray(v) for v in (A_aug, B_aug, Q_aug, R_inv)))]


def test_scan_and_query_match_the_tpu_kernels():
    A_aug, B_aug, Q_aug, R_inv, C, _ = _blocks()
    BRB = np.einsum("bnim,bmo,bnjo->bnij", B_aug, R_inv, B_aug)
    want = lft_scan_lanes(_lanes(A_aug), _lanes(Q_aug), _lanes(BRB), block_b=8, interpret=True)
    got = cuda_lft_scan.lft_scan(T(A_aug), T(BRB), T(Q_aug), levels=1)
    for g, w in zip(got, want):
        assert g.shape == A_aug.shape
        np.testing.assert_allclose(g.numpy(), _unlanes(w), rtol=RTOL, atol=1e-13)
    J_want = lft_query_lanes(*(jnp.asarray(_lanes(np.asarray(x))) for x in (*got, C)), block_b=8, interpret=True)
    J_got = cuda_lft_query.lft_query(*got, T(C), levels=1)
    assert J_got.shape == A_aug.shape[:2]
    np.testing.assert_allclose(J_got.numpy(), np.asarray(J_want).T, rtol=RTOL)


@pytest.mark.parametrize("levels", [1, 2])
def test_scan_and_query_match_xla(levels):
    A_aug, B_aug, Q_aug, R_inv, C, QT = _blocks(B=3, N=9, seed=61)
    want = _xla_prefixes(A_aug, B_aug, Q_aug, R_inv, levels)
    BRB = thor.brb(T(B_aug), T(R_inv))
    got = cuda_lft_scan.lft_scan(T(A_aug), BRB, T(Q_aug), levels=levels)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=1e-13)

    pj = jhor.LFTElements(*(jnp.asarray(w) for w in want))
    J_f = jax.vmap(lambda e, f, g, c: jhor.propagator_J_curve_factored(jhor.LFTElements(e, f, g), c, psd_levels=levels))(
        *pj, jnp.asarray(C))
    np.testing.assert_allclose(cuda_lft_query.lft_query(*got, T(C), levels=levels).numpy(), np.asarray(J_f), rtol=RTOL)
    # the inverse query on the same prefixes: kappa(QT) ~ 1e9 leaves ~1e-7
    J_i = jax.vmap(lambda e, f, g, q: jhor.propagator_J_curve(jhor.LFTElements(e, f, g), q, psd_levels=levels))(
        *pj, jnp.asarray(QT))
    J_it = thor.propagator_J_curve(thor.LFTElements(*(T(w) for w in want)), T(QT), psd_levels=levels)
    np.testing.assert_allclose(J_it.numpy(), np.asarray(J_i), rtol=1e-6)

    # the unfused select, both queries
    for mode, term, J_ref, rtol in (("factored", C, J_f, RTOL), ("inverse", QT, J_i, 1e-6)):
        J = thor.propagator_select(T(A_aug), T(B_aug), T(Q_aug), T(R_inv), T(term), psd_levels=levels,
                                   terminal_mode=mode)
        np.testing.assert_allclose(J.numpy(), np.asarray(J_ref), rtol=rtol)


@pytest.mark.parametrize("levels", [1, 2])
def test_ladder_takes_the_second_rung(levels):
    A, BRB, Q, qargs = ladder_inputs()
    got = cuda_lft_scan.lft_scan(T(A), T(BRB), T(Q), levels=levels)
    want = _xla_prefixes(A, np.zeros(A.shape[:3] + (1,)), Q, np.ones((A.shape[0], 1, 1)), levels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isfinite(g.numpy()), np.isfinite(w))
        f = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[f], w[f], rtol=RTOL)
    J = cuda_lft_query.lft_query(*(T(x) for x in qargs), levels=levels).numpy()
    J_want = jax.vmap(lambda e, f, g, c: jhor.propagator_J_curve_factored(jhor.LFTElements(e, f, g), c,
                                                                         psd_levels=levels))(
        *(jnp.asarray(x) for x in qargs))
    np.testing.assert_array_equal(np.isfinite(J), np.isfinite(np.asarray(J_want)))
    np.testing.assert_allclose(J[np.isfinite(J)], np.asarray(J_want)[np.isfinite(J)], rtol=RTOL)
    if levels == 1:
        assert not np.isfinite(got[0].numpy()[:, 1:]).all() and not np.isfinite(J[0, 1])
    else:
        assert all(np.isfinite(x.numpy()).all() for x in got) and np.isfinite(J).all()
        assert J[0, 1] == pytest.approx(0.5 / (1e-5 - 1e-9), rel=1e-12)


def test_kernel_wrappers_check_levels_only_on_the_card():
    """On the CPU any ladder depth runs the plain version; the card takes 1
    or 2 (tests/test_torch_card.py)."""
    A_aug, B_aug, Q_aug, R_inv, C, _ = _blocks(B=1, N=4, seed=62)
    BRB = thor.brb(T(B_aug), T(R_inv))
    E, F, G = cuda_lft_scan.lft_scan(T(A_aug), BRB, T(Q_aug), levels=3)
    assert torch.isfinite(cuda_lft_query.lft_query(E, F, G, T(C), levels=3)).all()
