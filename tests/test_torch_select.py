"""Parity of the port's propagator select (solver/horizon.py, the plain
version behind ops/cuda_lft.py) with the JAX reference in f64 on the CPU,
and with the independent NumPy Riccati oracle of tests/helpers.py.

Tolerances: J(T) for T >= T_min within rtol 1e-9 of JAX: the pivot-free
eliminations run in another operation order and kappa(Q_aug) reaches ~1e5,
so agreement is ~1e5 * eps. Against the Riccati oracle, the regularization
(q_reg, the 1e-9 jitter of every inverse) bounds the gap: rtol 1e-6 on the
double integrator as in tests/test_propagator.py, 2e-5 on the quadrotor,
whose compose inverses are the worst conditioned (the JAX reference, equal
to the port within 1e-9, shows the same ~6e-6 gap).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import riccati_J_curve_oracle, tiny_double_integrator
from tests.torch_helpers import T, iterate, problems, to_torch_problem
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu.solver.cost import argmin_T as jax_argmin_T
from timeopt_tpu.solver.ilqr import broadcast_problem as jax_broadcast
from timeopt_tpu_torch.ops import _build, cuda_lft
from timeopt_tpu_torch.solver import augmented as taug
from timeopt_tpu_torch.solver import horizon as thor
from timeopt_tpu_torch.solver.cost import argmin_T

torch.set_num_threads(1)


def _case(name):
    """(jax system, torch system, jax problems, torch problems, N)."""
    if name == "tiny_di":
        js, base = tiny_double_integrator(N=24, T_min=4, T_max=24)
        rng = np.random.default_rng(10)
        x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((3, 2))
        jp = jax_broadcast(base, 3).replace(x0=jnp.asarray(x0))
        from timeopt_tpu_torch.models import get_system

        return js, get_system("DoubleIntegrator")[0], jp, to_torch_problem(jp), 24
    return (*problems("Quadrotor", 2, 32, 8, 32, seed=11), 32)


def _inputs(name):
    js, ts, jp, tp, N = _case(name)
    X, U, A, Bm = iterate(js, jp, seed=12)
    fj = jax.vmap(
        lambda p, x, u, a, b: jaug.build_fused_inputs(js, p, x, u, a, b, q_reg=1e-9, psd_levels=1)
    )(jp, *(jnp.asarray(v) for v in (X, U, A, Bm)))
    ft = taug.build_fused_inputs(ts, tp, T(X), T(U), T(A), T(Bm), q_reg=1e-9, psd_levels=1)
    return js, jp, tp, (X, U, A, Bm), fj, ft


def _select_args(f):
    return [getattr(f, k) for k in ("A", "B", "vecs", "scal", "Qq", "R_inv", "Lt")]


@pytest.mark.parametrize("name", ["tiny_di", "quadrotor"])
def test_select_matches_jax_and_riccati_oracle(name):
    js, jp, tp, (X, U, A, Bm), fj, ft = _inputs(name)
    oracle_rtol = 1e-6 if name == "tiny_di" else 2e-5
    t_min, t_max = tp.T_min, tp.T_max
    J_jax = np.asarray(jax.vmap(jhor._make_select_fused_cv(t_min))(*_select_args(fj)))
    launches = cuda_lft.LAUNCHES
    J = thor.propagator_select_fused(*[t.contiguous() for t in _select_args(ft)], t_min).numpy()
    assert cuda_lft.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    np.testing.assert_allclose(J[:, t_min - 1 :], J_jax[:, t_min - 1 :], rtol=1e-9)

    s0 = ft.s[:, :1].numpy() ** 2
    T_port = argmin_T(T(s0 * J), t_min, t_max).numpy()
    T_jax = np.asarray(jax.vmap(lambda c: jax_argmin_T(c, t_min, t_max))(jnp.asarray(s0 * J_jax)))
    np.testing.assert_array_equal(T_port, T_jax)

    wrap = np.nonzero(np.asarray(jp.wrap_mask[0]))[0]
    for b in range(X.shape[0]):
        J_or = riccati_J_curve_oracle(
            A[b], Bm[b], X[b], U[b], np.asarray(jp.xg[b]), np.asarray(jp.u_ref[b]),
            np.asarray(jp.Q[b]), np.asarray(jp.R[b]), np.asarray(jp.Qf[b]), float(jp.w[b]),
            t_max, wrap_idx=tuple(wrap),
        )
        np.testing.assert_allclose(s0[b, 0] * J[b, t_min - 1 :], J_or[t_min - 1 :], rtol=oracle_rtol, atol=1e-9)


@pytest.mark.parametrize("name", ["tiny_di", "quadrotor"])
def test_lft_elements_and_prefix_scan_match_jax(name):
    js, jp, tp, _, fj, ft = _inputs(name)
    Aj, Bj, Qj, Cj = jax.vmap(jhor._assemble_from_fused)(*_select_args(fj))
    At, Bt, Qt, Ct = thor._assemble_from_fused(*_select_args(ft))
    for got, want in ((At, Aj), (Bt, Bj), (Qt, Qj), (Ct, Cj)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
    ej = jax.vmap(lambda a, b, q, r: jhor.lft_elements(jaug.AugmentedBlocks(a, b, q, r), psd_levels=1))(
        Aj, Bj, Qj, fj.R_inv
    )
    et = thor.lft_elements(At, Bt, Qt, ft.R_inv, psd_levels=1)
    for got, want in zip(et, ej):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-10, atol=1e-12)
    pj = jax.vmap(lambda e: jhor.lft_prefix_scan(jhor.LFTElements(*e), psd_levels=1))(tuple(ej))
    pt = thor.lft_prefix_scan(et, psd_levels=1)
    for got, want in zip(pt, pj):
        scale = np.abs(np.asarray(want)).max()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9, atol=1e-12 * scale)


def test_dispatch_rule_on_cpu_and_other_devices():
    x = torch.zeros(2, dtype=torch.float64)
    assert _build.on_card(x, "select") is False
    assert _build.on_card(x.float(), "select") is False
    with pytest.raises(ValueError):
        _build.on_card(torch.zeros(2, device="meta"), "select")
