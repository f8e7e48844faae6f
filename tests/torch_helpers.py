"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

Every input is made with numpy from a seed and handed to both packages:
the JAX reference (float64 on the CPU, its own XLA fallbacks) and the port
(`timeopt_tpu_torch`, plain PyTorch on the CPU). Problems cross over as
numpy leaves through `problem_from_numpy`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from timeopt_tpu.models import get_system as jax_get_system
from timeopt_tpu.solver.cost import rollout as jax_rollout
from timeopt_tpu.solver.ilqr import broadcast_problem as jax_broadcast
from timeopt_tpu.solver.linearize import linearize as jax_linearize
from timeopt_tpu_torch.models import get_system as torch_get_system
from timeopt_tpu_torch.models import problem_from_numpy
from timeopt_tpu_torch.models.base import PROBLEM_FIELDS


def T(a) -> torch.Tensor:
    """numpy / JAX array -> CPU torch tensor (a copy, dtype kept)."""
    return torch.as_tensor(np.array(a))


def to_torch_problem(jp):
    """A batched JAX Problem -> the port's Problem, through numpy."""
    leaves = {f: np.asarray(getattr(jp, f)) for f in PROBLEM_FIELDS}
    return problem_from_numpy(leaves, jp.N, jp.T_min, jp.T_max, "cpu")


def problems(case: str, B: int, N: int, T_min: int, T_max: int, seed: int):
    """(jax_system, torch_system, jax_problems, torch_problems): the case's
    default problem cut to N / T_min / T_max, x0 perturbed by its sigma_x0."""
    js, mk = jax_get_system(case)
    ts, _ = torch_get_system(case)
    base = mk(dtype=jnp.float64, N=N).replace(T_min=T_min, T_max=T_max)
    rng = np.random.default_rng(seed)
    x0 = np.tile(np.asarray(base.x0), (B, 1))
    x0 = x0 + np.asarray(js.sigma_x0) * rng.standard_normal(x0.shape)
    jp = jax_broadcast(base, B).replace(x0=jnp.asarray(x0))
    return js, ts, jp, to_torch_problem(jp)


def iterate(js, jp, seed: int, noise: float = 0.05):
    """A perturbed nominal: U = u_ref + noise N(0, 1), X its JAX rollout,
    (A, B) its AD Jacobians, all numpy with a leading batch axis."""
    rng = np.random.default_rng(seed)
    u_ref = np.asarray(jp.u_ref)
    U = u_ref[:, None, :] + noise * rng.standard_normal((u_ref.shape[0], jp.N, u_ref.shape[1]))
    U = jnp.asarray(U)
    X = jax.vmap(lambda p, u: jax_rollout(js, p, p.x0, u))(jp, U)
    A, Bm = jax.vmap(lambda x, u: jax_linearize(js.step, x, u))(X, U)
    return tuple(np.asarray(a) for a in (X, U, A, Bm))


def assert_results_match(got, want, t_min, curve: bool = True):
    """A port SolveResult against a batched JAX SolveResult: T*, n_accept
    and T_hist identical; J* and J_hist within rtol 1e-8; X, U within
    atol 1e-7 (the phases' own ~1e-10 differences pass through up to
    max_iter+1 accept decisions and rollouts); with `curve`, the last
    selection curve for T >= T_min within rtol 1e-7 (it is taken on the last
    iterate, which agrees to atol 1e-7; through the select's conditioning
    that is ~2e-8 relative) and identical flat-tie sets."""
    for name in ("T_star", "n_accept", "T_hist"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-8)
    np.testing.assert_allclose(got.J_hist.numpy(), np.asarray(want.J_hist), rtol=1e-8)
    np.testing.assert_allclose(got.lm_final.numpy(), np.asarray(want.lm_final), rtol=1e-12)
    np.testing.assert_allclose(got.X.numpy(), np.asarray(want.X), rtol=0, atol=1e-7)
    np.testing.assert_allclose(got.U.numpy(), np.asarray(want.U), rtol=0, atol=1e-7)
    if curve:
        jc = got.J_curve.numpy()[..., t_min - 1 :]
        np.testing.assert_allclose(jc, np.asarray(want.J_curve)[..., t_min - 1 :], rtol=1e-7)
        np.testing.assert_array_equal(got.T_ties.numpy(), np.asarray(want.T_ties))
