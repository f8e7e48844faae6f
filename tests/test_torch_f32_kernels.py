"""The float32 path of the port's four kernel modules on the CPU: the plain
version behind each wrapper (ops/cuda_lft.py, cuda_lft_generic.py,
cuda_backward.py, cuda_forward.py) on float32 inputs, held to three
references:

- (i) the JAX float64 function on the same float32 values upcast: the port
  computes the same float64 math (another operation order) and rounds its
  result to float32 once, so rtol 1e-6 (atol 1e-6 of the largest entry
  where entries cancel to ~0): half an ulp of float32 is 6e-8 relative,
  and the float64 operation orders differ by ~1e-12 on these inputs;
- (ii) the JAX df32 Pallas kernel on the float32 inputs, in interpret mode,
  as the JAX package's own tests run it on the CPU: interpret mode degrades
  the df32 arithmetic, so the loose tolerances of those tests (select
  rtol 2e-3 / atol 1e-4, the generic select rtol 5e-3 / atol 1e-3,
  backward rtol 2e-3 / atol 1e-4, line search J rtol 2e-4, X and U on
  [0, T*] rtol and atol 2e-3), +inf below T_min, the same accepted alphas
  and the same ok flags. The fused select is held to it on the JAX
  package's own inputs for that kernel (random LTV problems,
  tests/test_fused_select.py): on the quadrotor's noisy iterate below the
  interpret-mode kernel reads up to 5% off the per-horizon Riccati oracle
  (tests/helpers.py), where the JAX float64 function and the port agree
  with that oracle to 3e-6 (the q_reg term);
- (iii) the port's own plain version on the inputs upcast to float64,
  rounded to float32: bit for bit (the rule of the float32 path: float32
  storage, float64 arithmetic, one rounding on the way out).

The float64 instantiation of each kernel is not touched by any of this: on
float64 inputs the wrappers call the same plain versions as before.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.ops.pallas_backward import backward_lanes_df
from timeopt_tpu.ops.pallas_forward import linesearch_lanes_df
from timeopt_tpu.ops.pallas_lft import propagator_select_lanes_df, propagator_select_lanes_df_fused
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import backward as jback
from timeopt_tpu.solver import cost as jcost
from timeopt_tpu.solver import forward as jfw
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic
from timeopt_tpu_torch.solver import backward as tback
from timeopt_tpu_torch.solver.cost import cost_true

torch.set_num_threads(1)
B = 8  # one block of the Pallas lanes kernels (block_b=8)
ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.05)
FUSED = ("A", "B", "vecs", "scal", "Qq", "R_inv", "Lt")


def f32(a) -> np.ndarray:
    return np.asarray(a, np.float32)


def up(a):
    return jnp.asarray(np.asarray(a), jnp.float64)


def _close_i(got: torch.Tensor, want, rtol=1e-6, rel_atol=1e-6):
    want = np.asarray(want, np.float64)
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max() if fin.any() else 1.0
    np.testing.assert_array_equal(np.isfinite(got.numpy()), fin)
    np.testing.assert_allclose(got.numpy().astype(np.float64)[fin], want[fin], rtol=rtol, atol=rel_atol * scale)


def _bitwise_f64_rule(fn, *args):
    """(iii): fn on float32 inputs equals fn on the inputs upcast, rounded."""
    def up64(a):
        if hasattr(a, "tensors"):
            return a.replace(**{f: up64(t) for f, t in a.tensors().items()})
        return a.double() if isinstance(a, torch.Tensor) and a.is_floating_point() else a

    got = fn(*args)
    ref = fn(*(up64(a) for a in args))
    for g, r in zip(got if isinstance(got, tuple) else (got,), ref if isinstance(ref, tuple) else (ref,)):
        if g.is_floating_point():
            assert g.dtype == torch.float32 and r.dtype == torch.float64
            assert torch.equal(g, r.float())
        else:
            assert torch.equal(g, r)
    return got


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator"])
def test_fused_select_float32(case):
    t_min = 6
    js, ts, jp, tp = problems(case, B, 24, t_min, 24, seed=90)
    X, U, A, Bm = iterate(js, jp, seed=91)
    fj = jax.vmap(lambda p, x, u, a, b: jaug.build_fused_inputs(js, p, x, u, a, b, q_reg=1e-5, psd_levels=1))(
        jp, *(jnp.asarray(v) for v in (X, U, A, Bm))
    )
    args32 = [f32(getattr(fj, k)) for k in FUSED]
    launches = cuda_lft.LAUNCHES
    J = _bitwise_f64_rule(lambda *a: cuda_lft.propagator_select_fused(*a, t_min=t_min), *(T(a) for a in args32))
    assert cuda_lft.LAUNCHES == launches  # a CPU tensor never reaches the kernel
    J_f64 = np.asarray(jax.vmap(jhor._make_select_fused_cv(t_min))(*(up(a) for a in args32)))
    _close_i(J[:, t_min - 1 :], J_f64[:, t_min - 1 :])


def test_fused_select_float32_matches_the_df32_kernel():
    """(ii) on tests/test_fused_select.py's inputs: B random LTV problems
    (n=3, m=2, N=6), their fused inputs in float32."""
    from timeopt_tpu.models.base import System as JaxSystem
    from tests.helpers import random_ltv_problem

    rng, fused = np.random.default_rng(97), []
    for i in range(B):
        step, prob, Ad, Bd, X, U = random_ltv_problem(rng, n=3, m=2, N=6)
        system = JaxSystem(name=f"ltv{i}", n=3, m=2, dt=0.1, step=step)
        A, Bm = jnp.broadcast_to(jnp.asarray(Ad), (6, 3, 3)), jnp.broadcast_to(jnp.asarray(Bd), (6, 3, 2))
        fused.append(jaug.build_fused_inputs(system, prob, jnp.asarray(X), jnp.asarray(U), A, Bm, psd_levels=1))
    args32 = [f32(np.stack([getattr(f, k) for f in fused])) for k in FUSED]
    J = cuda_lft.propagator_select_fused(*(T(a) for a in args32), t_min=3)
    J_df = np.asarray(propagator_select_lanes_df_fused(*(jnp.asarray(a) for a in args32), block_b=B, t_min=3,
                                                       interpret=True))
    assert J.dtype == torch.float32 and np.isinf(J_df[:, :2]).all() and bool(torch.isfinite(J).all())
    np.testing.assert_allclose(J_df[:, 2:], J.numpy()[:, 2:], rtol=2e-3, atol=1e-4)


def test_generic_select_float32():
    t_min, case = 10, "PointMass_Navigation"
    js, ts, jp, tp = problems(case, B, 30, t_min, 30, seed=92)
    X, U, A, Bm = iterate(js, jp, seed=93)
    jb = jax.vmap(lambda p, x, u, a, b: jaug.build_augmented(js, p, x, u, a, b, q_reg=1e-5, psd_levels=1))(
        jp, *(jnp.asarray(v) for v in (X, U, A, Bm))
    )
    jC = jax.vmap(lambda p, x, s: jaug.build_terminal_factors(p, x, s=s))(jp, jnp.asarray(X), jb.s)
    args32 = [f32(a) for a in (jb.A_aug, jb.B_aug, jb.Q_aug, jb.R_inv, jC)]
    J = _bitwise_f64_rule(lambda *a: cuda_lft_generic.propagator_select_generic(*a, t_min=t_min),
                          *(T(a) for a in args32))
    J_f64 = np.asarray(jax.vmap(jhor._make_select_cv(t_min))(*(up(a) for a in args32)))
    _close_i(J[:, t_min - 1 :], J_f64[:, t_min - 1 :])
    J_df = np.asarray(propagator_select_lanes_df(*(jnp.asarray(a) for a in args32), block_b=B, t_min=t_min,
                                                 interpret=True))
    assert np.isinf(J_df[:, : t_min - 1]).all()
    np.testing.assert_allclose(J_df[:, t_min - 1 :], J.numpy()[:, t_min - 1 :], rtol=5e-3, atol=1e-3)


@pytest.mark.parametrize("case", ["Quadrotor", "Cartpole_SwingUp", "PointMass_Navigation"])
def test_backward_float32(case):
    N = 20
    js, ts, jp, tp = problems(case, B, N, 4, N, seed=94)
    X, U, A, Bm = iterate(js, jp, seed=95)
    ins = tback.backward_inputs(ts, tp, T(X), T(U))
    Tst = torch.as_tensor(np.arange(B) % (N - 4) + 4, dtype=torch.int64)
    lm = np.full(B, 1e-3)
    lm[1] = -1e4  # Quu + lambda I indefinite there: ok False on both
    args32 = [T(f32(a)) for a in (A, Bm, *ins)] + [Tst, T(f32(lm))]
    kap, K, ok = _bitwise_f64_rule(cuda_backward.backward_truncated_core, *args32)
    assert kap.dtype == K.dtype == torch.float32 and not bool(ok[1]) and int(ok.sum()) == B - 1
    ref = jax.vmap(jback._backward_arrays)(*(up(a) for a in args32[:-2]), jnp.asarray(Tst.numpy()), up(args32[-1]))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[2]))
    _close_i(kap, ref[0])
    _close_i(K, ref[1])
    kd, Kd, okd = backward_lanes_df(*(jnp.asarray(a.numpy()) for a in args32[:-2]),
                                    jnp.asarray(Tst.numpy(), jnp.int32), jnp.asarray(args32[-1].numpy()),
                                    block_b=B, interpret=True)
    np.testing.assert_array_equal(np.asarray(okd), ok.numpy())
    good = ok.numpy()
    np.testing.assert_allclose(np.asarray(kd)[good], kap.numpy()[good], rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(np.asarray(Kd)[good], K.numpy()[good], rtol=2e-3, atol=1e-4)


def _linesearch_inputs(case, seed):
    N = 24
    js, ts, jp, tp = problems(case, B, N, 4, N, seed=seed)
    X, U, A, Bm = iterate(js, jp, seed=seed + 1)
    Tst = torch.as_tensor(np.arange(B) % (N - 6) + 6, dtype=torch.int64)
    bw = tback.backward_truncated(ts, tp, T(A), T(Bm), T(X), T(U), Tst, torch.full((B,), 1e-3, dtype=torch.float64))
    tp32 = tp.replace(**{f: t.float() if t.is_floating_point() else t for f, t in tp.tensors().items()})
    return js, ts, jp, tp32, (T(f32(X)), T(f32(U)), bw.K.float(), (0.5 * bw.kappa).float(), Tst)


@pytest.mark.parametrize("case", ["Quadrotor", "Cartpole_SwingUp", "PointMass_Navigation"])
def test_linesearch_float32(case):
    js, ts, jp, tp32, (X, U, K, kap, Tst) = _linesearch_inputs(case, 96)
    Xs, Us, Js = _bitwise_f64_rule(lambda tp, *a: cuda_forward.linesearch(ts, tp, *a, ALPHAS), tp32, X, U, K, kap, Tst)
    assert Xs.dtype == Us.dtype == Js.dtype == torch.float32 and bool(torch.isfinite(Js).all())
    jp64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
    jp64 = jp64.replace(**{f: up(getattr(tp32, f).numpy()) for f in ("x0", "xg", "u_ref", "Q", "R", "Qf", "w")})

    def try_alpha(p, x, u, k, kp, t, a):
        Xn, Un = jfw.rollout_with_gains(js, p, x, u, k, kp, t, a)
        Jn = jcost.cost_true(js, p, Xn, Un, t)
        return Xn, Un, jnp.where(jnp.all(jnp.isfinite(Xn)), Jn, jnp.inf)

    per = jax.vmap(try_alpha, in_axes=(0, 0, 0, 0, 0, 0, None))
    ref = jax.vmap(lambda a: per(jp64, *(up(v.numpy()) for v in (X, U, K, kap)), jnp.asarray(Tst.numpy()), a),
                   out_axes=1)(jnp.asarray(ALPHAS, jnp.float64))
    _close_i(Js, ref[2])
    _close_i(Us, ref[1])
    _close_i(Xs, ref[0])
    if case == "PointMass_Navigation":
        return  # the JAX package has no df32 kernel for PointMass (its extra stage cost)
    J_old = cost_true(ts, tp32, X, U, Tst)
    Xd, Ud, Jd, accd = linesearch_lanes_df(
        js, ALPHAS, *(jnp.asarray(v.numpy()) for v in (X, U, K, kap)), jnp.asarray(Tst.numpy(), jnp.int32),
        jnp.asarray(J_old.numpy()), *(jnp.asarray(getattr(tp32, f).numpy()) for f in ("xg", "u_ref", "Q", "R", "Qf", "w",
                                                                                     "wrap_mask")),
        block_b=B, interpret=True,
    )
    from timeopt_tpu_torch.solver.forward import select_first_improving

    sel = select_first_improving(X, U, Xs, Us, Js, J_old)
    np.testing.assert_array_equal(np.asarray(accd), sel.accepted.numpy())
    np.testing.assert_allclose(np.asarray(Jd), sel.J.numpy(), rtol=2e-4)
    for b in range(B):
        t = int(Tst[b])
        np.testing.assert_allclose(np.asarray(Xd)[b, : t + 1], sel.X.numpy()[b, : t + 1], rtol=2e-3, atol=2e-3)
        np.testing.assert_allclose(np.asarray(Ud)[b, :t], sel.U.numpy()[b, :t], rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("how", ["view", "copy"])
def test_linesearch_float32_from_start_states(how):
    """The start-state entry (the one-pass method's shifted-gain rollouts)
    at float32: start states off row 0 of X, as a strided view or a copy."""
    js, ts, jp, tp32, (X, U, K, kap, Tst) = _linesearch_inputs("Quadrotor", 98)
    X2 = torch.cat([X, X[:, :1] + 0.05], dim=1)  # row N+1 holds the start states
    x_start = X2[:, -1] if how == "view" else X2[:, -1].clone()
    Xs, Us, Js = _bitwise_f64_rule(lambda tp, *a: cuda_forward.linesearch(ts, tp, *a[:5], ALPHAS, x_start=a[5]),
                                   tp32, X, U, K, kap, Tst, x_start)
    assert torch.equal(Xs[:, :, 0], x_start[:, None].expand(-1, len(ALPHAS), -1))
    assert not torch.equal(Xs[:, :, 1], cuda_forward.linesearch(ts, tp32, X, U, K, kap, Tst, ALPHAS)[0][:, :, 1])


@pytest.mark.parametrize("scale", [True, False])
def test_float32_select_inputs_match_jax(scale):
    """The block assembly runs in the problem dtype, as XLA does on the JAX
    package's f32 path: the fused inputs of a float32 quadrotor iterate and
    the assembled blocks of a float32 PointMass iterate (its obstacle
    cost's gradient and Hessian, vmap(grad) and vmap(hessian), in float32
    too) against the JAX functions on the same float32 values, float32 out,
    within rtol 1e-5 (float32 arithmetic in another operation order; atol
    1e-5 of each array's largest entry where entries cancel); the
    homogeneous scales s and the s_0^2 factor within rtol 1e-6, and
    exactly 1 with scale=False."""
    from timeopt_tpu_torch.solver import augmented as taug
    from timeopt_tpu_torch.solver.cost import extra_cost_terms

    def close(got, want, rtol=1e-5):
        want = np.asarray(want)
        assert got.dtype == torch.float32 and want.dtype == np.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=rtol, atol=rtol * np.abs(want).max())

    def f32_iterate(case, seed):
        js, ts, jp, tp = problems(case, 3, 24, 6, 24, seed=seed)
        X, U, A, Bm = (f32(v) for v in iterate(js, jp, seed=seed + 1))
        jp32 = jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)
        tp32 = tp.replace(**{f: t.float() if t.is_floating_point() else t for f, t in tp.tensors().items()})
        return js, ts, jp32, tp32, (X, U, A, Bm)

    js, ts, jp32, tp32, arrs = f32_iterate("Quadrotor", 99)
    fj = jax.vmap(lambda p, x, u, a, b: jaug.build_fused_inputs(js, p, x, u, a, b, q_reg=1e-5, psd_levels=1,
                                                                scale=scale))(jp32, *(jnp.asarray(v) for v in arrs))
    ft = taug.build_fused_inputs(ts, tp32, *(T(v) for v in arrs), q_reg=1e-5, psd_levels=1, scale=scale)
    for k in FUSED:
        close(getattr(ft, k), getattr(fj, k))
    close(ft.s, fj.s, 1e-6)
    close(ft.s[:, 0] ** 2, np.asarray(fj.s)[:, 0] ** 2, 1e-6)
    if not scale:
        assert bool((ft.s == 1).all())

    js, ts, jp32, tp32, (X, U, A, Bm) = f32_iterate("PointMass_Navigation", 101)
    for g, w in zip(extra_cost_terms(ts, T(X[:, :-1]), T(U)),
                    jax.vmap(lambda x, u: jcost.extra_cost_terms(js, x, u))(jnp.asarray(X[:, :-1]), jnp.asarray(U))):
        close(g, w)
    jb = jax.vmap(lambda p, x, u, a, b: jaug.build_augmented(js, p, x, u, a, b, q_reg=1e-5, psd_levels=1,
                                                             scale=scale))(jp32, *(jnp.asarray(v) for v in
                                                                                   (X, U, A, Bm)))
    tb = taug.build_augmented(ts, tp32, T(X), T(U), T(A), T(Bm), q_reg=1e-5, psd_levels=1, scale=scale)
    for k in ("A_aug", "B_aug", "Q_aug", "R_inv"):
        close(getattr(tb, k), getattr(jb, k))
    close(tb.s, jb.s, 1e-6)
