"""The float32 side of the prefix-scan (#9) and terminal-query (#10) kernels
and of every path through them, on the CPU (plain versions), against the
JAX package.

The port's float32 rule: float32 storage, every recursion in float64, one
rounding on the way out. For the unfused select that means float32 blocks,
B R^-1 B', C, QT and J, and float64 prefixes (E, F, G).

- The plain scan on float32 blocks returns float64 prefixes, bitwise those
  of the upcast blocks; the plain query on float32 C returns float32 J,
  bitwise the float64 query rounded once; float32 prefixes raise.
- The TPU kernels lft_scan_lanes and lft_query_lanes run at float32 in
  interpret mode on the well-conditioned blocks of
  tests/test_torch_scan_query.py. They compute in float32 arithmetic
  (explicit inverses), so they read up to 5.4e-5 (prefixes, of each
  matrix's largest entry) and 2.4e-4 (J, relative) off the port's float64
  recursion: held within 2e-4 and 1e-3, and the port's J must be the
  closer of the two to the JAX float64 select on the same float32 inputs,
  which it matches within rtol 1e-6 (one float32 rounding of J, 6.0e-8
  read, and B R^-1 B' rounded once) on both queries.
- Solves at float32 with terminal_mode="inverse", scan_mode="associative",
  "assoc_df" and associative + inverse, on the tiny double integrator and
  a short cart-pole, against the JAX float32 solve with
  select_dtype="float64" and the float32 path's q_reg 1e-5 (the port's
  float32 select takes 1e-5; at JAX's float64 default 1e-9 the
  explicit-inverse associative mode loses digits on the cart-pole, in the
  JAX package and the port alike, ROADMAP Queue 3): T* equal or tied by the
  flat-tie rule, J* within rtol 1e-4.
- consistency_check on a float32 trajectory against the JAX function in
  float64 on the same numbers: the brute-force curve within rtol 1e-6 (a
  float64 recursion rounded once); on the double integrator and the
  quadrotor the propagator's within 1e-5 of its largest entry (its blocks
  are formed in float32 arithmetic, as in the JAX function; read 4.9e-7)
  and max_abs within 1e-5 of it, absolute. On the cart-pole float32
  blocks leave the propagator's curve ill-determined (the test says why):
  max_abs within a factor 2 of the float64 function's and no larger than
  the JAX function's at float32.
- propagator_select_sharded at float32 on a two-entry CPU mesh, both scan
  modes and an odd N (padding): bitwise the unsharded select.
- The runner's --f32 --consistency: one double-integrator trial with a
  finite consistency_max_abs no larger than the JAX float32 pipeline's on
  a TPU (results/tpu_f32: 2.12e-3).
"""

from __future__ import annotations

import csv

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.helpers import tiny_double_integrator
from tests.test_torch_scan_query import _blocks, _lanes, _unlanes
from tests.torch_helpers import T, iterate, problems, to_torch_problem
from timeopt_tpu.ops.pallas_lft import lft_query_lanes, lft_scan_lanes
from timeopt_tpu.solver import augmented as jaug
from timeopt_tpu.solver import horizon as jhor
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu.solver.verify import consistency_check as jax_consistency_check
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.ops import cuda_lft_query, cuda_lft_scan
from timeopt_tpu_torch.parallel import make_mesh, propagator_select_sharded
from timeopt_tpu_torch.solver import horizon as thor
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
from timeopt_tpu_torch.solver.linearize import linearize
from timeopt_tpu_torch.solver.verify import consistency_check

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
TPU_F32_DI_CONSISTENCY = 0.002124786376953125  # results/tpu_f32, DoubleIntegrator trial 0


def _cast_tree(jp, dtype):
    return jax.tree.map(lambda a: a.astype(dtype) if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)


def _blocks32(**kw):
    """_blocks() rounded to float32: A_aug, B_aug, Q_aug, R_inv, C, QT."""
    return [T(x.astype(np.float32)) for x in _blocks(**kw)]


@pytest.mark.parametrize("levels", [1, 2])
def test_plain_scan_and_query_at_float32_are_the_float64_ones_rounded_once(levels):
    A, Bm, Q, Ri, C, _ = _blocks32()
    BRB = thor.brb(Bm, Ri)
    assert BRB.dtype == F32 and torch.equal(BRB, thor.brb(Bm.double(), Ri.double()).float())
    pre = cuda_lft_scan.lft_scan(A, BRB, Q, levels=levels)
    want = cuda_lft_scan.lft_scan(A.double(), BRB.double(), Q.double(), levels=levels)
    for g, w in zip(pre, want):
        assert g.dtype == F64 and torch.equal(g, w)
    J = cuda_lft_query.lft_query(*pre, C, levels=levels)
    assert J.dtype == F32 and torch.equal(J, cuda_lft_query.lft_query(*pre, C.double(), levels=levels).float())
    assert torch.equal(J, cuda_lft_query.lft_query_plain(*pre, C, levels=levels))
    with pytest.raises(TypeError, match="prefixes are float64"):
        cuda_lft_query.lft_query(pre[0].float(), *pre[1:], C, levels=levels)


def _normwise(got, want):
    return float((np.abs(got - want).max(axis=(-1, -2)) / np.abs(want).max(axis=(-1, -2))).max())


def test_float32_scan_and_query_against_the_tpu_kernels_at_float32():
    A, Bm, Q, Ri, C, QT = _blocks32()
    BRB = thor.brb(Bm, Ri)
    tpu_pre = lft_scan_lanes(_lanes(A.numpy()), _lanes(Q.numpy()), _lanes(BRB.numpy()), block_b=8, interpret=True)
    assert all(x.dtype == jnp.float32 for x in tpu_pre)
    pre = cuda_lft_scan.lft_scan(A, BRB, Q, levels=1)
    for g, w in zip(pre, tpu_pre):
        assert _normwise(g.numpy(), _unlanes(w).astype(np.float64)) <= 2e-4
    J_tpu = np.asarray(lft_query_lanes(*tpu_pre, _lanes(C.numpy()), block_b=8, interpret=True)).T.astype(np.float64)
    J = cuda_lft_query.lft_query(*pre, C, levels=1)
    np.testing.assert_allclose(J.numpy(), J_tpu, rtol=1e-3)

    # the JAX float64 select on the same float32 numbers, both queries
    up = [jnp.asarray(x.numpy().astype(np.float64)) for x in (A, Bm, Q, Ri)]
    for mode, term in (("factored", C), ("inverse", QT)):
        J_ref = np.asarray(jax.vmap(lambda a, b, q, r, t: jhor.propagator_select(
            jaug.AugmentedBlocks(a, b, q, r), t, psd_levels=2, terminal_mode=mode))(
            *up, jnp.asarray(term.numpy().astype(np.float64))))
        got = thor.propagator_select(A, Bm, Q, Ri, term, psd_levels=2, terminal_mode=mode)
        assert got.dtype == F32
        np.testing.assert_allclose(got.numpy(), J_ref, rtol=1e-6)
        if mode == "factored":
            port, tpu = (np.abs(x - J_ref).max() for x in (got.numpy().astype(np.float64), J_tpu))
            assert port < tpu, (port, tpu)


def _tiny_di(B=3):
    js, base = tiny_double_integrator()
    rng = np.random.default_rng(91)
    x0 = np.asarray(base.x0) + 0.2 * rng.standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return js, get_system("DoubleIntegrator")[0], jp


MODES = [dict(terminal_mode="inverse"), dict(scan_mode="associative"), dict(scan_mode="assoc_df"),
         dict(scan_mode="associative", terminal_mode="inverse")]


@pytest.mark.parametrize("mode", MODES, ids=lambda m: "+".join(m.values()))
@pytest.mark.parametrize("case", ["tiny_di", "cartpole"])
def test_float32_solve_in_each_mode_matches_jax_float32_solve(case, mode):
    if case == "tiny_di":
        js, ts, jp = _tiny_di()
    else:
        js, ts, jp, _ = problems("Cartpole_SwingUp", 3, 40, 10, 40, seed=81)
    jp32 = _cast_tree(jp, jnp.float32)
    tp32 = to_torch_problem(jp32)
    want = jilqr.solve_batch(js, jp32, options=jilqr.SolveOptions(max_iter=8, select_dtype="float64", q_reg=1e-5,
                                                                  use_pallas=False, **mode))
    got = tilqr.solve_batch(ts, tp32, options=tilqr.SolveOptions(max_iter=8, **mode))
    assert got.J_star.dtype == got.J_curve.dtype == F32
    T_o, curve = np.asarray(want.T_star), np.asarray(want.J_curve, np.float64)
    T_g, w, idx = got.T_star.numpy(), np.asarray(jp32.w, np.float64), np.arange(len(T_o))
    tied = (T_g == T_o) | (np.abs(curve[idx, T_g - 1] - curve[idx, T_o - 1]) <= w * (np.abs(T_g - T_o) + 1))
    assert tied.all(), (T_g, T_o)
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-4)


@pytest.mark.parametrize("case", ["tiny_di", "quadrotor", "cartpole"])
def test_float32_consistency_check_matches_jax_float64_on_the_same_numbers(case):
    if case == "tiny_di":
        js, ts, jp = _tiny_di()
    else:
        name = "Quadrotor" if case == "quadrotor" else "Cartpole_SwingUp"
        js, ts, jp, _ = problems(name, 3, 40, 10, 40, seed=81)
    X, U, _, _ = iterate(js, jp, seed=5)
    X32, U32 = X.astype(np.float32), U.astype(np.float32)
    jp32 = _cast_tree(jp, jnp.float32)
    got = consistency_check(ts, to_torch_problem(jp32), T(X32), T(U32))
    want = jax.vmap(lambda p, x, u: jax_consistency_check(js, p, x, u))(
        _cast_tree(jp32, jnp.float64), jnp.asarray(X32, jnp.float64), jnp.asarray(U32, jnp.float64))
    assert all(v.dtype == F32 for v in got.values())
    lo = jp.T_min - 1
    J_bf, J_prop = (np.asarray(want[k])[:, lo:] for k in ("J_bf", "J_prop"))
    np.testing.assert_allclose(got["J_bf"].numpy()[:, lo:], J_bf, rtol=1e-6)
    mx, mx_ref = got["max_abs"].numpy(), np.asarray(want["max_abs"])
    if case != "cartpole":
        err = np.abs(got["J_prop"].numpy()[:, lo:] - J_prop).max(axis=1) / np.abs(J_prop).max(axis=1)
        assert err.max() <= 1e-5, err
        np.testing.assert_allclose(mx, mx_ref, rtol=0, atol=1e-5 * np.abs(J_prop).max())
        return
    # The cart-pole's zero theta weight at build_augmented's default q_reg
    # 1e-9 leaves kappa(Q_aug) ~1e9, so float32 blocks (the JAX function's
    # semantics) fix J_prop only to their last bits: the JAX package's own
    # float32 blocks, recursed in float64, read 15-33% off the port's
    # (which differ from them by an ulp), and the JAX float64 function
    # 6-47%. What holds: max_abs of the float64 function's order (read
    # 0.61-1.37 times it) and below the JAX function's at float32 (which
    # reads 1,982 to 398,471 against the port's 356-515).
    want32 = jax.vmap(lambda p, x, u: jax_consistency_check(js, p, x, u))(jp32, jnp.asarray(X32), jnp.asarray(U32))
    assert np.all((mx >= 0.5 * mx_ref) & (mx <= 2.0 * mx_ref)), (mx, mx_ref)
    assert np.all(mx <= np.asarray(want32["max_abs"])), (mx, np.asarray(want32["max_abs"]))


@pytest.mark.parametrize("scan_mode", ["sequential", "associative"])
def test_float32_sharded_select_is_the_unsharded_one(scan_mode):
    ts, mk = get_system("DoubleIntegrator")
    p = tilqr.broadcast_problem(mk(N=15, device="cpu", dtype=F32).replace(T_min=4, T_max=15), 3)
    p = p.replace(x0=p.x0 + torch.tensor([[0.0, 0.0], [0.3, -0.2], [-0.1, 0.4]], dtype=F32))
    U = tilqr.default_U_init(p) + 0.05 * torch.as_tensor(np.random.default_rng(98).standard_normal((3, 15, 1)),
                                                         dtype=F32)
    from timeopt_tpu_torch.solver.cost import rollout

    X = rollout(ts, p, p.x0, U)
    A, Bj = linearize(ts.step, X, U)
    blk = build_augmented(ts, p, X, U, A, Bj)
    C = build_terminal_factors(p, X, s=blk.s)
    assert blk.A_aug.dtype == C.dtype == F32
    mesh = make_mesh(2, axis_names=("dp", "hs"), shape=(1, 2), device_type="cpu")
    got = propagator_select_sharded(blk, C, mesh, scan_mode=scan_mode)
    want = thor.propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, scan_mode=scan_mode)
    assert got.dtype == F32 and got.shape == (3, 15) and torch.equal(got, want)


def test_runner_f32_consistency_one_double_integrator_trial(tmp_path):
    from timeopt_tpu_torch.runner import run_suite

    args = ["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "1", "--f32", "--consistency",
            "--solvers", "ourmethod", "--outdir", str(tmp_path)]
    assert run_suite.parse_args(args).consistency
    run_suite.main(args)
    (row,) = csv.DictReader(open(tmp_path / "summary_all.csv", newline=""))
    cc = float(row["consistency_max_abs"])
    assert np.isfinite(cc) and cc <= TPU_F32_DI_CONSISTENCY and np.isfinite(float(row["consistency_rmse"]))
    assert float(np.float32(cc)) == cc  # a float32 value
