"""The port's float32 path end to end on the CPU, and its options and entries.

- Model builders: each system's `default_problem(dtype=float32)` equals the
  JAX `default_problem(dtype=jnp.float32)` leaf by leaf, bit for bit (both
  form the floats in float64 and round them once); `problem_from_numpy`
  keeps a float32 leaf float32.
- solve_batch on float32 problems against the JAX package's float32 solve
  on the CPU, which takes select_dtype="float64" (its plain-float32 select
  is wrong there and its df32 kernels run on a TPU only;
  tests/test_rollout_df.py): the port with the same select_dtype and with
  its default (the float32 select: float32 inputs, float64 recursion,
  q_reg 1e-5 as on the card) must reach T* exact or tied by the flat-tie
  rule on the JAX solve's last curve, J* within rtol 1e-4 (float32
  results; the JAX backward pass runs in plain float32, the port's in
  float64).
- df_forward ("auto" and "on" alike, "off" not ported) and select_dtype
  with the JAX semantics; TF32 off inside a
  solve and the caller's settings restored; --f32 through the runner;
  bench_torch.main on the CPU; and the float32 requests through the
  prefix-scan and query kernels (consistency_check, the sharded select,
  both latency modes, the inverse query) against the same calls in
  float64 (tests/test_torch_f32_scan_query.py holds them to the JAX
  package).
"""

from __future__ import annotations

import io
import json
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_helpers import problems, to_torch_problem
from timeopt_tpu.models import SYSTEMS as JAX_SYSTEMS
from timeopt_tpu.models import get_system as jax_get_system
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu_torch.models import get_system, problem_from_numpy
from timeopt_tpu_torch.models.base import PROBLEM_FIELDS
from timeopt_tpu_torch.ops import _build, cuda_forward, cuda_lft_query, cuda_lft_scan
from timeopt_tpu_torch.ops.precision import no_tf32
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.cost import rollout
from timeopt_tpu_torch.solver.linearize import linearize

torch.set_num_threads(1)
F32 = torch.float32


def _f32(jp):
    return jax.tree.map(lambda a: a.astype(jnp.float32) if jnp.issubdtype(a.dtype, jnp.floating) else a, jp)


@pytest.mark.parametrize("case", list(JAX_SYSTEMS))
def test_default_problem_float32_equals_jax(case):
    _, jmk = jax_get_system(case)
    _, tmk = get_system(case)
    jp, tp = jmk(dtype=jnp.float32), tmk(device="cpu", dtype=F32)
    for f in PROBLEM_FIELDS:
        want, got = np.asarray(getattr(jp, f)), getattr(tp, f)[0].numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    assert (tp.N, tp.T_min, tp.T_max) == (jp.N, jp.T_min, jp.T_max)


def test_problem_from_numpy_keeps_or_takes_the_dtype():
    _, jmk = jax_get_system("Quadrotor")
    leaves = {f: np.asarray(getattr(jmk(dtype=jnp.float32), f))[None] for f in PROBLEM_FIELDS}
    p = problem_from_numpy(leaves, 160, 40, 160, "cpu")
    assert all(t.dtype == (torch.bool if f == "wrap_mask" else F32) for f, t in p.tensors().items())
    p64 = problem_from_numpy(leaves, 160, 40, 160, "cpu", torch.float64)
    assert p64.Q.dtype == torch.float64 and torch.equal(p64.Q.float(), p.Q)
    ints = dict(leaves, w=np.asarray([1]))
    assert problem_from_numpy(ints, 160, 40, 160, "cpu").w.dtype == torch.float64


@pytest.mark.parametrize("case,N,t_min", [("DoubleIntegrator", 24, 4), ("Quadrotor", 40, 10),
                                          ("PointMass_Navigation", 40, 10)])
def test_float32_solve_matches_jax_float32_solve(case, N, t_min):
    js, ts, jp, _ = problems(case, 3, N, t_min, N, seed=80)
    jp32 = _f32(jp)
    tp32 = to_torch_problem(jp32)
    assert tp32.x0.dtype == F32
    want = jilqr.solve_batch(js, jp32, options=jilqr.SolveOptions(max_iter=8, select_dtype="float64", use_pallas=False))
    T_o, J_o, curve = np.asarray(want.T_star), np.asarray(want.J_star), np.asarray(want.J_curve, np.float64)
    w, idx = np.asarray(jp32.w, np.float64), np.arange(3)
    for sd in ("float64", None):
        got = tilqr.solve_batch(ts, tp32, options=tilqr.SolveOptions(max_iter=8, select_dtype=sd))
        for f in ("X", "U", "J_star", "J_curve", "J_hist", "lm_final"):
            assert getattr(got, f).dtype == F32, f
        T = got.T_star.numpy()
        tied = (T == T_o) | (np.abs(curve[idx, T - 1] - curve[idx, T_o - 1]) <= w * (np.abs(T - T_o) + 1))
        assert tied.all(), (sd, T, T_o)
        np.testing.assert_allclose(got.J_star.numpy(), J_o, rtol=1e-4)


def test_float32_baselines_solve():
    """The brute force (baseline1) and the one-pass method (baseline2) at
    float32: float64 recursions (the counterparts of bruteforce_df.py and
    sweep_df.py), float32 results, the same T* as at float64 here."""
    ts, mk = get_system("DoubleIntegrator")
    for method in ("bruteforce", "onepass"):
        runs = {}
        for dt in (torch.float64, F32):
            p = tilqr.broadcast_problem(mk(N=24, device="cpu", dtype=dt).replace(T_min=4, T_max=16), 2)
            p = p.replace(x0=p.x0 + torch.tensor([[0.0, 0.0], [0.3, -0.2]], dtype=dt))
            runs[dt] = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(method=method, max_iter=5, S_window=4))
        assert runs[F32].J_star.dtype == runs[F32].J_curve.dtype == F32
        assert torch.equal(runs[F32].T_star, runs[torch.float64].T_star)
        np.testing.assert_allclose(runs[F32].J_star.numpy(), runs[torch.float64].J_star.numpy(), rtol=1e-5)


def test_float32_onepass_newton_preimage():
    """The one-pass method's Newton preimages on float32 problems: the
    Jacobian taken in the states' dtype (forward AD promotes float32
    tangents), float32 results, the same T* as at float64 here."""
    ts, mk = get_system("DoubleIntegrator")
    runs = {}
    for dt in (torch.float64, F32):
        p = tilqr.broadcast_problem(mk(N=24, device="cpu", dtype=dt).replace(T_min=4, T_max=16), 2)
        p = p.replace(x0=p.x0 + torch.tensor([[0.0, 0.0], [0.3, -0.2]], dtype=dt))
        opts = tilqr.SolveOptions(method="onepass", max_iter=5, S_window=4, onepass_preimage="newton")
        runs[dt] = tilqr.solve_batch(ts, p, options=opts)
    assert runs[F32].J_star.dtype == runs[F32].X.dtype == F32
    assert torch.equal(runs[F32].T_star, runs[torch.float64].T_star)
    np.testing.assert_allclose(runs[F32].J_star.numpy(), runs[torch.float64].J_star.numpy(), rtol=1e-5)


def test_df_forward_options():
    """df_forward keeps the JAX package's names: "auto" and "on" both name
    the port's only float32 rollout (float64 state, float32 storage); "off",
    the JAX package's plain float32 rollouts, is not ported and raises, as
    does an unknown value."""
    O = tilqr.SolveOptions
    for ok in ("auto", "on"):
        O(df_forward=ok).check()
    for bad in (dict(df_forward="off"), dict(df_forward="yes"), dict(select_dtype="float16")):
        with pytest.raises(ValueError):
            O(**bad).check()


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
def test_df_forward_modes_at_float32(mode, monkeypatch):
    """"auto" and "on" give the same solve, through the line search's
    dispatch point (float64 state, float32 storage; the kernel on the card),
    starting from the float64-carried rollout, which differs from a plain
    float32 one; "off" raises before any work."""
    ts, mk = get_system("Cartpole_SwingUp")
    p = tilqr.broadcast_problem(mk(N=30, device="cpu", dtype=F32).replace(T_min=8, T_max=30), 2)
    if mode == "off":
        with pytest.raises(ValueError, match="not ported"):
            tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=3, df_forward=mode))
        return
    calls = []
    real = cuda_forward.linesearch
    monkeypatch.setattr(cuda_forward, "linesearch", lambda *a, **k: calls.append(1) or real(*a, **k))
    res = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=3, df_forward=mode))
    auto = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=3))
    assert res.X.dtype == F32 and bool(torch.isfinite(res.J_star).all()) and calls
    assert torch.equal(res.X, auto.X) and torch.equal(res.J_star, auto.J_star)
    U0 = tilqr.default_U_init(p)
    X_df = rollout(ts, p, p.x0, U0)
    X_pl = [p.x0]
    for k in range(U0.shape[1]):
        X_pl.append(ts.safe_step(X_pl[-1], U0[:, k]))
    assert torch.equal(res.X[:, 0], X_df[:, 0])
    assert not torch.equal(X_df, torch.stack(X_pl, dim=1))  # the two rollouts differ in the last bits on the swing-up


def test_df_forward_changes_nothing_at_float64():
    ts, mk = get_system("DoubleIntegrator")
    p = tilqr.broadcast_problem(mk(N=24, device="cpu").replace(T_min=4, T_max=16), 2)
    base = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=4))
    other = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=4, df_forward="on"))
    assert torch.equal(other.X, base.X) and torch.equal(other.J_star, base.J_star)


@pytest.mark.parametrize("sd,dt", [("float64", F32), ("float32", torch.float64)])
def test_select_dtype_casts_the_select(sd, dt):
    """select_dtype casts the select's inputs (problem, X, U, A, B) to that
    dtype and its curve back to the problem's, as the JAX _select_curve
    does: the curve equals the select run on the cast inputs, cast back."""
    ts, mk = get_system("Quadrotor")
    p = tilqr.broadcast_problem(mk(N=32, device="cpu", dtype=dt).replace(T_min=8, T_max=32), 2)
    U = tilqr.default_U_init(p)
    X = rollout(ts, p, p.x0, U)
    A, B = linearize(ts.step, X, U)
    got = tilqr._select_curve(ts, p, tilqr.SolveOptions(psd_levels=1, select_dtype=sd), X, U, A, B)
    c = getattr(torch, sd)
    want = tilqr._select_curve(ts, _build.cast(p, c), tilqr.SolveOptions(psd_levels=1),
                               *(t.to(c) for t in (X, U, A, B)))
    assert got.dtype == dt and torch.equal(got, want.to(dt))


def test_float32_requests_of_the_unported_kernels_raise():
    """Once refused, now ported: the prefix-scan (#9) and query (#10)
    kernels at float32 (float32 blocks and C, float64 prefixes, float32 J),
    consistency_check, propagator_select_sharded, both latency modes and the
    inverse terminal query run on float32 problems and agree with the same
    calls on the float64 values (the solves: with select_dtype="float64"):
    T* equal or tied, J within rtol 1e-5."""
    from timeopt_tpu_torch.parallel import make_mesh, propagator_select_sharded
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb
    from timeopt_tpu_torch.solver.verify import consistency_check

    ts, mk = get_system("DoubleIntegrator")
    p = tilqr.broadcast_problem(mk(N=16, device="cpu", dtype=F32).replace(T_min=4, T_max=16), 2)
    U = tilqr.default_U_init(p)
    X = rollout(ts, p, p.x0, U)
    A, B = linearize(ts.step, X, U)
    blk = build_augmented(ts, p, X, U, A, B)
    C = build_terminal_factors(p, X, s=blk.s)
    up = lambda t: t.double()  # noqa: E731
    pre = cuda_lft_scan.lft_scan(blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug, levels=1)
    J = cuda_lft_query.lft_query(*pre, C, levels=1)
    assert all(t.dtype == torch.float64 for t in pre) and J.dtype == F32
    J64 = cuda_lft_query.lft_query(*cuda_lft_scan.lft_scan(up(blk.A_aug), brb(up(blk.B_aug), up(blk.R_inv)),
                                                           up(blk.Q_aug), levels=1), up(C), levels=1)
    np.testing.assert_allclose(J.numpy(), J64.numpy(), rtol=1e-5)

    p64 = _build.cast(p, torch.float64)
    cc, cc64 = consistency_check(ts, p, X, U), consistency_check(ts, p64, up(X), up(U))
    assert cc["J_prop"].dtype == cc["max_abs"].dtype == F32
    for k in ("J_prop", "J_bf"):
        np.testing.assert_allclose(cc[k].numpy(), cc64[k].numpy(), rtol=1e-5)
    mesh = make_mesh(device_type="cpu", n_devices=2, axis_names=("hs",))
    J_sh = propagator_select_sharded(blk, C, mesh=mesh)
    J_sh64 = propagator_select_sharded(type(blk)(*map(up, blk)), up(C), mesh=mesh)
    assert J_sh.dtype == F32
    np.testing.assert_allclose(J_sh.numpy(), J_sh64.numpy(), rtol=1e-5)

    w = float(p.w[0])
    for kw in (dict(scan_mode="associative"), dict(scan_mode="assoc_df"), dict(terminal_mode="inverse"),
               dict(scan_mode="associative", terminal_mode="inverse")):
        res = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=2, **kw))
        want = tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=2, select_dtype="float64", **kw))
        assert res.J_curve.dtype == F32 and bool(torch.isfinite(res.J_star).all())
        T, T_o, curve = res.T_star.numpy(), want.T_star.numpy(), want.J_curve.double().numpy()
        idx = np.arange(len(T))
        assert ((T == T_o) | (np.abs(curve[idx, T - 1] - curve[idx, T_o - 1]) <= w * (np.abs(T - T_o) + 1))).all()
        np.testing.assert_allclose(res.J_star.numpy(), want.J_star.numpy(), rtol=1e-5)


def test_no_tf32_inside_a_solve_and_the_settings_restored(monkeypatch):
    seen = []
    real = tilqr._select_curve

    def spy(*a, **k):
        seen.append((torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32))
        return real(*a, **k)

    monkeypatch.setattr(tilqr, "_select_curve", spy)
    saved = torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32
    try:
        torch.set_float32_matmul_precision("medium")
        torch.backends.cudnn.allow_tf32 = True
        ts, mk = get_system("DoubleIntegrator")
        p = tilqr.broadcast_problem(mk(N=16, device="cpu", dtype=F32).replace(T_min=4, T_max=16), 1)
        tilqr.solve_batch(ts, p, options=tilqr.SolveOptions(max_iter=1))
        assert seen and all(s == ("highest", False) for s in seen)
        assert torch.get_float32_matmul_precision() == "medium" and torch.backends.cudnn.allow_tf32
        with no_tf32():
            assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision(saved[0])
        torch.backends.cudnn.allow_tf32 = saved[1]


def test_runner_f32_one_double_integrator_trial(tmp_path):
    """--f32 through the runner on the CPU: trial 0 of the double
    integrator, the three solvers, rows finite and stored from float32
    solves; ourmethod and baseline1 give the committed float32 TPU run's
    T* (results/tpu_f32: 25) and J* within rtol 1e-5."""
    import csv

    from timeopt_tpu_torch.runner import run_suite

    run_suite.main(["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "1", "--f32", "--outdir",
                    str(tmp_path)])
    rows = {r["solver"]: r for r in csv.DictReader(open(tmp_path / "summary_all.csv", newline=""))}
    assert set(rows) == {"ourmethod", "baseline1", "baseline2"}
    for r in rows.values():
        assert np.isfinite(float(r["J_star"])) and np.isfinite(float(r["final_err"])) and r["success"] == "True"
    for s in ("ourmethod", "baseline1"):
        assert rows[s]["T_star"] == "25"
        np.testing.assert_allclose(float(rows[s]["J_star"]), 6.544382095336914, rtol=1e-5)
    # J* is a float32 value, written as its float64 repr
    assert float(np.float32(float(rows["ourmethod"]["J_star"]))) == float(rows["ourmethod"]["J_star"])


def test_bench_torch_main_on_the_cpu(monkeypatch):
    """bench_torch.main(device="cpu") at B=4 and a short horizon prints
    exactly one JSON line with bench.py's keys, naming float32."""
    import bench_torch

    for k, v in dict(BENCH_BATCH="4", BENCH_N="20", BENCH_REPS="1", BENCH_PIPE="2",
                     BENCH_CASE="DoubleIntegrator").items():
        monkeypatch.setenv(k, v)
    buf = io.StringIO()
    with redirect_stdout(buf):
        line = bench_torch.main(device="cpu")
    out = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(out) == 1 and json.loads(out[0]) == line
    assert list(line) == ["metric", "value", "unit", "vs_baseline", "batch", "pipeline", "batch_time_s",
                          "success_rate", "T_star_median"]
    assert "float32" in line["metric"] and "CPU" in line["metric"] and "N=20" in line["metric"]
    assert line["batch"] == 4 and line["pipeline"] == 2 and line["unit"] == "solves/s" and line["value"] > 0
    if not torch.cuda.is_available():  # the default device is the card; nothing falls back
        with pytest.raises(RuntimeError):
            bench_torch.main()


def test_bench_torch_problems_are_bench_py_s():
    """bench.py's float32 problem set, bit for bit: x0[:, :3] += 0.4 N(0,1)
    for the quadrotor, x0 += sigma_x0 N(0, 1) otherwise (float32 draws of
    default_rng(0))."""
    import bench_torch

    for case in ("Quadrotor", "Cartpole_SwingUp"):
        js, jmk = jax_get_system(case)
        base = jmk(dtype=jnp.float32)
        rng = np.random.default_rng(0)
        x0s = np.tile(np.asarray(base.x0, np.float32), (6, 1))
        if case == "Quadrotor":
            x0s[:, :3] += 0.4 * rng.standard_normal((6, 3)).astype(np.float32)
        else:
            x0s += np.asarray(js.sigma_x0, np.float32) * rng.standard_normal(x0s.shape).astype(np.float32)
        _, probs = bench_torch.bench_problems(case, 6, 0)
        assert probs.x0.dtype == F32 and np.array_equal(probs.x0.numpy(), x0s)
