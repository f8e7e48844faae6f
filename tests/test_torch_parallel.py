"""The port's scale-out layer (timeopt_tpu_torch/parallel/) on the CPU.

- A CPU mesh of 4 (and 3: 8 problems do not split evenly) entries of the
  CPU: solve_batch_sharded against solve_batch on 8 tiny double-integrator
  problems, T* and T_ties identical, J*, X and U within rtol 1e-12, and
  against the JAX package's solve_batch of the same problems (T* and
  T_ties identical, J* within rtol 1e-9, X within rtol 1e-7 / atol 1e-9,
  as tests/test_torch_assoc.py holds a solve).
- propagator_select_sharded with the terminal queries over 3 hs entries
  (N = 16 is padded to 18) against the unsharded select (rtol 1e-12; the
  sequential and the associative scan), which tests/test_torch_scan_query.py
  and tests/test_torch_assoc.py hold against the JAX package.
- t_star_histogram and batch_summary against the JAX package's, and
  process_batch_bounds against the JAX function on (B, world).
- Two processes under gloo (the counterpart of tests/test_multihost.py):
  this file run as a script, once a rank. The gathered solve equals a
  one-process solve_batch (T* and T_ties identical, J*, X, U within rtol
  1e-12) and the JAX package's solve of the same problems (as above), the
  reduced statistics equal the whole batch's, and the runner
  with --distributed gives the rows of the runner without it, written by
  rank 0 alone.
"""

from __future__ import annotations

import csv
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script by the 2-process test
    sys.path.insert(0, REPO)

from timeopt_tpu_torch.models import get_system  # noqa: E402
from timeopt_tpu_torch.models.base import make_problem  # noqa: E402
from timeopt_tpu_torch.parallel import (  # noqa: E402
    batch_summary,
    distributed,
    make_mesh,
    propagator_select_sharded,
    shard_problems,
    solve_batch_sharded,
    t_star_histogram,
)
from timeopt_tpu_torch.solver.ilqr import SolveOptions, broadcast_problem, solve_batch  # noqa: E402

torch.set_num_threads(1)
OPTS = SolveOptions(max_iter=6)
RUNNER_ARGS = ["--device", "cpu", "--cases", "DoubleIntegrator", "--trials", "3", "--solvers", "ourmethod",
               "--max-iter", "3"]


def tiny_batch(B: int = 8, seed: int = 95):
    """The tiny double integrator of tests/helpers.py (N 24, T in [4, 16])
    with x0 perturbed, built by the port alone (the 2-process workers
    import no JAX)."""
    system = get_system("DoubleIntegrator")[0]
    base = make_problem(x0=[1.0, 0.0], xg=[2.0, 0.0], u_ref=[0.0], Q=[[1.0, 0.0], [0.0, 0.1]], R=[[1e-2]],
                        alpha=50.0, w=0.02, N=24, T_min=4, T_max=16, device="cpu")
    x0 = base.x0.numpy() + 0.2 * np.random.default_rng(seed).standard_normal((B, 2))
    return system, broadcast_problem(base, B).replace(x0=torch.as_tensor(x0))


def jax_solve(B: int = 8, seed: int = 95):
    """The JAX package's solve_batch (f64, the CPU) of tiny_batch(B, seed)'s
    problems, built from tests/helpers.tiny_double_integrator; checks that
    the two packages' problems are the same numbers."""
    import jax.numpy as jnp

    from tests.helpers import tiny_double_integrator
    from tests.torch_helpers import to_torch_problem
    from timeopt_tpu.solver import ilqr as jilqr

    js, base = tiny_double_integrator()
    x0 = np.asarray(base.x0) + 0.2 * np.random.default_rng(seed).standard_normal((B, 2))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    mine = tiny_batch(B, seed)[1].tensors()
    for f, t in to_torch_problem(jp).tensors().items():
        assert torch.equal(t, mine[f]), f
    return jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(max_iter=OPTS.max_iter))


def assert_matches_jax(got, want):
    """T* and T_ties identical; J* within rtol 1e-9, X within rtol 1e-7 /
    atol 1e-9 of the JAX package's solve."""
    np.testing.assert_array_equal(np.asarray(got.T_star), np.asarray(want.T_star))
    np.testing.assert_array_equal(np.asarray(got.T_ties), np.asarray(want.T_ties))
    np.testing.assert_allclose(np.asarray(got.J_star), np.asarray(want.J_star), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(got.X), np.asarray(want.X), rtol=1e-7, atol=1e-9)


def assert_same_result(got, want):
    """T* and T_ties identical; J*, X and U within rtol 1e-12."""
    g = {f: np.asarray(getattr(got, f)) for f in ("T_star", "T_ties", "J_star", "X", "U")}
    w = {f: getattr(want, f).numpy() for f in g}
    np.testing.assert_array_equal(g["T_star"], w["T_star"])
    np.testing.assert_array_equal(g["T_ties"], w["T_ties"])
    for f in ("J_star", "X", "U"):
        np.testing.assert_allclose(g[f], w[f], rtol=1e-12, atol=0, err_msg=f)


@pytest.mark.parametrize("k", [4, 3])
def test_solve_batch_sharded_matches_solve_batch(k):
    system, probs = tiny_batch()
    mesh = make_mesh(k, device_type="cpu")
    assert mesh.shape == {"dp": k}
    chunks = shard_problems(probs, mesh)
    assert [c.batch for c in chunks] == [len(r) for r in np.array_split(np.arange(8), k)]
    assert torch.equal(torch.cat([c.x0 for c in chunks]), probs.x0)
    got = solve_batch_sharded(system, probs, options=OPTS, mesh=mesh)
    assert_same_result(got, solve_batch(system, probs, options=OPTS))
    assert_matches_jax(got, jax_solve())


def test_make_mesh_shapes_and_errors():
    mesh = make_mesh(6, axis_names=("dp", "hs"), shape=(2, 3), device_type="cpu")
    assert mesh.shape == {"dp": 2, "hs": 3} and len(mesh.axis_devices("hs")) == 3
    with pytest.raises(ValueError, match="shape required"):
        make_mesh(4, axis_names=("dp", "hs"), device_type="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def _tiny_blocks():
    """The tiny batch's first-iterate blocks (B 8, N 16 = T_max)."""
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.cost import rollout
    from timeopt_tpu_torch.solver.ilqr import default_U_init
    from timeopt_tpu_torch.solver.linearize import linearize

    system, probs = tiny_batch()
    U = default_U_init(probs) + 0.05 * torch.as_tensor(np.random.default_rng(96).standard_normal((8, 24, 1)))
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    Tm = probs.T_max
    blk = build_augmented(system, probs, X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], Bj[:, :Tm])
    return blk, build_terminal_factors(probs, X[:, : Tm + 1], s=blk.s)


@pytest.mark.parametrize("scan_mode", ["sequential", "associative"])
def test_propagator_select_sharded_matches_unsharded(scan_mode):
    from timeopt_tpu_torch.solver.horizon import propagator_select

    blk, C = _tiny_blocks()
    mesh = make_mesh(3, axis_names=("dp", "hs"), shape=(1, 3), device_type="cpu")
    J = propagator_select_sharded(blk, C, mesh, scan_mode=scan_mode)
    want = propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, scan_mode=scan_mode)
    assert J.shape == (8, 16)
    np.testing.assert_allclose(J.numpy(), want.numpy(), rtol=1e-12, atol=0)


def _stats_inputs():
    rng = np.random.default_rng(97)
    T = rng.integers(4, 17, size=11)
    J = rng.uniform(1, 5, size=11)
    J[3] = np.inf
    err = rng.uniform(0, 1, size=11)
    err[5] = np.nan
    return T, J, err


def test_stats_match_jax():
    import jax.numpy as jnp

    from timeopt_tpu.parallel import batch_summary as jax_summary
    from timeopt_tpu.parallel import t_star_histogram as jax_hist

    T, J, err = _stats_inputs()
    h = t_star_histogram(torch.as_tensor(T), 16)
    np.testing.assert_array_equal(h.numpy(), np.asarray(jax_hist(jnp.asarray(T), 16)))
    s, js = batch_summary(torch.as_tensor(J), torch.as_tensor(err)), jax_summary(jnp.asarray(J), jnp.asarray(err))
    assert int(s["n"]) == int(js["n"]) == 11 and int(s["n_success"]) == int(js["n_success"])
    # the JAX package's local rate is a float32 mean; the port's float64 k / n
    assert np.float32(s["success_rate"]) == np.asarray(js["success_rate"])
    assert float(s["success_rate"]) == int(s["n_success"]) / 11


@pytest.mark.parametrize("B,world", [(8, 1), (8, 3), (5, 4), (3, 4), (1024, 7)])
def test_process_batch_bounds_matches_jax(B, world, monkeypatch):
    from timeopt_tpu.parallel import distributed as jdist

    for rank in range(world):
        monkeypatch.setattr(jdist.jax, "process_count", lambda: world)
        monkeypatch.setattr(jdist.jax, "process_index", lambda: rank)
        monkeypatch.setattr(distributed, "process_count", lambda: world)
        monkeypatch.setattr(distributed, "process_index", lambda: rank)
        assert distributed.process_batch_bounds(B) == jdist.process_batch_bounds(B)


def test_single_process_is_a_no_op(tmp_path, monkeypatch):
    """Without WORLD_SIZE nothing is initialized: one rank, the whole batch,
    results to numpy; the runner's --distributed runs as one process and
    rejects per-solve and phase timing as the JAX runner does."""
    from timeopt_tpu_torch.runner import run_suite

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    distributed.initialize("cpu")
    assert not distributed.is_initialized() and distributed.process_batch_bounds(5) == (0, 5)
    assert distributed.local_device("cpu") == torch.device("cpu")
    system, probs = tiny_batch(3)
    res = distributed.gather_results(distributed.solve_batch_global(system, probs, options=OPTS, device="cpu"))
    assert_same_result(res, solve_batch(system, probs, options=OPTS))
    distributed.sync_processes()
    for extra in (["--timing", "per-solve"], ["--phase-timers"]):
        with pytest.raises(ValueError, match="amortized"):
            run_suite.main(RUNNER_ARGS + ["--distributed", "--outdir", str(tmp_path)] + extra)


def _final_errs(res, probs) -> torch.Tensor:
    """||x_T* - x_g|| of each problem (the double integrator wraps nothing)."""
    return (res.X[torch.arange(probs.batch), res.T_star] - probs.xg).norm(dim=-1)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rows(path: str) -> list:
    """The rows of a summary_all.csv without the columns of this run's clock."""
    with open(path, newline="") as f:
        return [{k: v for k, v in r.items() if k not in ("total_time", "compile_and_run_s", "time_base",
                                                          "time_ratio_base")} for r in csv.DictReader(f)]


def test_two_processes_gloo(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), WORLD_SIZE="2", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(tmp_path)],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=120)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outs.append(p.communicate()[0])
    for r, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{o}"

    data = np.load(tmp_path / "gathered.npz")
    system, probs = tiny_batch(7)
    want = solve_batch(system, probs, options=OPTS)
    assert_same_result(types.SimpleNamespace(**data), want)
    assert_matches_jax(types.SimpleNamespace(**data), jax_solve(7))
    np.testing.assert_array_equal(data["hist"], t_star_histogram(want.T_star, probs.T_max).numpy())
    local = batch_summary(want.J_star, _final_errs(want, probs))
    assert [int(x) for x in data["summary"]] == [int(local["n"]), int(local["n_success"])]
    assert float(data["rate"]) == float(local["success_rate"])

    from timeopt_tpu_torch.runner import run_suite

    run_suite.main(RUNNER_ARGS + ["--outdir", str(tmp_path / "single")])
    assert _rows(tmp_path / "rank0" / "summary_all.csv") == _rows(tmp_path / "single" / "summary_all.csv")
    assert not (tmp_path / "rank1").exists() or not any((tmp_path / "rank1").iterdir())


def _worker(out: str) -> None:
    """One rank of test_two_processes_gloo (environment from the test)."""
    from timeopt_tpu_torch.runner import run_suite

    distributed.initialize("cpu")
    rank = distributed.process_index()
    assert distributed.process_count() == 2 and distributed.is_multiprocess()
    system, probs = tiny_batch(7)
    lo, hi = distributed.process_batch_bounds(7)
    local = probs.replace(**{f: t[lo:hi] for f, t in probs.tensors().items()})
    res = distributed.solve_batch_global(system, local, options=OPTS)
    gathered = distributed.gather_results(res)
    hist = t_star_histogram(res.T_star, probs.T_max)
    summ = batch_summary(res.J_star, _final_errs(res, local))
    if rank == 0:
        np.savez(os.path.join(out, "gathered.npz"), T_star=gathered.T_star, T_ties=gathered.T_ties,
                 J_star=gathered.J_star, X=gathered.X, U=gathered.U, hist=hist.numpy(),
                 summary=np.array([int(summ["n"]), int(summ["n_success"])]), rate=float(summ["success_rate"]))
    run_suite.main(RUNNER_ARGS + ["--distributed", "--outdir", os.path.join(out, f"rank{rank}")])
    distributed.sync_processes()
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1])
