"""The port's serving entry on the CPU: the device-resident sharded solve,
bench_torch.py's dp-sharded default and bench_sustained_torch.py's stream.

- solve_batch_resident over a CPU mesh of 2 and of 3 entries (8 tiny
  double-integrator problems) against each chunk's own solve_batch and the
  whole batch's (T* and T_ties identical, J*, X and U within rtol 1e-12),
  and against the JAX package's solve_batch of the same numpy inputs
  (T* and T_ties identical, J* rtol 1e-9, X rtol 1e-7 / atol 1e-9, as
  tests/test_torch_parallel.py holds solve_batch_sharded);
- bench_torch.main(device="cpu") with BENCH_SHARDED=1 over a two-entry CPU
  mesh: one JSON line with bench.py's keys, dp-sharded in its metric, and
  T* and J* equal to BENCH_SHARDED=0's one-device solve;
- the stream (bench_sustained_torch.sustained) for about 1 s at B=4, N=20
  on the double integrator with a big batch of 8: its record's keys in
  the order of results/bench_sustained_r05.json (the JAX script's
  record), and the big batch's rows 0-3 with the B=4 batch's T*;
- bench_problems(case, 8192, 0)'s first 1024 x0 rows bit for bit
  bench_problems(case, 1024, 0)'s, so the two batches share those
  problems.
"""

from __future__ import annotations

import io
import json
import os
import types
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import bench_sustained_torch
import bench_torch
from tests.test_torch_parallel import OPTS, assert_matches_jax, assert_same_result, jax_solve, tiny_batch
from timeopt_tpu_torch.parallel import make_mesh, shard_problems, solve_batch_resident
from timeopt_tpu_torch.solver.ilqr import default_U_init, solve_batch

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("T_star", "T_ties", "J_star", "X", "U")
BENCH_ENV = dict(BENCH_BATCH="4", BENCH_N="20", BENCH_REPS="1", BENCH_PIPE="2", BENCH_CASE="DoubleIntegrator")


def _cat(results) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{f: torch.cat([getattr(r, f) for r in results]) for f in FIELDS})


@pytest.mark.parametrize("k", [2, 3])
def test_solve_batch_resident_matches_solve_batch(k):
    system, probs = tiny_batch()
    parts = shard_problems(probs, make_mesh(k, device_type="cpu"))
    results = solve_batch_resident(system, parts, options=OPTS)
    assert len(results) == k and [r.T_star.shape[0] for r in results] == [p.batch for p in parts]
    for p, r in zip(parts, results):
        assert_same_result(r, solve_batch(system, p, options=OPTS))
    got = _cat(results)
    assert_same_result(got, solve_batch(system, probs, options=OPTS))
    assert_matches_jax(got, jax_solve())


def test_solve_batch_resident_inputs():
    """U_inits one a chunk (the default: each chunk's u_ref tiled), a count
    that does not match the chunks raises, and chunks left empty by a batch
    smaller than the mesh get no result."""
    system, probs = tiny_batch()
    parts = shard_problems(probs, make_mesh(2, device_type="cpu"))
    want = solve_batch_resident(system, parts, options=OPTS)
    got = solve_batch_resident(system, parts, [default_U_init(p) for p in parts], OPTS)
    for g, w in zip(got, want):
        assert_same_result(g, w)
    with pytest.raises(ValueError, match="U_inits"):
        solve_batch_resident(system, parts, [default_U_init(parts[0])], OPTS)
    system, small = tiny_batch(2)
    parts = shard_problems(small, make_mesh(3, device_type="cpu"))
    assert [p.batch for p in parts] == [1, 1, 0]
    assert_same_result(_cat(solve_batch_resident(system, parts, options=OPTS)),
                       solve_batch(system, small, options=OPTS))


def _bench_line(monkeypatch, sharded: str) -> dict:
    for key, v in dict(BENCH_ENV, BENCH_SHARDED=sharded).items():
        monkeypatch.setenv(key, v)
    buf = io.StringIO()
    with redirect_stdout(buf):
        line = bench_torch.main(device="cpu", n_devices=2)
    out = [ln for ln in buf.getvalue().splitlines() if ln.strip()]
    assert len(out) == 1 and json.loads(out[0]) == line
    return line


def test_bench_torch_sharded_on_a_cpu_mesh(monkeypatch):
    sharded, single = _bench_line(monkeypatch, "1"), _bench_line(monkeypatch, "0")
    keys = ["metric", "value", "unit", "vs_baseline", "batch", "pipeline", "batch_time_s", "success_rate",
            "T_star_median"]
    assert list(sharded) == keys and list(single) == keys
    assert "dp-sharded, 2 x CPU, float32" in sharded["metric"] and "dp-sharded" not in single["metric"]
    assert "1 x CPU" in single["metric"]
    for key in ("success_rate", "T_star_median", "batch", "pipeline"):
        assert sharded[key] == single[key], key

    system, probs = bench_torch.bench_problems("DoubleIntegrator", 4, 20)
    parts = shard_problems(probs, make_mesh(2, device_type="cpu"))
    outs, checksum = bench_torch.make_bench(system, parts)()
    outs1, checksum1 = bench_torch.make_bench(system, [probs])()
    assert len(outs) == 2 and len(outs1) == 1
    J, T, err, succ = bench_torch.summary(outs)
    J1, T1, err1, succ1 = bench_torch.summary(outs1)
    np.testing.assert_array_equal(T, T1)
    np.testing.assert_allclose(J, J1, rtol=1e-6)
    np.testing.assert_array_equal(succ, succ1)
    np.testing.assert_allclose(float(checksum), float(checksum1), rtol=1e-6)


def test_sustained_stream_on_the_cpu():
    mesh = make_mesh(2, device_type="cpu")
    record, arrays = bench_sustained_torch.sustained(mesh, 1.0, 4, 1, 8, case="DoubleIntegrator", bench_n=20)
    with open(os.path.join(REPO, "results", "bench_sustained_r05.json")) as f:
        jax_record = json.load(f)
    assert list(record) == list(jax_record)
    assert list(record["big_batch"]) == list(jax_record["big_batch"])
    assert "2 x CPU, float32" in record["metric"] and "B=4, PIPE=1" in record["metric"]
    assert record["n_batches"] >= 2 and record["duration_s"] >= 1.0 and record["value"] > 0
    assert record["p50_batch_s"] <= record["p99_batch_s"] <= record["max_batch_s"]
    assert record["big_batch"]["batch"] == 8 and record["big_batch"]["solves_per_s"] > 0
    np.testing.assert_array_equal(arrays["T"], arrays["T_first"])
    np.testing.assert_array_equal(arrays["T_big"][:4], arrays["T"])
    assert arrays["J"].tobytes() == arrays["J_first"].tobytes()
    assert 0.0 <= record["success_rate"] <= 1.0
    if not torch.cuda.is_available():  # the default is the card; nothing falls back
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bench_sustained_torch.main()


@pytest.mark.parametrize("case", ["Quadrotor", "DoubleIntegrator"])
def test_big_batch_shares_the_first_rows(case):
    _, big = bench_torch.bench_problems(case, 8192, 0)
    _, small = bench_torch.bench_problems(case, 1024, 0)
    assert big.batch == 8192 and small.batch == 1024
    assert big.x0[:1024].numpy().tobytes() == small.x0.numpy().tobytes()
