"""The work counts behind each kernel's roofline bound (timeopt_tpu_torch/ops/work.py).

chip_smoke.py divides these counts by the card's peaks to give `bound_ms`;
here they are checked against hand counts on small shapes and for the parts
that depend on the data (the select's T_min, the backward's T*).
"""

from __future__ import annotations

import numpy as np
import pytest

from timeopt_tpu_torch.ops import work


def test_bound_takes_the_larger_time():
    ops = work.bound(work.PEAK_FLOPS * 1e-3, 1.0)
    assert ops["bound_by"] == "operations" and ops["bound_ms"] == pytest.approx(1.0)
    assert ops["bound_ms_cuda_cores"] == pytest.approx(work.PEAK_FLOPS / work.PEAK_FLOPS_CUDA_CORES)
    mem = work.bound(1.0, work.PEAK_BYTES * 2e-3)
    assert mem["bound_by"] == "bytes" and mem["bound_ms"] == pytest.approx(2.0)
    assert mem["bound_ms_cuda_cores"] == pytest.approx(2.0)


def test_elimination_counts_by_hand():
    # one pivot: the 4 entries of R divided, no other row
    assert work.gj(1, 5) == 4
    # 2 x 3: the first pivot changes 2 columns (row 0's division, row 1's
    # multiply-add), the second only the right column
    assert work.gj(2, 3) == 2 * (1 + 2) + 1 * (1 + 2)
    # 2 x 2 down to the last pivot: one division, one multiply-add
    assert work.last_pivot(2) == 1 + 2
    assert work.last_pivot(1) == 0
    assert work.mm(2, 3, 4) == 48


@pytest.mark.parametrize("r, c", [(1, 5), (2, 3), (4, 9), (12, 25), (13, 39)])
def test_elimination_count_matches_a_counted_sweep(r, c):
    """gj(r, c) against a Gauss-Jordan sweep run here that counts, at each
    pivot, the divisions and multiply-adds of the columns that still change;
    the sweep must solve the system."""
    rng = np.random.default_rng(r * c)
    M0 = rng.standard_normal((r, c)) + r * np.eye(r, c)
    M, ops = M0.copy(), 0
    for i in range(r):
        cols = [j for j in range(c) if j != i and not (j < r and np.array_equal(M[:, j], np.eye(r)[:, j]))]
        M[i, cols] /= M[i, i]
        M[i, i] = 1.0
        ops += len(cols)
        for q in range(r):
            if q != i:
                M[q, cols] -= M[q, i] * M[i, cols]
                M[q, i] = 0.0
                ops += 2 * len(cols)
    np.testing.assert_allclose(M[:, r:], np.linalg.solve(M0[:, :r], M0[:, r:]), rtol=1e-9, atol=1e-12)
    assert ops == work.gj(r, c)


def test_fused_select_query_forms_fet_once():
    """Each W0-form query: the sweep, X0 and its last pivot, K, and FEt
    formed once (2 n p), not inside every term of the p x p product."""
    B, N, n, m = 2, 6, 4, 2
    p = n + 1
    per_query = (work.select_fused(B, N, n, m, 1)["flops"] - work.select_fused(B, N, n, m, N)["flops"]) / (B * (N - 1))
    assert per_query == work._query(n, p) + 6 * n * n + n + 2 * n * p


@pytest.mark.parametrize("count", [work.select_fused, work.select_generic])
def test_select_counts_queries_from_t_min(count):
    """The queries run for horizons t >= T_min only; the bytes do not change."""
    B, N, n, m = 4, 10, 3, 2
    full, none_but_last = count(B, N, n, m, 1), count(B, N, n, m, N)
    per_query = (full["flops"] - none_but_last["flops"]) / (B * (N - 1))
    assert per_query > 0 and per_query == int(per_query)
    assert count(B, N, n, m, 6)["flops"] == pytest.approx(none_but_last["flops"] + B * 4 * per_query)
    assert full["bytes"] == none_but_last["bytes"]


def test_backward_counts_only_the_active_steps():
    N, n, m = 8, 4, 1
    idle = work.backward([0, 0], N, n, m)
    assert idle["flops"] == 0
    half, whole, clipped = (work.backward(T, N, n, m) for T in ([4, 4], [8, 8], [20, 8]))
    assert whole["flops"] == pytest.approx(2 * half["flops"]) and clipped["flops"] == whole["flops"]
    assert idle["bytes"] < half["bytes"] < whole["bytes"]


def test_main_path_bounds():
    """The quadrotor at B=1024, N=160, T_min=40: the select is bound by
    operations (~44 kFLOP per step), the line search and the backward by
    bytes."""
    sel = work.select_fused(1024, 160, 12, 4, 40)
    assert sel["bound_by"] == "operations"
    assert 43e3 < sel["flops"] / (1024 * 160) < 45e3
    assert 0.3e9 < sel["bytes"] < 0.35e9
    ls = work.linesearch("Quadrotor", [51] * 1024, 160, 12, 4, 5)
    assert ls["bound_by"] == "bytes" and 0.18e9 < ls["bytes"] < 0.21e9
    assert work.backward([51] * 1024, 160, 12, 4)["bound_by"] == "bytes"
    for f in (work.lft_scan, work.lft_query):
        assert f(1024, 160, 12)["bound_by"] == "bytes"


def test_start_state_linesearch_bound():
    """The one-pass method's rollouts from their start states (quadrotor,
    3 x 1024 rollouts, 4 alphas, each at its own T*): the same operations
    as the ordinary entry at those T*, plus the start states read (8 B n
    bytes more); bound by bytes."""
    T = [40 + (i % 121) for i in range(3 * 1024)]
    plain = work.linesearch("Quadrotor", T, 160, 12, 4, 4)
    ls = work.linesearch("Quadrotor", T, 160, 12, 4, 4, x_start=True)
    assert ls["flops"] == plain["flops"] and ls["bytes"] == plain["bytes"] + 8 * 3 * 1024 * 12
    assert ls["bound_by"] == "bytes" and ls["bound_ms"] > plain["bound_ms"]


@pytest.mark.parametrize("kernel", ["select_fused", "select_generic", "backward", "linesearch", "linesearch_from"])
def test_float32_counts_the_storage_bytes(kernel):
    """At float32 storage (itemsize 4) every float input and output counts
    4 bytes, the float64 k-constants of the fused select and the alphas of
    the line search 8, T* (int64) 8 and the wrap mask and ok (bool) 1; the
    operations (float64 arithmetic on both paths) do not change. Counted by
    hand on small shapes."""
    B, N, n, m, t_min, A = 3, 7, 4, 2, 2, 5
    T = [0, 4, 9]
    act = sum(min(max(t, 0), N) for t in T)
    calls = {
        "select_fused": lambda i: work.select_fused(B, N, n, m, t_min, itemsize=i),
        "select_generic": lambda i: work.select_generic(B, N, n, m, t_min, itemsize=i),
        "backward": lambda i: work.backward(T, N, n, m, itemsize=i),
        "linesearch": lambda i: work.linesearch("PointMass_Navigation", T, N, n, m, A, itemsize=i),
        "linesearch_from": lambda i: work.linesearch("PointMass_Navigation", T, N, n, m, A, x_start=True,
                                                    itemsize=i),
    }
    p = n + 1
    floats = {  # float elements in storage type; the rest in bytes at fixed widths
        "select_fused": (B * N * (n * n + n * m + 4 * n + 4) + B * N, 8 * B * (2 * n * n + m * m)),
        "select_generic": (B * N * (2 * p * p + p * m + n * p) + B * m * m + B * N, 0),
        "backward": (act * (2 * n * n + n * m + n + m + 1) + B * (n + 1 + n * n + m * m + 1) + B * N * (m + m * n),
                     8 * B + B),
        "linesearch": (B * ((N + 1) * n + N * (m + m * n + m)) + B * (n + m + 2 * n * n + m * m + 1)
                       + B * A * ((N + 1) * n + N * m + 1), 8 * A + 8 * B + B * n),
    }
    floats["linesearch_from"] = (floats["linesearch"][0] + B * n, floats["linesearch"][1])
    f64, f32 = calls[kernel](8), calls[kernel](4)
    elems, fixed = floats[kernel]
    assert f64["bytes"] == 8 * elems + fixed and f32["bytes"] == 4 * elems + fixed
    assert f32["flops"] == f64["flops"]


def test_float32_main_path_bounds():
    """The quadrotor at B=1024 (select T_min 40, T* 51) and PointMass
    (N=220): float32 storage halves every kernel's bytes but the fused
    select's k-constants; the select stays bound by operations, so its
    bound does not move; the line search and the backward stay bound by
    bytes at about half their float64 bound."""
    s64, s32 = work.select_fused(1024, 160, 12, 4, 40), work.select_fused(1024, 160, 12, 4, 40, itemsize=4)
    assert s64 == work.select_fused(1024, 160, 12, 4, 40, itemsize=8)  # float64 is the default
    assert s32["bound_by"] == "operations" and s32["bound_ms"] == s64["bound_ms"]
    assert 0.5 < s32["bytes"] / s64["bytes"] < 0.51
    for f in (lambda i: work.linesearch("Quadrotor", [51] * 1024, 160, 12, 4, 5, itemsize=i),
              lambda i: work.backward([51] * 1024, 160, 12, 4, itemsize=i),
              lambda i: work.select_generic(1024, 220, 4, 2, 50, itemsize=i)):
        b64, b32 = f(8), f(4)
        assert b32["bound_by"] == "bytes" and 0.49 < b32["bound_ms"] / b64["bound_ms"] < 0.52
