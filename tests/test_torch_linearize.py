"""Parity of the port's finite-difference linearization modes
(solver/linearize.py, "central" and "forward") with the JAX reference in
f64 on the CPU, on every system, atol 1e-12: the same stencils and
relative steps, so the Jacobians differ only by the steps' last-bit
differences divided by the step size. Forward mode poisons a step's A and
B with NaN where its base evaluation is not finite, as the reference does.

The exact Jacobians of a registry system's step come, on the card, from
the kernel of csrc/linearize.cu. Here, without a card: the dispatch of
`linearize` (the kernel only for mode "ad" of a step with a device_id on a
card tensor), and the kernel's own arithmetic, `jacobian_column` on the
dual numbers of csrc/dual.cuh and the dynamics of csrc/systems.cuh, built
with g++ and held to linearize_ad.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from tests.torch_helpers import T, iterate, problems
from timeopt_tpu.solver.linearize import linearize as jax_linearize
from timeopt_tpu_torch.solver import ilqr as tilqr
from timeopt_tpu_torch.solver.linearize import linearize

torch.set_num_threads(1)
CASES = ("DoubleIntegrator", "Cartpole_SwingUp", "Quadrotor", "Segway_Balance", "Ballbot_Balance",
         "PointMass_Navigation")


def _fd_pair(case, mode, poison=False):
    js, ts, jp, tp = problems(case, 2, 12, 4, 12, seed=70)
    X, U, _, _ = iterate(js, jp, seed=71)
    if poison:
        X = X.copy()
        X[1, 5, 0] = np.nan  # the base evaluation of step 5 of problem 1 is NaN
    want = jax.vmap(lambda x, u: jax_linearize(js.step, x, u, mode))(X, U)
    got = linearize(ts.step, T(X), T(U), mode)
    return got, [np.asarray(w) for w in want]


@pytest.mark.parametrize("mode", ["central", "forward"])
@pytest.mark.parametrize("case", CASES)
def test_fd_jacobians_match_jax(case, mode):
    got, want = _fd_pair(case, mode)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("mode", ["central", "forward"])
def test_nonfinite_base_matches_jax(mode):
    """Forward mode: NaN in every entry of the step's A and B; central mode
    carries the NaN through its stencil as the reference does."""
    got, want = _fd_pair("Quadrotor", mode, poison=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.isnan(g.numpy()), np.isnan(w))
        f = np.isfinite(w)
        np.testing.assert_allclose(g.numpy()[f], w[f], rtol=0, atol=1e-12)
    if mode == "forward":
        assert np.isnan(got[0][1, 5].numpy()).all() and np.isnan(got[1][1, 5].numpy()).all()
        assert np.isfinite(got[0][0].numpy()).all()


def test_solve_with_central_diff_matches_ad_closely():
    """The runner's --use-central-diff path: a solve with FD Jacobians picks
    the same horizons as one with AD Jacobians on the double integrator
    (linear dynamics: FD is exact up to rounding)."""
    _, ts, _, tp = problems("DoubleIntegrator", 2, 30, 8, 24, seed=72)
    ad = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=4))
    fd = tilqr.solve_batch(ts, tp, options=tilqr.SolveOptions(max_iter=4, linearize_mode="central"))
    assert torch.equal(ad.T_star, fd.T_star)
    np.testing.assert_allclose(fd.J_star.numpy(), ad.J_star.numpy(), rtol=1e-8)


# ---- the Jacobian kernel of the registry systems (csrc/linearize.cu) ----

IDS = {"DoubleIntegrator": 0, "Quadrotor": 1, "Cartpole_SwingUp": 2, "Segway_Balance": 3, "Ballbot_Balance": 4,
       "PointMass_Navigation": 5, "Rocket6DoF": 6}


def test_registry_steps_carry_their_device_id():
    """Each registry model's Euler step carries its System's device_id, the
    struct of csrc/systems.cuh whose Jacobian the kernel takes."""
    from timeopt_tpu_torch.models import get_system

    for case, i in IDS.items():
        system = get_system(case)[0]
        assert system.device_id == i and system.step.device_id == i
        assert system.step.euler_ingredients[1] == system.dt


def _pretend_card(monkeypatch):
    """linearize's dispatch as it runs on the card (on_card True), with the
    kernel replaced by a recorder: the calls it gets, and what it returns."""
    from timeopt_tpu_torch.ops import cuda_linearize
    from timeopt_tpu_torch.solver import linearize as lin

    calls = []

    def kernel(device_id, dt, X, U):
        calls.append((device_id, dt))
        return "kernel", "kernel"

    monkeypatch.setattr(lin._build, "on_card", lambda x, phase: True)
    monkeypatch.setattr(cuda_linearize, "jacobians", kernel)
    return calls


@pytest.mark.parametrize("which", ["registry step, ad", "step without device_id, ad", "central", "forward",
                                   "CPU tensors"])
def test_dispatch_takes_the_kernel_only_for_a_registry_step_in_ad_mode(monkeypatch, which):
    """On the card, mode "ad" of a step that carries a device_id launches
    the kernel (with the step's dt); a step without one (a user's System)
    runs linearize_ad, and "central" and "forward" their stencils. On CPU
    tensors "ad" runs linearize_ad for every step."""
    from timeopt_tpu_torch.models.base import euler_step_fn
    from timeopt_tpu_torch.solver.cost import rollout
    from timeopt_tpu_torch.solver.linearize import linearize_ad, linearize_fd

    _, system, _, tp = problems("Quadrotor", 2, 6, 2, 6, seed=73)
    U = tp.u_ref[:, None].expand(-1, 6, -1).contiguous()
    X = rollout(system, tp, tp.x0, U)
    step, mode = system.step, "ad"
    if which == "CPU tensors":
        from timeopt_tpu_torch.ops import cuda_linearize

        monkeypatch.setattr(cuda_linearize, "jacobians", None)  # never reached on the CPU
        calls = None
    else:
        calls = _pretend_card(monkeypatch)
    if which == "step without device_id, ad":
        step = euler_step_fn(*system.step.euler_ingredients)
        assert step.device_id is None
    elif which in ("central", "forward"):
        mode = which
    got = linearize(step, X, U, mode)
    if which == "registry step, ad":
        assert got == ("kernel", "kernel") and calls == [(1, system.dt)]
        return
    want = linearize_ad(system.step, X, U) if mode == "ad" else linearize_fd(system.step, X, U, mode=mode)
    assert calls in (None, [])
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.fixture(scope="module")
def host_columns(tmp_path_factory):
    """csrc/linearize.cu's jacobian_column (the kernel's arithmetic, on the
    dual numbers of csrc/dual.cuh and the dynamics of csrc/systems.cuh)
    built for the host with g++, no FMA contraction, called through ctypes:
    column(system_id, x, u, c, dt, col)."""
    import ctypes
    import shutil
    import subprocess
    from pathlib import Path

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the Jacobian column on the host")
    d = tmp_path_factory.mktemp("linearize_host")
    (d / "cuda_runtime.h").write_text("")  # the sources' only CUDA header; the column needs nothing of it
    cases = "".join(f"    case {i}: jacobian_column<{s}>(x, u, c, dt, col); break;\n" for i, s in enumerate(
        ("DoubleIntegrator", "Quadrotor", "Cartpole", "Segway", "Ballbot", "PointMass", "Rocket6DoF")))
    (d / "host.cpp").write_text(
        "#define __device__\n#define __host__\n#define __forceinline__ inline\n#include \"linearize.cu\"\n"
        "extern \"C\" void column(int sys, const double* x, const double* u, int c, double dt, double* col) {\n"
        f"  switch (sys) {{\n{cases}  }}\n}}\n")
    csrc = Path(__file__).resolve().parent.parent / "timeopt_tpu_torch" / "csrc"
    so = d / "libcolumn.so"
    proc = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(d), "-I",
                           str(csrc), "-o", str(so), str(d / "host.cpp")], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.column.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_double,
                           ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("case", CASES + ("Rocket6DoF",))
def test_jacobian_column_on_the_host_matches_ad(host_columns, case):
    """The kernel's Jacobian, column by column, built on the host, against
    linearize_ad (torch's forward AD through the Python step) in float64 on
    random states and controls, with a NaN state entry, an infinite one, a
    NaN control and, on the quadrotor, a guarded pitch (|cos theta| < 1e-3),
    on the lander a mass below the dry mass: the same non-finite entries,
    the finite ones within rtol 1e-12 (the wrap's and the guard's
    derivatives are those of AD: 1 and 0)."""
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.linearize import linearize_ad

    system = get_system(case)[0]
    n, m, B, N = system.n, system.m, 3, 5
    rng = np.random.default_rng(74)
    X, U = rng.standard_normal((B, N + 1, n)), rng.standard_normal((B, N, m))
    X[1, 2, 7 % n] = np.nan
    X[2, 1, n - 1] = np.inf
    U[0, 3, 0] = np.nan
    if case == "Quadrotor":
        X[0, 1, 7] = np.pi / 2 - 5e-4
    if case == "Rocket6DoF":
        X[..., 0] = 1.5 + 0.1 * X[..., 0]  # masses near the wet mass, one below the dry mass
        X[0, 1, 0] = 0.5
    A, Bj = (t.numpy() for t in linearize_ad(system.step, torch.as_tensor(X), torch.as_tensor(U)))
    gA, gB, col = np.empty_like(A), np.empty_like(Bj), np.empty(n)
    for b in range(B):
        for k in range(N):
            x, u = np.ascontiguousarray(X[b, k]), np.ascontiguousarray(U[b, k])
            for c in range(n + m):
                host_columns.column(IDS[case], x.ctypes.data, u.ctypes.data, c, system.dt, col.ctypes.data)
                if c < n:
                    gA[b, k, :, c] = col
                else:
                    gB[b, k, :, c - n] = col
    if case == "Quadrotor":
        assert np.isfinite(A[0, 1]).all() and np.abs(A[0, 1]).max() > 100.0  # guarded, finite, large
    if case == "Rocket6DoF":
        assert bool(system.guard(torch.as_tensor(X[0, 1]), torch.as_tensor(U[0, 1]))) and np.isfinite(A[0, 1]).all()
    for g, w in ((gA, A), (gB, Bj)):
        np.testing.assert_array_equal(np.isfinite(g), np.isfinite(w))
        f = np.isfinite(w)
        np.testing.assert_allclose(g[f], w[f], rtol=1e-12, atol=0)
