"""The generated line-search dynamics (timeopt_tpu_torch/ops/dyngen.py), on
the CPU: no card, no nvcc.

A System without a `device_id` runs on the card a line-search kernel whose
dynamics are generated from its own xdot, guard and extra cost (make_fx,
one SSA statement per element). Here the emitted struct is compiled with
the host's g++ (`-ffp-contract=off`, no FMA) in a host translation unit
and called through ctypes:

- (a) for each of the six registry systems (their `device_id=None` twins)
  and a custom unicycle, on 64 seeded rows with angles outside (-pi, pi],
  rows that trip the guard and non-finite entries: xdot within rtol 1e-13,
  atol 1e-15 of the torch function (libm and ATen may differ by an ulp in
  sin, cos, exp), the guard exactly, the extra cost within rtol 1e-13; the
  ops the generator takes, one small function each, held the same way;
- (b) an op outside the generator's list, a trace that fails and a wrong
  result shape raise, naming the op or the function;
- (c) a `step` that is not `euler_step_fn` of the system's own xdot, dt,
  wrap_idx and guard raises, as do sizes the kernel template does not take;
- (d) the same system gives the same source and library name twice; two
  systems with equal names and different xdot differ in both, and in the
  memo key (System.__eq__ ignores the functions);
- (e) the unicycle, defined in both packages (in JAX without xdot_rows, so
  the JAX package runs its XLA line search), solves in the port as in the
  JAX package on the CPU (B=4, N=40), method "propagator" and "onepass":
  T* identical, J* within rtol 1e-9; it is the system chip_smoke.py
  solves on the card.

On the card the generated kernels are held to the plain line search and to
the hand-written ones by tests/test_torch_card.py and chip_smoke.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import importlib.util
import math
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timeopt_tpu.models.base import System as JaxSystem
from timeopt_tpu.models.base import euler_step_fn as jax_euler_step_fn
from timeopt_tpu.models.base import make_problem as jax_make_problem
from timeopt_tpu.solver import ilqr as jilqr
from tests.torch_helpers import to_torch_problem
from timeopt_tpu_torch.models import SYSTEMS, get_system
from timeopt_tpu_torch.models.base import System, euler_step_fn
from timeopt_tpu_torch.ops import _build, cuda_forward, dyngen
from timeopt_tpu_torch.solver import ilqr as tilqr

ROWS = 64

# ---------------------------------------------------------------------------
# The unicycle: x = (p_x, p_y, theta, v), u = (a, omega), theta wrapped; the
# guard poisons |v| > V_MAX and non-finite input. chip_smoke.py solves the
# same system on the card (test_chip_smoke_solves_this_unicycle).
# ---------------------------------------------------------------------------

DT, V_MAX = 0.1, 4.0
UNICYCLE_PROBLEM = dict(x0=[0.0, 0.0, 0.0, 0.0], xg=[1.5, 1.0, math.pi / 2, 0.0], u_ref=[0.0, 0.0],
                        Q=np.diag([0.5, 0.5, 0.2, 0.1]), R=np.diag([0.1, 0.1]), alpha=[60.0, 60.0, 20.0, 10.0],
                        w=0.05, N=40, T_min=10, T_max=40, wrap_idx=(2,))
UNICYCLE_SIGMA = (0.2, 0.2, 0.3, 0.0)


def unicycle_xdot(x, u):
    return torch.stack([x[..., 3] * torch.cos(x[..., 2]), x[..., 3] * torch.sin(x[..., 2]), u[..., 1], u[..., 0]],
                       dim=-1)


def unicycle_guard(x, u):
    return (~torch.isfinite(x).all(dim=-1)) | (~torch.isfinite(u).all(dim=-1)) | (torch.abs(x[..., 3]) > V_MAX)


def unicycle() -> System:
    return System(name="Unicycle", n=4, m=2, dt=DT, step=euler_step_fn(unicycle_xdot, DT, 4, (2,), unicycle_guard),
                  xdot=unicycle_xdot, guard=unicycle_guard, wrap_idx=(2,))


def jax_unicycle() -> JaxSystem:
    def xdot(x, u):
        return jnp.stack([x[3] * jnp.cos(x[2]), x[3] * jnp.sin(x[2]), u[1], u[0]])

    def guard(x, u):
        return (~jnp.all(jnp.isfinite(x))) | (~jnp.all(jnp.isfinite(u))) | (jnp.abs(x[3]) > V_MAX)

    return JaxSystem(name="Unicycle", n=4, m=2, dt=DT, step=jax_euler_step_fn(xdot, DT, (2,), guard), xdot=xdot,
                     guard=guard, wrap_idx=(2,))


def _twin(case: str) -> System:
    return dataclasses.replace(get_system(case)[0], device_id=None)


# ---------------------------------------------------------------------------
# The emitted struct, built with g++
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def gxx():
    path = shutil.which("g++")
    if path is None:
        pytest.skip("needs g++ to build the emitted struct on the host")
    return path


def _host_source(system) -> str:
    """The emitted struct in a host C++ translation unit (no CUDA), with
    the C entries dyn_xdot(x, u, xd), dyn_guard(x, u), dyn_extra_cost(x, u)."""
    return "\n".join([
        "#include <math.h>", "", dyngen.struct_source(system),
        'extern "C" void dyn_xdot(const double* x, const double* u, double* xd) { Generated::xdot(x, u, xd); }',
        'extern "C" int dyn_guard(const double* x, const double* u) { return Generated::guard(x, u) ? 1 : 0; }',
        'extern "C" double dyn_extra_cost(const double* x, const double* u) { return Generated::extra_cost(x, u); }',
        ""])


def _host_lib(gxx, system, tmp: Path):
    src, so = tmp / f"{system.name}.cpp", tmp / f"lib{system.name}.so"
    src.write_text(_host_source(system))
    proc = subprocess.run([gxx, "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    lib.dyn_xdot.argtypes = [ctypes.c_void_p] * 3
    lib.dyn_xdot.restype = None
    lib.dyn_guard.argtypes = [ctypes.c_void_p] * 2
    lib.dyn_guard.restype = ctypes.c_int
    lib.dyn_extra_cost.argtypes = [ctypes.c_void_p] * 2
    lib.dyn_extra_cost.restype = ctypes.c_double
    return lib


def _rows(system, seed: int):
    """ROWS seeded (x, u): wide angles and states, rows on and beyond each
    guard's limits, NaN and inf entries."""
    rng = np.random.default_rng(seed)
    n, m = system.n, system.m
    X = 4.0 * rng.standard_normal((ROWS, n))
    U = 3.0 * rng.standard_normal((ROWS, m))
    X[:8, list(system.wrap_idx) or [0]] += 7.0  # angles outside (-pi, pi]
    X[8, 0], X[9, n - 1], U[10, m - 1], X[11, 0], U[12, 0] = np.nan, np.inf, np.nan, -np.inf, np.inf
    if system.name == "Quadrotor":
        X[13, 7] = math.pi / 2  # |cos theta| < 1e-3
        X[14, 10] = 2e3  # |omega| > 1e3
        X[15, 0] = 2e6  # ||x|| > 1e6
    if system.name == "Unicycle":
        X[13:16, 3] = (V_MAX + 0.5, -V_MAX - 1.0, V_MAX)
    return X, U


def _check(lib, system, X, U):
    want_xd = system.xdot(torch.as_tensor(X), torch.as_tensor(U)).numpy()
    want_g = (system.guard(torch.as_tensor(X), torch.as_tensor(U)).numpy() if system.guard is not None
              else np.zeros(len(X), bool))
    want_c = (system.extra_cost(torch.as_tensor(X), torch.as_tensor(U)).numpy() if system.extra_cost is not None
              else np.zeros(len(X)))
    got_xd, got_g, got_c = np.zeros_like(want_xd), np.zeros(len(X), bool), np.zeros(len(X))
    xd = np.zeros(system.n)
    for b in range(len(X)):
        x, u = np.ascontiguousarray(X[b]), np.ascontiguousarray(U[b])
        lib.dyn_xdot(x.ctypes.data, u.ctypes.data, xd.ctypes.data)
        got_xd[b] = xd
        got_g[b] = bool(lib.dyn_guard(x.ctypes.data, u.ctypes.data))
        got_c[b] = lib.dyn_extra_cost(x.ctypes.data, u.ctypes.data)
    np.testing.assert_allclose(got_xd, want_xd, rtol=1e-13, atol=1e-15)
    np.testing.assert_array_equal(got_g, want_g)
    np.testing.assert_allclose(got_c, want_c, rtol=1e-13)
    return want_g


@pytest.mark.parametrize("case", list(SYSTEMS) + ["Unicycle"])
def test_generated_struct_matches_torch(gxx, tmp_path, case):
    """(a) The emitted xdot, guard and extra cost of each registry system's
    twin and of the unicycle against the torch functions."""
    system = unicycle() if case == "Unicycle" else _twin(case)
    X, U = _rows(system, seed=len(case))
    guarded = _check(_host_lib(gxx, system, tmp_path), system, X, U)
    if system.guard is not None:
        assert guarded.any() and not guarded.all()


def _sys(xdot, guard=None, extra_cost=None, n=4, m=2, wrap_idx=()):
    return System(name="Probe", n=n, m=m, dt=0.05, step=euler_step_fn(xdot, 0.05, n, wrap_idx, guard), xdot=xdot,
                  guard=guard, extra_cost=extra_cost, wrap_idx=wrap_idx)


# One small system a family of the generator's ops (dyngen.OPS), x (1, 4), u (1, 2)
OP_SYSTEMS = {
    "where_pow_atan2": lambda: _sys(
        lambda x, u: torch.stack([torch.where(x[..., 0] > 0, x[..., 1] ** 3, -x[..., 1]),
                                  torch.abs(x[..., 2]) ** 0.5 + torch.abs(x[..., 2]) ** 1.5,
                                  torch.atan2(x[..., 3], u[..., 0]), 1.0 / (1.0 + x[..., 0] ** 2)], dim=-1)),
    "views_and_cat": lambda: _sys(
        lambda x, u: torch.cat([x[..., :2].reshape(-1, 2, 1).permute(0, 2, 1).reshape(-1, 2) + x[..., 2:],
                                (x[..., None, :2].expand(-1, 3, 2).transpose(1, 2).sum(-1) - u).t().t()], dim=-1)),
    "log_tanh_exp": lambda: _sys(
        lambda x, u: torch.stack([torch.log(torch.abs(x[..., 0]) + 1.0), torch.tanh(x[..., 1]),
                                  torch.exp(-u[..., 0] ** 2), 2.0 - x[..., 3] / 3.0], dim=-1)),
    "reductions_keepdim": lambda: _sys(
        lambda x, u: x * torch.sum(u, dim=-1, keepdim=True) - torch.sum(x * x, dim=(-1,), keepdim=True) * 0.1,
        extra_cost=lambda x, u: (x ** 2).sum(-1) + (u ** -2).sum(dim=-1, keepdim=True)[..., 0] * 1e-3),
    "guard_logic": lambda: _sys(
        lambda x, u: torch.stack([x[..., 1], u[..., 0], x[..., 3], u[..., 1]], dim=-1),
        guard=lambda x, u: torch.logical_or((x > 5.0).any(-1), ~(u.abs() <= 4.0).all(-1))
        | ((x[..., 0] >= 1.0) & (x[..., 1] < -1.0)) ^ (x[..., 2] == 0.5) | torch.logical_not(x[..., 3] != 2.0)),
    "constants_and_likes": lambda: _sys(
        lambda x, u: x + torch.zeros_like(x) + torch.ones_like(x) * torch.tensor([0.1, -0.2, float("inf"), 3.0],
                                                                                 dtype=torch.float64)
        - torch.full_like(x, 0.25) + x.clone().unsqueeze(-1).squeeze(-1),
        extra_cost=lambda x, u: torch.where(torch.tensor([True, False, True, True]), x, -x).sum(-1)),
}


@pytest.mark.parametrize("name", list(OP_SYSTEMS))
def test_generated_ops_match_torch(gxx, tmp_path, name):
    """(a) The ops of dyngen.OPS beyond the registry's, one family a
    system, against torch on the same rows."""
    system = OP_SYSTEMS[name]()
    X, U = _rows(system, seed=7)
    _check(_host_lib(gxx, system, tmp_path), system, X, U)


# ---------------------------------------------------------------------------
# What the generator refuses
# ---------------------------------------------------------------------------


def _branchy(x, u):
    if bool(x[0, 0] > 0):
        return x
    return -x


@pytest.mark.parametrize("xdot,match", [
    (lambda x, u: torch.cumsum(x, dim=-1), "cumsum"),
    (lambda x, u: torch.clamp(x, -1.0, 1.0), "clamp"),
    (_branchy, "make_fx failed"),
    (lambda x, u: x.sum(-1), "expected torch.float64 of shape"),
])
def test_unsupported_function_raises(xdot, match):
    """(b) An op outside OPS names the aten op; a data-dependent branch
    fails the trace; a wrong result shape is refused."""
    system = _sys(xdot)
    with pytest.raises((NotImplementedError, ValueError), match=match):
        dyngen.struct_source(system)


def test_unsupported_op_is_a_not_implemented_error():
    system = _sys(lambda x, u: torch.cumsum(x, dim=-1))
    with pytest.raises(NotImplementedError, match=r"aten\.cumsum\.default"):
        dyngen.kernel_source(system)


def _other_xdot(x, u):
    return unicycle_xdot(x, u) * 1.0


@pytest.mark.parametrize("change", ["xdot", "dt", "wrap_idx", "guard", "handmade"])
def test_step_other_than_the_systems_euler_step_raises(change):
    """(c) The kernel computes euler_step_fn(xdot, dt, n, wrap_idx, guard)
    of the system's own fields; any other step is refused."""
    s = unicycle()
    steps = {
        "xdot": euler_step_fn(_other_xdot, DT, 4, (2,), unicycle_guard),
        "dt": euler_step_fn(unicycle_xdot, 2 * DT, 4, (2,), unicycle_guard),
        "wrap_idx": euler_step_fn(unicycle_xdot, DT, 4, (), unicycle_guard),
        "guard": euler_step_fn(unicycle_xdot, DT, 4, (2,)),
        "handmade": lambda x, u: x + DT * unicycle_xdot(x, u),
    }
    with pytest.raises(ValueError, match="euler_step_fn"):
        dyngen.struct_source(dataclasses.replace(s, step=steps[change]))
    dyngen.struct_source(s)


@pytest.mark.parametrize("n,m", [(33, 1), (2, 3), (16, 16)])
def test_sizes_the_kernel_does_not_take_raise(n, m):
    """(c) n beyond a warp, more controls than a rollout's lanes, or more
    static shared memory than a block has."""
    with pytest.raises(ValueError, match="line-search kernel"):
        dyngen.check_sizes(n, m)


def test_registry_sizes_are_taken():
    for mod in SYSTEMS.values():
        dyngen.check_sizes(mod.SYSTEM.n, mod.SYSTEM.m)
    dyngen.check_sizes(32, 2)


# ---------------------------------------------------------------------------
# Sources, names and the memo
# ---------------------------------------------------------------------------


def test_same_system_same_source_and_name():
    """(d) The source is a function of the system's functions and sizes."""
    a, b = dyngen.kernel_source(_twin("Quadrotor")), dyngen.kernel_source(_twin("Quadrotor"))
    assert a == b and _build.generated_name(a) == _build.generated_name(b)
    assert '#include "linesearch_kernel.cuh"' in a and "struct Generated" in a
    for entry in ("linesearch_rollout", "linesearch_rollout_from", "linesearch_rollout_f32",
                  "linesearch_rollout_from_f32"):
        assert f'extern "C" int {entry}(' in a


def test_equal_names_different_xdot_differ():
    """(d) Two systems equal as Systems (name, sizes, dt; the functions are
    compare=False) with different xdot get different sources, library names
    and memo keys."""
    s1 = unicycle()
    s2 = dataclasses.replace(s1, xdot=_other_xdot, step=euler_step_fn(_other_xdot, DT, 4, (2,), unicycle_guard))
    assert s1 == s2
    t1, t2 = dyngen.kernel_source(s1), dyngen.kernel_source(s2)
    assert t1 != t2 and _build.generated_name(t1) != _build.generated_name(t2)
    assert dyngen._key(s1) != dyngen._key(s2)


def test_literals_are_exact():
    for v in (0.05, -1e-300, 9.81, 1.0 / 3.0, 2.0, -0.0, 1e16, 5e-324):
        s = dyngen.literal(v).strip("()")
        assert float(s) == v and math.copysign(1.0, float(s)) == math.copysign(1.0, v) and ("." in s or "e" in s)
    assert dyngen.literal(float("inf")) == "INFINITY" and dyngen.literal(-float("inf")) == "(-INFINITY)"
    assert dyngen.literal(float("nan")) == "NAN" and dyngen.literal(True) == "true"


def test_cpu_line_search_builds_nothing():
    """On CPU tensors the wrapper runs the plain version: nothing is traced,
    built or counted for a system without a device_id."""
    from tests.torch_helpers import iterate, problems

    js, ts, jp, tp = problems("DoubleIntegrator", 2, 16, 4, 16, seed=5)
    X, U = (torch.as_tensor(a) for a in iterate(js, jp, seed=5)[:2])
    libs, launches = dict(dyngen._LIBS), dyngen.LAUNCHES
    z = torch.zeros((2, 16, 1, 2), dtype=torch.float64)
    out = cuda_forward.linesearch(_twin("DoubleIntegrator"), tp, X, U, z, U.clone(), torch.full((2,), 8), (1.0, 0.5))
    want = cuda_forward.linesearch_plain(get_system("DoubleIntegrator")[0], tp, X, U, z, U.clone(),
                                         torch.full((2,), 8), (1.0, 0.5))
    for a, b in zip(out, want):
        assert torch.equal(a, b)
    assert dyngen._LIBS == libs and dyngen.LAUNCHES == launches


# ---------------------------------------------------------------------------
# The unicycle in both packages
# ---------------------------------------------------------------------------


def unicycle_problems(B: int, seed: int):
    """(JAX problems, port problems): UNICYCLE_PROBLEM, x0 perturbed by
    UNICYCLE_SIGMA N(0, 1)."""
    base = jax_make_problem(**UNICYCLE_PROBLEM)
    rng = np.random.default_rng(seed)
    x0 = np.asarray(base.x0) + np.asarray(UNICYCLE_SIGMA) * rng.standard_normal((B, 4))
    jp = jilqr.broadcast_problem(base, B).replace(x0=jnp.asarray(x0))
    return jp, to_torch_problem(jp)


@pytest.mark.parametrize("method", ["propagator", "onepass"])
def test_unicycle_solves_as_the_jax_package(method):
    """(e) The port's unicycle (device_id None: its line search the plain
    version here, the generated kernel on the card) against the JAX
    package's (no xdot_rows: its XLA line search)."""
    jp, tp = unicycle_problems(4, seed=11)
    kw = dict(method=method, max_iter=6, psd_levels=1, S_window=5)
    want = jilqr.solve_batch(jax_unicycle(), jp, options=jilqr.SolveOptions(**kw))
    got = tilqr.solve_batch(unicycle(), tp, options=tilqr.SolveOptions(**kw))
    np.testing.assert_array_equal(got.T_star.numpy(), np.asarray(want.T_star))
    np.testing.assert_allclose(got.J_star.numpy(), np.asarray(want.J_star), rtol=1e-9)
    assert int(np.asarray(want.n_accept).min()) >= 1 and bool(torch.isfinite(got.J_star).all())


def test_chip_smoke_solves_this_unicycle():
    """(e) chip_smoke.py's custom system is this unicycle: the same
    generated struct, dt, wrap set and problem."""
    spec = importlib.util.spec_from_file_location("chip_smoke_dyngen", Path(__file__).resolve().parent.parent /
                                                  "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    theirs, mine = mod.unicycle(), unicycle()
    assert dyngen.struct_source(theirs) == dyngen.struct_source(mine)
    assert (theirs.dt, theirs.wrap_idx, theirs.n, theirs.m) == (mine.dt, mine.wrap_idx, mine.n, mine.m)
    want = unicycle_problems(3, seed=2)[1]
    got = mod.unicycle_problems(3, seed=2, device="cpu")
    for f, t in want.tensors().items():
        assert torch.equal(getattr(got, f), t), f
    assert (got.N, got.T_min, got.T_max) == (want.N, want.T_min, want.T_max)
