"""The compiled solve (timeopt_tpu_torch/solver/compiled.py) on the CPU.

On the card `solve_batch` captures the loop's init and step bodies into
CUDA graphs; a capture refuses host reads, tensors made from Python data
and copies from host memory. Here, without a card:

- (a) each method's bodies run once under `CaptureGuard` (which raises on
  what a capture refuses) after the eager warm-up a capture follows, on
  the double integrator, PointMass and the quadrotor, in float64 and
  float32, in the sequential and latency-mode selects, and for a system
  without device dynamics; the guard itself catches a host read in a
  system's step and a tensor made from Python data;
- (b) the bodies keep every state buffer (its data_ptr) across iterations;
- (c) one CompiledSolve, driven eagerly on the CPU, refilled with a second
  batch: each result bitwise a fresh `_solve_traced` of its batch, the
  first result unchanged by the second call; programs driven together
  (as the mesh drives one a card) each equal to their own solve;
- (d) `solve_batch` on the CPU is `_solve_traced`, bitwise, and
  `_solve_traced` holds the JAX package's solve (tests/torch_helpers.py
  tolerances); the program cache keys and bound;
- (e) a `device_id=None` double integrator solves as the registry's:
  T* identical, J* within rtol 1e-12.

The card's side (capture, replay, launch counts) is in
tests/test_torch_card.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from tests.torch_helpers import assert_results_match, problems
from timeopt_tpu.solver import ilqr as jilqr
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver import compiled
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, broadcast_problem, prepare, solve_batch

torch.set_num_threads(1)

# (case, N, T_min, T_max): tiny cuts of each default problem
SIZES = {
    "DoubleIntegrator": (24, 4, 16),
    "PointMass_Navigation": (30, 8, 26),
    "Quadrotor": (16, 4, 12),
}


def _batch(case: str, B: int = 3, seed: int = 0, dtype=torch.float64, system=None):
    """(system, probs, U_init) on the CPU: the case's default problem cut to
    SIZES, x0 perturbed by numpy draws from `seed`, prepared as solve_batch
    prepares them."""
    sys_, mk = get_system(case)
    system = system or sys_
    N, T_min, T_max = SIZES[case]
    base = mk(N=N, device="cpu", dtype=dtype).replace(T_min=T_min, T_max=T_max)
    rng = np.random.default_rng(seed)
    sigma = np.asarray([s if s else 0.05 for s in sys_.sigma_x0] if sys_.sigma_x0 else [0.1] * sys_.n)
    p = broadcast_problem(base, B)
    p = p.replace(x0=p.x0 + torch.as_tensor(sigma * rng.standard_normal((B, sys_.n)), dtype=dtype))
    probs, U = prepare(p, None)
    return system, probs, U


def _same(got: SolveResult, want: SolveResult) -> None:
    """Every field equal bit for bit (NaN where NaN)."""
    for f in dataclasses.fields(SolveResult):
        a, b = getattr(got, f.name), getattr(want, f.name)
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        assert torch.equal(torch.isnan(a), torch.isnan(b)) if a.is_floating_point() else True, f.name
        if a.is_floating_point():
            assert torch.equal(torch.nan_to_num(a, nan=0.0), torch.nan_to_num(b, nan=0.0)), f.name
        else:
            assert torch.equal(a, b), f.name


def _nodev(case: str):
    system, _ = get_system(case)
    return dataclasses.replace(system, name=f"{system.name}_nodev", device_id=None)


GUARD_CASES = [
    ("DoubleIntegrator", dict(method="propagator"), torch.float64),
    ("DoubleIntegrator", dict(method="bruteforce"), torch.float64),
    ("DoubleIntegrator", dict(method="onepass", S_window=4), torch.float64),
    ("PointMass_Navigation", dict(method="propagator"), torch.float64),
    ("PointMass_Navigation", dict(method="bruteforce"), torch.float64),
    ("PointMass_Navigation", dict(method="onepass", S_window=4), torch.float64),
    ("Quadrotor", dict(method="propagator"), torch.float64),
    ("Quadrotor", dict(method="onepass", S_window=3, onepass_preimage="newton"), torch.float64),
    ("DoubleIntegrator", dict(method="propagator"), torch.float32),
    ("PointMass_Navigation", dict(method="propagator"), torch.float32),
    ("Quadrotor", dict(method="bruteforce"), torch.float32),
    ("Quadrotor", dict(method="onepass", S_window=3), torch.float32),
    ("DoubleIntegrator", dict(method="onepass", S_window=4, onepass_preimage="newton"), torch.float32),
    ("DoubleIntegrator", dict(method="propagator", scan_mode="assoc_df"), torch.float64),
    ("PointMass_Navigation", dict(method="propagator", scan_mode="assoc_df"), torch.float64),
    ("Quadrotor", dict(method="propagator", scan_mode="associative"), torch.float32),
    ("Quadrotor", dict(method="propagator", terminal_mode="inverse"), torch.float64),
    ("DoubleIntegrator", dict(method="propagator", linearize_mode="central"), torch.float64),
]


@pytest.mark.parametrize("case,kw,dtype", GUARD_CASES + [
    ("DoubleIntegrator", dict(method="propagator", nodev=True), torch.float64),
    ("DoubleIntegrator", dict(method="onepass", S_window=4, nodev=True), torch.float32),
])
def test_bodies_pass_the_capture_guard(case, kw, dtype):
    """(a) After one eager init and step (the warm-up before a capture),
    the init and step bodies run under CaptureGuard without a refused op."""
    kw = dict(kw)
    system = _nodev(case) if kw.pop("nodev", False) else None
    system, probs, U = _batch(case, dtype=dtype, system=system)
    opts = SolveOptions(max_iter=3, psd_levels=1, **kw)
    b = compiled.bodies(opts)
    st = b.state(probs, opts, dtype, probs.x0.device)
    b.init(system, opts, probs, U, st)
    b.step(system, opts, probs, st)
    with compiled.CaptureGuard():
        b.init(system, opts, probs, U, st)
        b.step(system, opts, probs, st)
    assert torch.isfinite(st["J_last"]).all()


@pytest.mark.parametrize("fault", ["item", "tensor"])
def test_capture_guard_names_what_a_capture_refuses(fault):
    """(a) The guard raises at a host read in a system's step (.item()),
    and at a tensor made from Python data, naming the op and the line."""
    base, _ = get_system("DoubleIntegrator")
    if fault == "item":
        step = lambda x, u: base.step(x, u) * (1.0 + 0.0 * float(x.sum()))  # noqa: E731
    else:
        step = lambda x, u: base.step(x, u) * torch.tensor([1.0, 1.0], dtype=x.dtype)  # noqa: E731
    system = dataclasses.replace(base, name=f"DI_{fault}", step=step)
    _, probs, U = _batch("DoubleIntegrator")
    # central differences: the step runs on plain tensors (no vmap)
    opts = SolveOptions(max_iter=2, psd_levels=1, linearize_mode="central")
    b = compiled.bodies(opts)
    st = b.state(probs, opts, U.dtype, U.device)
    b.init(system, opts, probs, U, st)
    op = "_local_scalar_dense" if fault == "item" else "lift_fresh"
    with pytest.raises(compiled.CaptureError, match=op) as err, compiled.CaptureGuard():
        b.step(system, opts, probs, st)
    assert "test_torch_compiled.py" in str(err.value)


@pytest.mark.parametrize("method", ["propagator", "onepass"])
def test_state_buffers_stay_fixed(method):
    """(b) init and step write the state in place: the same keys, each
    buffer at the same address, across iterations."""
    system, probs, U = _batch("PointMass_Navigation")
    opts = SolveOptions(method=method, max_iter=4, psd_levels=1, S_window=4)
    b = compiled.bodies(opts)
    st = b.state(probs, opts, U.dtype, U.device)
    ptrs = {k: v.data_ptr() for k, v in st.items()}
    b.init(system, opts, probs, U, st)
    for _ in range(3):
        b.step(system, opts, probs, st)
        assert {k: v.data_ptr() for k, v in st.items()} == ptrs


@pytest.mark.parametrize("method", ["propagator", "bruteforce", "onepass"])
def test_refilled_program_matches_fresh_solves(method):
    """(c) One program, driven eagerly, over two batches: each result is a
    fresh _solve_traced of its batch, bit for bit, and the first result is
    not overwritten by the second call."""
    opts = SolveOptions(method=method, max_iter=4, psd_levels=1, S_window=4)
    system, p1, U1 = _batch("DoubleIntegrator", seed=1)
    _, p2, U2 = _batch("DoubleIntegrator", seed=2)
    prog = compiled.CompiledSolve(system, opts, p1, U1)
    r1 = compiled.run_programs([(prog, p1, U1)])[0]
    kept = SolveResult(**{f.name: getattr(r1, f.name).clone() for f in dataclasses.fields(r1)})
    r2 = compiled.run_programs([(prog, p2, U2)])[0]
    _same(r1, compiled._solve_traced(system, opts, p1, U1))
    _same(r2, compiled._solve_traced(system, opts, p2, U2))
    _same(r1, kept)
    assert not torch.equal(r1.X, r2.X)


def test_programs_driven_together_match_their_own_solves():
    """(c) run_programs, as the mesh drives one program a card: the parts
    of a batch, each its own program, all launched before any result is
    copied out (each stops at its own early exit), equal each part's
    _solve_traced bit for bit."""
    opts = SolveOptions(method="propagator", max_iter=6, psd_levels=1)
    system, probs, U = _batch("PointMass_Navigation", B=5, seed=4)
    parts = [(probs.replace(**{f: t[sl] for f, t in probs.tensors().items()}), U[sl])
             for sl in (slice(0, 2), slice(2, 5))]
    runs = [(compiled.CompiledSolve(system, opts, p, u), p, u) for p, u in parts]
    for got, (p, u) in zip(compiled.run_programs(runs), parts):
        _same(got, compiled._solve_traced(system, opts, p, u))


def test_one_program_for_two_parts_raises():
    """(c) Two parts driven by one program would overwrite each other's
    buffers: run_programs refuses them."""
    opts = SolveOptions(method="propagator", max_iter=2, psd_levels=1)
    system, probs, U = _batch("DoubleIntegrator", B=2, seed=6)
    prog = compiled.CompiledSolve(system, opts, probs, U)
    with pytest.raises(ValueError, match="share one program"):
        compiled.run_programs([(prog, probs, U), (prog, probs, U)])


@pytest.mark.parametrize("method,early_exit", [("propagator", True), ("bruteforce", True), ("onepass", True),
                                               ("propagator", False)])
def test_solve_batch_on_the_cpu_is_the_eager_driver(method, early_exit):
    """(d) solve_batch on the CPU equals _solve_traced bit for bit."""
    system, probs, U = _batch("Quadrotor")
    opts = SolveOptions(method=method, max_iter=4, psd_levels=1, S_window=3, early_exit=early_exit)
    _same(solve_batch(system, probs, options=opts), compiled._solve_traced(system, opts, probs, U))


def test_eager_driver_matches_jax():
    """(d) _solve_traced against the JAX package's batched solve on a
    perturbed tiny double integrator, at the parity tests' tolerances."""
    js, ts, jp, tp = problems("DoubleIntegrator", B=3, N=24, T_min=4, T_max=16, seed=5)
    kw = dict(max_iter=8, psd_levels=1)
    want = jilqr.solve_batch(js, jp, options=jilqr.SolveOptions(use_pallas=False, **kw))
    probs, U = prepare(tp, None)
    assert_results_match(compiled._solve_traced(ts, SolveOptions(**kw), probs, U), want, tp.T_min)


def test_program_cache_keys_and_bound(monkeypatch):
    """(d) A program is reused for the same system, options, shapes and
    dtypes; T_min, the options or the dtype make another; at most
    MAX_PROGRAMS are kept, least recently used dropped first."""
    compiled.clear_compiled()
    monkeypatch.setattr(compiled, "MAX_PROGRAMS", 3)
    system, probs, U = _batch("DoubleIntegrator")
    opts = SolveOptions(max_iter=2, psd_levels=1)
    first = compiled.program(system, opts, probs, U)
    assert compiled.program(system, opts, probs, U) is first
    other_tmin = compiled.program(system, opts, probs.replace(T_min=5), U)
    other_opts = compiled.program(system, dataclasses.replace(opts, max_iter=3), probs, U)
    assert len({id(first), id(other_tmin), id(other_opts)}) == 3
    assert compiled.program(system, opts, probs, U) is first  # now the most recent
    _, p32, U32 = _batch("DoubleIntegrator", dtype=torch.float32)
    compiled.program(system, opts, p32, U32)
    progs = compiled.programs()
    assert len(progs) == 3 and other_tmin not in progs and first in progs
    compiled.clear_compiled()
    assert compiled.programs() == []


@pytest.mark.parametrize("method", ["propagator", "onepass"])
def test_system_without_device_dynamics_solves_as_the_registry(method):
    """(e) A double integrator with device_id None (its line search the
    plain version, the CPU's path; on the card the kernel generated from its
    functions, ops/dyngen.py) solves to the registry system's T*, J* within
    rtol 1e-12."""
    system, probs, U = _batch("DoubleIntegrator", B=4, seed=3)
    opts = SolveOptions(method=method, max_iter=6, psd_levels=1, S_window=4)
    want = solve_batch(system, probs, options=opts)
    got = solve_batch(_nodev("DoubleIntegrator"), probs, options=opts)
    assert torch.equal(got.T_star, want.T_star) and torch.equal(got.n_accept, want.n_accept)
    np.testing.assert_allclose(got.J_star.numpy(), want.J_star.numpy(), rtol=1e-12)
