"""The float32 rollout of the port (solver/cost.py::rollout) against the
JAX package's df32 rollout
(solver/rollout_df.py::rollout_df), on the cases of tests/test_rollout_df.py.

The port carries the state in float64 and stores its float32 rounding, so
its rows are the float64 rollout of the same float32 inputs, rounded once:
bit for bit against the port's own float64 rollout, and within one float32
ulp (2^-23 relative) of the JAX float64 rollout where both follow the same
formulas (the double integrator). rollout_df carries ~48 bits, so the port
is at least as close to the float64 oracle as it is: the port's error is
held to the df32 rollout's own plus one float32 ulp of the state, and the
two within the df32 test's own bounds of each other (4e-7 on the double
integrator, 2e-5 on the cart-pole's first 150 steps, 1e-3 modulo 2 pi on
the spinning pole). Poisoning starts at the same step (within one, as the
df32 test allows). Both are closer to the float64 rollout than the JAX
package's plain float32 rollout is.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from timeopt_tpu.models import get_system as jax_get_system
from timeopt_tpu.solver.cost import rollout as jax_rollout
from timeopt_tpu.solver.rollout_df import rollout_df
from timeopt_tpu_torch.models import get_system
from timeopt_tpu_torch.solver.cost import rollout

torch.set_num_threads(1)
ULP = 2.0**-23


def _pair(case):
    js, jmk = jax_get_system(case)
    ts, tmk = get_system(case)
    return js, ts, jmk(dtype=jnp.float32), jmk(dtype=jnp.float64), tmk(device="cpu", dtype=torch.float32)


def _roll(ts, tp, U32):
    X = rollout(ts, tp, tp.x0, torch.as_tensor(U32)[None])[0]
    assert X.dtype == torch.float32
    return X.numpy().astype(np.float64)


def _angle(d, i):
    d = d.copy()
    d[:, i] = (d[:, i] + np.pi) % (2 * np.pi) - np.pi
    return d


def test_float32_rollout_is_the_float64_rollout_rounded():
    ts, tmk = get_system("Cartpole_SwingUp")
    tp = tmk(device="cpu", dtype=torch.float32)
    U = torch.as_tensor(np.sin(np.linspace(0.0, 9.0, tp.N))[None, :, None] * 3.0, dtype=torch.float32)
    X32 = rollout(ts, tp, tp.x0, U)
    X64 = rollout(ts, tp, tp.x0.double(), U.double())
    assert torch.equal(X32, X64.float())


def test_float32_rollout_double_integrator():
    js, ts, p32, p64, tp = _pair("DoubleIntegrator")
    U32 = np.sin(np.linspace(0.0, 6.0, p32.N))[:, None].astype(np.float32)
    X64 = np.asarray(jax_rollout(js, p64, p64.x0, jnp.asarray(U32, jnp.float64)))
    Xdf = np.asarray(rollout_df(js, p32, p32.x0, jnp.asarray(U32)), np.float64)
    X = _roll(ts, tp, U32)
    scale = np.abs(X64) + 1e-30
    assert np.all(np.abs(X - X64) <= ULP * scale)
    assert np.abs(X - Xdf).max() < 4e-7
    assert np.abs(X - X64).max() <= np.abs(Xdf - X64).max() + ULP * np.abs(X64).max()


def test_float32_rollout_cartpole_accuracy():
    """The swing-up cart-pole (N = 360) under smooth controls, its first 150
    steps (the open-loop tail beyond amplifies any rounding)."""
    js, ts, p32, p64, tp = _pair("Cartpole_SwingUp")
    U32 = (3.0 * np.sin(np.linspace(0.0, 9.0, p32.N)))[:, None].astype(np.float32)
    X64 = np.asarray(jax_rollout(js, p64, p64.x0, jnp.asarray(U32, jnp.float64)))[:151]
    Xdf = np.asarray(rollout_df(js, p32, p32.x0, jnp.asarray(U32)), np.float64)[:151]
    X = _roll(ts, tp, U32)[:151]
    Xpl = np.asarray(jax_rollout(js, p32, p32.x0, jnp.asarray(U32)), np.float64)[:151]
    err = lambda Xc: np.abs(_angle(Xc - X64, 2)).max()  # noqa: E731
    assert err(X) <= err(Xdf) + ULP * np.abs(X64).max()
    assert err(X) < 0.2 * err(Xpl)
    assert np.abs(_angle(X - Xdf, 2)).max() < 2e-5


def test_float32_rollout_wrap_crosses_pi():
    js, ts, p32, p64, tp = _pair("Cartpole_SwingUp")
    U = np.full((p32.N, 1), 2.5, np.float32)  # constant push: the pole wraps repeatedly
    Xdf = np.asarray(rollout_df(js, p32, p32.x0, jnp.asarray(U)), np.float64)
    X = _roll(ts, tp, U)
    assert np.all(np.abs(X[:, 2]) <= np.pi + 1e-6)
    assert np.abs(_angle(X[:150] - Xdf[:150], 2)).max() < 1e-3


def test_float32_rollout_guard_poisons():
    js, ts, p32, p64, tp = _pair("Quadrotor")
    U = np.zeros((p32.N, 4), np.float32)
    U[:, 1], U[:, 0] = 500.0, 9.81  # absurd torque: |omega| passes the guard
    Xdf = np.asarray(rollout_df(js, p32, p32.x0, jnp.asarray(U)))
    X = _roll(ts, tp, U)
    assert np.isnan(X[-1]).all()
    first = lambda Xc: int(np.argmax(np.isnan(Xc).any(axis=1)))  # noqa: E731
    assert abs(first(X) - first(Xdf)) <= 1
    assert abs(first(X) - first(np.asarray(jax_rollout(js, p32, p32.x0, jnp.asarray(U))))) <= 1


@pytest.mark.parametrize("case", ["DoubleIntegrator", "Quadrotor", "Segway_Balance", "Ballbot_Balance",
                                  "PointMass_Navigation"])
def test_float32_rollout_against_rollout_df(case):
    """Over the first 40 steps under perturbed reference controls the port's
    float32 rollout is no farther from the JAX float64 rollout of the same
    float32 inputs than rollout_df is, plus one float32 ulp of the state,
    and nearer to it than the JAX plain float32 rollout."""
    js, ts, p32, p64, tp = _pair(case)
    rng = np.random.default_rng(70)
    U = (np.asarray(p32.u_ref) + 0.1 * rng.standard_normal((40, ts.m))).astype(np.float32)
    X64 = np.asarray(jax_rollout(js, p64, p64.x0, jnp.asarray(U, jnp.float64)))
    Xdf = np.asarray(rollout_df(js, p32, p32.x0, jnp.asarray(U)), np.float64)
    Xpl = np.asarray(jax_rollout(js, p32, p32.x0, jnp.asarray(U)), np.float64)
    X = _roll(ts, tp, U)
    err = lambda Xc: np.abs(Xc - X64).max()  # noqa: E731
    assert err(X) <= err(Xdf) + ULP * np.abs(X64).max()
    assert err(X) <= err(Xpl)
