"""Problem and system abstractions (port of timeopt_tpu/models/base.py).

- `System`: a frozen description of the dynamics. `xdot(x, u)` and
  `guard(x, u)` broadcast over leading batch axes: x (..., n), u (..., m)
  give (..., n) and (...,) bool. `step` is the Euler step built from them.
- `Problem`: tensors with an explicit leading batch axis (B, ...) plus the
  plain ints N, T_min, T_max that fix every trajectory shape.

Variable horizons are handled by masking, never by dynamic shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from timeopt_tpu_torch.ops._build import constant
from timeopt_tpu_torch.ops.linalg import as_terminal_weight
from timeopt_tpu_torch.ops.wrap import angle_normalize, wrap_mask_from_idx

StepFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# Problem tensor fields in their canonical order (the JAX pytree leaves).
PROBLEM_FIELDS = ("x0", "xg", "u_ref", "Q", "R", "Qf", "w", "wrap_mask")


@dataclasses.dataclass(frozen=True)
class Problem:
    """A batch of horizon-optimal trajectory-optimization problems.

    min_{U,T} sum_{k<T} [0.5 e_k'Q e_k + 0.5 du_k'R du_k + w] + 0.5 e_T'Qf e_T
    s.t. x_{k+1} = step(x_k, u_k), x_0 = x0, T in [T_min, T_max].
    """

    x0: torch.Tensor  # (B, n)
    xg: torch.Tensor  # (B, n)
    u_ref: torch.Tensor  # (B, m)
    Q: torch.Tensor  # (B, n, n)
    R: torch.Tensor  # (B, m, m)
    Qf: torch.Tensor  # (B, n, n) full terminal weight
    w: torch.Tensor  # (B,) time penalty per step
    wrap_mask: torch.Tensor  # (B, n) bool, angular state components
    N: int
    T_min: int
    T_max: int

    @property
    def batch(self) -> int:
        return self.x0.shape[0]

    @property
    def n(self) -> int:
        return self.x0.shape[-1]

    @property
    def m(self) -> int:
        return self.u_ref.shape[-1]

    def tensors(self) -> dict:
        return {f: getattr(self, f) for f in PROBLEM_FIELDS}

    def replace(self, **kw) -> "Problem":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Problem":
        return self.replace(**{f: t.to(device) for f, t in self.tensors().items()})


@dataclasses.dataclass(frozen=True)
class System:
    """Static dynamics description. `device_id` names a hand-tuned struct
    of dynamics of the line-search and Jacobian kernels (csrc/systems.cuh;
    the six registry systems): setting it asserts that the struct computes
    `xdot`, `guard` and `extra_cost`, since the kernels run their own copy
    of them (chip_smoke.py holds each against the generated one); the
    Jacobian kernel reads it from the step (euler_step_fn's `device_id`).
    None means the card runs a kernel generated from these functions themselves
    (ops/dyngen.py: traced with make_fx, built with nvcc at first use),
    which needs `step` to be `euler_step_fn` of this system's xdot, dt, n,
    wrap_idx and guard, and raises on an op it does not take.
    `kernel_rollout` makes the curve methods' initial rollout one launch of
    the line-search kernel (solver/cost.py::rollout_kernel) in place of N
    steps of small torch ops; the systems whose benchmark answers predate
    it keep the torch rollout."""

    name: str
    n: int
    m: int
    dt: float
    step: StepFn = dataclasses.field(compare=False)
    xdot: StepFn = dataclasses.field(compare=False)
    guard: Optional[Callable] = dataclasses.field(default=None, compare=False)
    extra_cost: Optional[Callable] = dataclasses.field(default=None, compare=False)
    wrap_idx: tuple = ()
    sigma_x0: tuple = ()  # x0 perturbation of the benchmark trials
    sigma_xg: tuple = ()  # xg perturbation of the benchmark trials
    device_id: Optional[int] = None
    kernel_rollout: bool = False

    def safe_step(self, x: torch.Tensor, u: torch.Tensor, max_state_norm: float = 1e6) -> torch.Tensor:
        """step() with divergence poisoning: a non-finite or exploding next
        state becomes all-NaN, so later line searches reject it."""
        xn = self.step(x, u)
        bad = (~torch.isfinite(xn).all(dim=-1)) | (
            torch.sqrt(torch.sum(torch.square(xn), dim=-1)) > max_state_norm
        )
        return xn + _nan_where(bad[..., None], xn)


def _nan_where(bad: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Additive poison payload: NaN where `bad`, 0 elsewhere. Additive on
    purpose: forward-mode AD through `x + poison` keeps the Jacobian of x
    finite at guarded states (a masked fill would poison it too)."""
    return torch.where(bad, torch.full_like(like, float("nan")), torch.zeros_like(like))


def euler_step_fn(xdot: StepFn, dt: float, n: int, wrap_idx: tuple = (), guard=None,
                  device_id: Optional[int] = None) -> StepFn:
    """x+ = x + dt*xdot(x, u), the wrap_idx components angle-normalized,
    poisoned to NaN where guard(x, u) holds. The step carries its
    ingredients as `step.euler_ingredients` (xdot, dt, n, wrap_idx, guard):
    the generated line-search kernel (ops/dyngen.py) computes this step and
    checks that a System's step is it. A registry model passes its
    `device_id` (that of its System), which the step carries as
    `step.device_id`: it asserts that the struct of csrc/systems.cuh
    computes xdot, and on the card solver/linearize.py then takes the
    step's Jacobians from the kernel that differentiates that struct."""
    wrap = tuple(bool(b) for b in wrap_mask_from_idx(wrap_idx, n)) if wrap_idx else None

    def step(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        xn = x + dt * xdot(x, u)
        if wrap is not None:
            xn = torch.where(constant(wrap, torch.bool, xn.device), angle_normalize(xn), xn)
        if guard is not None:
            xn = xn + _nan_where(guard(x, u)[..., None], xn)
        return xn

    step.euler_ingredients = (xdot, float(dt), int(n), tuple(int(i) for i in wrap_idx), guard)
    step.device_id = device_id
    return step


def make_problem(
    *, x0, xg, u_ref, Q, R, alpha, w, N: int, T_min: int, T_max: int,
    wrap_idx=(), device="cuda", dtype=torch.float64,
) -> Problem:
    """Assemble a batch-of-1 Problem from reference-style ingredients, on
    `device`: the card unless the caller passes device="cpu" (with no card
    the default raises, as torch does; nothing falls back to the CPU). The
    floats are formed in float64 and stored in `dtype` (float64, or float32
    for the float32 path), as the JAX builders take `dtype`."""
    x0 = np.asarray(x0, dtype=np.float64).reshape(-1)
    n = x0.size
    leaves = dict(
        x0=x0,
        xg=np.reshape(np.asarray(xg, np.float64), -1),
        u_ref=np.reshape(np.asarray(u_ref, np.float64), -1),
        Q=np.asarray(Q, np.float64),
        R=np.atleast_2d(np.asarray(R, np.float64)),
        Qf=as_terminal_weight(alpha, n),
        w=np.asarray(w, np.float64),
        wrap_mask=wrap_mask_from_idx(wrap_idx, n),
    )
    return problem_from_numpy({k: v[None] for k, v in leaves.items()}, N, T_min, T_max, device, dtype)


def problem_from_numpy(leaves: dict, N: int, T_min: int, T_max: int, device, dtype=None) -> Problem:
    """Build a Problem from numpy arrays with a leading batch axis, e.g. the
    leaves of a batched JAX Problem (`np.asarray(leaf)`). Without `dtype` a
    float32 or float64 leaf keeps its dtype (any other becomes float64);
    with it every float leaf takes `dtype`. The wrap mask becomes bool."""
    t = {}
    for f in PROBLEM_FIELDS:
        a = np.asarray(leaves[f])
        if f == "wrap_mask":
            dt = torch.bool
        elif dtype is not None:
            dt = dtype
        else:
            dt = torch.float32 if a.dtype == np.float32 else torch.float64
        t[f] = torch.as_tensor(np.array(a), dtype=dt, device=device)
    return Problem(**t, N=int(N), T_min=int(T_min), T_max=int(T_max))
