"""The plain reference of a solve's answers, and the numbers that judge them.

A problem of a deployment (configs/<config>.json) is fixed by its start
state x0 and the configuration's weights; the solver answers with a
horizon T*, a cost J* and controls U (N, m). The reference works out again,
from x0 and U alone, in plain PyTorch:

- the rollout X (N + 1, n) of U from x0 through the system's dynamics and
  guards (reference/systems.py), and the true cost at T*: the stage costs
  0.5 e'Q e + 0.5 du'R du + w (+ the extra cost) for k < T* and the
  terminal cost 0.5 e'Qf e at X[T*], e = wrap(x - xg), du = u - u_ref;
- the horizon curve J(T), T = 1..T_max, of that trajectory: for each T the
  cost the second-order model of the trajectory predicts with the terminal
  at T (the value V0 at step 0 of a Riccati sweep: the brute-force curve of
  the paper's baseline 1, around the returned trajectory, with each step's
  state Hessian cut to its positive part, so that J(T) is what one more
  Newton step at horizon T would reach), and its argmin T_o over [T_min,
  T_max];
- the initial trajectory's best cost J_0: the controls u_ref at every step
  (the solver's start, the reference code's default), rolled out from x0,
  at its best horizon in [T_min, T_max].

The numbers (the largest over the problems judged, unless said):

- `cost_gap`: (|J* - J_ref(T*)| - h) / |J_ref(T*)|, at least 0: the
  solver's claimed cost against the reference's cost of its own controls at
  its own horizon (the rollout, the dynamics, guards, stage, terminal and
  extra costs), beyond h, half the spacing of the configuration's storage
  dtype at J (J* is stored in it, so no answer can come closer than its own
  rounding);
- `horizon_excess`: (J(T*) - J(T_o)) / (w (|T* - T_o| + 1)) on the curve
  of the returned trajectory: 0 where T* is its argmin, at most 1 where T*
  is flat-tied with it (the repository's tie rule), above where the solver
  chose a horizon the curve rejects;
- `descent_left`, and its median over the problems `descent_left_median`:
  (J_ref(T*) - J(T_o)) / (J_0 - J_ref(T*)), the share of the solve's descent
  that one more Newton step, its horizon free, would still add: near 0 for
  a solve that has converged, large for one that stopped early or moved the
  wrong way, +inf where the answer is no better than the start;
- `nonfinite`: the problems whose J*, T* or U is not finite or out of
  range, or whose reference cost or curve is not finite.

The reference takes nothing from the program: the problem's numbers come
from the configuration and the seed's x0, and only the answers (T*, J*, U)
are read, to be judged. `control` is the same reference in a lower
precision put in the solver's place.

A configuration's `system` names its plain system: one of
reference/systems.py's, or else the class `SYSTEM` of
reference/plain/<system>.py, loaded by its path, so a new system is a new
file and no edit here. Such a class has the interface of systems.py's
(`name`, `n`, `m`, `xdot`, `guard`, `extra_cost`) and declares beside its
formulas the operations of one step's evaluation of each (`xdot_flops`,
`guard_flops`, `extra_cost_flops`, counted by hopbench/work.py's rules),
which work.py's line-search and Jacobian counts take for a system it does
not list. Name the file after the program's System.name, which the
work counts are keyed by, and give the configuration's `system` the same
name.
"""

from __future__ import annotations

import functools
import importlib.util
from pathlib import Path

import torch

from hopbench.reference.systems import SYSTEMS, step, wrap

PLAIN = Path(__file__).resolve().parent / "plain"  # one file a system not in systems.py


@functools.lru_cache(maxsize=None)
def _load(path: Path):
    spec = importlib.util.spec_from_file_location(f"hopbench_plain_{path.stem.replace('.', '_').replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SYSTEM


def system(name: str):
    """The plain system `name`: reference/systems.py's, else the class
    SYSTEM of PLAIN/<name>.py."""
    if name in SYSTEMS:
        return SYSTEMS[name]
    path = PLAIN / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"hopbench: no plain system {name!r}: not in reference/systems.py, no {path}")
    return _load(path)


class Deployment:
    """A configuration's problem numbers on a device, in a dtype."""

    def __init__(self, cfg: dict, dtype: torch.dtype, device):
        z = dict(dtype=dtype, device=device)
        self.system = system(cfg["system"])
        self.n, self.m = self.system.n, self.system.m
        self.dt = float(cfg["dt"])
        self.N, self.T_min, self.T_max = int(cfg["N"]), int(cfg["T_min"]), int(cfg["T_max"])
        self.xg = torch.tensor(cfg["xg"], **z)
        self.u_ref = torch.tensor(cfg["u_ref"], **z)
        self.Q = torch.diag(torch.tensor(cfg["Q_diag"], **z))
        self.R = torch.diag(torch.tensor(cfg["R_diag"], **z))
        qf = torch.tensor(cfg["Qf"], **z)
        self.Qf = qf * torch.eye(self.n, **z) if qf.dim() == 0 else torch.diag(qf)
        self.w = float(cfg["w"])
        self.wrap_idx = tuple(cfg["wrap_idx"])
        self.storage = getattr(torch, cfg["dtype"])
        self.dtype, self.device = dtype, device

    def step(self, x, u):
        return step(self.system, x, u, self.dt)

    def rollout(self, x0: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """X (B, N + 1, n) of U (B, N, m) from x0 (B, n)."""
        xs = [x0]
        for k in range(U.shape[1]):
            xs.append(self.step(xs[-1], U[:, k]))
        return torch.stack(xs, dim=1)

    def stage(self, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """Stage costs (B, N) of the steps k = 0..N-1."""
        e = wrap(X[:, :-1] - self.xg, self.wrap_idx)
        du = U - self.u_ref
        l = 0.5 * ((e @ self.Q) * e).sum(-1) + 0.5 * ((du @ self.R) * du).sum(-1) + self.w
        extra = self.system.extra_cost(X[:, :-1])
        return l if extra is None else l + extra[0]

    def terminal(self, x: torch.Tensor) -> torch.Tensor:
        e = wrap(x - self.xg, self.wrap_idx)
        return 0.5 * ((e @ self.Qf) * e).sum(-1)

    def cost(self, X: torch.Tensor, U: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
        """The true cost (B,) at the horizons T (B,), +inf where X up to
        T or U before T is not finite."""
        k = torch.arange(self.N, device=X.device)
        active = k[None] < T[:, None]
        l = torch.where(active, self.stage(X, U), 0.0).sum(1)
        xT = X[torch.arange(X.shape[0], device=X.device), T]
        J = l + self.terminal(xT)
        rows = torch.arange(self.N + 1, device=X.device)[None] <= T[:, None]
        ok = (torch.where(rows, torch.isfinite(X).all(-1), True).all(1)
              & torch.where(active, torch.isfinite(U).all(-1), True).all(1) & torch.isfinite(J))
        return torch.where(ok, J, float("inf"))

    def jacobians(self, X: torch.Tensor, U: torch.Tensor) -> tuple:
        """A (B, N, n, n), B (B, N, n, m): the step's Jacobians along (X, U)."""
        n, m = self.n, self.m
        x, u = X[:, :-1].reshape(-1, n), U.reshape(-1, m)
        cols = []
        for i in range(n + m):  # one forward-mode product per input direction, over every step at once
            tx, tu = torch.zeros_like(x), torch.zeros_like(u)
            (tx if i < n else tu)[:, i if i < n else i - n] = 1.0
            cols.append(torch.func.jvp(self.step, (x, u), (tx, tu))[1])
        J = torch.stack(cols, dim=-1).reshape(X.shape[0], -1, n, n + m)
        return J[..., :n], J[..., n:]

    def costs(self, X: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
        """The true cost (B, N) at every horizon T = 1..N, +inf where it
        is not finite."""
        J = torch.cumsum(self.stage(X, U), dim=1) + self.terminal(X[:, 1:])
        return torch.where(torch.isfinite(J), J, float("inf"))

    def curve(self, X: torch.Tensor, U: torch.Tensor, lam: float = 1e-6, psd: bool = False) -> torch.Tensor:
        """J(T) (B, T_max), T = 1..T_max, of the trajectory (X, U): the
        value at step 0 of the second-order model with the terminal at T
        (Gauss-Newton: the dynamics' Jacobians, the costs' Hessians), Quu
        regularized by lam I; +inf where it is not finite. With psd, each
        step's state Hessian (Q plus the extra cost's) has its negative
        eigenvalues cut to 0, so the model is convex and its value a
        Newton step's prediction below the trajectory's cost."""
        Tm, n, m = self.T_max, self.n, self.m
        Bsz = X.shape[0]
        A, Bj = self.jacobians(X[:, : Tm + 1], U[:, :Tm])
        e = wrap(X[:, :Tm] - self.xg, self.wrap_idx)
        du = U[:, :Tm] - self.u_ref
        lx, lu = e @ self.Q, du @ self.R
        l0 = self.stage(X[:, : Tm + 1], U[:, :Tm])
        Qs = self.Q.expand(Bsz, Tm, n, n)
        extra = self.system.extra_cost(X[:, :Tm])
        if extra is not None:
            lx = lx + extra[1]
            Qs = Qs + extra[2]
            if psd:
                ev, V = torch.linalg.eigh(Qs)
                Qs = (V * ev.clamp(min=0.0)[..., None, :]) @ V.transpose(-1, -2)
        eT = wrap(X[:, 1 : Tm + 1] - self.xg, self.wrap_idx)  # terminal at T = k + 1
        Qf = self.Qf
        T = torch.arange(1, Tm + 1, device=X.device)
        Vx = torch.zeros((Bsz, Tm, n), dtype=X.dtype, device=X.device)
        Vxx = torch.zeros((Bsz, Tm, n, n), dtype=X.dtype, device=X.device)
        V0 = torch.zeros((Bsz, Tm), dtype=X.dtype, device=X.device)
        lamI = lam * torch.eye(m, dtype=X.dtype, device=X.device)
        for k in range(Tm - 1, -1, -1):
            term = (T == k + 1)[None]
            Vx = torch.where(term[..., None], (eT[:, k] @ Qf)[:, None], Vx)
            Vxx = torch.where(term[..., None, None], Qf, Vxx)
            V0 = torch.where(term, self.terminal(X[:, k + 1])[:, None], V0)
            Ak, Bk = A[:, k, None], Bj[:, k, None]
            Qx = lx[:, k, None] + (Ak.transpose(-1, -2) @ Vx[..., None])[..., 0]
            Qu = lu[:, k, None] + (Bk.transpose(-1, -2) @ Vx[..., None])[..., 0]
            Qxx = Qs[:, k, None] + Ak.transpose(-1, -2) @ Vxx @ Ak
            Quu = self.R + Bk.transpose(-1, -2) @ Vxx @ Bk
            Qux = Bk.transpose(-1, -2) @ Vxx @ Ak
            H = 0.5 * (Quu + Quu.transpose(-1, -2)) + lamI
            sol = torch.linalg.solve_ex(H, torch.cat([Qu[..., None], Qux], dim=-1))[0]
            ku, Kx = sol[..., 0], sol[..., 1:]
            Vx_n = Qx - (Qux.transpose(-1, -2) @ ku[..., None])[..., 0]
            Vxx_n = Qxx - Qux.transpose(-1, -2) @ Kx
            Vxx_n = 0.5 * (Vxx_n + Vxx_n.transpose(-1, -2))
            V0_n = l0[:, k, None] + V0 - 0.5 * (Qu * ku).sum(-1)
            act = (k < T)[None]
            Vx = torch.where(act[..., None], Vx_n, Vx)
            Vxx = torch.where(act[..., None, None], Vxx_n, Vxx)
            V0 = torch.where(act, V0_n, V0)
        return torch.where(torch.isfinite(V0), V0, float("inf"))

    def argmin(self, J: torch.Tensor) -> torch.Tensor:
        """The first argmin T (B,) of J (B, T_max) over [T_min, T_max]."""
        return torch.argmin(J[:, self.T_min - 1 : self.T_max], dim=1) + self.T_min


def half_spacing(a: torch.Tensor, storage: torch.dtype) -> torch.Tensor:
    """Half the spacing of `storage` floats at a >= 0 (a's dtype)."""
    s = a.to(storage)
    return 0.5 * (torch.nextafter(s, torch.full_like(s, float("inf"))) - s).to(a.dtype)


def judge(dep: Deployment, x0, T_star, J_star, U) -> dict:
    """The per-problem numbers of `module docstring` for answers (T*, J*,
    U) to the problems x0, and `ok`, the problems whose answers and
    reference cost are finite and in range. dep in float64; the answers
    are cast to its dtype."""
    z = dict(dtype=dep.dtype, device=dep.device)
    x0, J_star, U = x0.to(**z), J_star.to(**z), U.to(**z)
    T = T_star.to(device=dep.device, dtype=torch.int64)
    in_range = (T >= dep.T_min) & (T <= dep.T_max)
    Tc = T.clamp(dep.T_min, dep.T_max)
    X = dep.rollout(x0, U)
    J_ref = dep.cost(X, U, Tc)
    cost_gap = ((J_star - J_ref).abs() - half_spacing(torch.maximum(J_star.abs(), J_ref.abs()), dep.storage)).clamp(
        min=0.0) / J_ref.abs()
    model = dep.curve(X, U, psd=True)
    T_o = dep.argmin(model)
    rows = torch.arange(x0.shape[0], device=dep.device)
    excess = (model[rows, Tc - 1] - model[rows, T_o - 1]) / (dep.w * ((Tc - T_o).abs() + 1))
    U0 = dep.u_ref.expand(U.shape).contiguous()
    J0 = dep.costs(dep.rollout(x0, U0), U0)[:, dep.T_min - 1 : dep.T_max].min(dim=1).values
    descent = J0 - J_ref
    left = torch.where(descent > 0, (J_ref - model[rows, T_o - 1]).clamp(min=0.0) / descent, float("inf"))
    ok = (in_range & torch.isfinite(J_star) & torch.isfinite(U).flatten(1).all(1) & torch.isfinite(J_ref)
          & torch.isfinite(excess))
    return dict(cost_gap=cost_gap, horizon_excess=excess, descent_left=left, T_o=T_o, J_ref=J_ref, ok=ok)


def worst(per_problem: dict) -> dict:
    """The numbers over the problems judged: `cost_gap`, `horizon_excess`
    and `descent_left` the largest, `descent_left_median` the median, over
    the problems that are `ok`; `nonfinite` the count of the others."""
    ok = per_problem["ok"]
    out = {k: float(per_problem[k][ok].max()) if ok.any() else float("inf")
           for k in ("cost_gap", "horizon_excess", "descent_left")}
    out["descent_left_median"] = float(per_problem["descent_left"][ok].median()) if ok.any() else float("inf")
    out["nonfinite"] = int((~ok).sum())
    return out


def control(dep_low: Deployment, x0: torch.Tensor, U: torch.Tensor) -> tuple:
    """The reference in `dep_low`'s (lower) precision put in the solver's
    place for the controls U: its own horizon T*, the argmin of its curve
    of U's rollout, and its cost there. Returns (T*, J*, U)."""
    z = dict(dtype=dep_low.dtype, device=dep_low.device)
    x0, U = x0.to(**z), U.to(**z)
    X = dep_low.rollout(x0, U)
    T = dep_low.argmin(dep_low.curve(X, U, psd=True))
    return T, dep_low.cost(X, U, T), U
