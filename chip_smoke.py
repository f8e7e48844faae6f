#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timeopt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's batched HOP-DDP solves in float64 on the card through
its six hand-written CUDA kernels, for every system of the model registry,
in seven phases; each prints its own lines and any failure raises (non-zero
exit, no result line):

1. device: the card, CUDA and nvcc versions (no CPU fallback);
2. build: the six kernels from timeopt_tpu_torch/csrc/, one nvcc each, all
   started together;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, on inputs from a real iterate, with the stated tolerances, and
   timed (median of CUDA-event timings after warm-up): the fused select,
   backward and line search on the quadrotor at B=1024, N=160 (the main
   path); the generic select on PointMass at B=1024, N=220; then per system,
   at B=128 on its oracle problem set, its select kernel (the error printed,
   gated by SELECT_BOUND) and the line search, and the generic select on
   the quadrotor's assembled blocks (rtol 2e-9, the tight check of that
   kernel); then the unfused select's prefix-scan and terminal-query
   kernels on the quadrotor's first-iterate blocks at B=1024, N=160, timed,
   and per system at B=128 on the oracle's own final (X, U): E, F, G
   printed; on every system the query kernel alone (QUERY_BOUND) and the
   chain against the generic select kernel (CHAIN_BOUND); the chain against
   the plain chain where that holds (SCAN_QUERY_FIRST_BOUND,
   SCAN_QUERY_BOUND);
4. the solve of the 128 problems of each results/oracle_f64*.npz (six
   systems), scored against that f64 brute-force oracle (exact and
   exact-or-tied T*, every problem but REFERENCE_MISSES), with the launch
   count of every kernel in each run;
5. brute force: the oracle's own computation, solve_batch(method=
   "bruteforce", max_iter=12, psd_levels=1), on each of the six oracle
   problem sets, exact-or-tied 128/128 with no exception, the J* and J(T)
   gaps printed; then consistency_check (the scan and query kernels against
   the plain brute force) on each result, its argmin tied to the brute
   force's on every problem and its curve within CC_NORM_BOUND of it; and
   one quadrotor solve with terminal_mode="inverse" (the scan kernel inside
   a solve);
6. the port's suite runner (timeopt_tpu_torch.runner.run_suite) in-process
   on all six cases, 25 trials, ourmethod and baseline1, with --consistency
   --save-jt --save-trajectories, against results/cpu_f64_25: T* identical
   on every DoubleIntegrator and Quadrotor row, their trial-0
   consistency_max_abs within RUNNER_CC_RTOL of the committed value; the
   other cases' mismatches printed;
7. throughput: one timed solve_batch at B=1024 of the quadrotor and of
   PointMass, after a warm-up; the kernels of each path must launch.

Each path resets the kernels' launch counts just before it runs and reads
them just after; a kernel of the path that was not launched fails it. The
line before the last is the card's name and power limit as nvidia-smi
prints them; before that, one JSON line with each kernel's numbers: its
launches summed over the paths of phases 4-6 (`launches`) and in one
B=1024 solve of phase 7 (`launches_per_solve`), its error and times from
phase 3 (`ms` and `plain_ms` one call between two CUDA events, the
wrapper's host work included; `ms_back_to_back` ten launches back to back
between two events, the kernel's own device time), and its roofline bound
at the phase-3 shapes (timeopt_tpu_torch/ops/work.py: `flops`, `bytes`,
`bound_ms` at 67 TFLOP/s and 3.35 TB/s, `bound_by`, `bound_ms_cuda_cores`
at 34 TFLOP/s, `share_of_bound` = bound_ms / ms_back_to_back; `library_ms`
is null: no single PyTorch call computes any of these functions). The last
line is {"ok": true, "device": {...}}.
Imports no JAX.

    python3 chip_smoke.py --ab OLD_CSRC

times the fused select and the line search built from another directory
of kernel sources (e.g. an earlier commit's timeopt_tpu_torch/csrc, from
`git archive`) against this checkout's, in turns old, new, new, old, and
prints the largest difference between their outputs (phase_ab).
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B_FULL = 1024
B_ORACLE = 128
MAX_ITER = 12
SEED = 0
CASES = ("DoubleIntegrator", "Cartpole_SwingUp", "Quadrotor", "Segway_Balance", "Ballbot_Balance",
         "PointMass_Navigation")
KERNELS = {
    # name: (route, source, replaces: the TPU kernel's pallas_call)
    "lft_select": ("cuda", "timeopt_tpu_torch/csrc/lft_select.cu", "timeopt_tpu/ops/pallas_lft.py:865"),
    "lft_select_generic": ("cuda", "timeopt_tpu_torch/csrc/lft_select_generic.cu",
                           "timeopt_tpu/ops/pallas_lft.py:537 (and :598)"),
    "backward": ("cuda", "timeopt_tpu_torch/csrc/backward.cu", "timeopt_tpu/ops/pallas_backward.py:235"),
    "linesearch": ("cuda", "timeopt_tpu_torch/csrc/linesearch.cu", "timeopt_tpu/ops/pallas_forward.py:308"),
    "lft_scan": ("cuda", "timeopt_tpu_torch/csrc/lft_scan.cu", "timeopt_tpu/ops/pallas_lft.py:161"),
    "lft_query": ("cuda", "timeopt_tpu_torch/csrc/lft_query.cu", "timeopt_tpu/ops/pallas_lft.py:232"),
}
# Select kernel vs plain on J(T), T >= T_min: ("rel", r) bounds the largest
# elementwise relative error, ("norm", r) each problem's largest error
# relative to its largest |J(T)|; both errors are printed. With a bound the
# argmin T* must also be equal or tied within 1e-9 relative on every
# problem; None prints the errors and the argmin agreement, and the gate is
# the oracle score of phase 4. The kernels take solve-based eliminations
# where the plain versions (the JAX reference's algorithm) form explicit
# inverses; where Q has a zero weight (cartpole's theta, PointMass's
# position) or a tiny time weight w (segway, ballbot) q_reg = 1e-9 lets
# kappa(Q_aug) reach 1e9 and beyond, and the plain side loses digits
# (against a long-double run of the same math, PERF.md section 6).
SELECT_BOUND = {"DoubleIntegrator": ("rel", 1e-9), "Cartpole_SwingUp": None, "Quadrotor": ("rel", 1e-9),
                "Segway_Balance": None, "Ballbot_Balance": None, "PointMass_Navigation": ("norm", 1e-2)}
# Phase 4 requires every problem exact or tied, except the problems listed
# here: on them the JAX f64 propagator itself (CPU, the same 128 problems
# and options) is neither exact nor tied against the brute-force oracle
# (it scores 122/128 on PointMass; PERF.md section 6, ROADMAP.md Queue 3).
REFERENCE_MISSES = {"PointMass_Navigation": (39, 42, 57, 66, 81, 112)}
# The unfused select (prefix-scan kernel, then query kernel), J(T) for
# T >= T_min, read as SELECT_BOUND, on every system three ways:
# - the query kernel alone on the plain prefixes against the plain query,
#   QUERY_BOUND (readings <= 1.6e-10 relative, PointMass; <= 6.2e-13 on the
#   other five);
# - the chain against the generic select kernel (csrc/lft_select_generic.cu,
#   gated on its own above and by phase 4) on the same blocks, CHAIN_BOUND:
#   the scan takes that kernel's element and compose sweeps in the same
#   order and its J the same last-pivot value, so the two agree bitwise
#   (reading 0 on all six systems at levels 1 and 2); a change of either
#   kernel's operation order must re-read this bound against long double;
# - the chain against the chain of plain versions, SCAN_QUERY_BOUND, where
#   that holds: the scan kernel eliminates where the plain scan (the JAX
#   algorithm) forms explicit inverses. On the quadrotor's first iterate the
#   chain is the generic select's math on the same blocks, hence its rtol
#   2e-9. At the oracle's final (X, U) the plain chain is the side that
#   loses digits: against a long-double run of the same math on the 128
#   problems it is off by 2.7e-7 relative (quadrotor) and 0.18 normwise
#   (PointMass), the kernels' elimination order by 1.6e-10 and 3.6e-4
#   (PERF.md section 6); cartpole, segway and ballbot are printed only.
QUERY_BOUND = ("rel", 1e-9)
CHAIN_BOUND = ("rel", 1e-12)
SCAN_QUERY_FIRST_BOUND = ("rel", 2e-9)
SCAN_QUERY_BOUND = {"DoubleIntegrator": ("rel", 1e-9), "Cartpole_SwingUp": None, "Quadrotor": ("rel", 1e-6),
                    "Segway_Balance": None, "Ballbot_Balance": None, "PointMass_Navigation": None}
# Phase 5 holds consistency_check's two curves on each brute-force result to
# each other: the kernels' J_prop(T) against the plain brute force's J_bf(T)
# (an independent algorithm), every problem's argmin T* tied to J_bf's by
# the oracle's rule, and each problem's max |J_prop - J_bf| over its max
# |J_bf| within CC_NORM_BOUND. The readings (PERF.md section 6) are 2.2e-5
# (DI, about lm_lambda), 1.6e-4, 8.8e-6, 0.80 (segway: J_bf and the
# propagator's q_reg disagree there at lm_lambda 0 too), 2.1e-2 and 0.22
# (PointMass, 1.3e-2 at lm_lambda 0). Scan outputs off by 1e-3 relative (E,
# F or G), shifted by one horizon or taken at jitter 1e-6 read 3.4 to 2e4
# times higher on the five others, and leave 4 to 121 of the segway's 128
# argmins tied.
CC_NORM_BOUND = {"DoubleIntegrator": 5e-5, "Cartpole_SwingUp": 3e-4, "Quadrotor": 2e-5, "Segway_Balance": 1.0,
                 "Ballbot_Balance": 4e-2, "PointMass_Navigation": 0.5}
# Phase 6 holds these cases' rows to the committed results/cpu_f64_25 CSV:
# T* identical, and trial-0 consistency_max_abs within RUNNER_CC_RTOL of the
# committed value. That value, the largest |J_prop(T) - J_bf(T)|, carries
# the propagator's rounding at the longest horizon: the card reads DI
# 1.8e-9 and the quadrotor 1.15e-2 off the committed value, the port's
# plain chain on the CPU 2.2e-2, and the JAX package recomputes its own
# committed quadrotor trajectory 1.46e-2 off (PERF.md section 6).
RUNNER_GATED = ("DoubleIntegrator", "Quadrotor")
RUNNER_CC_RTOL = {"DoubleIntegrator": 1e-3, "Quadrotor": 3e-2}
COMMITTED_CSV = os.path.join(ROOT, "results", "cpu_f64_25", "summary_all.csv")


def require(cond, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {msg}")


def log(*a) -> None:
    print(*a, flush=True)


def smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 10) -> float:
    """Milliseconds per call of fn() launched `reps` times back to back
    between two CUDA events, after a warm-up: the device's own time, as
    long as the host enqueues faster than the card runs (cuda_ms, one call
    per event pair, also counts the card idling on the host's launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a, b):
    """(max |a-b| over finite entries, same non-finite pattern)."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    same = bool(torch.equal(fa, fb)) and bool(
        torch.equal(torch.where(fa, 0.0, a.nan_to_num(0.0, 1.0, -1.0)), torch.where(fb, 0.0, b.nan_to_num(0.0, 1.0, -1.0)))
    )
    both = fa & fb
    err = (a - b).abs()[both].max().item() if bool(both.any()) else 0.0
    return err, same


def within(a, b, rtol: float, atol: float) -> bool:
    import torch

    fa = torch.isfinite(a)
    ok_fin = bool(((a - b).abs() <= atol + rtol * b.abs())[fa].all())
    return ok_fin and max_err(a, b)[1]


def oracle_problems(system, mk, B: int, device):
    """The problem sets of scripts/oracle_match.py, bit for bit: the default
    problem with x0[:, :3] += 0.4 N(0, 1) for the quadrotor and
    x0 += sigma_x0 N(0, 1) for every other system, default_rng(0)."""
    import torch
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    base = mk(device=device)
    rng = np.random.default_rng(SEED)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    if system.name == "Quadrotor":
        x0[:, :3] += 0.4 * rng.standard_normal((B, 3))
    else:
        x0 += np.asarray(system.sigma_x0, np.float64) * rng.standard_normal(x0.shape)
    return broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, device=device))


def first_iterate(system, probs):
    """The solve's first iterate: U = u_ref, its rollout and Jacobians."""
    from timeopt_tpu_torch.solver.cost import rollout
    from timeopt_tpu_torch.solver.ilqr import default_U_init
    from timeopt_tpu_torch.solver.linearize import linearize

    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    return X, U, A, Bj


def phase_device():
    import torch

    require(torch.cuda.is_available(), "torch.cuda.is_available() is False; this script needs an NVIDIA GPU")
    # TF32 never touches float64; set both off all the same, so no float32
    # product anywhere on the path could run in TF32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from timeopt_tpu_torch.ops import _build

    nv = subprocess.run([_build.nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(f"[device] {smi()} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{nv.stdout.strip().splitlines()[-1]} | count {torch.cuda.device_count()}")


def phase_build():
    from timeopt_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_all(list(KERNELS))
    log(f"[build] {len(KERNELS)} kernels in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        secs, report = _build.build_info(name)
        lines = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: nvcc {secs:.1f} s | " + " | ".join(lines))


def check_select(J_k, J_p, s, probs, bound, label: str, inf_below: bool = True,
                 ungated: str = "the gate is the oracle score of phase 4"):
    """J of kernel and plain for T >= T_min: +inf below T_min from the
    kernel (with inf_below: the select kernels skip those queries), the same
    non-finite pattern, and the errors and argmin T* agreement gated by
    `bound` (see SELECT_BOUND); with no bound the log names the gate that
    holds instead (`ungated`). Returns (max abs err, the plain version's
    T*)."""
    import torch
    from timeopt_tpu_torch.solver.cost import argmin_T

    t_min, Bsz = probs.T_min, J_k.shape[0]
    if inf_below:
        require(bool(torch.isinf(J_k[:, : t_min - 1]).all()), f"{label}: kernel J below T_min is not +inf")
    a, b = J_k[:, t_min - 1 :], J_p[:, t_min - 1 :]
    err, same = max_err(a, b)
    require(same, f"{label}: non-finite pattern of J differs")
    d = (a - b).abs()
    errs = {"rel": (d / b.abs()).max().item(), "norm": (d.amax(1) / b.abs().amax(1)).max().item()}
    s0 = s[:, :1] ** 2
    T_k = argmin_T(s0 * J_k, t_min, probs.T_max)
    T_p = argmin_T(s0 * J_p, t_min, probs.T_max)
    rows = torch.arange(Bsz, device=J_k.device)
    Jpk, Jpp = J_p[rows, T_k - 1], J_p[rows, T_p - 1]
    tied = (T_k == T_p) | ((Jpk - Jpp).abs() <= 1e-9 * Jpp.abs())
    log(f"[kernels] {label}: max abs err {err:.3e}, max rel err {errs['rel']:.3e}, normwise {errs['norm']:.3e} "
        f"(t >= T_min; bound {bound or 'none here: ' + ungated}), argmin equal {int((T_k == T_p).sum())}/{Bsz}, "
        f"tied {int(tied.sum())}/{Bsz}")
    if bound is not None:
        kind, r = bound
        require(errs[kind] <= r, f"{label}: J {kind} err {errs[kind]:.3e} > {r}")
        require(bool(tied.all()), f"{label}: argmin T differs beyond a 1e-9 tie on {int((~tied).sum())} problems")
    return err, T_p


def close_per_rollout(k, p, mask, rtol: float, atol: float) -> bool:
    """Kernel and plain rollouts Xs or Us (B, A, rows, d) agree on the
    masked rows of each (problem, alpha): the same non-finite pattern, and
    max |k - p| <= atol + rtol max |p| over the rollout."""
    import torch

    m = mask[..., None].expand_as(p)
    if not torch.equal(torch.isfinite(k) | ~m, torch.isfinite(p) | ~m):
        return False
    d = torch.where(m, (k - p).abs(), 0.0).nan_to_num(0.0).amax(dim=(2, 3))
    ref = torch.where(m, p.abs(), 0.0).nan_to_num(0.0).amax(dim=(2, 3))
    return bool((d <= atol + rtol * ref).all())


def check_linesearch(system, probs, X, U, K, kap, T, alphas, label: str, gate_all: bool):
    """Line-search kernel vs plain: X, U, J within rtol 1e-10 / atol 1e-12
    and identical accepted flags. With gate_all, elementwise on every alpha
    and row. Otherwise on the alphas that improve on J_old (a diverging
    rollout amplifies last-bit differences without bound), X on the rows
    k <= T* that the cost reads (beyond T* the rollout runs open loop on
    the nominal controls: on the segway a 1-ulp change of x0 moves those
    rows by 6.5e-6), and X and U relative to each rollout's largest entry
    (a control near zero, as PointMass's with u_ref = 0, carries the
    absolute error of the K dx terms that sum to it). Returns the max abs
    error over all alphas and rows."""
    import torch
    from timeopt_tpu_torch.ops import cuda_forward
    from timeopt_tpu_torch.solver.cost import cost_true
    from timeopt_tpu_torch.solver.forward import select_first_improving

    args = (system, probs, X, U, K, kap, T, alphas)
    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*args)
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*args)
    torch.cuda.synchronize()
    errs = [max_err(Xs_k, Xs_p)[0], max_err(Us_k, Us_p)[0], max_err(Js_k, Js_p)[0]]
    J_old = cost_true(system, probs, X, U, T)
    imp = Js_p < J_old[:, None]
    require(bool(torch.equal(Js_k < J_old[:, None], imp)), f"{label}: improving alphas differ")
    if gate_all:
        ok = all(within(k, p, 1e-10, 1e-12) for k, p in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)))
        gated = "all, elementwise"
    else:
        rows = torch.arange(probs.N + 1, device=X.device)[None, None] <= T[:, None, None]
        ok = (close_per_rollout(Xs_k, Xs_p, imp[..., None] & rows, 1e-10, 1e-12)
              and close_per_rollout(Us_k, Us_p, imp[..., None].expand(Us_p.shape[:3]), 1e-10, 1e-12)
              and within(Js_k[imp], Js_p[imp], 1e-10, 1e-12))
        gated = "the improving, X on rows <= T*, per rollout"
    require(ok, f"{label}: X/U/J outside rtol 1e-10 atol 1e-12 (max abs over all {errs})")
    acc_k = select_first_improving(X, U, Xs_k, Us_k, Js_k, J_old).accepted
    acc_p = select_first_improving(X, U, Xs_p, Us_p, Js_p, J_old).accepted
    require(bool(torch.equal(acc_k, acc_p)), f"{label}: accepted flags differ")
    log(f"[kernels] {label}: max abs err X {errs[0]:.3e}, U {errs[1]:.3e}, J {errs[2]:.3e} (all alphas and rows; "
        f"gated on {gated}), accepted identical ({int(acc_k.sum())}/{X.shape[0]})")
    return max(errs)


def select_pair(system, probs, opts, X, U, A, Bj):
    """(kernel, plain, s): the path's select kernel and its plain version as
    calls on the same inputs, and the homogeneous scales."""
    from timeopt_tpu_torch.ops import cuda_lft, cuda_lft_generic
    from timeopt_tpu_torch.solver.ilqr import select_inputs

    generic, args, s = select_inputs(system, probs, opts, X, U, A, Bj)
    if generic:
        return (lambda: cuda_lft_generic.propagator_select_generic(*args, t_min=probs.T_min),
                lambda: cuda_lft_generic.select_generic_plain(*args), s)
    return (lambda: cuda_lft.propagator_select_fused(*args, t_min=probs.T_min),
            lambda: cuda_lft.select_fused_plain(*args), s)


def normwise(k, p, label: str) -> float:
    """Largest |k - p| of each trailing matrix over its largest |p|, max over
    the batch; the non-finite patterns must agree."""
    require(max_err(k, p)[1], f"{label}: non-finite pattern differs")
    d = (k - p).abs().nan_to_num(0.0).amax(dim=(-1, -2))
    return (d / p.abs().nan_to_num(0.0).amax(dim=(-1, -2))).nan_to_num(0.0).max().item()


def scan_query_pair(system, probs, X, U, A, Bj, levels: int, bound, label: str, timed: bool = False) -> dict:
    """The unfused select on the assembled blocks of (X, U, A, B): the scan
    kernel's prefixes against the plain scan's (normwise per matrix,
    printed); the query kernel on the plain prefixes against the plain query
    (QUERY_BOUND); the whole kernel chain against the generic select kernel
    (CHAIN_BOUND) and against the whole plain chain (`bound`), each gated as
    check_select. With `timed`, both kernels and both plain versions are
    timed. Returns the errors of the chain and of the query alone."""
    import torch
    from timeopt_tpu_torch.ops import cuda_lft_generic, cuda_lft_query, cuda_lft_scan
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb

    blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=levels)
    C = build_terminal_factors(probs, X, s=blk.s).contiguous()
    args = [t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)]
    pre_k = cuda_lft_scan.lft_scan(*args, levels=levels)
    pre_p = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    J_kq = cuda_lft_query.lft_query(*pre_p, C, levels=levels)
    J_p = cuda_lft_query.lft_query_plain(*pre_p, C, levels=levels)
    J_k = cuda_lft_query.lft_query(*pre_k, C, levels=levels)
    J_g = cuda_lft_generic.propagator_select_generic(
        *[t.contiguous() for t in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C)], t_min=probs.T_min)
    torch.cuda.synchronize()
    efg = [normwise(k, p, f"{label} prefixes") for k, p in zip(pre_k, pre_p)]
    log(f"[kernels] {label}: scan normwise err E {efg[0]:.3e}, F {efg[1]:.3e}, G {efg[2]:.3e}")
    q_err, _ = check_select(J_kq, J_p, blk.s, probs, QUERY_BOUND, f"{label} query kernel on the plain prefixes",
                            inf_below=False)
    check_select(J_k, J_g, blk.s, probs, CHAIN_BOUND, f"{label} scan+query J vs the generic select kernel",
                 inf_below=False)
    err, _ = check_select(J_k, J_p, blk.s, probs, bound, f"{label} scan+query J vs the plain chain", inf_below=False,
                          ungated="the plain chain loses digits; gated against the generic select kernel above "
                                  "and against the brute force in phase 5")
    out = dict(max_abs_err=err, query_max_abs_err=q_err)
    if timed:
        scan = lambda: cuda_lft_scan.lft_scan(*args, levels=levels)  # noqa: E731
        query = lambda: cuda_lft_query.lft_query(*pre_k, C, levels=levels)  # noqa: E731
        out["scan"] = (device_ms(scan), cuda_ms(scan, reps=5),
                       cuda_ms(lambda: cuda_lft_scan.lft_scan_plain(*args, levels=levels), reps=3))
        out["query"] = (device_ms(query), cuda_ms(query, reps=5),
                        cuda_ms(lambda: cuda_lft_query.lft_query_plain(*pre_k, C, levels=levels), reps=3))
        log(f"[kernels] {label}: lft_scan kernel {out['scan'][0]:.3f} ms back to back, {out['scan'][1]:.3f} ms one "
            f"call, plain {out['scan'][2]:.3f} ms | lft_query kernel {out['query'][0]:.3f} ms back to back, "
            f"{out['query'][1]:.3f} ms one call, plain {out['query'][2]:.3f} ms")
    return out


def load_oracle(case: str) -> dict:
    suffix = "" if case == "Quadrotor" else f"_{case}"
    return dict(np.load(os.path.join(ROOT, "results", f"oracle_f64{suffix}.npz")))


def phase_kernels(device) -> dict:
    """The main path's kernels at B=1024 (quadrotor N=160, PointMass
    N = T_max = 220), then each system's select and line search at B=128."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft_generic, work
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.backward import backward_inputs, backward_truncated
    from timeopt_tpu_torch.solver.ilqr import SolveOptions
    from timeopt_tpu_torch.solver.linearize import linearize

    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    out = {}

    # ---- B=1024: quadrotor fused select (rtol 1e-9), PointMass generic select
    for case, name in (("Quadrotor", "lft_select"), ("PointMass_Navigation", "lft_select_generic")):
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_FULL, device)
        X, U, A, Bj = first_iterate(system, probs)
        kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
        J_k, J_p = kernel(), plain()
        torch.cuda.synchronize()
        err, T_p = check_select(J_k, J_p, s, probs, SELECT_BOUND[case], f"{name} ({case} B={B_FULL})")
        b2b, ms, pms = device_ms(kernel), cuda_ms(kernel, reps=5), cuda_ms(plain, reps=3)
        count = work.select_fused if name == "lft_select" else work.select_generic
        out[name] = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                         **count(B_FULL, probs.N, system.n, system.m, probs.T_min))
        log(f"[kernels] {name}: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")
        if case == "Quadrotor":
            quad = (system, probs, X, U, A, Bj, T_p)

    # ---- quadrotor B=1024, at the plain select's T*: backward (kappa, K
    # rtol 1e-9 / atol 1e-12, ok identical), then the line search
    system, probs, X, U, A, Bj, T_p = quad
    lm = torch.full((B_FULL,), opts.lm_init, dtype=torch.float64, device=device)
    bw_args = [A.contiguous(), Bj.contiguous(), *backward_inputs(system, probs, X, U), T_p.contiguous(), lm]
    kap_k, K_k, ok_k = cuda_backward.backward_truncated_core(*bw_args)
    kap_p, K_p, ok_p = cuda_backward.backward_plain(*bw_args)
    torch.cuda.synchronize()
    e1, _ = max_err(kap_k, kap_p)
    e2, _ = max_err(K_k, K_p)
    require(within(kap_k, kap_p, 1e-9, 1e-12) and within(K_k, K_p, 1e-9, 1e-12),
            f"backward: kappa/K outside rtol 1e-9 atol 1e-12 (max abs {e1:.3e}, {e2:.3e})")
    require(bool(torch.equal(ok_k, ok_p)), "backward: ok flags differ")
    b2b = device_ms(lambda: cuda_backward.backward_truncated_core(*bw_args))
    ms = cuda_ms(lambda: cuda_backward.backward_truncated_core(*bw_args), reps=5)
    pms = cuda_ms(lambda: cuda_backward.backward_plain(*bw_args), reps=3)
    out["backward"] = dict(max_abs_err=max(e1, e2), ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                           **work.backward(T_p.tolist(), probs.N, system.n, system.m))
    log(f"[kernels] backward: max abs err kappa {e1:.3e}, K {e2:.3e}, ok identical "
        f"({int(ok_k.sum())}/{B_FULL} ok) | kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")

    ls_args = (system, probs, X, U, K_p, kap_p, T_p, opts.alphas)
    err = check_linesearch(*ls_args, f"line search (Quadrotor B={B_FULL})", gate_all=True)
    b2b = device_ms(lambda: cuda_forward.linesearch(*ls_args))
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=3)
    out["linesearch"] = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                             **work.linesearch(system.name, T_p.tolist(), probs.N, system.n, system.m,
                                               len(opts.alphas)))
    log(f"[kernels] line search: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")

    # ---- B=128, each system's oracle set: its select kernel and the line
    # search; on the quadrotor the generic select on its assembled blocks
    for case in CASES:
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_ORACLE, device)
        X, U, A, Bj = first_iterate(system, probs)
        if case == "Quadrotor":
            blk = build_augmented(system, probs, X, U, A, Bj, q_reg=1e-9, psd_levels=opts.psd_levels)
            args = [t.contiguous() for t in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv,
                                             build_terminal_factors(probs, X, s=blk.s))]
            J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=probs.T_min)
            J_p = cuda_lft_generic.select_generic_plain(*args)
            torch.cuda.synchronize()
            # rtol 2e-9: against a long-double run of the same math the plain
            # version is off by 7.9e-10 and the kernel's elimination order by
            # 2.8e-10 (before FMA contraction) on these inputs
            check_select(J_k, J_p, blk.s, probs, ("rel", 2e-9), f"lft_select_generic (Quadrotor blocks B={B_ORACLE})")
            continue
        kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
        J_k, J_p = kernel(), plain()
        torch.cuda.synchronize()
        _, T = check_select(J_k, J_p, s, probs, SELECT_BOUND[case], f"select ({case} B={B_ORACLE})")
        lm = torch.full((B_ORACLE,), opts.lm_init, dtype=torch.float64, device=device)
        bw = backward_truncated(system, probs, A, Bj, X, U, T, lm)
        ls_args = (system, probs, X, U, bw.K, bw.kappa, T, opts.alphas)
        check_linesearch(*ls_args, f"line search ({case} B={B_ORACLE})", gate_all=False)
        ms = device_ms(lambda: cuda_forward.linesearch(*ls_args))
        pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=1)
        log(f"[kernels] line search ({case} B={B_ORACLE} N={probs.N}): kernel {ms:.3f} ms back to back, "
            f"plain {pms:.3f} ms")

    # ---- the unfused select (consistency_check's psd_levels=2): quadrotor
    # B=1024 first iterate, timed; then each system's oracle (X, U) at B=128
    system, probs, X, U, A, Bj, _ = quad
    sq = scan_query_pair(system, probs, X, U, A, Bj, 2, SCAN_QUERY_FIRST_BOUND,
                         f"scan+query (Quadrotor B={B_FULL})", timed=True)
    # the scan's error is the chain's (its prefixes reach J only through a
    # query); the query's is its own, on the plain prefixes
    out["lft_scan"] = dict(max_abs_err=sq["max_abs_err"], ms=sq["scan"][1], ms_back_to_back=sq["scan"][0],
                           plain_ms=sq["scan"][2],
                           **work.lft_scan(B_FULL, probs.N, system.n))
    out["lft_query"] = dict(max_abs_err=sq["query_max_abs_err"], ms=sq["query"][1], ms_back_to_back=sq["query"][0],
                            plain_ms=sq["query"][2],
                            **work.lft_query(B_FULL, probs.N, system.n))
    for case in CASES:
        system, mk = get_system(case)
        orc = load_oracle(case)
        probs = oracle_problems(system, mk, B_ORACLE, device)
        X, U = (torch.as_tensor(orc[k], device=device) for k in ("X", "U"))
        A, Bj = linearize(system.step, X, U)
        scan_query_pair(system, probs, X, U, A, Bj, 2, SCAN_QUERY_BOUND[case], f"scan+query ({case} oracle X, U)")
    return out


def _counted():
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query, cuda_lft_scan

    return {"lft_select": cuda_lft, "lft_select_generic": cuda_lft_generic, "backward": cuda_backward,
            "linesearch": cuda_forward, "lft_scan": cuda_lft_scan, "lft_query": cuda_lft_query}


def reset_launches() -> None:
    for mod in _counted().values():
        mod.LAUNCHES = 0


def launches() -> dict:
    return {name: mod.LAUNCHES for name, mod in _counted().items()}


def score(T, T_o, curve_o, w: float):
    """(exact, exact-or-tied) boolean arrays of T* against the oracle's."""
    idx = np.arange(len(T_o))
    exact = T == T_o
    return exact, exact | (np.abs(curve_o[idx, T - 1] - curve_o[idx, T_o - 1]) <= w * (np.abs(T - T_o) + 1))


def phase_oracle(case: str, device) -> dict:
    """The 128 problems of the case's results/oracle_f64*.npz, solved on the
    card and scored; returns the launch count of every kernel in the solve."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    system, mk = get_system(case)
    orc = load_oracle(case)
    T_o, J_o, curve_o = orc["T"].astype(np.int64), orc["J"], orc["J_curve"]
    Bo = len(T_o)
    probs = oracle_problems(system, mk, Bo, device)
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)

    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    select = "lft_select" if system.extra_cost is None else "lft_select_generic"
    for name in (select, "backward", "linesearch"):
        require(counts[name] > 0, f"oracle solve {case}: kernel {name} was never launched")

    n, m, N = system.n, system.m, probs.N
    require(tuple(res.X.shape) == (Bo, N + 1, n) and tuple(res.U.shape) == (Bo, N, m), f"{case}: result shapes")
    require(bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all()), f"{case}: non-finite X or U")
    require(bool(torch.isfinite(res.J_star).all()), f"{case}: non-finite J*")
    T = res.T_star.cpu().numpy()
    J = res.J_star.cpu().numpy()
    exact, tied = score(T, T_o, curve_o, float(probs.w[0]))
    gap = np.abs(J - J_o) / np.abs(J_o)
    eT = wrap_error(res.X[torch.arange(Bo, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    succ = float((eT.norm(dim=-1) <= 0.5).double().mean())
    log(f"[oracle] {case} B={Bo}: T* exact {int(exact.sum())}/{Bo}, exact-or-tied {int((exact | tied).sum())}/{Bo} | "
        f"J* rel gap median {np.median(gap):.3e} max {gap.max():.3e} | success@0.5 {succ:.3f} | "
        f"{secs:.2f} s | launches {counts}")
    bad = np.nonzero(~(exact | tied))[0]
    if len(bad):
        log(f"[oracle] {case} not tied: idx {bad.tolist()} T* {T[bad].tolist()} oracle {T_o[bad].tolist()}")
    allowed = set(REFERENCE_MISSES.get(case, ()))
    require(set(bad.tolist()) <= allowed,
            f"oracle {case}: exact-or-tied {int((exact | tied).sum())}/{Bo}, misses {sorted(set(bad.tolist()) - allowed)} "
            "beyond the reference's own")
    return counts


def phase_bruteforce(case: str, device) -> dict:
    """The oracle's own computation on its 128 problems: the brute-force
    solve, scored exact-or-tied 128/128; then consistency_check on its
    result (the scan and query kernels). Returns the launch counts of both
    paths."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.cost import argmin_T
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch
    from timeopt_tpu_torch.solver.verify import consistency_check

    system, mk = get_system(case)
    orc = load_oracle(case)
    T_o, J_o, curve_o = orc["T"].astype(np.int64), orc["J"], orc["J_curve"]
    Bo = len(T_o)
    probs = oracle_problems(system, mk, Bo, device)

    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=SolveOptions(method="bruteforce", max_iter=MAX_ITER, psd_levels=1))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    for name in ("backward", "linesearch"):
        require(counts[name] > 0, f"brute-force solve {case}: kernel {name} was never launched")
    require(bool(torch.isfinite(res.J_star).all()), f"brute-force {case}: non-finite J*")
    T, J = res.T_star.cpu().numpy(), res.J_star.cpu().numpy()
    exact, tied = score(T, T_o, curve_o, float(probs.w[0]))
    gap = np.abs(J - J_o) / np.abs(J_o)
    c, co = res.J_curve.cpu().numpy()[:, probs.T_min - 1 :], curve_o[:, probs.T_min - 1 :]
    cgap = np.abs(c - co).max(axis=1) / np.abs(co).max(axis=1)
    log(f"[bruteforce] {case} B={Bo}: T* exact {int(exact.sum())}/{Bo}, exact-or-tied {int(tied.sum())}/{Bo} | "
        f"J* rel gap median {np.median(gap):.3e} max {gap.max():.3e} | J(T) normwise gap to the oracle's curve "
        f"median {np.median(cgap):.3e} max {cgap.max():.3e} | {secs:.2f} s, {counts['backward']} outer iterations, "
        f"{1e3 * secs / counts['backward']:.1f} ms/iteration | {smi()}")
    bad = np.nonzero(~tied)[0]
    require(len(bad) == 0, f"brute force {case}: not exact or tied on {bad.tolist()} (T* {T[bad].tolist()}, "
            f"oracle {T_o[bad].tolist()})")

    reset_launches()
    t0 = time.perf_counter()
    cc = consistency_check(system, probs, res.X, res.U)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cc_counts = launches()
    for name in ("lft_scan", "lft_query"):
        require(cc_counts[name] > 0, f"consistency_check {case}: kernel {name} was never launched")
    mx = cc["max_abs"].cpu().numpy()
    require(np.isfinite(mx).all() and bool(torch.isfinite(cc["rmse"]).all()), f"consistency_check {case}: non-finite")
    require(bool(torch.isfinite(cc["J_prop"][:, probs.T_min - 1 :]).all()), f"consistency_check {case}: J_prop non-finite")
    # the kernels' curve against the brute force's on the same trajectories
    J_prop, J_bf = cc["J_prop"], cc["J_bf"]
    a, b = J_prop[:, probs.T_min - 1 :], J_bf[:, probs.T_min - 1 :]
    nw = ((a - b).abs().amax(1) / b.abs().amax(1)).cpu().numpy()
    T_prop = argmin_T(J_prop, probs.T_min, probs.T_max).cpu().numpy()
    T_bf = argmin_T(J_bf, probs.T_min, probs.T_max).cpu().numpy()
    exact_bf, tied_bf = score(T_prop, T_bf, J_bf.cpu().numpy(), float(probs.w[0]))
    q = np.quantile(mx, [0.0, 0.5, 0.9, 1.0])
    log(f"[consistency] {case} B={Bo}: max_abs min {q[0]:.3e} median {q[1]:.3e} p90 {q[2]:.3e} max {q[3]:.3e} | "
        f"rmse median {float(cc['rmse'].median()):.3e} | J_prop vs J_bf normwise median {np.median(nw):.3e} max "
        f"{nw.max():.3e} (bound {CC_NORM_BOUND[case]}), argmin exact {int(exact_bf.sum())}/{Bo}, tied "
        f"{int(tied_bf.sum())}/{Bo} | {secs:.2f} s | launches {cc_counts}")
    require(nw.max() <= CC_NORM_BOUND[case],
            f"consistency_check {case}: J_prop vs J_bf normwise {nw.max():.3e} > {CC_NORM_BOUND[case]}")
    bad = np.nonzero(~tied_bf)[0]
    require(len(bad) == 0, f"consistency_check {case}: the kernels' argmin T* is not tied to the brute force's on "
            f"{bad.tolist()} (T* {T_prop[bad].tolist()}, brute force {T_bf[bad].tolist()})")
    return {k: counts[k] + cc_counts[k] for k in counts}


def phase_inverse(device) -> dict:
    """One quadrotor solve at B=128 with the reference-parity inverse query:
    the scan kernel inside a solve. Returns its launch counts."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    system, mk = get_system("Quadrotor")
    orc = load_oracle("Quadrotor")
    probs = oracle_problems(system, mk, B_ORACLE, device)
    opts = SolveOptions(method="propagator", terminal_mode="inverse", max_iter=MAX_ITER, psd_levels=1)
    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    require(counts["lft_scan"] > 0, "inverse-query solve: kernel lft_scan was never launched")
    require(bool(torch.isfinite(res.J_star).all()), "inverse-query solve: non-finite J*")
    T_o = orc["T"].astype(np.int64)
    exact, tied = score(res.T_star.cpu().numpy(), T_o, orc["J_curve"], float(probs.w[0]))
    gap = np.abs(res.J_star.cpu().numpy() - orc["J"]) / np.abs(orc["J"])
    log(f"[inverse] Quadrotor B={B_ORACLE} terminal_mode=inverse: T* exact {int(exact.sum())}/{B_ORACLE}, "
        f"exact-or-tied {int(tied.sum())}/{B_ORACLE} | J* rel gap max {gap.max():.3e} | {secs:.2f} s | launches {counts}")
    return counts


def phase_runner() -> dict:
    """The port's suite runner in-process (device cuda) on all six cases,
    held against the committed results/cpu_f64_25 rows. Returns its launch
    counts."""
    import csv
    import tempfile

    from timeopt_tpu_torch.runner import run_suite

    with open(COMMITTED_CSV, newline="") as f:
        want = {(r["case"], r["solver"], r["trial"]): r for r in csv.DictReader(f)}
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        run_suite.main(["--cases", ",".join(CASES), "--trials", "25", "--solvers", "ourmethod,baseline1",
                        "--consistency", "--save-jt", "--save-trajectories", "--outdir", out])
        secs = time.perf_counter() - t0
        counts = launches()
        with open(os.path.join(out, "summary_all.csv"), newline="") as f:
            got = list(csv.DictReader(f))
        with open(os.path.join(out, "summary_agg.csv"), newline="") as f:
            agg = list(csv.DictReader(f))
        for case in CASES:
            require(os.path.exists(os.path.join(out, case, f"{case}_Jt.csv")), f"runner: no {case}_Jt.csv")
            require(os.path.exists(os.path.join(out, case, "trajectories_baseline1.npz")), f"runner: no {case} npz")
    for name in KERNELS:
        require(counts[name] > 0, f"runner: kernel {name} was never launched")
    require(len(got) == len(CASES) * 2 * 25, f"runner: {len(got)} rows")
    log(f"[runner] 6 cases x 25 trials x (ourmethod, baseline1), --consistency --save-jt --save-trajectories: "
        f"{secs:.1f} s | launches {counts}")
    for case in CASES:
        rows = [r for r in got if r["case"] == case]
        t_miss = [(r["solver"], r["trial"], r["T_star"], want[(case, r["solver"], r["trial"])]["T_star"])
                  for r in rows if r["T_star"] != want[(case, r["solver"], r["trial"])]["T_star"]]
        jgap = max(abs(float(r["J_star"]) - float(want[(case, r["solver"], r["trial"])]["J_star"]))
                   / abs(float(want[(case, r["solver"], r["trial"])]["J_star"])) for r in rows)
        cc = {s: (float(r["consistency_max_abs"]), float(want[(case, s, "0")]["consistency_max_abs"]))
              for s in ("ourmethod", "baseline1") for r in rows if r["solver"] == s and r["trial"] == "0"}
        ratio = {r["solver"]: r["ratio_time_median"] for r in agg if r["case"] == case}
        log(f"[runner] {case}: T* differs from the committed rows on {len(t_miss)}/{len(rows)} "
            f"{t_miss[:6]}{' ...' if len(t_miss) > 6 else ''} | J* max rel gap {jgap:.3e} | trial-0 consistency_max_abs "
            + ", ".join(f"{s} {a:.6e} (committed {b:.6e}, rel {(a - b) / b:+.3e})" for s, (a, b) in cc.items())
            + f" | time_ratio_base median ourmethod {ratio.get('ourmethod')}")
        if case in RUNNER_GATED:
            require(not t_miss, f"runner {case}: T* differs from the committed rows: {t_miss}")
            for s, (a, b) in cc.items():
                lim = RUNNER_CC_RTOL[case] * abs(b)
                require(abs(a - b) <= lim, f"runner {case} {s}: consistency_max_abs {a} vs committed {b} (limit {lim:.3e})")
    return counts


def phase_throughput(case: str, device) -> dict:
    """One timed solve_batch at B=1024 after a warm-up; returns its launch
    counts (the launches of one main-path solve)."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.cost import extra_cost_terms
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    system, mk = get_system(case)
    probs = oracle_problems(system, mk, B_FULL, device)
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    solve_batch(system, probs, options=opts)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    select = "lft_select" if system.extra_cost is None else "lft_select_generic"
    for name in (select, "backward", "linesearch"):
        require(counts[name] > 0, f"throughput {case}: kernel {name} was never launched")
    iters = counts["backward"]
    eT = wrap_error(res.X[torch.arange(B_FULL, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    succ = float((eT.norm(dim=-1) <= 0.5).double().mean())
    require(bool(torch.isfinite(res.J_star).all()), f"throughput {case}: non-finite J*")
    extra = ""
    if system.extra_cost is not None:
        X, U = res.X[:, :-1].contiguous(), res.U
        ems = cuda_ms(lambda: extra_cost_terms(system, X, U), reps=3)
        extra = f" | extra_cost_terms (B*N={B_FULL * probs.N} steps) {ems:.2f} ms per call"
    log(f"[throughput] {case} B={B_FULL} max_iter={MAX_ITER} f64: {B_FULL / secs:.2f} solves/s | {secs:.3f} s | "
        f"{iters} outer iterations, {1e3 * secs / iters:.2f} ms/iteration | T* median "
        f"{float(res.T_star.double().median()):g} | success@0.5 {succ:.3f} | launches {counts}{extra} | {smi()}")
    return counts


def phase_ab(device, old: str) -> list:
    """The two redesigned kernels against an earlier version of their
    sources (`old`, a csrc/ directory) on one card, in turns old, new, new,
    old (each turn the median of CUDA-event timings): the fused select at
    the quadrotor's B=1024 and the line search there and at B=128 on every
    system, each on the first iterate of the oracle problem sets. Prints the
    largest difference between the two versions' outputs and whether they
    are bitwise equal; the new version is also held against the plain one
    as phase 3 holds it."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import _build, cuda_forward
    from timeopt_tpu_torch.solver.backward import backward_truncated
    from timeopt_tpu_torch.solver.cost import argmin_T
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    names = ["lft_select", "linesearch"]
    old = Path(old).resolve()
    t0 = time.perf_counter()
    _build.load_all(names, old)
    _build.load_all(names)
    log(f"[ab] {names} built from {old} (old) and from this checkout (new) in {time.perf_counter() - t0:.1f} s")
    for tag, csrc in (("old", old), ("new", _build.CSRC)):
        for name in names:
            report = _build.build_info(name, csrc)[1]
            lines = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines() if "registers" in ln or "spill" in ln]
            log(f"[ab] {tag} {name}: " + " | ".join(lines))

    @contextmanager
    def kernels(tag):
        """Inside the block the wrappers launch the old kernels for tag
        "old", this checkout's for "new"."""
        load = _build.load
        if tag == "old":
            _build.load = lambda name: load(name, old)
        try:
            yield
        finally:
            _build.load = load

    def both(fn):
        with kernels("old"):
            a = fn()
        b = fn()
        torch.cuda.synchronize()
        return a, b

    def turns(fn) -> dict:
        """Back-to-back ms (and one-call ms) of old and new, in turns."""
        t = {"old": [], "new": [], "old_one_call": [], "new_one_call": []}
        for tag in ("old", "new", "new", "old"):
            with kernels(tag):
                t[tag].append(device_ms(fn))
                t[tag + "_one_call"].append(cuda_ms(fn, reps=5))
        return t

    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    rows = []
    system, mk = get_system("Quadrotor")
    probs = oracle_problems(system, mk, B_FULL, device)
    X, U, A, Bj = first_iterate(system, probs)
    kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
    J_o, J_n = both(kernel)
    err, same = max_err(J_o, J_n)
    check_select(J_n, plain(), s, probs, SELECT_BOUND["Quadrotor"], f"ab: new lft_select vs plain (Quadrotor B={B_FULL})")
    rows.append(dict(kernel="lft_select", case="Quadrotor", B=B_FULL, N=probs.N, max_abs_diff=err,
                     bitwise=bool(same and err == 0.0), **{f"{k}_ms": v for k, v in turns(kernel).items()}))
    for case, Bsz in [("Quadrotor", B_FULL)] + [(c, B_ORACLE) for c in CASES]:
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, Bsz, device)
        X, U, A, Bj = first_iterate(system, probs)
        kernel, _, s = select_pair(system, probs, opts, X, U, A, Bj)
        T = argmin_T(s[:, :1] ** 2 * kernel(), probs.T_min, probs.T_max)
        lm = torch.full((Bsz,), opts.lm_init, dtype=torch.float64, device=device)
        bw = backward_truncated(system, probs, A, Bj, X, U, T, lm)
        args = (system, probs, X, U, bw.K, bw.kappa, T, opts.alphas)
        out_o, out_n = both(lambda: cuda_forward.linesearch(*args))
        errs = [max_err(a, b) for a, b in zip(out_o, out_n)]
        check_linesearch(*args, f"ab: new line search vs plain ({case} B={Bsz})", gate_all=Bsz == B_FULL)
        rows.append(dict(kernel="linesearch", case=case, B=Bsz, N=probs.N, max_abs_diff=max(e for e, _ in errs),
                         bitwise=all(same and e == 0.0 for e, same in errs),
                         **{f"{k}_ms": v for k, v in turns(lambda: cuda_forward.linesearch(*args)).items()}))
    # end to end: one B=1024 solve with each version's kernels, in turns
    from timeopt_tpu_torch.solver.ilqr import solve_batch

    for case in ("Quadrotor", "PointMass_Navigation"):
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_FULL, device)
        res, secs = {}, {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            with kernels(tag):
                solve_batch(system, probs, options=opts)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[tag] = solve_batch(system, probs, options=opts)
                torch.cuda.synchronize()
                secs[tag].append(time.perf_counter() - t0)
        same = all(bool(torch.equal(getattr(res["old"], f), getattr(res["new"], f))) for f in ("T_star", "J_star", "X", "U"))
        rows.append(dict(kernel="solve_batch", case=case, B=B_FULL, N=probs.N, same_result=same,
                         old_solves_per_s=[B_FULL / t for t in secs["old"]],
                         new_solves_per_s=[B_FULL / t for t in secs["new"]]))
        log(f"[ab] solve_batch ({case} B={B_FULL}), solves/s in turns: old {B_FULL / secs['old'][0]:.2f} / new "
            f"{B_FULL / secs['new'][0]:.2f} / new {B_FULL / secs['new'][1]:.2f} / old {B_FULL / secs['old'][1]:.2f} | "
            f"T*, J*, X, U identical {same} | {smi()}")
    for r in rows:
        if r["kernel"] == "solve_batch":
            continue
        log(f"[ab] {r['kernel']} ({r['case']} B={r['B']} N={r['N']}), back to back: old {r['old_ms'][0]:.3f} / new "
            f"{r['new_ms'][0]:.3f} / new {r['new_ms'][1]:.3f} / old {r['old_ms'][1]:.3f} ms; one call: old "
            f"{r['old_one_call_ms'][0]:.3f} / new {r['new_one_call_ms'][0]:.3f} / new {r['new_one_call_ms'][1]:.3f} / old "
            f"{r['old_one_call_ms'][1]:.3f} ms | max |new - old| {r['max_abs_diff']:.3e}, bitwise {r['bitwise']} | {smi()}")
    return rows


def main() -> None:
    import torch

    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    numbers = phase_kernels(device)
    counts = {name: 0 for name in KERNELS}

    def add(c: dict) -> None:
        for name, v in c.items():
            counts[name] += v

    for case in CASES:
        add(phase_oracle(case, device))
    for case in CASES:
        add(phase_bruteforce(case, device))
    add(phase_inverse(device))
    add(phase_runner())
    per_solve = {case: phase_throughput(case, device) for case in ("Quadrotor", "PointMass_Navigation")}

    from timeopt_tpu_torch.ops import work

    log(f"[bounds] float64 peaks of an H100 SXM: {work.PEAK_FLOPS / 1e12:g} TFLOP/s (tensor cores; bound_ms), "
        f"{work.PEAK_FLOPS_CUDA_CORES / 1e12:g} TFLOP/s (CUDA cores; bound_ms_cuda_cores), "
        f"{work.PEAK_BYTES / 1e12:g} TB/s; card: {smi()}")
    kernels = []
    for name, (route, src, rep) in KERNELS.items():
        k = dict(name=name, route=route, source=src, replaces=rep, launches=counts[name],
                 launches_per_solve={case: c[name] for case, c in per_solve.items()}, **numbers[name],
                 library_ms=None, library="none: no single PyTorch call computes it")
        k["share_of_bound"] = k["bound_ms"] / k["ms_back_to_back"]
        kernels.append(k)
        log(f"[bounds] {name}: {k['ms_back_to_back']:.3f} ms back to back ({k['ms']:.3f} one call), bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
            f"({k['flops'] / 1e9:.3f} GFLOP, {k['bytes'] / 1e6:.1f} MB; {k['bound_ms_cuda_cores']:.4f} ms at "
            f"{work.PEAK_FLOPS_CUDA_CORES / 1e12:g} TFLOP/s), share of bound {k['share_of_bound']:.4f}, "
            f"launches per B={B_FULL} solve {k['launches_per_solve']}")
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def main_ab(old: str) -> None:
    import torch

    phase_device()
    rows = phase_ab(torch.device("cuda", 0), old)
    print(json.dumps({"ab": rows}))
    print(smi())


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:
        main_ab(sys.argv[2])
    else:
        main()
