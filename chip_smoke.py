#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timeopt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path, the batched HOP-DDP propagator solve of the
quadrotor (n=12, m=4, N=160, float64), on the card through its three
hand-written CUDA kernels, in five phases; each prints its own lines and
any failure raises (non-zero exit, no result line):

1. device: the card, CUDA and nvcc versions (no CPU fallback);
2. build: the three kernels from timeopt_tpu_torch/csrc/ with nvcc;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, at B=1024, N=160, on inputs from a real iterate, with the stated
   tolerances, and both timed (median of CUDA-event timings after warm-up);
4. the solve of the 128 problems of results/oracle_f64.npz, scored against
   that f64 brute-force oracle (exact and exact-or-tied T*), with the
   launch count of every kernel in that run;
5. throughput: one timed solve_batch at B=1024.

The line before the last is the card's name and power limit as nvidia-smi
prints them; before that, one JSON line with each kernel's numbers. The
last line is {"ok": true, "device": {...}}. Imports no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

B_FULL = 1024
MAX_ITER = 12
SEED = 0
KERNELS = {
    # name: (route, source, replaces: the TPU kernel's pallas_call)
    "lft_select": ("cuda", "timeopt_tpu_torch/csrc/lft_select.cu", "timeopt_tpu/ops/pallas_lft.py:865"),
    "backward": ("cuda", "timeopt_tpu_torch/csrc/backward.cu", "timeopt_tpu/ops/pallas_backward.py:235"),
    "linesearch": ("cuda", "timeopt_tpu_torch/csrc/linesearch.cu", "timeopt_tpu/ops/pallas_forward.py:308"),
}


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


def bench_problems(system, mk, B: int, device):
    """The bench distribution: default quadrotor, x0[:, :3] += 0.4 N(0, 1)."""
    import torch
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    base = mk(device=device)
    rng = np.random.default_rng(SEED)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    x0[:, :3] += 0.4 * rng.standard_normal((B, 3))
    return broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, device=device))


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

    for name in KERNELS:
        t0 = time.perf_counter()
        _build.load(name)
        secs, report = _build.build_info(name)
        lines = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        log(f"[build] {name}: {time.perf_counter() - t0:.1f} s (nvcc {secs:.1f} s) | " + " | ".join(lines))


def phase_kernels(system, mk, device) -> dict:
    """Each kernel against its plain version on the card, at B=1024, N=160."""
    import torch
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft
    from timeopt_tpu_torch.solver.augmented import build_fused_inputs
    from timeopt_tpu_torch.solver.backward import backward_inputs
    from timeopt_tpu_torch.solver.cost import argmin_T, cost_true, rollout
    from timeopt_tpu_torch.solver.forward import select_first_improving
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, default_U_init
    from timeopt_tpu_torch.solver.linearize import linearize

    probs = bench_problems(system, mk, B_FULL, device)
    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)
    A, Bj = linearize(system.step, X, U)
    fi = build_fused_inputs(system, probs, X, U, A, Bj, q_reg=1e-9, psd_levels=opts.psd_levels)
    sel_args = [t.contiguous() for t in (fi.A, fi.B, fi.vecs, fi.scal, fi.Qq, fi.R_inv, fi.Lt)]
    out = {}

    # ---- select: J for t >= T_min within rtol 1e-9; argmin equal or tied
    t_min = probs.T_min
    J_k = cuda_lft.propagator_select_fused(*sel_args, t_min=t_min)
    J_p = cuda_lft.select_fused_plain(*sel_args)
    torch.cuda.synchronize()
    s0 = fi.s[:, :1] ** 2
    a, b = J_k[:, t_min - 1 :], J_p[:, t_min - 1 :]
    err, same = max_err(a, b)
    rel = ((a - b).abs() / b.abs()).max().item()
    require(same and rel <= 1e-9, f"select: J rel err {rel:.3e} > 1e-9 (or non-finite pattern differs)")
    T_k = argmin_T(s0 * J_k, t_min, probs.T_max)
    T_p = argmin_T(s0 * J_p, t_min, probs.T_max)
    rows = torch.arange(B_FULL, device=device)
    Jpk, Jpp = J_p[rows, T_k - 1], J_p[rows, T_p - 1]
    tied = (T_k == T_p) | ((Jpk - Jpp).abs() <= 1e-9 * Jpp.abs())
    require(bool(tied.all()), f"select: argmin T differs beyond a 1e-9 tie on {int((~tied).sum())} problems")
    ms = cuda_ms(lambda: cuda_lft.propagator_select_fused(*sel_args, t_min=t_min), reps=5)
    pms = cuda_ms(lambda: cuda_lft.select_fused_plain(*sel_args), reps=3)
    out["lft_select"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    log(f"[kernels] select: max abs err {err:.3e}, max rel err {rel:.3e} (t >= T_min), argmin equal "
        f"{int((T_k == T_p).sum())}/{B_FULL}, tied {int(tied.sum())}/{B_FULL} | kernel {ms:.3f} ms, plain {pms:.3f} ms")

    # ---- backward at the plain select's T*: kappa, K rtol 1e-9 / atol 1e-12, ok identical
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
    ms = cuda_ms(lambda: cuda_backward.backward_truncated_core(*bw_args), reps=5)
    pms = cuda_ms(lambda: cuda_backward.backward_plain(*bw_args), reps=3)
    out["backward"] = dict(max_abs_err=max(e1, e2), ms=ms, plain_ms=pms)
    log(f"[kernels] backward: max abs err kappa {e1:.3e}, K {e2:.3e}, ok identical "
        f"({int(ok_k.sum())}/{B_FULL} ok) | kernel {ms:.3f} ms, plain {pms:.3f} ms")

    # ---- line search: X, U, J rtol 1e-10 / atol 1e-12, accepted identical
    ls_args = (system, probs, X, U, K_p, kap_p, T_p, opts.alphas)
    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*ls_args)
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*ls_args)
    torch.cuda.synchronize()
    errs = [max_err(Xs_k, Xs_p)[0], max_err(Us_k, Us_p)[0], max_err(Js_k, Js_p)[0]]
    require(all(within(k, p, 1e-10, 1e-12) for k, p in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p))),
            f"line search: X/U/J outside rtol 1e-10 atol 1e-12 (max abs {errs})")
    J_old = cost_true(system, probs, X, U, T_p)
    acc_k = select_first_improving(X, U, Xs_k, Us_k, Js_k, J_old).accepted
    acc_p = select_first_improving(X, U, Xs_p, Us_p, Js_p, J_old).accepted
    require(bool(torch.equal(acc_k, acc_p)), "line search: accepted flags differ")
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=3)
    out["linesearch"] = dict(max_abs_err=max(errs), ms=ms, plain_ms=pms)
    log(f"[kernels] line search: max abs err X {errs[0]:.3e}, U {errs[1]:.3e}, J {errs[2]:.3e}, accepted "
        f"identical ({int(acc_k.sum())}/{B_FULL}) | kernel {ms:.3f} ms, plain {pms:.3f} ms")
    return out


def reset_launches() -> None:
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft

    cuda_lft.LAUNCHES = cuda_backward.LAUNCHES = cuda_forward.LAUNCHES = 0


def launches() -> dict:
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft

    return {"lft_select": cuda_lft.LAUNCHES, "backward": cuda_backward.LAUNCHES, "linesearch": cuda_forward.LAUNCHES}


def phase_oracle(system, mk, device) -> dict:
    """The 128 problems of results/oracle_f64.npz, solved on the card."""
    import torch
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    orc = np.load(os.path.join(ROOT, "results", "oracle_f64.npz"))
    T_o, J_o, curve_o = orc["T"].astype(np.int64), orc["J"], orc["J_curve"]
    Bo = len(T_o)
    probs = bench_problems(system, mk, Bo, device)
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)

    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    for name, c in counts.items():
        require(c > 0, f"oracle solve: kernel {name} was never launched")

    n, m, N = system.n, system.m, probs.N
    require(tuple(res.X.shape) == (Bo, N + 1, n) and tuple(res.U.shape) == (Bo, N, m), "result shapes")
    require(bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all()), "non-finite X or U")
    require(bool(torch.isfinite(res.J_star).all()), "non-finite J*")
    T = res.T_star.cpu().numpy()
    J = res.J_star.cpu().numpy()
    w = float(probs.w[0])
    idx = np.arange(Bo)
    exact = T == T_o
    tied = np.abs(curve_o[idx, T - 1] - curve_o[idx, T_o - 1]) <= w * (np.abs(T - T_o) + 1)
    gap = np.abs(J - J_o) / np.abs(J_o)
    eT = wrap_error(res.X[torch.arange(Bo, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    succ = float((eT.norm(dim=-1) <= 0.5).double().mean())
    log(f"[oracle] B={Bo}: T* exact {int(exact.sum())}/{Bo}, exact-or-tied {int((exact | tied).sum())}/{Bo} | "
        f"J* rel gap median {np.median(gap):.3e} max {gap.max():.3e} | success@0.5 {succ:.3f} | "
        f"{secs:.2f} s | launches {counts}")
    require(bool((exact | tied).all()), f"oracle: exact-or-tied {int((exact | tied).sum())}/{Bo} < {Bo}")
    return counts


def phase_throughput(system, mk, device) -> None:
    import torch
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    probs = bench_problems(system, mk, B_FULL, device)
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    solve_batch(system, probs, options=opts)  # warm-up
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    counts = launches()
    iters = counts["lft_select"]
    eT = wrap_error(res.X[torch.arange(B_FULL, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    succ = float((eT.norm(dim=-1) <= 0.5).double().mean())
    require(bool(torch.isfinite(res.J_star).all()), "throughput: non-finite J*")
    log(f"[throughput] B={B_FULL} max_iter={MAX_ITER} f64: {B_FULL / secs:.2f} solves/s | {secs:.3f} s | "
        f"{iters} outer iterations, {1e3 * secs / iters:.2f} ms/iteration | T* median "
        f"{float(res.T_star.double().median()):g} | success@0.5 {succ:.3f} | launches {counts} | {smi()}")


def main() -> None:
    import torch

    phase_device()
    from timeopt_tpu_torch.models import get_system

    system, mk = get_system("Quadrotor")
    device = torch.device("cuda", 0)
    phase_build()
    numbers = phase_kernels(system, mk, device)
    counts = phase_oracle(system, mk, device)
    phase_throughput(system, mk, device)

    kernels = [
        dict(name=name, route=route, source=src, replaces=rep, launches=counts[name], **numbers[name])
        for name, (route, src, rep) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
