#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (timeopt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's batched HOP-DDP solves and its one-pass baseline in
float64 on the card through its six hand-written CUDA kernels, for every
system of the model registry (and the line search generated for a System
without a device_id: phases 3 and 4), then its latency mode, its scale-out layer,
its float32 path (float32 storage, float64 recursions) and its serving
entries (bench_torch.py's dp-sharded batch, bench_sustained_torch.py's
stream), then the device-side outer loop, in twelve phases; each prints its own lines and any failure raises (non-zero exit,
no result line). Every solve runs as `solve_batch` runs it on the card:
one launch of a program's loop graph, its captured CUDA graphs inside a
conditional WHILE node (timeopt_tpu_torch/solver/compiled.py), each
program's warm-up, capture and loop-graph seconds and pool bytes printed; the solves of
phases 4, 5, 8 and 10 (b) (of the float32 modes, the F32_MODES_EAGER
sets) are each also run by the eager driver `compiled._solve_traced` and
must equal it bit for bit with the same launches and, on the device's
loop counter, the steps _solve_traced takes; phases 7, 8 (b) and 10 (c)
also time captured against eager in turns, with the same checks. Every program built
on the main path is traced with torch.profiler (observe_programs): one
replay of each of its two captures, whose kernels on the card must equal,
kernel by kernel, the launches the program books for that graph. A
solve's launches are derived, not traced: init's launches plus `it` times
step's, `it` read from the loop's counters on the card when the counts are
read (compiled.settle_launches, called by launches()); no launch of a loop
graph is held to a trace (the comment above TRACED). The captured programs
are dropped between phases, and a `[time]` line follows each phase:

1. device: the card, CUDA and nvcc versions (no CPU fallback);
2. build: the six kernels from timeopt_tpu_torch/csrc/ and the generated
   line searches (ops/dyngen.py: the kernel template of
   csrc/linesearch_kernel.cuh on a struct traced from a System's own xdot,
   guard and extra cost) of the six registry systems' device_id=None twins
   and of the unicycle, one nvcc each, all started together, their nvcc
   seconds and registers printed, the fused select's shuffles per
   instantiation from its SASS (those compiled for a diverged warp, inside
   WARPSYNC.COLLECTIVE ... ENDCOLLECTIVE, apart), and the scan's, query's
   and fused select's blocks resident per SM;
3. kernels vs plain: each kernel against its plain PyTorch version on the
   card, on inputs from a real iterate, with the stated tolerances, and
   timed (median of CUDA-event timings after warm-up): the fused select,
   backward and line search on the quadrotor at B=1024, N=160 (the main
   path), and the line search from start states other than row 0 of X:
   the one-pass method's first shifted-gain rollouts on the quadrotor, at
   three horizons a problem (3 x 1024 rollouts); the generated line search
   of the quadrotor's twin at B=1024 against the plain version (as the
   hand-written kernel) and against the hand-written kernel (check_generated:
   GENERATED_RTOL, the same improving alphas, bitwise equality printed), on
   both entries, timed in turns with the hand-written one; the generic select on PointMass at B=1024, N=220, and the
   backward there at its own T*; then per system, at B=128 on its oracle
   problem set, its select kernel (the error printed, gated by
   SELECT_BOUND), the backward at that select's T* (rtol 1e-9, atol 1e-12,
   ok identical) and the line search, hand-written and generated (each
   against the plain version, and against each other), and the generic select on the
   assembled blocks of the quadrotor, the double integrator and the
   cart-pole (GENERIC_BLOCKS_BOUND: p = 13, 3 and 5); the backward and the
   generic select on random inputs of shapes no system has (their
   run-time-size paths: OFF_REGISTRY_BACKWARD, OFF_REGISTRY_SELECT); at
   PointMass B=1024, where the backward is held normwise, a long-double
   witness on the problems where kernel and plain differ most; then the unfused
   select's prefix-scan and terminal-query
   kernels on the quadrotor's first-iterate blocks at B=1024, N=160, timed,
   and per system at B=128 on the oracle's own final (X, U): E, F, G
   printed; on every system the query kernel alone (QUERY_BOUND) and the
   chain against the generic select kernel (CHAIN_BOUND); the chain against
   the plain chain where that holds (SCAN_QUERY_FIRST_BOUND,
   SCAN_QUERY_BOUND), and the scan against a long-double witness of its
   own math where it does not (cart-pole, PointMass: SCAN_WITNESS_NORM);
   (b) the Jacobian kernel (csrc/linearize.cu, the port's own) against
   linearize_ad (vmap(jacfwd)) in float64 at the benchmark cells' shapes
   (quadrotor B=1024 N=160, PointMass B=1024 N=240), float32 and float64
   (LINEARIZE_RTOL), timed one call and back to back beside the plain
   version, with its byte bound; (c) the 6-DoF lander (LANDER: n = 14,
   m = 3, the only system on the wide size tiers of the fused select and
   the backward) at its benchmark cell's size, B=1024, N=200, in float64
   and float32: the select, the backward and the line search against
   their plain versions at the quadrotor's gates of phases 3 and 10 (a),
   the Jacobian kernel against float64 AD, each timed with its bound; then
   a captured float32 solve of the set, bitwise its eager run, with its
   launches counted from zero;
4. the solve of the 128 problems of each results/oracle_f64*.npz (six
   systems), scored against that f64 brute-force oracle (exact and
   exact-or-tied T*, every problem but REFERENCE_MISSES), with the launch
   count of every kernel in each run; then each set solved by the
   system's device_id=None twin (the generated line search; its step is the
   registry's, so its Jacobians are the kernel's too): the same T*
   on every problem, J* within rtol 1e-10, the same score, its line-search
   launches all generated ones and the plain line search never run
   (solve_twin); (b) the same for the one-pass method on the double
   integrator (the start-state entry) and the quadrotor's float32 set (the
   _f32 entries), and the unicycle, a system outside the registry, at
   B=128 against its CPU solve (T* identical, J* rtol 1e-9; its step
   carries no device_id, so its Jacobians stay vmap(jacfwd)'s);
5. brute force: the oracle's own computation, solve_batch(method=
   "bruteforce", max_iter=12, psd_levels=1), on each of the six oracle
   problem sets, exact-or-tied 128/128 with no exception, the J* and J(T)
   gaps printed; then consistency_check (the scan and query kernels against
   the plain brute force) on each result, its argmin tied to the brute
   force's on every problem and its curve within CC_NORM_BOUND of it; and
   one quadrotor solve with terminal_mode="inverse" (the scan kernel inside
   a solve);
6. the port's suite runner (timeopt_tpu_torch.runner.run_suite) in-process
   on all six cases, 25 trials, ourmethod, baseline1 and baseline2 (the
   one-pass method), with --consistency --save-jt --save-trajectories
   --phase-timers, against results/cpu_f64_25: ourmethod's and baseline1's
   T* identical on every DoubleIntegrator and Quadrotor row, their trial-0
   consistency_max_abs within RUNNER_CC_RTOL of the committed value;
   baseline2's trial 0 of every case with the committed T* and J* within
   rtol 1e-6, and its success share per case at least the committed one;
   the other mismatches printed (baseline2's with their J* gap), and each
   case's trial-0 phase timers beside the committed CPU values;
7. throughput: solve_batch at B=1024 of the quadrotor and of PointMass,
   and the one-pass solve of the quadrotor, each timed captured, eager,
   eager, captured after the program's build (bitwise equal, the same
   launches); the kernels of each path must launch;
8. latency mode: the six oracle sets at B=128 solved with
   scan_mode="associative" and "assoc_df" (plain torch scans, then the
   query kernel), scored and gated as phase 4 (misses within
   REFERENCE_MISSES, and for "associative" within ASSOC_MISSES) and
   printed beside phase 4's score; then the
   quadrotor's oracle problem 0 at B=1 (N=160, max_iter=12) solved in the
   three scan modes, captured and eager (median of 5 synchronized solves
   of each after a warm-up, the modes and the drivers in turns; captured
   bitwise eager; T* identical to the sequential solve's, J* within rtol
   1e-9) and its
   select alone timed on the first iterate in each mode;
9. scale-out (timeopt_tpu_torch.parallel): solve_batch_sharded over a
   mesh of every card against solve_batch on the quadrotor and PointMass
   oracle sets, propagator_select_sharded with the queries over the cards
   against propagator_select (both scan modes; at float32 bit for bit),
   then torch.distributed
   in this process at world size 1 with NCCL: solve_batch_global +
   gather_results against the same solve, t_star_histogram and
   batch_summary against their local values (exactly), and the runner
   with --distributed against the runner without it (DoubleIntegrator, 5
   trials, ourmethod,baseline1: T* identical); with two or more cards,
   one NCCL rank a card by torch.multiprocessing against the one-process
   solve. Solves: T* and T_ties identical, J*, X and U within rtol 1e-12,
   the sharded solve (its chunks' captured programs driven together)
   bit for bit, timed against the one-card solve in turns;
10. float32: (a) the float32 instantiations of the fused select, the
   backward, the line search (both entries) and the generic select against
   their plain versions at phase 3's shapes (F32_SELECT_BOUND, F32_REL,
   F32_ATOL; PointMass's select also against a long-double witness,
   F32_WITNESS_REL, beside the plain version computed in float32), and
   the scan's and the query's on the quadrotor's float32 blocks
   (f32_scan_query: phase 3's gates, and bit for bit their float64 entries
   on the upcast inputs), timed, with their bounds at float32 bytes; (b)
   the six oracle sets as float32 problems (oracle_problems' perturbation,
   rounded), scored against the float64 oracle: exact-or-tied no lower
   than the JAX package's float32 pipeline (results/oracle_f32_dense*.npz
   against the same oracle), phase 4's float64 score beside it, with the
   J(T) change from rounding the prefixes to float32 printed on the segway
   and the quadrotor (prefix_rounding, a diagnostic); then the same sets
   through #9 and #10 at float32 (F32_MODES: the inverse query and both
   latency modes), gated as phase 8 and each result's consistency_check as
   phase 5, the argmins at float32 resolution (tied_f32); (c) phase 7's quadrotor and PointMass
   solves and the quadrotor's one-pass solve at float32, captured and
   eager in turns, beside phase 7's
   float64 solves/s of this run, then `python3 bench_torch.py` at its
   defaults (dp-sharded over every card), its one JSON line echoed; (d) the runner with --f32
   --consistency on the double integrator and the quadrotor (5 trials,
   three solvers), every row finite, each T* printed beside
   results/tpu_f32/summary_all.csv and each trial-0 consistency_max_abs no
   larger than that file's;
11. the serving entries: (a) bench_torch.py's quadrotor set (float32,
   B=1024) split over every card by shard_problems and solved in place by
   solve_batch_resident: one program a card, each card's result bitwise
   its chunk's own solve_batch; (b) the B=8192 set the same way, its first
   1024 x0 rows (a)'s bit for bit, those rows' T* equal or tied at float32
   resolution to (a)'s (tied_f32 on (a)'s J curve) and J* within
   BIG_J_RTOL where T* is equal (the largest difference and bitwise
   equality printed, with each B=8192 program's warm-up, capture and
   pool); (c) `python3 bench_sustained_torch.py` with DURATION_S=10 and
   BIG_BATCH=8192, its JSON line echoed, its keys those of
   results/bench_sustained_r05.json (the JAX script's record), its
   success_rate bench_torch.py's, no program built in its window and its
   last batch bitwise its first;
12. the device-side loop (phase_device_loop): the loop condition kernel
   against its plain version on a table of cases (B = 1, 37, 8192), timed
   at B=1024; a warmed quadrotor float32 B=1024 solve_batch under
   torch.cuda.set_sync_debug_mode("error"), its host seconds against its
   device seconds; four solves of four seeds queued on one program, each
   bitwise its own; the quadrotor's oracle problem 0 at B=1, its steps on
   the device counter those of _solve_traced; the resident solve over
   every card with no sync, each chunk bitwise its own solve.

Each path resets the kernels' launch counts just before it runs and reads
them just after; a kernel of the path that was not launched fails it. The
line before the last is the card's name and power limit as nvidia-smi
prints them; before that, one JSON line with each kernel's numbers: its
launches summed over the paths of phases 4-6, 8, 9, 10 (b), (d) and 11 (a), (b) (`launches`) and in one
B=1024 solve of phase 7 (`launches_per_solve`, by case; `Quadrotor_onepass`
the one-pass solve; `linesearch_generated`, the generated line search,
launches in phase 4 and its numbers from the quadrotor's twin), its error and times from
phase 3 (`ms` and `plain_ms` one call between two CUDA events, the
wrapper's host work included; `ms_back_to_back` ten launches back to back
between two events, the kernel's own device time), and its roofline bound
at the phase-3 shapes (timeopt_tpu_torch/ops/work.py: `flops`, `bytes`,
`bound_ms` at 67 TFLOP/s and 3.35 TB/s, `bound_by`, `bound_ms_cuda_cores`
at 34 TFLOP/s, `share_of_bound` = bound_ms / ms_back_to_back; `library_ms`
is null: no single PyTorch call computes any of these functions); the
backward's entry also holds its numbers at PointMass B=1024 (`pointmass`,
printed on a [bounds] line of its own), the line search's those of the
one-pass rollouts from their start states, with their bound
(`onepass_rollout`); every kernel also holds its float32 instantiation's
phase-10 numbers (`float32`: the same keys, bytes at float32, launches
per float32 solve of phase 10 (c); the scan and the query also their
float64 entries' times on the same blocks). `loop_cond`, the port's own
kernel (the loop's condition; it replaces no TPU kernel), has the same
keys: its launches over phases 4-11 and per B=1024 solve of phase 7, its
numbers from phase 12 (a). `linearize`, the port's own Jacobian kernel,
too: its launches over phases 4-11, per B=1024 solve of phase 7 and of
phase 10 (c), its numbers from phase 3 (b) (the quadrotor's float32 ones,
every shape's under `shapes`). `lander` holds phase 3 (c)'s numbers by
dtype and kernel, the same keys, and the launches of its solve. The last
line is {"ok": true, "device": {...}}.
Imports no JAX.

    python3 chip_smoke.py --lander

runs phases 1 and 3 (c) alone (a few minutes) and prints the same three
last lines, the JSON line holding `lander` only.

    python3 chip_smoke.py --ab OLD_CSRC

times every kernel whose sources (its .cu or a header it includes) differ
between another directory of kernel sources (e.g. an earlier commit's
timeopt_tpu_torch/csrc, from `git archive`) and this checkout's, old
against new in turns old, new, new, old, on that kernel's rows (AB_ROWS),
prints the largest difference between their outputs and whether they are
bitwise equal, then times one B=1024 solve with each version's kernels,
and fails unless old and new are bitwise equal on every row (phase_ab).
The fused select's rows cover each of its size tiers (ab_lft_select), and
its SASS counts of both versions are printed.
The line search's rows also run the new kernel through its start-state
entry (start states X[:, 0], as a view of X and as a copy) against the old
kernel's ordinary entry. Where the old sources have a kernel's float32
entry, that kernel's rows include its float32 instantiation too (the
quadrotor, or PointMass, at B=1024; the line search also from the
one-pass rollouts' start states; the scan and the query also the random
blocks of the run-time-size paths).
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
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
# The line search of a System without a device_id: the kernel template of
# csrc/linesearch_kernel.cuh on a struct generated from the system's own
# xdot, guard and extra cost (ops/dyngen.py, built with nvcc in phase 2);
# its launches count on dyngen.LAUNCHES.
GENERATED = ("linesearch_generated", "cuda",
             "timeopt_tpu_torch/csrc/linesearch_kernel.cuh + timeopt_tpu_torch/ops/dyngen.py",
             "timeopt_tpu/ops/pallas_forward.py:308 (and :385)")
# The compiled solve's device-side loop (solver/compiled.py): the condition
# kernel of csrc/loop_graph.cu, launched twice or more by each solve's loop
# graph (once after init, once after each step), its launches booked from the
# programs' counters (compiled.settle_launches) on cuda_loop.LAUNCHES. It is
# the port's own: the TPU evaluates the lax.while_loop's condition inside
# its jitted program.
LOOP = ("loop_cond", "cuda", "timeopt_tpu_torch/csrc/loop_graph.cu",
        "none: the port's own kernel, the condition of the lax.while_loop in "
        "timeopt_tpu/solver/ilqr.py:165-190 (_run_outer_loop)")
# The Jacobians of a registry system's step (solver/linearize.py on the card,
# ops/cuda_linearize.py): the port's own kernel, dual numbers on the
# dynamics of csrc/systems.cuh. The JAX package leaves jacfwd to XLA, so it
# replaces no TPU kernel; on the card it replaces linearize_ad (vmap(jacfwd)),
# its plain version here. Its launches count on cuda_linearize.LAUNCHES.
LINEARIZE = ("linearize", "cuda", "timeopt_tpu_torch/csrc/linearize.cu (+ systems.cuh, dual.cuh)",
             "none: the port's own kernel; the JAX package's jacfwd (timeopt_tpu/solver/linearize.py) is XLA's")
# Phase 3 (b) holds it to linearize_ad in float64 on the same card inputs at
# the benchmark cells' shapes: the same non-finite entries, the finite ones
# within LINEARIZE_RTOL (atol 1e-15) at float64, and within half a float32
# spacing plus that margin at float32 (one rounding of the float64 value).
LINEARIZE_RTOL = 1e-12
LINEARIZE_SHAPES = (("Quadrotor", 160), ("PointMass_Navigation", 240))  # B = B_FULL
# Phase 3 (c): the system of the benchmark cell rocket6dof-prop-b1024, the
# only one that takes the wide size tiers of the fused select and the
# backward (n = 14, m = 3).
LANDER = "Rocket6DoF"
# The generated kernel against the hand-written one of the same system
# (check_generated): both compile the same formulas with nvcc's default FMA
# contraction, so they are likely bitwise equal (printed), not certainly;
# the gate is GENERATED_RTOL and the same improving alphas.
GENERATED_RTOL = 1e-12
GENERATED_BUILD_S: dict = {}  # system name -> nvcc seconds of its generated library
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
# The backward kernel against its plain version: ok identical, and kappa
# and K within rtol 1e-9 / atol 1e-12 elementwise (the quadrotor at B=1024
# and every system at B=128). PointMass at B=1024 (first iterate, T* up to
# 220) holds the largest error of each problem within 1e-8 of its largest
# |kappa| (|K|) instead: there the earlier kernel, bitwise equal to this
# one (--ab), reads 2.8e-4 abs off the plain version (a gain near zero
# carries the absolute error of the terms that sum to it) and 6.95e-10
# normwise (PERF.md section 6). There a long-double witness
# (witness_backward) reads both sides on the problems where they differ
# most, and the kernel must stay within the same bound of it.
BACKWARD_NORM_B1024 = {"PointMass_Navigation": 1e-8}
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
#   both kernels run the one element and compose of csrc/lft_chain.cuh and
#   the query takes the same last-pivot value, so the two agree bitwise by
#   construction (reading 0 on all six systems at levels 1 and 2);
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
# The generic select kernel against its plain version on the assembled
# blocks of the first iterate at B=128, read as SELECT_BOUND: one system a
# width (p = 13, 3, 5). Against a long-double run of the same math on the
# quadrotor's blocks the plain version is off by 7.9e-10 and the kernel's
# elimination order by 2.8e-10 (before FMA contraction), hence rtol 2e-9
# there and on the double integrator. On the cart-pole's blocks the plain
# version loses digits as it does in SELECT_BOUND (zero theta weight; the
# kernel reads 1.77e-2 off it, PERF.md section 6): printed, and the
# generic kernel is gated there by a long-double witness and CHAIN_BOUND.
GENERIC_BLOCKS_BOUND = {"Quadrotor": ("rel", 2e-9), "DoubleIntegrator": ("rel", 2e-9), "Cartpole_SwingUp": None}
# Where GENERIC_BLOCKS_BOUND is None, the kernel is held to a long-double
# run of its own solve-based math (select_generic_longdouble): J within
# WITNESS_SELECT_REL relative for T >= T_min, and argmin T* tied to the
# witness's on every problem. The kernel's order run in float64 on the CPU
# reads 3.9e-5 (8 of the cart-pole's problems) and 1.9e-4 (a 32-step
# cart-pole iterate) off the witness, the plain version 1.9e-2 and 0.42
# (tests/test_torch_witness.py).
WITNESS_SELECT_REL = 1e-3
# On the cart-pole's and PointMass's oracle (X, U), where the plain chain
# loses digits (SCAN_QUERY_BOUND None), the scan kernel's prefixes are held
# to a long-double run of its own solve-based math (scan_longdouble): the
# largest error of each E, F and G over that matrix's largest entry, on every
# problem and step, within SCAN_WITNESS_NORM. Each bound is 10x the
# kernel's first reading on the card (cart-pole 3.02e-6, PointMass 1.53e-3;
# the kernel's order run in float64 on the CPU reads the same,
# tests/test_torch_witness.py), and fails the plain scan, which reads
# 2.9e-3 and 6.6e-2 (PERF.md section 6).
SCAN_WITNESS_NORM = {"Cartpole_SwingUp": 3e-5, "PointMass_Navigation": 1.5e-2}
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
# Phase 4's exact-or-tied score per case, printed beside phase 8's.
ORACLE_TIED: dict = {}
# Phase 7's and phase 10's solves/s, by (case, "f64" | "f32").
THROUGHPUT: dict = {}
# The eager driver's solves/s in the same phases (captured_vs_eager).
THROUGHPUT_EAGER: dict = {}
# Phase 8 gates both latency modes on every case as phase 4 gates the
# sequential select: the misses (not exact-or-tied) lie within
# REFERENCE_MISSES. scan_mode="associative" composes with explicit
# inverses, as the JAX package's does, and may also miss ASSOC_MISSES
# (ROADMAP.md Queue 3): PointMass 55, which the JAX package's associative
# mode misses too (T* 56 for 68, on the CPU in f64), and the segway's 18
# and 110, T* 89 for 90 with J* 2.6e-7 off the oracle's (the JAX mode and
# the port's plain path on the CPU pick 90). Its cart-pole T* are tied on
# the oracle's flat curve, with J* up to 68x off, in the JAX package too.
ASSOC_MISSES = {"Segway_Balance": (18, 110), "PointMass_Navigation": (55,)}
LATENCY_MODES = ("associative", "assoc_df")
# Phase 8's exact-or-tied score per (scan mode, case) and phase 5's inverse
# query's (quadrotor), printed beside phase 10 (b)'s float32 modes; phase
# 5's largest J_prop vs J_bf normwise reading per case, beside phase 10's.
MODE_TIED: dict = {}
CC_READ: dict = {}


def kernel_sources(name: str, csrc: Path) -> set:
    """The file names a kernel's build reads in a csrc/ directory:
    <name>.cu and, transitively, the headers it includes ("x.cuh")."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f in seen or not (csrc / f).exists():
            continue
        seen.add(f)
        todo += re.findall(r'^\s*#include\s+"([^"]+)"', (csrc / f).read_text(), flags=re.M)
    return seen


def changed_kernels(old: Path, new: Path, names) -> list:
    """The kernels among `names` that both csrc/ directories hold and whose
    sources differ between them: the .cu, or a header it includes in either
    directory (a header that one of them lacks counts as differing)."""
    out = []
    for name in names:
        if not ((old / f"{name}.cu").exists() and (new / f"{name}.cu").exists()):
            continue
        files = kernel_sources(name, old) | kernel_sources(name, new)
        read = lambda d, f: (d / f).read_bytes() if (d / f).exists() else None  # noqa: E731
        if any(read(old, f) != read(new, f) for f in files):
            out.append(name)
    return out


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


def oracle_problems(system, mk, B: int, device, dtype=None, seed: int = SEED):
    """The problem sets of scripts/oracle_match.py, bit for bit: the default
    problem with x0[:, :3] += 0.4 N(0, 1) for the quadrotor and
    x0 += sigma_x0 N(0, 1) for every other system, default_rng(0), drawn in
    float64; with `dtype` (float32) every float then rounded to it, as the
    script makes its float32 sets. Another `seed` draws another set."""
    import torch
    from timeopt_tpu_torch.ops import _build
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    base = mk(device=device)
    rng = np.random.default_rng(seed)
    x0 = np.tile(base.x0.cpu().numpy(), (B, 1))
    if system.name == "Quadrotor":
        x0[:, :3] += 0.4 * rng.standard_normal((B, 3))
    else:
        x0 += np.asarray(system.sigma_x0, np.float64) * rng.standard_normal(x0.shape)
    probs = broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, device=device))
    return probs if dtype is None else _build.cast(probs, dtype)


def first_iterate(system, probs):
    """The solve's first iterate: U = u_ref, its rollout and Jacobians."""
    from timeopt_tpu_torch.solver.cost import rollout
    from timeopt_tpu_torch.solver.ilqr import default_U_init
    from timeopt_tpu_torch.solver.linearize import linearize

    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)  # at float32 float64-carried, as in the solve
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
    driver = subprocess.run(["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
                            capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi()} | torch {torch.__version__} CUDA {torch.version.cuda} | "
        f"{' '.join(nv.stdout.strip().splitlines()[-2:])} | driver {driver} | count {torch.cuda.device_count()}")


def ptxas_lines(report: str) -> str:
    lines = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines() if "registers" in ln or "spill" in ln]
    return " | ".join(lines)


def select_sass(sass: str) -> dict:
    """Per lft_select_kernel instantiation in the text of `cuobjdump -sass`
    ("double 13": the storage type and the register tile's rows): its SHFL
    instructions, those inside WARPSYNC.COLLECTIVE ... ENDCOLLECTIVE
    sequences (a shuffle the compiler could not prove the whole warp
    reaches, compiled again for a diverged warp behind a BRA.DIV), and the
    sequences."""
    out = {}
    for fn, body in zip(*[iter(re.split(r"Function : (\S+)", sass)[1:])] * 2):
        inst = re.search(r"lft_select_kernelI([df])Li(\d+)E", fn)
        if inst is None:
            continue
        shfl = coll = seqs = 0
        inside = False
        for line in body.splitlines():
            if "ENDCOLLECTIVE" in line:
                inside = False
            elif "COLLECTIVE" in line:
                inside, seqs = True, seqs + 1
            elif "SHFL" in line:
                shfl += 1
                coll += inside
        out[f"{dict(d='double', f='float')[inst[1]]} {inst[2]}"] = dict(shfl=shfl, collective_shfl=coll,
                                                                      collective_sequences=seqs)
    return out


def select_sass_line(lib_path: str) -> str:
    """select_sass of a built library, on one line."""
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    return "; ".join(f"<{k}> SHFL {v['shfl']}, in collective sequences {v['collective_shfl']} "
                     f"({v['collective_sequences']} sequences)" for k, v in sorted(select_sass(sass).items()))


def phase_build():
    """The six kernels of csrc/ and the generated line searches of the six
    registry systems' device_id=None twins and of the unicycle
    (ops/dyngen.py: traced, then one nvcc each), all builds at once."""
    from concurrent.futures import ThreadPoolExecutor

    from timeopt_tpu_torch.ops import _build, dyngen

    t0 = time.perf_counter()
    generated = [twin(c) for c in CASES] + [unicycle()]
    with ThreadPoolExecutor(max_workers=1) as pool:
        gen = pool.submit(dyngen.build_all, generated)
        _build.load_all(list(KERNELS) + ["loop_graph", LINEARIZE[0]])
        gen.result()
    log(f"[build] {len(KERNELS)} kernels, the loop graph's, the Jacobians' and {len(generated)} generated line "
        f"searches in {time.perf_counter() - t0:.1f} s")
    for name in list(KERNELS) + ["loop_graph", LINEARIZE[0]]:
        secs, report = _build.build_info(name)
        log(f"[build] {name}: nvcc {secs:.1f} s | " + ptxas_lines(report))
        if name == "lft_select":
            log("[build] lft_select sass: " + select_sass_line(_build.load(name)._name))
    for system in generated:
        name, secs, report = dyngen.build_info(system)
        GENERATED_BUILD_S[system.name] = secs
        log(f"[build] generated line search {system.name} ({name}): nvcc {secs:.1f} s | " + ptxas_lines(report))
    residency()


def residency() -> None:
    """Blocks an SM holds at once of the scan kernel (two problems a block)
    at each p, of the query kernel (one warp a block) at each n and of the
    fused select (one problem a block) at each size tier, float64 and
    float32 instantiations, as the built kernels report them (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
    from their registers and shared memory): the scan's B=1024 quadrotor
    problems run in one wave if 2 x blocks x SMs >= 1,024."""
    import ctypes

    import torch
    from timeopt_tpu_torch.ops import _build

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for suffix, tag in (("", "float64"), ("_f32", "float32")):
        scan = getattr(_build.load("lft_scan"), f"lft_scan_blocks_per_sm{suffix}")
        query = getattr(_build.load("lft_query"), f"lft_query_blocks_per_sm{suffix}")
        for f in (scan, query):
            f.argtypes, f.restype = [ctypes.c_int], ctypes.c_int
        s = {p: scan(p) for p in (3, 5, 13, 4)}
        log(f"[build] lft_scan {tag} blocks an SM (two problems each): " + ", ".join(f"p={p} {v}" for p, v in s.items())
            + f"; at p=13 {2 * s[13] * sms} problems at once on {sms} SMs (quadrotor B={B_FULL})")
        log(f"[build] lft_query {tag} blocks an SM (one warp each): "
            + ", ".join(f"n={n} {query(n)}" for n in (2, 4, 12, 3)))
        select = getattr(_build.load("lft_select"), f"lft_select_blocks_per_sm{suffix}")
        select.argtypes, select.restype = [ctypes.c_int], ctypes.c_int
        log(f"[build] lft_select {tag} blocks an SM (one problem each): "
            + ", ".join(f"n={n} (tier {n}) {select(n)}" for n in (4, 12, 14)))


def check_select(J_k, J_p, s, probs, bound, label: str, inf_below: bool = True,
                 ungated: str = "the gate is the oracle score of phase 4", tie: float = 1e-9):
    """J of kernel and plain for T >= T_min: +inf below T_min from the
    kernel (with inf_below: the select kernels skip those queries), the same
    non-finite pattern, and the errors and argmin T* agreement (equal, or
    tied within `tie` relative) gated by `bound` (see SELECT_BOUND); with no
    bound the log names the gate that holds instead (`ungated`). Returns
    (max abs err, the plain version's T*)."""
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
    tied = (T_k == T_p) | ((Jpk - Jpp).abs() <= tie * Jpp.abs())
    log(f"[kernels] {label}: max abs err {err:.3e}, max rel err {errs['rel']:.3e}, normwise {errs['norm']:.3e} "
        f"(t >= T_min; bound {bound or 'none here: ' + ungated}), argmin equal {int((T_k == T_p).sum())}/{Bsz}, "
        f"tied {int(tied.sum())}/{Bsz}")
    if bound is not None:
        kind, r = bound
        require(errs[kind] <= r, f"{label}: J {kind} err {errs[kind]:.3e} > {r}")
        require(bool(tied.all()), f"{label}: argmin T differs beyond a {tie} tie on {int((~tied).sum())} problems")
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


def check_linesearch(system, probs, X, U, K, kap, T, alphas, label: str, gate_all: bool, rtol: float = 1e-10,
                     atol: float = 1e-12):
    """Line-search kernel vs plain: X, U, J within rtol 1e-10 / atol 1e-12
    (or the given rtol, atol) and identical accepted flags. With gate_all,
    elementwise on every alpha and row. Otherwise on the alphas that
    improve on J_old (a diverging rollout amplifies last-bit differences
    without bound), X on the rows
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
        ok = all(within(k, p, rtol, atol) for k, p in ((Xs_k, Xs_p), (Us_k, Us_p), (Js_k, Js_p)))
        gated = "all, elementwise"
    else:
        rows = torch.arange(probs.N + 1, device=X.device)[None, None] <= T[:, None, None]
        ok = (close_per_rollout(Xs_k, Xs_p, imp[..., None] & rows, rtol, atol)
              and close_per_rollout(Us_k, Us_p, imp[..., None].expand(Us_p.shape[:3]), rtol, atol)
              and within(Js_k[imp], Js_p[imp], rtol, atol))
        gated = "the improving, X on rows <= T*, per rollout"
    require(ok, f"{label}: X/U/J outside rtol {rtol} atol {atol} (max abs over all {errs})")
    acc_k = select_first_improving(X, U, Xs_k, Us_k, Js_k, J_old).accepted
    acc_p = select_first_improving(X, U, Xs_p, Us_p, Js_p, J_old).accepted
    require(bool(torch.equal(acc_k, acc_p)), f"{label}: accepted flags differ")
    log(f"[kernels] {label}: max abs err X {errs[0]:.3e}, U {errs[1]:.3e}, J {errs[2]:.3e} (all alphas and rows; "
        f"gated on {gated}), accepted identical ({int(acc_k.sum())}/{X.shape[0]})")
    return max(errs)


def onepass_rollout_args(system, probs, X, U, A, Bj, S: int = 20):
    """The line-search kernel's inputs for the one-pass method's shifted-gain
    rollouts of its first iteration from the iterate (X, U) and its
    Jacobians, as solve_onepass makes them: T-bar from the nominal cost
    curve, the warm-start update at T-bar (the backward and line-search
    kernels), the prefix (S states) and the sweep on the updated iterate,
    then three horizons of each problem, rolled out as 3 B problems: the
    pick of the widest window, and T-bar + 2 and + 5 (- where above T_max),
    horizons of the window at which the start state X_ext[:, S] is not the
    first reference row. Returns (the line search's arguments, the start
    states, the cost each rollout must improve on to be accepted: the warm
    start's)."""
    import torch
    from timeopt_tpu_torch.solver import onepass
    from timeopt_tpu_torch.solver.backward import backward_truncated
    from timeopt_tpu_torch.solver.cost import argmin_T, nominal_cost_curve
    from timeopt_tpu_torch.solver.forward import forward_linesearch
    from timeopt_tpu_torch.solver.ilqr import SolveOptions
    from timeopt_tpu_torch.solver.linearize import linearize

    opts = SolveOptions(method="onepass", S_window=S)
    T_bar = argmin_T(nominal_cost_curve(system, probs, X, U), probs.T_min, probs.T_max)
    lm = torch.full((probs.batch,), opts.lm_init, dtype=X.dtype, device=X.device)
    bw = backward_truncated(system, probs, A, Bj, X, U, T_bar, lm)
    ls = forward_linesearch(system, probs, X, U, bw.K, bw.kappa, T_bar, alphas=opts.alphas)
    X1 = torch.where(bw.ok[:, None, None], ls.X, X)
    U1 = torch.where(bw.ok[:, None, None], ls.U, U)
    J_prev = torch.where(bw.ok & torch.isfinite(ls.J), ls.J, float("inf"))
    X_ext, U_ext, A_ext, B_ext = onepass.extend_and_linearize(system, opts, X1, U1, *linearize(system.step, X1, U1))
    sweep = onepass.value_sweep_prefix(system, probs, A_ext, B_ext, X_ext, U_ext, T_bar, S, lm)
    off = lambda d: torch.where(T_bar + d <= probs.T_max, T_bar + d, T_bar - d)  # noqa: E731
    Ts = torch.stack([onepass.onepass_pick(probs, sweep, X_ext, X_ext[:, S], T_bar, S, S, S)[0], off(2), off(5)])
    probJ, X_in, U_in, K_in, k_in, T_in, x_start = onepass.shifted_rollout_inputs(probs, X_ext, U_ext, sweep,
                                                                                   T_bar, Ts, S)
    return (system, probJ, X_in, U_in, K_in, k_in, T_in, opts.alphas[:4]), x_start, J_prev.repeat(3)


def check_onepass_rollout(ls_args, x_start, J_prev, label: str, rtol: float = 1e-10, atol: float = 1e-12) -> float:
    """The line-search kernel from start states against its plain version
    on what the one-pass method reads of each rollout: whether its
    least-cost alpha improves on J_prev, the accept test (identical), and
    on the accepted rollouts that alpha (identical, or its J tied within
    1e-10 relative) with its J (rtol 1e-10), X on the rows <= T* and U,
    each relative to the rollout's largest entry (rtol 1e-10, atol 1e-12;
    beyond T* the rollout runs open loop on nominal controls). A rollout
    that diverges amplifies last-bit differences without bound (as
    check_linesearch says), so the others are compared only in the
    printed errors. At float32 rtol and atol (and the alpha tie) are the
    given ones. Returns the max abs error over all alphas and rows."""
    import torch
    from timeopt_tpu_torch.ops import cuda_forward

    Xs_k, Us_k, Js_k = cuda_forward.linesearch(*ls_args, x_start=x_start)
    Xs_p, Us_p, Js_p = cuda_forward.linesearch_plain(*ls_args, x_start=x_start)
    torch.cuda.synchronize()
    errs = [max_err(Xs_k, Xs_p)[0], max_err(Us_k, Us_p)[0], max_err(Js_k, Js_p)[0]]
    r = torch.arange(Js_p.shape[0], device=Js_p.device)
    bk, bp = torch.argmin(Js_k, dim=1), torch.argmin(Js_p, dim=1)
    acc = Js_p[r, bp] < J_prev
    require(torch.equal(acc, Js_k[r, bk] < J_prev), f"{label}: the accept decisions differ")
    require(bool(acc.any()), f"{label}: no rollout improves on the warm start's cost, nothing to compare")
    same = (bk == bp) | ((Js_p[r, bk] - Js_p[r, bp]).abs() <= rtol * Js_p[r, bp].abs())
    require(bool(same[acc].all()), f"{label}: the least-cost alpha differs on {int((~same & acc).sum())} rollouts")
    T = ls_args[6]
    rows = torch.arange(Xs_p.shape[2], device=T.device)[None, None] <= T[:, None, None]
    sel = torch.zeros_like(Js_p, dtype=torch.bool)
    sel[r, bp] = acc
    gated = (close_per_rollout(Xs_k, Xs_p, sel[..., None] & rows, rtol, atol)
             and close_per_rollout(Us_k, Us_p, sel[..., None].expand(Us_p.shape[:3]), rtol, atol)
             and within(Js_k[sel], Js_p[sel], rtol, atol))
    require(gated, f"{label}: the accepted alpha's X/U/J outside rtol {rtol} atol {atol} (max abs over all {errs})")
    fin = torch.isfinite(Js_p).any(dim=1)
    log(f"[kernels] {label}: max abs err X {errs[0]:.3e}, U {errs[1]:.3e}, J {errs[2]:.3e} (all alphas and rows; "
        f"gated on the accepted rollouts' least-cost alpha, X on rows <= T*, per rollout), accepted identical "
        f"({int(acc.sum())}/{acc.numel()}); a finite alpha on {int(fin.sum())} (plain) and "
        f"{int(torch.isfinite(Js_k).any(dim=1).sum())} (kernel)")
    return max(errs)


def check_generated(case: str, ls_args, label: str, x_start=None, J_ref=None) -> dict:
    """The generated line search of the case's device_id=None twin against
    the hand-written kernel of the registry system on the same inputs (the
    ordinary entry, or with x_start the start-state entry): the same
    improving alphas against J_ref (default the nominal's cost, J_old) on
    every problem, hence the same first improving alpha; J within
    GENERATED_RTOL elementwise, X on the rows <= T* and U of the improving
    rollouts within GENERATED_RTOL of each rollout's largest entry (a
    diverging rollout amplifies last-bit differences without bound).
    Whether the two are bitwise equal, and their largest difference, are
    printed and returned."""
    import torch
    from timeopt_tpu_torch.ops import cuda_forward
    from timeopt_tpu_torch.solver.cost import cost_true

    system, probs, X, U, K, kap, T, alphas = ls_args
    hand = cuda_forward.linesearch(*ls_args, x_start=x_start)
    gen = cuda_forward.linesearch(twin(case), *ls_args[1:], x_start=x_start)
    torch.cuda.synchronize()
    same = all(bitwise(g, h) for g, h in zip(gen, hand))
    diff = max(max_err(g, h)[0] for g, h in zip(gen, hand))
    J_ref = cost_true(system, probs, X, U, T) if J_ref is None else J_ref
    imp_h, imp_g = hand[2] < J_ref[:, None], gen[2] < J_ref[:, None]
    require(bool(torch.equal(imp_h, imp_g)), f"{label}: the generated and the hand-written kernel improve on "
                                             f"different alphas ({int((imp_h != imp_g).any(dim=1).sum())} problems)")
    rows = torch.arange(hand[0].shape[2], device=X.device)[None, None] <= T[:, None, None]
    ok = (within(gen[2], hand[2], GENERATED_RTOL, 0.0)
          and close_per_rollout(gen[0], hand[0], imp_h[..., None] & rows, GENERATED_RTOL, 0.0)
          and close_per_rollout(gen[1], hand[1], imp_h[..., None].expand(hand[1].shape[:3]), GENERATED_RTOL, 0.0))
    require(ok, f"{label}: generated vs hand-written outside rtol {GENERATED_RTOL} (max abs difference {diff:.3e})")
    log(f"[kernels] {label}: generated vs hand-written bitwise {same}, max |diff| {diff:.3e} (all alphas and rows), "
        f"the same improving alphas on all {X.shape[0]} problems")
    return dict(bitwise=same, max_abs_diff=diff)


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


def scan_query_pair(system, probs, X, U, A, Bj, levels: int, bound, label: str, timed: bool = False,
                    witness: float | None = None) -> dict:
    """The unfused select on the assembled blocks of (X, U, A, B): the scan
    kernel's prefixes against the plain scan's (normwise per matrix,
    printed) and, with a `witness` bound, both against the long-double
    witness (witness_scan); the query kernel on the plain prefixes against
    the plain query (QUERY_BOUND); the whole kernel chain against the generic
    select kernel (CHAIN_BOUND) and against the whole plain chain (`bound`),
    each gated as check_select. With `timed`, both kernels and both plain
    versions are timed. Returns the errors of the chain and of the query
    alone."""
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
    if witness is not None:
        witness_scan(args, pre_k, pre_p, levels, witness, label)
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


def generic_block_args(system, probs, X, U, A, Bj) -> tuple:
    """The generic select's inputs on the assembled blocks of (X, U, A, B)
    (q_reg 1e-9, psd_levels 1), for any system, and the scales s."""
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors

    blk = build_augmented(system, probs, X, U, A, Bj, q_reg=1e-9, psd_levels=1)
    args = [t.contiguous() for t in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv,
                                     build_terminal_factors(probs, X, s=blk.s))]
    return args, blk.s


def backward_args(system, probs, X, U, A, Bj, T, lm_init: float) -> list:
    """backward_truncated_core's inputs at the horizons T, as the solve builds them."""
    import torch
    from timeopt_tpu_torch.solver.backward import backward_inputs

    lm = torch.full((T.shape[0],), lm_init, dtype=X.dtype, device=X.device)
    return [A.contiguous(), Bj.contiguous(), *backward_inputs(system, probs, X, U), T.contiguous(), lm]


# Shapes that no system of the registry has, which the kernels run through
# their run-time-size paths: the backward any (n, m) but (2, 1), (4, 1),
# (4, 2) and (12, 4); the generic select any p but 3 and 5. Phase 3 holds
# each against its plain version on random inputs (random_backward_args,
# random_select_args), --ab against the earlier kernel bit for bit.
OFF_REGISTRY_BACKWARD = ((3, 1), (6, 5))  # (n, m)
OFF_REGISTRY_SELECT = ((4, 1), (9, 3))  # (p, m)
OFF_REGISTRY_FUSED = ((7, 3),)  # (n, m): the fused select's registry tier below its p = 13 tile
B_OFF, N_OFF = 37, 48  # a batch that leaves the last block of either kernel partial


def _spd(rng, k: int, lead: tuple, shift: float) -> np.ndarray:
    """Random symmetric matrices G G' / k + shift I, exactly symmetric."""
    G = rng.standard_normal((*lead, k, k))
    S = G @ G.swapaxes(-1, -2) / k
    return 0.5 * (S + S.swapaxes(-1, -2)) + shift * np.eye(k)


def random_backward_args(n: int, m: int, B: int, N: int, device, seed: int = SEED) -> list:
    """backward_truncated_core's inputs from a seed: A = I + 0.05 N(0, 1),
    B = 0.3 N(0, 1), Qstage, Qf and R positive definite, every flag 1, T*
    0, N, N/2, 1, N - 1, 3 and N + 2 in turn (so that the problems of one
    block differ), lambda 1e-3."""
    import torch

    rng = np.random.default_rng(seed)
    f = [np.eye(n) + 0.05 * rng.standard_normal((B, N, n, n)), 0.3 * rng.standard_normal((B, N, n, m)),
         rng.standard_normal((B, N, n)), rng.standard_normal((B, N, m)), _spd(rng, n, (B, N), 0.1),
         rng.standard_normal((B, N, n)), np.ones((B, N)), np.ones((B, N)), _spd(rng, n, (B,), 1.0),
         _spd(rng, m, (B,), 0.5)]
    T = [(0, N, N // 2, 1, N - 1, 3, N + 2)[i % 7] for i in range(B)]
    return ([torch.as_tensor(x, device=device) for x in f]
            + [torch.tensor(T, dtype=torch.int64, device=device), torch.full((B,), 1e-3, dtype=torch.float64,
                                                                              device=device)])


def random_select_args(p: int, m: int, B: int, N: int, device, seed: int = SEED) -> list:
    """The generic select's inputs from a seed, laid out as build_augmented
    lays them out: A_aug = [A a; 0 1] with A = I + 0.05 N(0, 1) and
    a = 0.1 N(0, 1), B_aug = [0.3 N(0, 1); 0], Q_aug and R_inv positive
    definite, C = [I + 0.1 N(0, 1) | 0.3 N(0, 1)]."""
    import torch

    rng = np.random.default_rng(seed)
    n = p - 1
    A = np.zeros((B, N, p, p))
    A[..., :n, :n] = np.eye(n) + 0.05 * rng.standard_normal((B, N, n, n))
    A[..., :n, n] = 0.1 * rng.standard_normal((B, N, n))
    A[..., n, n] = 1.0
    Bm = np.zeros((B, N, p, m))
    Bm[..., :n, :] = 0.3 * rng.standard_normal((B, N, n, m))
    C = np.concatenate([np.eye(n) + 0.1 * rng.standard_normal((B, N, n, n)), 0.3 * rng.standard_normal((B, N, n, 1))],
                       axis=-1)
    f = [A, Bm, _spd(rng, p, (B, N), 0.5), _spd(rng, m, (B,), 0.5), C]
    return [torch.as_tensor(x, device=device) for x in f]


def random_fused_args(n: int, m: int, B: int, N: int, device, seed: int = SEED, negated: bool = False) -> list:
    """The fused select's inputs from a seed, laid out as build_fused_inputs
    lays them out (A, Bm, vecs, scal, Qq, R_inv, Lt): A = I + 0.05 N(0, 1),
    Bm = 0.3 N(0, 1), e, e_next and a~ 0.1 N(0, 1), Qq and R_inv positive
    definite, Qe = Qq e and the corner e'Qq e + 2w (w = 0.05) as a
    stationary cost gives them, scales exp(0.05 N(0, 1)), Lt = chol(Qf)'.
    `negated`: rows 0 and n - 2 of A and column 0 of Bm exactly zero, the
    stage cost negated (-Qq, -R_inv, -Qq e, -(e'Qq e + 2w)) and Qf scaled
    by 100 (W0 = Qf^-1 small beside the negated blocks): each element and
    prefix is then its positive twin's negative, as well conditioned, and
    the sweeps meet exact zeros inside their matrices and negative pivots."""
    import torch

    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.05 * rng.standard_normal((B, N, n, n))
    Bm = 0.3 * rng.standard_normal((B, N, n, m))
    e, en, at = (0.1 * rng.standard_normal((B, N, n)) for _ in range(3))
    Qq, R_inv, Qf = _spd(rng, n, (B,), 0.5), _spd(rng, m, (B,), 0.5), _spd(rng, n, (B,), 1.0)
    Qe = np.einsum("bij,bkj->bki", Qq, e)
    corner = np.einsum("bki,bki->bk", e, Qe) + 2 * 0.05
    if negated:
        A[..., [0, n - 2], :] = 0.0
        Bm[..., 0] = 0.0
        Qq, R_inv, Qe, corner, Qf = -Qq, -R_inv, -Qe, -corner, 100.0 * Qf
    s = np.exp(0.05 * rng.standard_normal((B, N + 1)))
    scal = np.stack([corner, 1.0 / s[:, :N], s[:, 1:], 1.0 / s[:, 1:]], axis=-1)
    Lt = np.linalg.cholesky(Qf).swapaxes(-1, -2)
    f = [A, Bm, np.stack([e, en, at, Qe], axis=2), scal, Qq, R_inv, Lt]
    return [torch.as_tensor(np.ascontiguousarray(x), device=device) for x in f]


def random_rung2_args(p: int, B: int, N: int, device, seed: int = SEED) -> tuple:
    """Prefix-scan inputs (A_aug, BRB, Q_aug) and the query's C from a seed
    (random_select_args, m = 2, BRB = B_aug R^-1 B_aug'), on which the jitter
    ladder takes its second rung, by problem b % 3:
    0: none (the random blocks as drawn);
    1: the element at a quarter of the steps (seeded, step 0 always):
       Q_aug[0, 0] = -jitter, so the first pivot of sym(Q_aug) + jitter I is
       exactly zero and the rung-1 inverse is not finite;
    2: the compose at every k > 0 and the query at every t: A_aug = 0,
       BRB = 0 and Q_aug = -1e9 I make every element (-1e-9 I, 0, 0) and
       keep the carry at it, so sym(E_k + Gbar) + jitter I and X0 + jitter I
       are exactly zero (tests/test_torch_card.py::ladder_inputs at any p
       and N)."""
    import torch

    A, Bm, Q, Ri, C = random_select_args(p, 2, B, N, device, seed)
    BRB = torch.einsum("bkim,bmn,bkjn->bkij", Bm, Ri, Bm)
    rng = np.random.default_rng(seed + 1)
    kind = np.arange(B) % 3
    hit = rng.random((B, N)) < 0.25
    hit[:, 0] = True
    el = torch.as_tensor(hit & (kind == 1)[:, None], device=device)
    Q[..., 0, 0] = torch.where(el, -1e-9, Q[..., 0, 0])
    two = torch.as_tensor(kind == 2, device=device)
    A[two] = 0.0
    BRB[two] = 0.0
    Q[two] = -1e9 * torch.eye(p, dtype=Q.dtype, device=device)
    return (A.contiguous(), BRB.contiguous(), Q.contiguous()), C.contiguous()


def _gj_longdouble(M, k: int):
    """Pivot-free Gauss-Jordan on the first k columns of the batched
    (..., k, k + r) M, as ops/linalg.py::_gj_eliminate."""
    for i in range(k):
        row = M[..., i, :] / M[..., i, i][..., None]
        M = M - M[..., :, i][..., :, None] * row[..., None, :]
        M[..., i, :] = row
    return M


def select_generic_longdouble(args, rows, jitter: float = 1e-9, dtype=np.longdouble):
    """J (len(rows), N) of the generic select kernel's math in numpy long
    double, in its solve-based order (element from [sym(Q) + jitter I | A' |
    I], compose from [sym(E_k + Gbar) + jitter I | Fbar' | F_k], query
    Y = S^-1 (C Fbar') and J = 0.5 ((sym(X0) + jitter I)^-1)[p-1, p-1]),
    every horizon evaluated; float64 on the CPU. The witness where the plain
    version (explicit inverses) loses digits. dtype=np.float64 runs the
    same order in double, as the kernel does (tests/test_torch_witness.py
    reads it against the witness)."""
    import torch

    ld = dtype
    A, Bm, Q, Ri, C = [a[rows].cpu().numpy().astype(ld) for a in args]
    Bz, N, p, _ = A.shape
    n = p - 1
    tr = lambda x: x.swapaxes(-1, -2)  # noqa: E731
    sym = lambda x: 0.5 * (x + tr(x))  # noqa: E731
    I_p, I_n = np.eye(p, dtype=ld), np.eye(n, dtype=ld)
    M = _gj_longdouble(np.concatenate([sym(Q) + jitter * I_p, tr(A), np.broadcast_to(I_p, Q.shape)], -1), p)
    F, E = M[..., p:2 * p], M[..., 2 * p:]
    G = sym(A @ F + (Bm @ Ri[:, None]) @ tr(Bm))
    e_last = np.broadcast_to(I_p[:, -1:], (Bz, p, 1))
    J = np.empty((Bz, N), ld)
    Eb, Fb, Gb = E[:, 0], F[:, 0], G[:, 0]
    for k in range(N):
        if k:
            M = _gj_longdouble(np.concatenate([sym(E[:, k] + Gb) + jitter * I_p, tr(Fb), F[:, k]], -1), p)
            WFb, WFk = M[..., p:2 * p], M[..., 2 * p:]
            Eb, Fb, Gb = sym(Eb - Fb @ WFb), Fb @ WFk, sym(G[:, k] - tr(F[:, k]) @ WFk)
        Ck = C[:, k]
        FC = Fb @ tr(Ck)
        Y = _gj_longdouble(np.concatenate([sym(I_n + (Ck @ Gb) @ tr(Ck)), tr(FC)], -1), n)[..., n:]
        X0 = sym(Eb - FC @ Y) + jitter * I_p
        J[:, k] = 0.5 * _gj_longdouble(np.concatenate([X0, e_last], -1), p)[:, p - 1, p]
    return torch.as_tensor(J.astype(np.float64))


def scan_longdouble(args, rows, levels: int = 2, jitter: float = 1e-9, dtype=np.longdouble) -> tuple:
    """Every prefix (E, F, G) (len(rows), N, p, p) of the scan kernel's math
    in numpy long double, in its solve-based order (element from
    [sym(Q) + eps I | A' | I], compose from [sym(E_k + Gbar) + eps I | Fbar'
    | F_k], eps a rung of the jitter ladder of ops/linalg.py::psd_inv: with
    levels = 2, rung 2 where rung 1's inverse has a non-finite entry);
    float64 on the CPU. args: A_aug, BRB, Q_aug. The witness where the plain
    scan (explicit inverses) loses digits; dtype=np.float64 runs the same
    order in double, as the kernel does."""
    import torch

    A, BRB, Q = [a[rows].cpu().numpy().astype(dtype) for a in args]
    Bz, N, p, _ = A.shape
    tr = lambda x: x.swapaxes(-1, -2)  # noqa: E731
    sym = lambda x: 0.5 * (x + tr(x))  # noqa: E731
    I_p = np.eye(p, dtype=dtype)

    def ladder(left, right):
        """The right part of the swept [left + eps I | right | I]: rung 2 on
        the matrices whose rung-1 inverse (the last p columns) is not
        finite."""
        Ib = np.broadcast_to(I_p, left.shape)
        M = _gj_longdouble(np.concatenate([left + jitter * I_p, right, Ib], -1), p)
        if levels > 1:
            bad = ~np.isfinite(M[..., -p:]).all(axis=(-1, -2))
            if bad.any():
                M2 = _gj_longdouble(np.concatenate([left + 1e4 * jitter * I_p, right, Ib], -1), p)
                M = np.where(bad[..., None, None], M2, M)
        return M[..., p:]

    out = [np.empty((Bz, N, p, p), dtype) for _ in range(3)]
    with np.errstate(all="ignore"):
        FE = ladder(sym(Q), tr(A))
        F, E = FE[..., :p], FE[..., p:]
        G = sym(A @ F + BRB)
        Eb, Fb, Gb = E[:, 0], F[:, 0], G[:, 0]
        for k in range(N):
            if k:
                WW = ladder(sym(E[:, k] + Gb), np.concatenate([tr(Fb), F[:, k]], -1))
                WFb, WFk = WW[..., :p], WW[..., p:2 * p]
                Eb, Fb, Gb = sym(Eb - Fb @ WFb), Fb @ WFk, sym(G[:, k] - tr(F[:, k]) @ WFk)
            for o, x in zip(out, (Eb, Fb, Gb)):
                o[:, k] = x
    return tuple(torch.as_tensor(o.astype(np.float64)) for o in out)


def witness_scan(args, pre_k, pre_p, levels: int, bound: float, label: str) -> dict:
    """The scan kernel's prefixes and the plain scan's against the
    long-double witness (scan_longdouble) on every problem: each side's
    largest error of each E, F, G over that matrix's largest witness entry
    (normwise) printed; the kernel's must be within `bound`
    (SCAN_WITNESS_NORM). Returns the readings."""
    wit = scan_longdouble(args, np.arange(args[0].shape[0]), levels=levels)
    read = {side: [normwise(x.cpu(), w, f"{label} {side} vs the long-double witness") for x, w in zip(pre, wit)]
            for side, pre in (("kernel", pre_k), ("plain", pre_p))}
    log(f"[kernels] {label}: scan against a long-double witness (eps {float(np.finfo(np.longdouble).eps):.2e}), "
        f"normwise E, F, G: kernel {read['kernel'][0]:.3e}, {read['kernel'][1]:.3e}, {read['kernel'][2]:.3e}; "
        f"plain {read['plain'][0]:.3e}, {read['plain'][1]:.3e}, {read['plain'][2]:.3e} (bound on the kernel {bound})")
    require(max(read["kernel"]) <= bound, f"{label}: scan kernel {max(read['kernel']):.3e} normwise off the "
                                          f"long-double witness > {bound}")
    return read


def backward_longdouble(bw_args, rows) -> tuple:
    """kappa, K of the plain backward's math (solver/backward.py::
    _backward_arrays: the same Q-expansion, pivot-free Gauss-Jordan on
    [sym(Quu) + lambda I | Qu | Qux], value update in the K'Quu K form) in
    numpy long double, for the problems `rows`; float64 on the CPU. The
    witness for which of the kernel and its plain version is nearer the
    exact gains where the two differ."""
    import torch

    ld = np.longdouble
    A, Bm, lx, lu, Qs, QfeT, _, _, Qf, R, T, lm = [a[rows].cpu().numpy() for a in bw_args]
    A, Bm, lx, lu, Qs, QfeT, Qf, R, lm = (x.astype(ld) for x in (A, Bm, lx, lu, Qs, QfeT, Qf, R, lm))
    Bz, N, n, _ = A.shape
    m = Bm.shape[-1]
    tr = lambda x: x.swapaxes(-1, -2)  # noqa: E731
    Vx, Vxx = np.zeros((Bz, n), ld), np.zeros((Bz, n, n), ld)
    kappa, K = np.zeros((Bz, N, m), ld), np.zeros((Bz, N, m, n), ld)
    for k in range(N - 1, -1, -1):
        term = (k + 1) == T
        Vx = np.where(term[:, None], QfeT[:, k], Vx)
        Vxx = np.where(term[:, None, None], Qf, Vxx)
        Ak, Bk = A[:, k], Bm[:, k]
        Qx = lx[:, k] + (tr(Ak) @ Vx[..., None])[..., 0]
        Qu = lu[:, k] + (tr(Bk) @ Vx[..., None])[..., 0]
        Qxx = Qs[:, k] + tr(Ak) @ Vxx @ Ak
        Quu = R + tr(Bk) @ Vxx @ Bk
        Qux = tr(Bk) @ Vxx @ Ak
        M = _gj_longdouble(np.concatenate([0.5 * (Quu + tr(Quu)) + lm[:, None, None] * np.eye(m, dtype=ld),
                                           Qu[..., None], Qux], -1), m)
        kap, Kk = -M[:, :, m], -M[:, :, m + 1:]
        Vx_new = Qx + (tr(Kk) @ Qu[..., None])[..., 0] + (tr(Qux) @ kap[..., None])[..., 0] + (
            tr(Kk) @ (Quu @ kap[..., None]))[..., 0]
        Vxx_new = Qxx + tr(Kk) @ Qux + tr(Qux) @ Kk + tr(Kk) @ Quu @ Kk
        Vxx_new = 0.5 * (Vxx_new + tr(Vxx_new))
        active = k < T
        Vx = np.where(active[:, None], Vx_new, Vx)
        Vxx = np.where(active[:, None, None], Vxx_new, Vxx)
        kappa[:, k] = np.where(active[:, None], kap, 0.0)
        K[:, k] = np.where(active[:, None, None], Kk, 0.0)
    return torch.as_tensor(kappa.astype(np.float64)), torch.as_tensor(K.astype(np.float64))


def check_backward(bw_args, label: str, timed: bool = False, norm: float | None = None,
                   witness: bool = True) -> tuple:
    """Backward kernel vs plain: ok identical, and kappa, K within rtol 1e-9
    / atol 1e-12 elementwise or, with `norm`, each problem's largest error
    within `norm` of its largest |kappa| (|K|) (BACKWARD_NORM_B1024, or
    F32_REL at float32, there without the long-double witness); both
    readings are printed. Returns (kappa, K, ok) of the kernel and of the
    plain version, and the kernel's numbers: max abs error and, with
    `timed`, ms one call, back to back and plain."""
    import torch
    from timeopt_tpu_torch.ops import cuda_backward

    kap_k, K_k, ok_k = cuda_backward.backward_truncated_core(*bw_args)
    kap_p, K_p, ok_p = cuda_backward.backward_plain(*bw_args)
    torch.cuda.synchronize()
    e1, _ = max_err(kap_k, kap_p)
    e2, _ = max_err(K_k, K_p)
    nw = max(((k - p).abs().flatten(1).amax(1) / p.abs().flatten(1).amax(1)).nan_to_num(0.0).max().item()
             for k, p in ((kap_k, kap_p), (K_k, K_p)))
    elementwise = within(kap_k, kap_p, 1e-9, 1e-12) and within(K_k, K_p, 1e-9, 1e-12)
    if norm is None:
        require(elementwise, f"{label}: kappa/K outside rtol 1e-9 atol 1e-12 (max abs {e1:.3e}, {e2:.3e})")
    else:
        require(max_err(kap_k, kap_p)[1] and max_err(K_k, K_p)[1] and nw <= norm,
                f"{label}: kappa/K normwise {nw:.3e} > {norm} or non-finite patterns differ")
    require(bool(torch.equal(ok_k, ok_p)), f"{label}: ok flags differ")
    if norm is not None and witness:
        witness_backward(bw_args, (kap_k, K_k), (kap_p, K_p), norm, label)
    out = dict(max_abs_err=max(e1, e2))
    timing = ""
    if timed:
        run = lambda: cuda_backward.backward_truncated_core(*bw_args)  # noqa: E731
        out.update(ms=cuda_ms(run, reps=5), ms_back_to_back=device_ms(run),
                   plain_ms=cuda_ms(lambda: cuda_backward.backward_plain(*bw_args), reps=3))
        timing = (f" | kernel {out['ms']:.3f} ms one call, {out['ms_back_to_back']:.3f} ms back to back, "
                  f"plain {out['plain_ms']:.3f} ms")
    T = bw_args[-2]
    gate = "rtol 1e-9, atol 1e-12" if norm is None else f"normwise {norm}; rtol 1e-9 atol 1e-12 holds: {elementwise}"
    log(f"[kernels] {label}: max abs err kappa {e1:.3e}, K {e2:.3e}, normwise {nw:.3e} ({gate}), ok identical "
        f"({int(ok_k.sum())}/{len(ok_k)} ok), T* {int(T.min())}..{int(T.max())}{timing}")
    return (kap_k, K_k, ok_k), (kap_p, K_p, ok_p), out


def witness_backward(bw_args, kernel, plain, norm: float, label: str, n_rows: int = 4) -> None:
    """Where the backward kernel and its plain version differ beyond rtol
    1e-9 / atol 1e-12, the long-double witness (backward_longdouble) on the
    n_rows problems of largest excess: each side's largest abs error and
    normwise error against it are printed, and the kernel must stay within
    `norm` of it normwise."""
    import torch

    def excess(k, p):
        return ((k - p).abs() - (1e-12 + 1e-9 * p.abs())).nan_to_num(0.0).flatten(1).amax(1)

    exc = torch.maximum(excess(kernel[0], plain[0]), excess(kernel[1], plain[1]))
    rows = exc.topk(min(n_rows, exc.numel())).indices.cpu()
    wit = backward_longdouble(bw_args, rows)
    read = {}
    for side, outs in (("kernel", kernel), ("plain", plain)):
        errs = [(o[rows].cpu() - w).abs() for o, w in zip(outs, wit)]
        nw = max((e.flatten(1).amax(1) / w.abs().flatten(1).amax(1)).nan_to_num(0.0).max().item()
                 for e, w in zip(errs, wit))
        read[side] = (max(e.max().item() for e in errs), nw,
                      all(within(o[rows].cpu(), w, 1e-9, 1e-12) for o, w in zip(outs, wit)))
    log(f"[kernels] {label}: long-double witness (eps {float(np.finfo(np.longdouble).eps):.2e}) on problems "
        f"{rows.tolist()} (excess over rtol 1e-9 / atol 1e-12: {exc.max().item():.3e}): kernel max abs err "
        f"{read['kernel'][0]:.3e}, normwise {read['kernel'][1]:.3e}, rtol 1e-9 / atol 1e-12 {read['kernel'][2]}; "
        f"plain max abs err {read['plain'][0]:.3e}, normwise {read['plain'][1]:.3e}, rtol 1e-9 / atol 1e-12 "
        f"{read['plain'][2]}")
    require(read["kernel"][1] <= norm, f"{label}: kappa/K normwise {read['kernel'][1]:.3e} off the long-double "
                                       f"witness > {norm}")


def witness_select(args, J_k, J_p, s, probs, label: str, rel: float = WITNESS_SELECT_REL,
                   tie: float = 1e-9) -> dict:
    """The generic select kernel and its plain version against the
    long-double witness (select_generic_longdouble) on every problem, for
    T >= T_min: each side's largest relative and normwise error and its
    argmin T* against the witness's (equal, or tied within `tie` of the
    witness's J) printed; the kernel's J must be within `rel` (by default
    WITNESS_SELECT_REL) of the witness's and its argmin tied on every
    problem. Returns the witness's J (float64, on J_k's device)."""
    import torch
    from timeopt_tpu_torch.solver.cost import argmin_T

    Bsz, t = J_k.shape[0], probs.T_min - 1
    J_w = select_generic_longdouble(args, torch.arange(Bsz)).to(J_k.device)
    s0 = s[:, :1] ** 2
    T_w = argmin_T(s0 * J_w, probs.T_min, probs.T_max)
    rows = torch.arange(Bsz, device=J_k.device)
    read = {}
    for side, J in (("kernel", J_k), ("plain", J_p)):
        d = (J[:, t:] - J_w[:, t:]).abs()
        T = argmin_T(s0 * J, probs.T_min, probs.T_max)
        Jt, Jw = J_w[rows, T - 1], J_w[rows, T_w - 1]
        read[side] = ((d / J_w[:, t:].abs()).max().item(), (d.amax(1) / J_w[:, t:].abs().amax(1)).max().item(),
                      int((T == T_w).sum()), int(((T == T_w) | ((Jt - Jw).abs() <= tie * Jw.abs())).sum()))
    log(f"[kernels] {label}: long-double witness (eps {float(np.finfo(np.longdouble).eps):.2e}): kernel max rel err "
        f"{read['kernel'][0]:.3e}, normwise {read['kernel'][1]:.3e}, argmin equal {read['kernel'][2]}/{Bsz}, tied "
        f"{read['kernel'][3]}/{Bsz}; plain max rel err {read['plain'][0]:.3e}, normwise {read['plain'][1]:.3e}, "
        f"argmin equal {read['plain'][2]}/{Bsz}, tied {read['plain'][3]}/{Bsz}")
    require(read["kernel"][0] <= rel, f"{label}: kernel J {read['kernel'][0]:.3e} relative off the "
                                      f"long-double witness > {rel}")
    require(read["kernel"][3] == Bsz, f"{label}: kernel argmin T* not tied to the long-double witness's on "
                                      f"{Bsz - read['kernel'][3]} problems")
    return J_w


# The custom system of phase 4 (b): a unicycle, x = (p_x, p_y, theta, v),
# u = (a, omega), theta wrapped, its guard on |v| and non-finite input, and
# device_id None, so that its line search on the card is a kernel generated
# from these functions. tests/test_torch_dyngen.py defines the same system
# in both packages, solves it in each on the CPU and checks that this one
# is it (struct text and problems).
UNICYCLE_DT, UNICYCLE_V_MAX = 0.1, 4.0
UNICYCLE_PROBLEM = dict(x0=[0.0, 0.0, 0.0, 0.0], xg=[1.5, 1.0, np.pi / 2, 0.0], u_ref=[0.0, 0.0],
                        Q=np.diag([0.5, 0.5, 0.2, 0.1]), R=np.diag([0.1, 0.1]), alpha=[60.0, 60.0, 20.0, 10.0],
                        w=0.05, N=40, T_min=10, T_max=40, wrap_idx=(2,))
UNICYCLE_SIGMA = (0.2, 0.2, 0.3, 0.0)


def _unicycle_xdot(x, u):
    import torch

    return torch.stack([x[..., 3] * torch.cos(x[..., 2]), x[..., 3] * torch.sin(x[..., 2]), u[..., 1], u[..., 0]],
                       dim=-1)


def _unicycle_guard(x, u):
    import torch

    return (~torch.isfinite(x).all(dim=-1)) | (~torch.isfinite(u).all(dim=-1)) | (torch.abs(x[..., 3]) > UNICYCLE_V_MAX)


def unicycle():
    from timeopt_tpu_torch.models.base import System, euler_step_fn

    return System(name="Unicycle", n=4, m=2, dt=UNICYCLE_DT,
                  step=euler_step_fn(_unicycle_xdot, UNICYCLE_DT, 4, (2,), _unicycle_guard), xdot=_unicycle_xdot,
                  guard=_unicycle_guard, wrap_idx=(2,))


def unicycle_problems(B: int, seed: int, device):
    """UNICYCLE_PROBLEM for B problems, x0 perturbed by UNICYCLE_SIGMA
    N(0, 1) (default_rng(seed), float64)."""
    import torch
    from timeopt_tpu_torch.models import make_problem
    from timeopt_tpu_torch.solver.ilqr import broadcast_problem

    base = make_problem(**UNICYCLE_PROBLEM, device=device)
    rng = np.random.default_rng(seed)
    x0 = base.x0.cpu().numpy() + np.asarray(UNICYCLE_SIGMA) * rng.standard_normal((B, 4))
    return broadcast_problem(base, B).replace(x0=torch.as_tensor(x0, device=device))


_TWINS: dict = {}


def twin(case: str):
    """The registry system of `case` with device_id None: the same functions,
    so its line search on the card is the kernel generated from them
    (ops/dyngen.py) in place of the hand-written struct."""
    import dataclasses

    from timeopt_tpu_torch.models import get_system

    if case not in _TWINS:
        system = get_system(case)[0]
        _TWINS[case] = dataclasses.replace(system, name=f"{system.name}_generated", device_id=None)
    return _TWINS[case]


def load_oracle(case: str) -> dict:
    suffix = "" if case == "Quadrotor" else f"_{case}"
    return dict(np.load(os.path.join(ROOT, "results", f"oracle_f64{suffix}.npz")))


def generated_b1024(ls_args, plain_ms: float) -> dict:
    """Phase 3 at the quadrotor's B=1024: the generated line search of its
    device_id=None twin against the plain version (check_linesearch's
    tolerances, elementwise on every alpha and row) and the hand-written
    kernel (check_generated), then both timed in turns hand-written,
    generated, generated, hand-written (back to back and one call)."""
    from timeopt_tpu_torch.ops import cuda_forward, work

    system, probs, X, U, K, kap, T, alphas = ls_args
    tw = twin("Quadrotor")
    err = check_linesearch(tw, *ls_args[1:], f"generated line search (Quadrotor B={B_FULL})", gate_all=True)
    nums = check_generated("Quadrotor", ls_args, f"generated line search (Quadrotor B={B_FULL})")
    fns = {"hand": lambda: cuda_forward.linesearch(*ls_args), "gen": lambda: cuda_forward.linesearch(tw, *ls_args[1:])}
    t = {k: [] for k in ("hand", "gen", "hand_one_call", "gen_one_call")}
    for tag in ("hand", "gen", "gen", "hand"):
        t[tag].append(device_ms(fns[tag]))
        t[tag + "_one_call"].append(cuda_ms(fns[tag], reps=5))
    log(f"[kernels] generated line search (Quadrotor B={B_FULL}), in turns hand-written / generated / generated / "
        f"hand-written: back to back {t['hand'][0]:.3f} / {t['gen'][0]:.3f} / {t['gen'][1]:.3f} / {t['hand'][1]:.3f} "
        f"ms, one call {t['hand_one_call'][0]:.3f} / {t['gen_one_call'][0]:.3f} / {t['gen_one_call'][1]:.3f} / "
        f"{t['hand_one_call'][1]:.3f} ms, plain {plain_ms:.3f} ms | generated builds (nvcc s) {GENERATED_BUILD_S} | "
        f"{smi()}")
    nums.update(max_abs_err=err, ms=min(t["gen_one_call"]), ms_back_to_back=min(t["gen"]), plain_ms=plain_ms,
                hand_written_ms_back_to_back=t["hand"], generated_ms_back_to_back=t["gen"], systems={},
                build_s=dict(GENERATED_BUILD_S),
                **work.linesearch(system.name, T.tolist(), probs.N, system.n, system.m, len(alphas)))
    return nums


def phase_kernels(device) -> dict:
    """The main path's kernels at B=1024 (quadrotor N=160, PointMass
    N = T_max = 220), then each system's select, backward and line search
    at B=128."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import cuda_forward, cuda_lft_generic, work
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
        else:
            pm = (system, probs, X, U, A, Bj, T_p)

    # ---- B=1024, at the plain select's T*: the backward on the quadrotor
    # (its row in the kernels line) and on PointMass (beside it), each
    # against its plain version (kappa, K rtol 1e-9 / atol 1e-12, ok
    # identical); then the line search on the quadrotor
    for case, tup in (("Quadrotor", quad), ("PointMass_Navigation", pm)):
        system, probs, X, U, A, Bj, T_p = tup
        bw_args = backward_args(system, probs, X, U, A, Bj, T_p, opts.lm_init)
        _, plain_out, nums = check_backward(bw_args, f"backward ({case} B={B_FULL})", timed=True,
                                            norm=BACKWARD_NORM_B1024.get(case))
        nums.update(work.backward(T_p.tolist(), probs.N, system.n, system.m))
        if case == "Quadrotor":
            out["backward"] = nums
            kap_p, K_p, _ = plain_out
        else:
            out["backward"]["pointmass"] = nums
    system, probs, X, U, A, Bj, T_p = quad

    ls_args = (system, probs, X, U, K_p, kap_p, T_p, opts.alphas)
    err = check_linesearch(*ls_args, f"line search (Quadrotor B={B_FULL})", gate_all=True)
    b2b = device_ms(lambda: cuda_forward.linesearch(*ls_args))
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=3)
    out["linesearch"] = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                             **work.linesearch(system.name, T_p.tolist(), probs.N, system.n, system.m,
                                               len(opts.alphas)))
    log(f"[kernels] line search: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")
    out[GENERATED[0]] = generated_b1024(ls_args, pms)

    # ---- the one-pass method's first shifted-gain rollouts from the
    # quadrotor's first iterate: start states X_ext[:, S], not row 0 of the
    # kernel's X
    ls_args, x_start, J_prev = onepass_rollout_args(system, probs, X, U, A, Bj)
    nJ = ls_args[2].shape[0]
    shifted = int((x_start != ls_args[2][:, 0]).any(dim=-1).sum())
    require(shifted >= nJ // 2, f"one-pass rollouts: only {shifted}/{nJ} start states differ from row 0 of X")
    err = check_onepass_rollout(ls_args, x_start, J_prev, f"line search from start states (one-pass rollouts, "
                                                          f"Quadrotor {nJ} = 3 x {B_FULL})")
    b2b = device_ms(lambda: cuda_forward.linesearch(*ls_args, x_start=x_start))
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args, x_start=x_start), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args, x_start=x_start), reps=1)
    out["linesearch"]["onepass_rollout"] = dict(rollouts=nJ, alphas=len(ls_args[-1]), max_abs_err=err, ms=ms,
                                                ms_back_to_back=b2b, plain_ms=pms,
                                                **work.linesearch(system.name, ls_args[6].tolist(), ls_args[2].shape[1] - 1,
                                                                  system.n, system.m, len(ls_args[-1]), x_start=True))
    log(f"[kernels] line search from start states ({nJ} rollouts x {len(ls_args[-1])} alphas, {shifted} start states "
        f"off row 0 of X): kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")
    out[GENERATED[0]]["onepass_rollout"] = check_generated(
        "Quadrotor", ls_args, f"line search from start states (one-pass rollouts, Quadrotor {nJ})", x_start, J_prev)

    # ---- B=128, each system's oracle set: its select kernel, the backward
    # at that select's T* and the line search; the generic select on the
    # assembled blocks of the quadrotor (p = 13), the double integrator
    # (p = 3) and the cart-pole (p = 5)
    for case in CASES:
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_ORACLE, device)
        X, U, A, Bj = first_iterate(system, probs)
        if case in GENERIC_BLOCKS_BOUND:
            args, s = generic_block_args(system, probs, X, U, A, Bj)
            J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=probs.T_min)
            J_p = cuda_lft_generic.select_generic_plain(*args)
            torch.cuda.synchronize()
            check_select(J_k, J_p, s, probs, GENERIC_BLOCKS_BOUND[case],
                         f"lft_select_generic ({case} blocks B={B_ORACLE})",
                         ungated="the plain version loses digits on these blocks (SELECT_BOUND); the generic kernel "
                                 "is gated against the long-double witness next and the scan+query chain "
                                 "(CHAIN_BOUND) below")
            if GENERIC_BLOCKS_BOUND[case] is None:
                witness_select(args, J_k, J_p, s, probs, f"lft_select_generic ({case} blocks B={B_ORACLE})")
        kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
        J_k, J_p = kernel(), plain()
        torch.cuda.synchronize()
        _, T = check_select(J_k, J_p, s, probs, SELECT_BOUND[case], f"select ({case} B={B_ORACLE})")
        (kap, K, _), _, _ = check_backward(backward_args(system, probs, X, U, A, Bj, T, opts.lm_init),
                                        f"backward ({case} B={B_ORACLE})")
        ls_args = (system, probs, X, U, K, kap, T, opts.alphas)
        check_linesearch(*ls_args, f"line search ({case} B={B_ORACLE})", gate_all=False)
        ms = device_ms(lambda: cuda_forward.linesearch(*ls_args))
        pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=1)
        log(f"[kernels] line search ({case} B={B_ORACLE} N={probs.N}): kernel {ms:.3f} ms back to back, "
            f"plain {pms:.3f} ms")
        check_linesearch(twin(case), *ls_args[1:], f"generated line search ({case} B={B_ORACLE})", gate_all=False)
        out[GENERATED[0]]["systems"][case] = check_generated(case, ls_args, f"generated line search ({case} "
                                                                             f"B={B_ORACLE})")

    # ---- shapes no system has (the kernels' run-time-size paths), random
    # inputs: the backward as at B=128, the generic select at T_min 1 (rel
    # 1e-9: on these well-conditioned blocks 1e-13 relative perturbations
    # of the inputs move J by at most 22 times that)
    for n, m in OFF_REGISTRY_BACKWARD:
        check_backward(random_backward_args(n, m, B_OFF, N_OFF, device),
                       f"backward (random n={n} m={m} B={B_OFF} N={N_OFF})")
    for p, m in OFF_REGISTRY_SELECT:
        args = random_select_args(p, m, B_OFF, N_OFF, device)
        J_k = cuda_lft_generic.propagator_select_generic(*args, t_min=1)
        J_p = cuda_lft_generic.select_generic_plain(*args)
        err, same = max_err(J_k, J_p)
        rel = ((J_k - J_p).abs() / J_p.abs()).max().item()
        log(f"[kernels] lft_select_generic (random p={p} m={m} B={B_OFF} N={N_OFF}, T_min 1): max abs err {err:.3e}, "
            f"max rel err {rel:.3e} (bound rel 1e-9)")
        require(same and rel <= 1e-9, f"lft_select_generic (random p={p} m={m}): J rel err {rel:.3e} > 1e-9")

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
        scan_query_pair(system, probs, X, U, A, Bj, 2, SCAN_QUERY_BOUND[case], f"scan+query ({case} oracle X, U)",
                        witness=SCAN_WITNESS_NORM.get(case))
    return out


def check_linearize(system, probs, label: str) -> dict:
    """The Jacobian kernel against linearize_ad run in float64 on the same
    card inputs (the rollout of the problems' u_ref), gated as
    LINEARIZE_RTOL says; timed one call and back to back beside the plain
    version at the same dtype, with its byte bound (ops/work.py::linearize).
    Returns the numbers."""
    import torch
    from timeopt_tpu_torch.ops import work
    from timeopt_tpu_torch.solver.cost import rollout
    from timeopt_tpu_torch.solver.ilqr import default_U_init
    from timeopt_tpu_torch.solver.linearize import linearize, linearize_ad

    U = default_U_init(probs)
    X = rollout(system, probs, probs.x0, U)
    kernel = lambda: linearize(system.step, X, U)  # noqa: E731
    plain = lambda: linearize_ad(system.step, X, U)  # noqa: E731
    got = kernel()
    want = linearize_ad(system.step, X.double(), U.double())
    err, share = 0.0, 0.0
    for g, w in zip(got, want):
        require(torch.equal(torch.isfinite(g), torch.isfinite(w)),
                f"{label}: the non-finite entries differ from float64 AD's")
        f = torch.isfinite(w)
        g, w = g.double()[f], w[f]
        room = LINEARIZE_RTOL * w.abs() + 1e-15
        if X.dtype == torch.float32:
            w32 = w.float().abs()
            room = room + 0.5 * (torch.nextafter(w32, torch.full_like(w32, float("inf"))) - w32).double()
        err = max(err, (g - w).abs().max().item())
        share = max(share, ((g - w).abs() / room).max().item())
    require(share <= 1.0, f"{label}: {share:.3f} of its room off float64 AD (max abs err {err:.3e})")
    b2b, ms, pms = device_ms(kernel), cuda_ms(kernel, reps=5), cuda_ms(plain, reps=3)
    k = dict(max_abs_err=err, share_of_room=share, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
             **work.linearize(system.name, X.shape[0], probs.N, system.n, system.m, X.element_size()))
    log(f"[kernels] {label}: max abs err {err:.3e} against float64 AD ({share:.3f} of its room) | back to "
        f"back {b2b:.4f} ms, one call {ms:.4f} ms, plain vmap(jacfwd) {pms:.3f} ms | bound "
        f"{k['bound_ms']:.4f} ms by {k['bound_by']} ({k['bytes'] / 1e6:.1f} MB), share of bound "
        f"{k['bound_ms'] / b2b:.4f} | {smi()}")
    return k


def phase_linearize(device) -> dict:
    """Phase 3 (b): the Jacobian kernel against linearize_ad (vmap(jacfwd),
    its plain version) at the benchmark cells' shapes (LINEARIZE_SHAPES,
    B=1024, the first iterate), in float32 as the cells run and in float64
    (check_linearize). Returns the kernels line's numbers: the quadrotor's
    float32 ones, every shape's under `shapes`."""
    import torch
    from timeopt_tpu_torch.models import get_system

    shapes = {}
    for case, N in LINEARIZE_SHAPES:
        system, mk = get_system(case)
        for dtype in (torch.float32, torch.float64):
            probs = oracle_problems(system, mk, B_FULL, device, dtype)
            require(probs.N == N, f"linearize {case}: N {probs.N}, expected {N}")
            tag = str(dtype).split('.')[-1]
            shapes[f"{case} {tag}"] = check_linearize(system, probs, f"linearize ({case} B={B_FULL} N={N} {tag})")
    return dict(shapes["Quadrotor float32"], shapes=shapes)


def witness_lander_select(system, probs, X, U, A, Bj, J_k, J_p, s, label: str, n_rows: int = 8) -> None:
    """The lander's float64 select against the long-double witness of its
    math (select_generic_longdouble on the assembled blocks, whose J the
    fused select's equals: the two plain versions agree bit for bit) on the
    n_rows problems where kernel and plain differ most: the kernel within
    1e-9 relative of the witness (the quadrotor's gate against the plain
    version) or nearer to it than the plain version, and its argmin T*
    tied to the witness's on each."""
    import torch
    from timeopt_tpu_torch.solver.cost import argmin_T

    t = probs.T_min - 1
    d = ((J_k[:, t:] - J_p[:, t:]).abs() / J_p[:, t:].abs()).amax(1)
    rows = torch.argsort(d, descending=True)[:n_rows].cpu()
    args, _ = generic_block_args(system, probs, X, U, A, Bj)
    J_w = select_generic_longdouble(args, rows).to(J_k.device)
    sub = lambda J: J[rows.to(J.device)]  # noqa: E731
    rel = {side: ((sub(J)[:, t:] - J_w[:, t:]).abs() / J_w[:, t:].abs()).max().item()
           for side, J in (("kernel", J_k), ("plain", J_p))}
    s0 = sub(s)[:, :1] ** 2
    T_k, T_w = argmin_T(s0 * sub(J_k), probs.T_min, probs.T_max), argmin_T(s0 * J_w, probs.T_min, probs.T_max)
    r = torch.arange(len(rows), device=J_w.device)
    tied = (T_k == T_w) | ((J_w[r, T_k - 1] - J_w[r, T_w - 1]).abs() <= 1e-9 * J_w[r, T_w - 1].abs())
    log(f"[kernels] {label}: long-double witness on the {len(rows)} problems where kernel and plain differ most "
        f"(up to {d.max().item():.3e}): kernel max rel err {rel['kernel']:.3e}, plain {rel['plain']:.3e}, kernel "
        f"argmin tied {int(tied.sum())}/{len(rows)}")
    require(rel["kernel"] <= max(1e-9, rel["plain"]),
            f"{label}: kernel J {rel['kernel']:.3e} off the long-double witness, farther than 1e-9 and than the "
            f"plain version's {rel['plain']:.3e}")
    require(bool(tied.all()), f"{label}: kernel argmin not tied to the witness's on {int((~tied).sum())} problems")


def hold_lander_select(system, probs, X, U, A, Bj, J_k, J_p, s, label: str, f32: bool) -> tuple:
    """The lander's select kernel J_k against its plain version J_p, as
    phase 3 (c) holds it: in float32 within F32_REL; in float64 the argmin
    equal or tied within 1e-9 and J held to a long-double witness
    (witness_lander_select), since at N = 200 the plain version's explicit
    inverses lose digits past the quadrotor's 1e-9. (max abs err, the plain
    version's T*), as check_select."""
    import torch
    from timeopt_tpu_torch.solver.cost import argmin_T

    if f32:
        return check_select(J_k, J_p, s, probs, ("rel", F32_REL), label, tie=F32_REL)
    err, T_p = check_select(J_k, J_p, s, probs, None, label,
                            ungated="the argmin below, and the long-double witness next")
    T_k = argmin_T(s[:, :1] ** 2 * J_k, probs.T_min, probs.T_max)
    rb = torch.arange(J_k.shape[0], device=J_k.device)
    require(bool(((T_k == T_p) | ((J_p[rb, T_k - 1] - J_p[rb, T_p - 1]).abs()
                                  <= 1e-9 * J_p[rb, T_p - 1].abs())).all()),
            f"{label}: argmin T differs from the plain version's beyond a 1e-9 tie")
    witness_lander_select(system, probs, X, U, A, Bj, J_k, J_p, s, label)
    return err, T_p


def phase_lander(device) -> dict:
    """Phase 3 (c): the 6-DoF lander (LANDER, n = 14, m = 3) at the size of
    the benchmark cell rocket6dof-prop-b1024 (B=1024, N=200, T in [40,
    200]; its start perturbed by sigma_x0 as oracle_problems does), in
    float64 and in float32 as the cell runs: the fused select's wide size
    tier against select_fused_plain, the (14, 3) backward against
    backward_plain at the plain select's T*, the line search on the
    lander's struct (case 6) against its plain version, each at the gate
    the quadrotor's rows of phases 3 and 10 (a) have, and the Jacobian
    kernel against float64 AD (check_linearize); each timed one call and
    back to back beside its plain version, with its bound (ops/work.py).
    In float64 the select is held to the plain version's argmin and to a
    long-double witness (witness_lander_select), since at N = 200 the plain
    version's explicit inverses lose digits past the quadrotor's 1e-9.
    Then one captured float32 solve of the set with its launches counted
    from zero (captured_vs_eager: bitwise the eager run, the same
    launches), every kernel of the lander's path launched and neither the
    generic select, the generated line search nor vmap(jacfwd) run.
    Returns the numbers by dtype and kernel, and the solve's launches."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward, cuda_lft, work
    from timeopt_tpu_torch.solver import linearize as lin
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    system, mk = get_system(LANDER)
    require((system.n, system.m) == (14, 3) and cuda_lft.tier(14, 3) == 14 and cuda_backward.tier(14, 3) == 14,
            f"{LANDER}: not the wide tiers of the select and the backward")
    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    out = {}
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split(".")[-1]
        f32 = dtype == torch.float32
        size = 4 if f32 else 8
        probs = oracle_problems(system, mk, B_FULL, device, dtype if f32 else None)
        require((probs.N, probs.T_min, probs.T_max) == (200, 40, 200), f"{LANDER}: not the cell's horizons")
        X, U, A, Bj = first_iterate(system, probs)
        where = f"{LANDER} B={B_FULL} N={probs.N} {tag}"
        rows = {}

        kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
        J_k, J_p = kernel(), plain()
        torch.cuda.synchronize()
        err, T_p = hold_lander_select(system, probs, X, U, A, Bj, J_k, J_p, s, f"lft_select wide tier ({where})", f32)
        rows["lft_select"] = dict(max_abs_err=err, ms=cuda_ms(kernel, reps=5), ms_back_to_back=device_ms(kernel),
                                  plain_ms=cuda_ms(plain, reps=3),
                                  **work.select_fused(B_FULL, probs.N, system.n, system.m, probs.T_min, size))

        bw_args = backward_args(system, probs, X, U, A, Bj, T_p, opts.lm_init)
        _, (kap_p, K_p, _), nums = check_backward(bw_args, f"backward (14, 3) ({where})", timed=True,
                                                  norm=F32_REL if f32 else None, witness=False)
        rows["backward"] = dict(nums, **work.backward(T_p.tolist(), probs.N, system.n, system.m, size))

        ls_args = (system, probs, X, U, K_p, kap_p, T_p, opts.alphas)
        err = check_linesearch(*ls_args, f"line search case 6 ({where})", gate_all=True,
                               **(dict(rtol=F32_REL, atol=F32_ATOL) if f32 else {}))
        run = lambda: cuda_forward.linesearch(*ls_args)  # noqa: E731
        rows["linesearch"] = dict(max_abs_err=err, ms=cuda_ms(run, reps=5), ms_back_to_back=device_ms(run),
                                  plain_ms=cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=3),
                                  **work.linesearch(LANDER, T_p.tolist(), probs.N, system.n, system.m,
                                                    len(opts.alphas), itemsize=size))
        rows[LINEARIZE[0]] = check_linearize(system, probs, f"linearize case 6 ({where})")
        for name, k in rows.items():
            k["share_of_bound"] = k["bound_ms"] / k["ms_back_to_back"]
            log(f"[bounds] {name} ({where}): {k['ms_back_to_back']:.4f} ms back to back ({k['ms']:.4f} one call, "
                f"plain {k['plain_ms']:.3f}), bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
                f"({k['flops'] / 1e9:.3f} GFLOP, {k['bytes'] / 1e6:.1f} MB), share of bound "
                f"{k['share_of_bound']:.4f}")
        out[tag] = rows

    def refused(*a, **k):
        raise AssertionError(f"{LANDER}: linearize_ad (vmap(jacfwd)) ran on the card")

    probs = oracle_problems(system, mk, B_FULL, device, torch.float32)
    saved, lin.linearize_ad = lin.linearize_ad, refused
    try:
        o = captured_vs_eager(system, probs, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1),
                              f"solve {LANDER}")
    finally:
        lin.linearize_ad = saved
    counts, res = o["counts"], o["res"]
    for name in ("lft_select", "backward", "linesearch", LINEARIZE[0]):
        require(counts[name] > 0, f"solve {LANDER}: kernel {name} was never launched")
    for name in ("lft_select_generic", GENERATED[0]):
        require(counts[name] == 0, f"solve {LANDER}: {name} was launched {counts[name]} times")
    require(bool(torch.isfinite(res.J_star).all()), f"solve {LANDER}: non-finite J*")
    inside = ((res.T_star > probs.T_min) & (res.T_star < probs.T_max)).double().mean().item()
    thrust = torch.linalg.vector_norm(res.U.double(), dim=-1)
    thrust = torch.where(torch.arange(probs.N, device=device)[None] < res.T_star[:, None], thrust, 0.0)
    secs = statistics.mean(o["secs"]["captured"])
    log(f"[lander] solve {LANDER} B={B_FULL} float32 max_iter={MAX_ITER}: launches {counts} | "
        f"{turns_line(o, B_FULL)} | T* {int(res.T_star.min())}..{int(res.T_star.max())}, inside (T_min, T_max) "
        f"{inside:.4f} | largest thrust {thrust.max().item():.4f} | {smi()}")
    out["launches_per_solve"] = counts
    out["solves_per_s"] = B_FULL / secs
    return out


def _counted():
    from timeopt_tpu_torch.ops import (cuda_backward, cuda_forward, cuda_lft, cuda_lft_generic, cuda_lft_query,
                                       cuda_lft_scan, cuda_linearize, dyngen)

    return {"lft_select": cuda_lft, "lft_select_generic": cuda_lft_generic, "backward": cuda_backward,
            "linesearch": cuda_forward, "lft_scan": cuda_lft_scan, "lft_query": cuda_lft_query, GENERATED[0]: dyngen,
            LINEARIZE[0]: cuda_linearize}


def reset_launches() -> None:
    """Every TPU kernel's count to 0, the captured solves run so far booked
    first (compiled.settle_launches), so that none is booked later."""
    from timeopt_tpu_torch.solver import compiled

    compiled.settle_launches()
    for mod in _counted().values():
        mod.LAUNCHES = 0


def launches() -> dict:
    """Every TPU kernel's count, the captured solves run so far booked
    first. The loop condition's count (loop_launches) is kept apart: the
    eager driver, which these counts are held to, does not launch it."""
    from timeopt_tpu_torch.solver import compiled

    compiled.settle_launches()
    return {name: mod.LAUNCHES for name, mod in _counted().items()}


def loop_launches() -> int:
    """The loop condition kernel's count, the captured solves run so far
    booked first."""
    from timeopt_tpu_torch.ops import cuda_loop
    from timeopt_tpu_torch.solver import compiled

    compiled.settle_launches()
    return cuda_loop.LAUNCHES


def differing(got, want) -> list:
    """The SolveResult fields in which got and want differ in any bit (NaN
    where NaN counts as equal)."""
    import dataclasses

    import torch

    out = []
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if a.dtype != b.dtype or a.shape != b.shape:
            out.append(f.name)
            continue
        if a.is_floating_point():
            same = torch.equal(torch.isnan(a), torch.isnan(b)) and torch.equal(a.nan_to_num(0.0), b.nan_to_num(0.0))
        else:
            same = torch.equal(a, b)
        if not same:
            out.append(f.name)
    return out


# Each kernel's __global__ function in its .cu, as a pattern of the traced
# (demangled) kernel name; the line search's template argument tells the
# hand-written structs from the generated one
# (linesearch_kernel<(anonymous namespace)::Generated, double>).
KERNEL_SYMBOL = {"lft_select": r"\blft_select_kernel\b", "lft_select_generic": r"\blft_select_generic_kernel\b",
                 "backward": r"\bbackward_kernel\b", "linesearch": r"\blinesearch_kernel<(?![^,>]*\bGenerated\b)",
                 "lft_scan": r"\blft_scan_kernel\b", "lft_query": r"\blft_query_kernel\b",
                 GENERATED[0]: r"\blinesearch_kernel<[^,>]*\bGenerated\b", LOOP[0]: r"\bloop_cond_kernel\b",
                 LINEARIZE[0]: r"\blinearize_kernel\b"}
# Why no loop-graph launch is held to a trace (an H100, torch 2.11, CUDA
# 12.8, driver 580.159): CUPTI shows at most the first run of a WHILE body
# in a loop graph instantiated before the process's first profiler session,
# and in one instantiated after it, sometimes every run, sometimes none
# (a float32 cart-pole launch of 11 steps showed its init graph's events
# alone, three traces running); inside a body it may name a kernel event
# after another kernel (a B=128 quadrotor launch: 25 select and 25 backward
# kernels of the 13 each it ran; a brute-force one 5 loop conditions of
# 3); and a launch of ~475,000 device events (the one-pass quadrotor's,
# 12 steps) faulted with an illegal address inside the trace. So the
# captures are traced, each replayed on its own, and a solve's launches are
# derived from them and the loop's counters; the counters are held to the
# steps _solve_traced takes (solve_captured, captured_vs_eager, phase 12).
TRACED = {"programs": 0, "events": 0, "secs": 0.0, "retraced": 0}
TRACE_TRIES = 4  # traces before a shortfall fails: one run, then two runs, in turns


def traced_launches(fn, runs: int = 1) -> tuple:
    """fn() `runs` times under torch.profiler, a spin kernel between two
    runs: the last run's kernel events on the card whose name holds each
    kernel's function (KERNEL_SYMBOL), counted by kernel, its number of
    device events, and the first two kernel names of each run (printed
    when a trace is short)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for r in range(runs):
            if r:
                torch.cuda._sleep(1000)
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    cuts = [-1] + [i for i, e in enumerate(events) if "spin_kernel" in e.name()]
    heads = [[e.name()[:60] for e in events[c + 1:c + 3]] for c in cuts]
    names = Counter(e.name() for e in events[cuts[-1] + 1:])
    return ({k: sum(c for n, c in names.items() if re.search(pat, n)) for k, pat in KERNEL_SYMBOL.items()},
            sum(names.values()), heads)


def traced_booked(fn, booked: dict, what: str) -> tuple:
    """fn() traced (traced_launches) until its kernels equal `booked`, kernel
    by kernel. A trace can come back short: on an H100 one step graph's
    trace once held 184 of its ~860 events, the other traces of that run
    whole; late in this smoke the only run of a graph in a trace lost its
    first device events three traces out of three (the Jacobian kernel,
    first in the propagator's step graph and second in the brute force's,
    read missing; a fresh process saw it, and spin kernels before the run
    did not help); and a trace of two runs of the largest graphs (~35,000
    events each) lost events at its end. So the traces alternate: one run,
    then two runs that count the second, in turns; one that shows fewer
    than booked is taken again, up to TRACE_TRIES times; one that shows
    more, or TRACE_TRIES short ones, fails. Returns (the kernels seen, the
    device events)."""
    for attempt in range(1, TRACE_TRIES + 1):
        runs = 1 if attempt % 2 else 2
        traced, n, heads = traced_launches(fn, runs)
        got = {k: traced[k] for k in booked}
        short = all(got[k] <= booked[k] for k in booked) and got != booked
        if not short or attempt == TRACE_TRIES:
            break
        TRACED["retraced"] += 1
        log(f"[trace] {what}: trace {attempt} ({runs} run(s)) short ({got} in {n} device events, booked {booked}; "
            f"each run's first kernels {heads}), traced again")
    require(n > 0 and got == booked, f"{what}: the trace shows {got} in {n} device events (trace {attempt} of "
                                     f"{TRACE_TRIES}), booked {booked}")
    return traced, n


def observe_programs() -> None:
    """From here on, every program that compiled.program builds is traced
    with torch.profiler (traced_booked), on the inputs it was built on:
    one replay of its init graph and one of its step graph (each capture
    instantiated on its own; traced_booked says when a trace holds two),
    whose kernels on the card must equal, kernel
    by kernel, the launches the program books for that graph (the counts
    recorded at its capture). So every launch count of a captured solve
    rests on kernels seen on the card, and on the loop's counters, which
    the solves held to _solve_traced check against the steps it takes.
    These replays count nowhere; the next solve reloads the inputs."""
    import torch
    from timeopt_tpu_torch.solver import compiled

    build = compiled.program
    name_of = {mod: name for name, mod in _counted().items()}

    def program(system, opts, probs, U_init):
        cached = {id(p) for p in compiled.programs()}
        prog = build(system, opts, probs, U_init)
        if id(prog) in cached or prog.graphs is None:
            return prog
        t0 = time.perf_counter()
        seen = []
        with torch.cuda.device(prog.device):
            for g in ("init", "step"):
                booked = {name_of[mod]: c for mod, c in zip(compiled._launch_modules(), prog.graphs[g][1])}
                traced, e = traced_booked(prog.graphs[g][0].replay, dict(booked, **{LOOP[0]: 0}),
                                          f"program {prog.label}, {g} graph")
                seen.append(f"{g} {e} events, {dict((k, v) for k, v in traced.items() if v)}")
                TRACED["events"] += e
        TRACED["programs"] += 1
        TRACED["secs"] += time.perf_counter() - t0
        log(f"[trace] program {prog.label}: one replay of each graph traced, the kernels seen equal those booked "
            f"({'; '.join(seen)}; {time.perf_counter() - t0:.2f} s)")
        return prog

    compiled.program = program


def program_line(prog) -> str:
    """A captured program's build: its eager warm-up, its two captures and
    the loop graph around them, and its graphs' memory pool."""
    return (f"program {prog.label}: warm-up {prog.warmup_s:.3f} s, capture {prog.capture_s:.3f} s (the loop graph "
            f"{prog.loop_s:.3f} s of it), pool {prog.pool_bytes / 2**20:.1f} MiB")


def solve_captured(system, probs, opts, label: str, eager: bool = True) -> dict:
    """One solve_batch on the card through its captured program (built
    first, untimed: the warm-up's launches are not the solve's), timed and
    its launches counted; with `eager`, then the eager driver
    compiled._solve_traced on the same inputs, which it must equal bit for
    bit, launch for launch. Returns the result, seconds, launch counts and
    the program (and the eager seconds)."""
    import torch
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare, solve_batch

    p, U = prepare(probs, None)
    prog = compiled.program(system, opts, p, U)
    torch.cuda.synchronize()
    reset_launches()
    loops = loop_launches()
    t0 = time.perf_counter()
    res = solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    out = dict(res=res, secs=time.perf_counter() - t0, counts=launches(), prog=prog, eager_secs=None)
    it, conds = prog.iterations(), loop_launches() - loops
    if eager:
        reset_launches()
        t0 = time.perf_counter()
        want, steps = counted_steps(lambda: compiled._solve_traced(system, opts, p, U))
        torch.cuda.synchronize()
        out["eager_secs"] = time.perf_counter() - t0
        counts = launches()
        diff = differing(res, want)
        require(not diff, f"{label}: the captured solve differs from _solve_traced in {diff}")
        require(counts == out["counts"], f"{label}: launches captured {out['counts']}, eager {counts}")
        check_steps(it, conds, steps, label)
    return out


def check_steps(it: int, conds: int, steps: int, label: str) -> None:
    """A captured solve's steps on the device (its loop counter `it`, and
    the loop_cond launches booked from the counters: one after init and
    one a step) against the steps _solve_traced takes on the same inputs
    (counted_steps)."""
    require(it == steps and conds == 1 + steps, f"{label}: {it} steps on the device counter and {conds} loop_cond "
                                                f"launches booked, _solve_traced took {steps} steps")


def captured_note(o: dict) -> str:
    """The log fragment of a solve_captured run."""
    eager = ("" if o["eager_secs"] is None else
             f", eager _solve_traced {o['eager_secs']:.2f} s: bitwise equal, the same launches")
    return f"captured {o['secs']:.2f} s{eager} ({program_line(o['prog'])})"


def oracle_w(case: str) -> float:
    """The time weight w of the case's float64 default problem (the
    oracle's scoring rule reads it there, at float32 too)."""
    from timeopt_tpu_torch.models import get_system

    return float(get_system(case)[1](device="cpu").w[0])


def score(T, T_o, curve_o, w: float):
    """(exact, exact-or-tied) boolean arrays of T* against the oracle's."""
    idx = np.arange(len(T_o))
    exact = T == T_o
    return exact, exact | (np.abs(curve_o[idx, T - 1] - curve_o[idx, T_o - 1]) <= w * (np.abs(T - T_o) + 1))


def tied_f32(T, T_o, curve_o, w: float):
    """Exact-or-tied at float32 resolution: the flat-tie rule widened by two
    float32 ulps of J(T_o). A float32 curve stores each J(T) rounded to
    float32 (half an ulp), and both the curve that picked T and the one
    that picked T_o do, so two horizons whose J differ by up to two ulps
    may compare equal or swap order. Where w (|T - T_o| + 1) is below that
    (the ballbot: w = 1e-4, J ~2600, ulp 2.4e-4; J(199) and J(200) of the
    oracle differ by 1.2-1.3 ulps, and the float32 J_prop holds them
    equal, PERF.md section 2) the flat-tie rule asks for more than a
    float32 curve can tell."""
    idx = np.arange(len(T_o))
    ref = curve_o[idx, T_o - 1]
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    return (T == T_o) | (np.abs(curve_o[idx, T - 1] - ref) <= w * (np.abs(T - T_o) + 1) + 2 * ulp)


def solve_oracle_set(case: str, device, opts, dtype=None, eager: bool = True) -> dict:
    """The 128 problems of the case's results/oracle_f64*.npz solved on the
    card with `opts` (in `dtype`, float32, if given) through the captured
    program, with `eager` held bitwise to the eager driver (solve_captured),
    checked finite and of the expected shapes, and scored against the oracle
    with the float64 default problem's w: the system, problems, result,
    seconds, launch counts, exact and exact-or-tied arrays, J* gaps, success
    share and the compiled note."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops.wrap import wrap_error

    system, mk = get_system(case)
    orc = load_oracle(case)
    T_o, J_o, curve_o = orc["T"].astype(np.int64), orc["J"], orc["J_curve"]
    Bo = len(T_o)
    probs = oracle_problems(system, mk, Bo, device, dtype)

    o = solve_captured(system, probs, opts, f"{case} {opts.method} scan_mode={opts.scan_mode} "
                                            f"terminal_mode={opts.terminal_mode} {dtype or 'float64'}", eager)
    res, secs, counts = o["res"], o["secs"], o["counts"]

    n, m, N = system.n, system.m, probs.N
    require(tuple(res.X.shape) == (Bo, N + 1, n) and tuple(res.U.shape) == (Bo, N, m), f"{case}: result shapes")
    require(bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all()), f"{case}: non-finite X or U")
    require(bool(torch.isfinite(res.J_star).all()), f"{case}: non-finite J*")
    T = res.T_star.cpu().numpy()
    J = res.J_star.cpu().numpy()
    exact, tied = score(T, T_o, curve_o, oracle_w(case))
    eT = wrap_error(res.X[torch.arange(Bo, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    return dict(system=system, probs=probs, res=res, secs=secs, counts=counts, T=T, T_o=T_o, exact=exact,
                tied=exact | tied, gap=np.abs(J - J_o) / np.abs(J_o),
                succ=float((eT.norm(dim=-1) <= 0.5).double().mean()), note=captured_note(o))


def phase_oracle(case: str, device) -> dict:
    """The 128 problems of the case's results/oracle_f64*.npz, solved on the
    card and scored; returns the launch count of every kernel in the solve
    and records the exact-or-tied score in ORACLE_TIED."""
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    o = solve_oracle_set(case, device, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1))
    counts, Bo, T, T_o = o["counts"], len(o["T_o"]), o["T"], o["T_o"]
    select = "lft_select" if o["system"].extra_cost is None else "lft_select_generic"
    for name in (select, "backward", "linesearch", LINEARIZE[0]):
        require(counts[name] > 0, f"oracle solve {case}: kernel {name} was never launched")
    ORACLE_TIED[case] = int(o["tied"].sum())
    log(f"[oracle] {case} B={Bo}: T* exact {int(o['exact'].sum())}/{Bo}, exact-or-tied {ORACLE_TIED[case]}/{Bo} | "
        f"J* rel gap median {np.median(o['gap']):.3e} max {o['gap'].max():.3e} | success@0.5 {o['succ']:.3f} | "
        f"{o['note']} | launches {counts}")
    bad = np.nonzero(~o["tied"])[0]
    if len(bad):
        log(f"[oracle] {case} not tied: idx {bad.tolist()} T* {T[bad].tolist()} oracle {T_o[bad].tolist()}")
    allowed = set(REFERENCE_MISSES.get(case, ()))
    require(set(bad.tolist()) <= allowed,
            f"oracle {case}: exact-or-tied {ORACLE_TIED[case]}/{Bo}, misses {sorted(set(bad.tolist()) - allowed)} "
            "beyond the reference's own")
    tw = solve_twin(case, o, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1))
    return {k: counts[k] + tw[k] for k in counts}


@contextmanager
def plain_rollouts_counted():
    """Counts the plain line search's rollouts (solver/forward.py::
    rollout_with_gains, which both plain paths run) while the block runs:
    yields a dict whose "calls" the caller reads after the block."""
    from timeopt_tpu_torch.solver import forward

    seen, plain = {"calls": 0}, forward.rollout_with_gains

    def counted(*a, **kw):
        seen["calls"] += 1
        return plain(*a, **kw)

    forward.rollout_with_gains = counted
    try:
        yield seen
    finally:
        forward.rollout_with_gains = plain


def solve_twin(case: str, o: dict, opts, dtype=None, rtol: float = 1e-10) -> dict:
    """The problems of `o` (a registry system's solve_oracle_set result)
    solved on the card by the case's device_id=None twin (phase 4 (b)): its
    line search the kernel generated from the same functions. It must score
    as the registry system (the same exact-or-tied problems), with the same
    T* on every problem and J* within rtol; its launches those of the
    registry solve, the hand-written line search's moved to the generated
    one, and the plain line search never run. Returns its launch counts."""
    import torch

    tw = twin(case)
    with plain_rollouts_counted() as plain:
        g = solve_captured(tw, o["probs"], opts, f"{tw.name} {opts.method} {dtype or 'float64'}", eager=False)
    res, want = g["res"], o["res"]
    T = res.T_star.cpu().numpy()
    require(np.array_equal(T, o["T"]), f"{tw.name} {opts.method}: T* differs from {case}'s on problems "
                                       f"{np.nonzero(T != o['T'])[0].tolist()}")
    gap = ((res.J_star - want.J_star).abs() / want.J_star.abs()).max().item()
    require(gap <= rtol, f"{tw.name} {opts.method}: J* {gap:.3e} relative off {case}'s (rtol {rtol})")
    same = all(bitwise(getattr(res, f), getattr(want, f)) for f in ("J_star", "X", "U"))
    counts, reg = g["counts"], o["counts"]
    require(counts[GENERATED[0]] == reg["linesearch"] > 0 and counts["linesearch"] == 0 and plain["calls"] == 0,
            f"{tw.name} {opts.method}: launches {counts} (the registry solve's {reg}), plain rollouts {plain['calls']}")
    require({k: v for k, v in counts.items() if k not in ("linesearch", GENERATED[0])}
            == {k: v for k, v in reg.items() if k not in ("linesearch", GENERATED[0])},
            f"{tw.name} {opts.method}: the other kernels' launches {counts} differ from the registry solve's {reg}")
    tied = score(T, o["T_o"], load_oracle(case)["J_curve"], oracle_w(case))
    tied = tied[0] | tied[1]
    log(f"[generated] {tw.name} {opts.method} {dtype or 'float64'} B={len(T)}: T* equal to {case}'s on every problem, "
        f"exact-or-tied {int(tied.sum())}/{len(T)} (the registry's {int(o['tied'].sum())}), J* max rel gap {gap:.3e}, "
        f"J*, X, U bitwise the registry's {same} | generated launches {counts[GENERATED[0]]}, hand-written 0, plain "
        f"rollouts 0 | {captured_note(g)}")
    return counts


def phase_generated(device) -> dict:
    """Phase 4 (b): the generated line search's other entries in solves (the
    one-pass method's start-state entry on the double integrator's oracle
    set, the float32 entries on the quadrotor's as float32 problems), each
    twin against its registry system as solve_twin holds them (float32 J*
    within F32_REL); then the unicycle, a system outside the registry, at
    B=128 on the card against its CPU solve: T* identical, J* within rtol
    1e-9. Returns the launch counts."""
    import torch
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    for case, opts, dtype, rtol in (
            ("DoubleIntegrator", SolveOptions(method="onepass", max_iter=MAX_ITER, psd_levels=1), None, 1e-10),
            ("Quadrotor", SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1), torch.float32, F32_REL)):
        o = solve_oracle_set(case, device, opts, dtype, eager=False)
        add(o["counts"])
        add(solve_twin(case, o, opts, dtype, rtol))
        compiled.clear_compiled()

    system = unicycle()
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    probs = unicycle_problems(B_ORACLE, SEED, device)
    with plain_rollouts_counted() as plain:
        g = solve_captured(system, probs, opts, "Unicycle", eager=False)
    t0 = time.perf_counter()
    want = solve_batch(system, probs.to("cpu"), options=opts)
    cpu_s = time.perf_counter() - t0
    res, c = g["res"], g["counts"]
    require(bool(torch.isfinite(res.J_star).all()) and bool((res.n_accept > 0).all()),
            "Unicycle: a non-finite J* or a problem without an accepted step on the card")
    require(torch.equal(res.T_star.cpu(), want.T_star), f"Unicycle: T* differs from the CPU solve on problems "
                                                         f"{torch.nonzero(res.T_star.cpu() != want.T_star).flatten().tolist()}")
    gap = ((res.J_star.cpu() - want.J_star).abs() / want.J_star.abs()).max().item()
    require(gap <= 1e-9, f"Unicycle: J* {gap:.3e} relative off the CPU solve (rtol 1e-9)")
    require(c[GENERATED[0]] > 0 and c["linesearch"] == 0 and plain["calls"] == 0 and c[LINEARIZE[0]] == 0,
            f"Unicycle: launches {c}, plain rollouts {plain['calls']} (its step carries no device_id: "
            "linearize_ad, not the Jacobian kernel)")
    log(f"[generated] Unicycle (custom system, device_id None) B={B_ORACLE} N={probs.N}: T* identical to the CPU solve "
        f"on every problem (median {int(res.T_star.median())}), J* max rel gap {gap:.3e}, accepted steps "
        f"{int(res.n_accept.min())}-{int(res.n_accept.max())} | CPU solve {cpu_s:.2f} s | launches {c} | "
        f"{captured_note(g)}")
    add(c)
    return counts


def phase_bruteforce(case: str, device) -> dict:
    """The oracle's own computation on its 128 problems: the brute-force
    solve, scored exact-or-tied 128/128; then consistency_check on its
    result (the scan and query kernels). Returns the launch counts of both
    paths."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    system, mk = get_system(case)
    orc = load_oracle(case)
    T_o, J_o, curve_o = orc["T"].astype(np.int64), orc["J"], orc["J_curve"]
    Bo = len(T_o)
    probs = oracle_problems(system, mk, Bo, device)

    o = solve_captured(system, probs, SolveOptions(method="bruteforce", max_iter=MAX_ITER, psd_levels=1),
                       f"brute force {case}")
    res, secs, counts = o["res"], o["secs"], o["counts"]
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
        f"median {np.median(cgap):.3e} max {cgap.max():.3e} | {counts['backward']} outer iterations, "
        f"{1e3 * secs / counts['backward']:.1f} ms/iteration captured | {captured_note(o)} | {smi()}")
    bad = np.nonzero(~tied)[0]
    require(len(bad) == 0, f"brute force {case}: not exact or tied on {bad.tolist()} (T* {T[bad].tolist()}, "
            f"oracle {T_o[bad].tolist()})")

    cc_counts, CC_READ[case] = check_consistency(system, probs, res.X, res.U, CC_NORM_BOUND[case],
                                                 f"[consistency] {case} B={Bo}")
    return {k: counts[k] + cc_counts[k] for k in counts}


def check_consistency(system, probs, X, U, bound: float, label: str) -> tuple:
    """consistency_check on the trajectories (X, U): the scan and query
    kernels' J_prop(T) against the plain brute force's J_bf(T), every
    problem's argmin T* tied to J_bf's by the oracle's rule (on float32
    curves at float32 resolution, tied_f32) and the largest normwise
    difference within `bound`. Returns (launch counts, that largest
    normwise difference)."""
    import torch
    from timeopt_tpu_torch.solver.cost import argmin_T
    from timeopt_tpu_torch.solver.verify import consistency_check

    Bo = probs.batch
    reset_launches()
    t0 = time.perf_counter()
    cc = consistency_check(system, probs, X, U)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cc_counts = launches()
    for name in ("lft_scan", "lft_query"):
        require(cc_counts[name] > 0, f"{label}: kernel {name} was never launched")
    mx = cc["max_abs"].cpu().numpy()
    require(np.isfinite(mx).all() and bool(torch.isfinite(cc["rmse"]).all()), f"{label}: non-finite")
    require(bool(torch.isfinite(cc["J_prop"][:, probs.T_min - 1 :]).all()), f"{label}: J_prop non-finite")
    # the kernels' curve against the brute force's on the same trajectories
    J_prop, J_bf = cc["J_prop"], cc["J_bf"]
    a, b = J_prop[:, probs.T_min - 1 :].double(), J_bf[:, probs.T_min - 1 :].double()
    nw = ((a - b).abs().amax(1) / b.abs().amax(1)).cpu().numpy()
    T_prop = argmin_T(J_prop, probs.T_min, probs.T_max).cpu().numpy()
    T_bf = argmin_T(J_bf, probs.T_min, probs.T_max).cpu().numpy()
    curve, w = J_bf.double().cpu().numpy(), oracle_w(system.name)
    exact_bf, tied_bf = score(T_prop, T_bf, curve, w)
    f32 = J_bf.dtype == torch.float32
    gate = tied_f32(T_prop, T_bf, curve, w) if f32 else tied_bf
    q = np.quantile(mx, [0.0, 0.5, 0.9, 1.0])
    log(f"{label}: max_abs min {q[0]:.3e} median {q[1]:.3e} p90 {q[2]:.3e} max {q[3]:.3e} | "
        f"rmse median {float(cc['rmse'].median()):.3e} | J_prop vs J_bf normwise median {np.median(nw):.3e} max "
        f"{nw.max():.3e} (bound {bound}), argmin exact {int(exact_bf.sum())}/{Bo}, tied "
        f"{int(tied_bf.sum())}/{Bo}" + (f", tied at float32 resolution {int(gate.sum())}/{Bo}" if f32 else "")
        + f" | {secs:.2f} s | launches {cc_counts}")
    require(nw.max() <= bound, f"{label}: J_prop vs J_bf normwise {nw.max():.3e} > {bound}")
    bad = np.nonzero(~gate)[0]
    require(len(bad) == 0, f"{label}: the kernels' argmin T* is not tied to the brute force's on "
            f"{bad.tolist()} (T* {T_prop[bad].tolist()}, brute force {T_bf[bad].tolist()})")
    return cc_counts, float(nw.max())


def phase_inverse(device) -> dict:
    """One quadrotor solve at B=128 with the reference-parity inverse query:
    the scan kernel inside a solve. Returns its launch counts."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    system, mk = get_system("Quadrotor")
    orc = load_oracle("Quadrotor")
    probs = oracle_problems(system, mk, B_ORACLE, device)
    opts = SolveOptions(method="propagator", terminal_mode="inverse", max_iter=MAX_ITER, psd_levels=1)
    o = solve_captured(system, probs, opts, "inverse-query solve")
    res, counts = o["res"], o["counts"]
    require(counts["lft_scan"] > 0, "inverse-query solve: kernel lft_scan was never launched")
    require(bool(torch.isfinite(res.J_star).all()), "inverse-query solve: non-finite J*")
    T_o = orc["T"].astype(np.int64)
    exact, tied = score(res.T_star.cpu().numpy(), T_o, orc["J_curve"], float(probs.w[0]))
    gap = np.abs(res.J_star.cpu().numpy() - orc["J"]) / np.abs(orc["J"])
    MODE_TIED[("inverse", "Quadrotor")] = int(tied.sum())
    log(f"[inverse] Quadrotor B={B_ORACLE} terminal_mode=inverse: T* exact {int(exact.sum())}/{B_ORACLE}, "
        f"exact-or-tied {int(tied.sum())}/{B_ORACLE} | J* rel gap max {gap.max():.3e} | {captured_note(o)} | "
        f"launches {counts}")
    return counts


def phase_runner() -> dict:
    """The port's suite runner in-process (device cuda) on all six cases,
    the three solvers, with the phase timers, held against the committed
    results/cpu_f64_25 rows. Returns its launch counts."""
    import csv
    import tempfile

    from timeopt_tpu_torch.runner import run_suite

    solvers = ("ourmethod", "baseline1", "baseline2")
    with open(COMMITTED_CSV, newline="") as f:
        want = {(r["case"], r["solver"], r["trial"]): r for r in csv.DictReader(f)}
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        run_suite.main(["--cases", ",".join(CASES), "--trials", "25", "--solvers", ",".join(solvers),
                        "--consistency", "--save-jt", "--save-trajectories", "--phase-timers", "--outdir", out])
        secs = time.perf_counter() - t0
        counts = launches()
        with open(os.path.join(out, "summary_all.csv"), newline="") as f:
            got = list(csv.DictReader(f))
        with open(os.path.join(out, "summary_agg.csv"), newline="") as f:
            agg = list(csv.DictReader(f))
        for case in CASES:
            require(os.path.exists(os.path.join(out, case, f"{case}_Jt.csv")), f"runner: no {case}_Jt.csv")
            require(os.path.exists(os.path.join(out, case, "trajectories_baseline2.npz")), f"runner: no {case} npz")
    for name in KERNELS:
        require(counts[name] > 0, f"runner: kernel {name} was never launched")
    require(len(got) == len(CASES) * len(solvers) * 25, f"runner: {len(got)} rows")
    with open(COMMITTED_CSV, newline="") as f:
        require(list(got[0]) == next(csv.reader(f)), "runner: the header differs from the committed one")
    log(f"[runner] 6 cases x 25 trials x {solvers}, --consistency --save-jt --save-trajectories --phase-timers: "
        f"{secs:.1f} s | launches {counts}")
    phases = ("linearize", "select", "backward", "forward")
    for case in CASES:
        rows = [r for r in got if r["case"] == case]
        w = {(r["solver"], r["trial"]): want[(case, r["solver"], r["trial"])] for r in rows}
        t_miss = [(r["solver"], r["trial"], r["T_star"], w[(r["solver"], r["trial"])]["T_star"])
                  for r in rows if r["T_star"] != w[(r["solver"], r["trial"])]["T_star"]]
        jgap = {s: max(abs(float(r["J_star"]) - float(w[(s, r["trial"])]["J_star"])) / abs(float(w[(s, r["trial"])]["J_star"]))
                       for r in rows if r["solver"] == s) for s in solvers}
        cc = {s: (float(r["consistency_max_abs"]), float(want[(case, s, "0")]["consistency_max_abs"]))
              for s in ("ourmethod", "baseline1") for r in rows if r["solver"] == s and r["trial"] == "0"}
        ratio = {r["solver"]: r["ratio_time_median"] for r in agg if r["case"] == case}
        log(f"[runner] {case}: T* differs from the committed rows on {len(t_miss)}/{len(rows)} "
            f"{t_miss[:6]}{' ...' if len(t_miss) > 6 else ''} | J* max rel gap "
            + ", ".join(f"{s} {g:.3e}" for s, g in jgap.items()) + " | trial-0 consistency_max_abs "
            + ", ".join(f"{s} {a:.6e} (committed {b:.6e}, rel {(a - b) / b:+.3e})" for s, (a, b) in cc.items())
            + " | time_ratio_base median " + ", ".join(f"{s} {ratio.get(s)}" for s in solvers))
        for s in solvers:
            r0 = next(r for r in rows if r["solver"] == s and r["trial"] == "0")
            log(f"[runner] {case} {s} trial-0 phase timers (B=1, host-driven), s on this card | committed CPU run: "
                + ", ".join(f"t_{k} {float(r0['t_' + k]):.4f} | {float(w[(s, '0')]['t_' + k]):.4f}" for k in phases))
        if case in RUNNER_GATED:
            curve = [m for m in t_miss if m[0] != "baseline2"]
            require(not curve, f"runner {case}: T* differs from the committed rows: {curve}")
            for s, (a, b) in cc.items():
                lim = RUNNER_CC_RTOL[case] * abs(b)
                require(abs(a - b) <= lim, f"runner {case} {s}: consistency_max_abs {a} vs committed {b} (limit {lim:.3e})")
        # baseline2 (one-pass): trial 0 as committed, the success share no lower
        b2 = {r["trial"]: r for r in rows if r["solver"] == "baseline2"}
        w0 = w[("baseline2", "0")]
        J0, Jw0 = float(b2["0"]["J_star"]), float(w0["J_star"])
        share = sum(r["success"] == "True" for r in b2.values()) / 25
        share_w = sum(w[("baseline2", t)]["success"] == "True" for t in b2) / 25
        others = [(t, r["T_star"], w[("baseline2", t)]["T_star"],
                   f"{(float(r['J_star']) - float(w[('baseline2', t)]['J_star'])) / abs(float(w[('baseline2', t)]['J_star'])):+.3e}")
                  for t, r in b2.items() if t != "0" and r["T_star"] != w[("baseline2", t)]["T_star"]]
        log(f"[runner] {case} baseline2: trial 0 T* {b2['0']['T_star']} (committed {w0['T_star']}), J* {J0!r} "
            f"(committed {Jw0!r}, rel {(J0 - Jw0) / abs(Jw0):+.3e}) | success {share:.2f} (committed {share_w:.2f}) | "
            f"other trials whose T* differs {len(others)}/24 (trial, T*, committed T*, J* rel gap): {others}")
        require(b2["0"]["T_star"] == w0["T_star"] and abs(J0 - Jw0) <= 1e-6 * abs(Jw0),
                f"runner {case} baseline2 trial 0: T* {b2['0']['T_star']} J* {J0} vs committed {w0['T_star']} {Jw0}")
        require(share >= share_w, f"runner {case} baseline2: success share {share} < committed {share_w}")
    return counts


def captured_vs_eager(system, probs, opts, label: str, dtype=None) -> dict:
    """Phase 7 and 10 (c): the captured solve and the eager driver, timed in
    turns captured, eager, eager, captured after the program's build (its
    warm-up and capture timed on their own): the captured result bitwise
    the eager one, the same launches. Returns the captured result, its
    launch counts, the seconds of each turn by kind and the program."""
    import torch
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import prepare, solve_batch

    compiled.clear_compiled()
    p, U = prepare(probs, None)
    prog = compiled.program(system, opts, p, U)
    torch.cuda.synchronize()
    secs, res, counts, steps = {"captured": [], "eager": []}, {}, {}, {"captured": [], "eager": []}
    for kind in ("captured", "eager", "eager", "captured"):
        reset_launches()
        loops = loop_launches()
        t0 = time.perf_counter()
        if kind == "captured":
            res[kind] = solve_batch(system, probs, options=opts)
        else:
            res[kind], n = counted_steps(lambda: compiled._solve_traced(system, opts, p, U))
        torch.cuda.synchronize()
        secs[kind].append(time.perf_counter() - t0)
        counts[kind] = launches()
        if kind == "captured":
            counts["loop_cond"] = loop_launches() - loops
            steps[kind].append((prog.iterations(), counts["loop_cond"]))
        else:
            steps[kind].append(n)
    diff = differing(res["captured"], res["eager"])
    require(not diff, f"{label}: the captured solve differs from _solve_traced in {diff}")
    require(counts["captured"] == counts["eager"],
            f"{label}: launches captured {counts['captured']}, eager {counts['eager']}")
    for it, conds in steps["captured"]:
        for n in steps["eager"]:
            check_steps(it, conds, n, label)
    return dict(res=res["captured"], counts=dict(counts["captured"], loop_cond=counts["loop_cond"]), secs=secs,
                prog=prog)


def turns_line(o: dict, B: int) -> str:
    """Solves/s of each turn of captured_vs_eager, in the order run."""
    c, e = (o["secs"][k] for k in ("captured", "eager"))
    return (f"solves/s in turns captured / eager / eager / captured: {B / c[0]:.2f} / {B / e[0]:.2f} / "
            f"{B / e[1]:.2f} / {B / c[1]:.2f} (bitwise equal, the same launches; {program_line(o['prog'])})")


def phase_throughput(case: str, device, dtype=None) -> dict:
    """solve_batch at B=1024 in float64 or `dtype` (float32), captured and
    eager in turns (captured_vs_eager); records the captured solves/s (the
    mean of its two turns) in THROUGHPUT and the eager in THROUGHPUT_EAGER,
    and returns the captured solve's launch counts (the launches of one
    main-path solve)."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.cost import extra_cost_terms
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    system, mk = get_system(case)
    probs = oracle_problems(system, mk, B_FULL, device, dtype)
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    o = captured_vs_eager(system, probs, opts, f"throughput {case}")
    res, counts = o["res"], o["counts"]
    secs = statistics.mean(o["secs"]["captured"])
    select = "lft_select" if system.extra_cost is None else "lft_select_generic"
    for name in (select, "backward", "linesearch", LINEARIZE[0]):
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
    tag = "f64" if dtype is None else "f32"
    THROUGHPUT[(case, tag)] = B_FULL / secs
    THROUGHPUT_EAGER[(case, tag)] = B_FULL / statistics.mean(o["secs"]["eager"])
    beside = (f" (f64 in this call: captured {THROUGHPUT[(case, 'f64')]:.2f}, eager "
              f"{THROUGHPUT_EAGER[(case, 'f64')]:.2f})" if tag == "f32" else "")
    log(f"[throughput] {case} B={B_FULL} max_iter={MAX_ITER} {tag}: captured {B_FULL / secs:.2f}, eager "
        f"{THROUGHPUT_EAGER[(case, tag)]:.2f} solves/s{beside} | {turns_line(o, B_FULL)} | captured {secs:.3f} s, "
        f"{iters} outer iterations, {1e3 * secs / iters:.2f} ms/iteration | T* median "
        f"{float(res.T_star.double().median()):g} | success@0.5 {succ:.3f} | launches {counts}{extra} | {smi()}")
    return counts


def phase_throughput_onepass(device, dtype=None) -> dict:
    """One timed one-pass solve (baseline2) of the quadrotor at B=1024,
    N=160, max_iter=12, after a warm-up, in float64 or `dtype` (float32);
    records its solves/s in THROUGHPUT and returns its launch counts. The
    one-pass method launches the backward and the line-search kernels: the
    warm start and the fixed-T-bar fallback (computed every iteration), and
    the three window shrinks' shifted-gain rollouts of each iteration
    stacked as one line-search launch."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    system, mk = get_system("Quadrotor")
    probs = oracle_problems(system, mk, B_FULL, device, dtype)
    opts = SolveOptions(method="onepass", max_iter=MAX_ITER, S_window=20)
    o = captured_vs_eager(system, probs, opts, "throughput one-pass")
    res, counts = o["res"], o["counts"]
    secs = statistics.mean(o["secs"]["captured"])
    for name in ("backward", "linesearch", LINEARIZE[0]):
        require(counts[name] > 0, f"throughput one-pass: kernel {name} was never launched")
    require(bool(torch.isfinite(res.J_star).all()), "throughput one-pass: non-finite J*")
    eT = wrap_error(res.X[torch.arange(B_FULL, device=device), res.T_star] - probs.xg, probs.wrap_mask)
    succ = float((eT.norm(dim=-1) <= 0.5).double().mean())
    iters = counts["backward"] - 1  # the warm start's and one fallback backward an iteration
    tag = "f64" if dtype is None else "f32"
    key = ("Quadrotor_onepass", tag)
    THROUGHPUT[key] = B_FULL / secs
    THROUGHPUT_EAGER[key] = B_FULL / statistics.mean(o["secs"]["eager"])
    beside = (f" (f64 in this call: captured {THROUGHPUT[('Quadrotor_onepass', 'f64')]:.2f}, eager "
              f"{THROUGHPUT_EAGER[('Quadrotor_onepass', 'f64')]:.2f})" if tag == "f32" else "")
    log(f"[throughput] Quadrotor one-pass B={B_FULL} max_iter={MAX_ITER} S_window=20 {tag}: captured "
        f"{B_FULL / secs:.2f}, eager {THROUGHPUT_EAGER[key]:.2f} solves/s{beside} | {turns_line(o, B_FULL)} | "
        f"captured {secs:.3f} s | {iters} outer iterations | launches per solve: linesearch {counts['linesearch']}, backward "
        f"{counts['backward']} (all {counts}) | T* median {float(res.T_star.double().median()):g} | n_fallback total "
        f"{int(res.n_fallback.sum())} | success@0.5 {succ:.3f} | {smi()}")
    return counts


def phase_latency_oracle(device) -> dict:
    """Phase 8 (a): each oracle set solved in both latency modes
    (scan_mode "associative": the plain tree scan, then the query kernel;
    "assoc_df": the Hillis-Steele scan, then the query kernel), scored as
    phase 4, the misses within REFERENCE_MISSES (and ASSOC_MISSES for
    "associative"). Returns the launch counts summed over the runs."""
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    total = {name: 0 for name in _counted()}
    for mode in LATENCY_MODES:
        for case in CASES:
            o = solve_oracle_set(case, device, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1,
                                                            scan_mode=mode))
            counts, Bo = o["counts"], len(o["T_o"])
            for name in ("lft_query", "backward", "linesearch"):
                require(counts[name] > 0, f"latency mode {mode} {case}: kernel {name} was never launched")
            require(counts["lft_select"] == counts["lft_select_generic"] == 0,
                    f"latency mode {mode} {case}: a sequential select kernel was launched")
            tied = MODE_TIED[(mode, case)] = int(o["tied"].sum())
            bad = np.nonzero(~o["tied"])[0]
            log(f"[latency] {case} B={Bo} scan_mode={mode}: T* exact {int(o['exact'].sum())}/{Bo}, exact-or-tied "
                f"{tied}/{Bo} (phase 4, sequential: {ORACLE_TIED.get(case)}/{Bo}) | J* rel gap max {o['gap'].max():.3e} "
                f"| success@0.5 {o['succ']:.3f} | {o['note']} | launches {counts}"
                + (f" | not tied: idx {bad.tolist()} T* {o['T'][bad].tolist()} oracle {o['T_o'][bad].tolist()}"
                   if len(bad) else ""))
            allowed = set(REFERENCE_MISSES.get(case, ()))
            if mode == "associative":
                allowed |= set(ASSOC_MISSES.get(case, ()))
            require(set(bad.tolist()) <= allowed,
                    f"latency mode {mode} {case}: exact-or-tied {tied}/{Bo}, misses "
                    f"{sorted(set(bad.tolist()) - allowed)} beyond the allowed")
            for name, v in counts.items():
                total[name] += v
    return total


def phase_latency_b1(device) -> dict:
    """Phase 8 (b): the quadrotor's oracle problem 0 (N=160, max_iter=12) as
    one solve in each scan mode, captured and eager, the median of 5
    synchronized runs of each after a warm-up (the modes and the drivers in
    turns), each captured result bitwise the eager one, its steps on the
    device the eager one's (check_steps), T* identical to the sequential
    solve's and J* within rtol 1e-9;
    then the select alone at B=1 on the first iterate: the fused kernel
    (sequential), the plain tree scan + query kernel (associative), the
    Hillis-Steele scan + query kernel (assoc_df), each also with its inputs'
    assembly (solver/ilqr.py::_select_curve). Returns the timed solves'
    launch counts."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.horizon import propagator_select
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, _select_curve, prepare, solve_batch
    from timeopt_tpu_torch.solver.select_assoc import propagator_select_assoc

    system, mk = get_system("Quadrotor")
    probs = oracle_problems(system, mk, B_ORACLE, device)
    prob, U = prepare(probs.replace(**{f: t[:1].contiguous() for f, t in probs.tensors().items()}), None)
    total = {name: 0 for name in _counted()}
    modes = ("sequential",) + LATENCY_MODES
    opts = {mode: SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1, scan_mode=mode) for mode in modes}
    run = {"captured": lambda mode: solve_batch(system, prob, options=opts[mode]),
           "eager": lambda mode: counted_steps(lambda: compiled._solve_traced(system, opts[mode], prob, U))}
    for mode in modes:
        for kind in run:
            run[kind](mode)  # warm-up; the captured one builds its program
    progs = {mode: compiled.program(system, opts[mode], prob, U) for mode in modes}
    torch.cuda.synchronize()
    # five rounds, the modes in turns (rotated each round), captured and
    # eager in turns within a mode (swapped each round), so a drift of the
    # host's speed meets every mode and both drivers alike
    out = {mode: dict(solve_s_all=[], captured_s_all=[], counts={name: 0 for name in _counted()}) for mode in modes}
    for r in range(5):
        for mode in modes[r % 3:] + modes[: r % 3]:
            res, counts = {}, {}
            for kind in (("captured", "eager") if r % 2 == 0 else ("eager", "captured")):
                reset_launches()
                loops = loop_launches()
                t0 = time.perf_counter()
                res[kind] = run[kind](mode)
                torch.cuda.synchronize()
                out[mode]["captured_s_all" if kind == "captured" else "solve_s_all"].append(time.perf_counter() - t0)
                counts[kind] = launches()
                if kind == "captured":
                    device_steps = (progs[mode].iterations(), loop_launches() - loops)
            res["eager"], steps = res["eager"]
            diff = differing(res["captured"], res["eager"])
            require(not diff and counts["captured"] == counts["eager"],
                    f"B=1 solve scan_mode={mode}: captured vs _solve_traced differ in {diff}, launches "
                    f"{counts['captured']} vs {counts['eager']}")
            check_steps(*device_steps, steps, f"B=1 solve scan_mode={mode}")
            for name, v in counts["captured"].items():
                out[mode]["counts"][name] += v
            out[mode]["res"] = (int(res["captured"].T_star[0]), float(res["captured"].J_star[0]))
    for mode in modes:
        o, counts = out[mode], out[mode]["counts"]
        need = ("lft_select",) if mode == "sequential" else ("lft_query",)
        for name in need + ("backward", "linesearch"):
            require(counts[name] > 0, f"B=1 solve scan_mode={mode}: kernel {name} was never launched")
        for name, v in counts.items():
            total[name] += v
        (T, J), (T0, J0) = o["res"], out["sequential"]["res"]
        require(T == T0 and abs(J - J0) <= 1e-9 * abs(J0),
                f"B=1 solve scan_mode={mode}: T* {T} J* {J!r} vs sequential {T0} {J0!r}")
        o.update(solve_s=statistics.median(o["solve_s_all"]), captured_s=statistics.median(o["captured_s_all"]),
                 T_star=T, J_star=J, iterations=counts["backward"] // 5,
                 launches_per_solve={k: v // 5 for k, v in counts.items()})

    X, U, A, Bj = first_iterate(system, prob)
    kernel = select_pair(system, prob, SolveOptions(method="propagator", psd_levels=1), X, U, A, Bj)[0]
    Tm = prob.T_max
    blk = build_augmented(system, prob, X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], Bj[:, :Tm], psd_levels=1)
    C = build_terminal_factors(prob, X[:, : Tm + 1], s=blk.s)
    bargs = [t.contiguous() for t in (blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C)]
    alone = {
        "sequential": kernel,
        "associative": lambda: propagator_select(*bargs, psd_levels=1, scan_mode="associative"),
        "assoc_df": lambda: propagator_select_assoc(*bargs, prob.T_min),
    }
    J_seq = None
    for mode, fn in alone.items():
        J = fn()
        torch.cuda.synchronize()
        J = J[:, prob.T_min - 1:]
        J_seq = J if J_seq is None else J_seq
        rel = ((J - J_seq).abs() / J_seq.abs()).max().item()
        full = lambda: _select_curve(system, prob, SolveOptions(psd_levels=1, scan_mode=mode), X, U, A, Bj)  # noqa: E731
        out[mode].update(select_ms=cuda_ms(fn, reps=10), select_with_inputs_ms=cuda_ms(full, reps=10),
                         select_rel_to_sequential=rel)
    for mode, o in out.items():
        log(f"[latency] Quadrotor B=1 N={prob.N} max_iter={MAX_ITER} scan_mode={mode}: solve captured "
            f"{1e3 * o['captured_s']:.2f} ms, eager {1e3 * o['solve_s']:.2f} ms (medians of 5, modes and drivers in "
            f"turns; captured {', '.join(f'{1e3 * t:.2f}' for t in o['captured_s_all'])}; eager "
            f"{', '.join(f'{1e3 * t:.2f}' for t in o['solve_s_all'])}; bitwise equal), T* {o['T_star']}, J* "
            f"{o['J_star']!r}, {o['iterations']} outer iterations, launches per solve {o['launches_per_solve']} | "
            f"select alone {o['select_ms']:.3f} ms, with its inputs' assembly {o['select_with_inputs_ms']:.3f} ms, "
            f"J(T >= T_min) max rel to the sequential kernel's {o['select_rel_to_sequential']:.3e} | {smi()}")
    return total


def check_same_solve(got, want, label: str, exact: bool = False) -> None:
    """T* and T_ties identical, J*, X and U within rtol 1e-12; with
    `exact`, J*, X and U bit for bit."""
    import torch

    got = {f: torch.as_tensor(getattr(got, f)).to(want.X.device) for f in ("T_star", "T_ties", "J_star", "X", "U")}
    require(torch.equal(got["T_star"], want.T_star) and torch.equal(got["T_ties"], want.T_ties),
            f"{label}: T* or T_ties differ")
    for f in ("J_star", "X", "U"):
        require(within(got[f], getattr(want, f), 1e-12, 0.0), f"{label}: {f} outside rtol 1e-12")
    bitwise = all(torch.equal(got[f], getattr(want, f)) for f in ("J_star", "X", "U"))
    require(bitwise or not exact, f"{label}: J*, X or U not bitwise equal")
    log(f"[scale-out] {label}: T*, T_ties identical; J*, X, U within rtol 1e-12 (bitwise {bitwise})")


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_worker(rank: int, world: int, port: int, out: str) -> None:
    """One rank of phase 9's multi-rank run (torch.multiprocessing): NCCL
    over the cards, the quadrotor oracle set split over the ranks, gathered;
    rank 0 saves T* and J*."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.parallel import distributed
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    distributed.initialize("cuda")
    system, mk = get_system("Quadrotor")
    probs = oracle_problems(system, mk, B_ORACLE, torch.device("cpu"))
    lo, hi = distributed.process_batch_bounds(B_ORACLE)
    local = probs.replace(**{f: t[lo:hi] for f, t in probs.tensors().items()})
    res = distributed.gather_results(distributed.solve_batch_global(
        system, local, options=SolveOptions(max_iter=MAX_ITER, psd_levels=1)))
    if rank == 0:
        np.savez(out, T_star=res.T_star, T_ties=res.T_ties, J_star=res.J_star, X=res.X, U=res.U)
    distributed.sync_processes()
    torch.distributed.destroy_process_group()


def phase_scaleout(device) -> dict:
    """Phase 9: parallel/ on the card. The batch over a mesh of every card
    (solve_batch_sharded against solve_batch on the quadrotor and PointMass
    oracle sets), the terminal queries over the cards
    (propagator_select_sharded against propagator_select, rtol 1e-12; at
    float32 on the float32 first iterate, bitwise), then
    torch.distributed in this process at world size 1 with NCCL:
    solve_batch_global + gather_results against the same solve, the
    statistics against their local values (exactly), the runner with
    --distributed against the runner without it (T* identical); with two
    or more cards one NCCL rank a card as well. Returns the launch
    counts."""
    import csv
    import tempfile
    import types

    import torch
    import torch.multiprocessing as mp
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import _build
    from timeopt_tpu_torch.ops.wrap import wrap_error
    from timeopt_tpu_torch.parallel import (batch_summary, distributed, make_mesh, propagator_select_sharded,
                                            solve_batch_sharded, t_star_histogram)
    from timeopt_tpu_torch.runner import run_suite
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import propagator_select
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    cards = torch.cuda.device_count()
    mesh = make_mesh()
    log(f"[scale-out] {cards} card(s): dp mesh {mesh.shape}")
    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    total = {name: 0 for name in _counted()}

    def count(c: dict) -> None:
        for name, v in c.items():
            total[name] += v

    solved = {}
    for case in ("Quadrotor", "PointMass_Navigation"):
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_ORACLE, device)
        solve = {"sharded": lambda: solve_batch_sharded(system, probs, options=opts, mesh=mesh),
                 "one card": lambda: solve_batch(system, probs, options=opts)}
        for fn in solve.values():
            fn()  # builds the programs: one a card, and the whole batch's
        torch.cuda.synchronize()
        secs, res = {kind: [] for kind in solve}, {}
        for kind in ("sharded", "one card", "one card", "sharded"):
            reset_launches()
            t0 = time.perf_counter()
            res[kind] = solve[kind]()
            torch.cuda.synchronize()
            secs[kind].append(time.perf_counter() - t0)
            if kind == "sharded":
                c = launches()
        got, want = res["sharded"], res["one card"]
        select = "lft_select" if system.extra_cost is None else "lft_select_generic"
        for name in (select, "backward", "linesearch"):
            require(c[name] > 0, f"solve_batch_sharded {case}: kernel {name} was never launched")
        count(c)
        check_same_solve(got, want, f"solve_batch_sharded ({case} B={B_ORACLE}, {cards} card(s), captured, every "
                                    f"card's step replayed before any done check) vs solve_batch; in turns sharded / "
                                    f"one card / one card / sharded {1e3 * secs['sharded'][0]:.1f} / "
                                    f"{1e3 * secs['one card'][0]:.1f} / {1e3 * secs['one card'][1]:.1f} / "
                                    f"{1e3 * secs['sharded'][1]:.1f} ms", exact=True)
        solved[case] = (system, probs, want)

    system, probs, _ = solved["Quadrotor"]
    X, U, A, Bj = first_iterate(system, probs)
    Tm = probs.T_max
    blk = build_augmented(system, probs, X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], Bj[:, :Tm])
    C = build_terminal_factors(probs, X[:, : Tm + 1], s=blk.s)
    hs = make_mesh(axis_names=("dp", "hs"), shape=(1, cards))
    for mode in ("sequential", "associative"):
        want = propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, scan_mode=mode)
        reset_launches()
        got = propagator_select_sharded(blk, C, hs, scan_mode=mode)
        torch.cuda.synchronize()
        c = launches()
        for name in (("lft_scan",) if mode == "sequential" else ()) + ("lft_query",):
            require(c[name] > 0, f"propagator_select_sharded {mode}: kernel {name} was never launched")
        count(c)
        rel = ((got - want).abs() / want.abs()).max().item()
        log(f"[scale-out] propagator_select_sharded (Quadrotor B={B_ORACLE} first iterate, scan_mode={mode}, hs over "
            f"{cards} card(s)) vs propagator_select: max rel err {rel:.3e} (bound 1e-12), bitwise "
            f"{bool(torch.equal(got, want))} | launches {c}")
        require(within(got, want, 1e-12, 0.0), f"propagator_select_sharded {mode}: rel err {rel:.3e} > 1e-12")
    # at float32: the float32 blocks of the float32 problems' first iterate,
    # float64 prefixes and float32 C sent to the cards, float32 J back
    probs32 = _build.cast(probs, torch.float32)
    X, U, A, Bj = first_iterate(system, probs32)
    blk = build_augmented(system, probs32, X[:, : Tm + 1], U[:, :Tm], A[:, :Tm], Bj[:, :Tm])
    C = build_terminal_factors(probs32, X[:, : Tm + 1], s=blk.s)
    require(blk.A_aug.dtype == C.dtype == torch.float32, "propagator_select_sharded float32: blocks not float32")
    for mode in ("sequential", "associative"):
        want = propagator_select(blk.A_aug, blk.B_aug, blk.Q_aug, blk.R_inv, C, scan_mode=mode)
        reset_launches()
        got = propagator_select_sharded(blk, C, hs, scan_mode=mode)
        torch.cuda.synchronize()
        c = launches()
        for name in (("lft_scan",) if mode == "sequential" else ()) + ("lft_query",):
            require(c[name] > 0, f"propagator_select_sharded float32 {mode}: kernel {name} was never launched")
        count(c)
        same = got.dtype == want.dtype == torch.float32 and bool(torch.equal(got.view(torch.int32),
                                                                             want.view(torch.int32)))
        log(f"[scale-out] propagator_select_sharded float32 (Quadrotor B={B_ORACLE} float32 first iterate, "
            f"scan_mode={mode}, hs over {cards} card(s)) vs propagator_select float32: bitwise {same} | launches {c}")
        require(same, f"propagator_select_sharded float32 {mode}: not bitwise equal to propagator_select")

    system, probs, want = solved["Quadrotor"]
    errs = wrap_error(want.X[torch.arange(B_ORACLE, device=device), want.T_star] - probs.xg, probs.wrap_mask).norm(dim=-1)
    hist_local = t_star_histogram(want.T_star, probs.T_max)
    summ_local = batch_summary(want.J_star, errs)
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        distributed.initialize("cuda")
        require(distributed.is_initialized() and torch.distributed.get_backend() == "nccl",
                "torch.distributed: not initialized with NCCL")
        reset_launches()
        lo, hi = distributed.process_batch_bounds(B_ORACLE)
        local = probs.replace(**{f: t[lo:hi] for f, t in probs.tensors().items()})
        got = distributed.gather_results(distributed.solve_batch_global(system, local, options=opts))
        c = launches()
        for name in ("lft_select", "backward", "linesearch"):
            require(c[name] > 0, f"solve_batch_global: kernel {name} was never launched")
        count(c)
        check_same_solve(got, want, f"solve_batch_global + gather_results (NCCL, world size "
                                    f"{distributed.process_count()}, slice [{lo}, {hi}))")
        hist = t_star_histogram(want.T_star, probs.T_max)
        summ = batch_summary(want.J_star, errs)
        require(torch.equal(hist, hist_local) and all(torch.equal(summ[k], summ_local[k]) for k in summ),
                "t_star_histogram / batch_summary under NCCL differ from their local values")
        log(f"[scale-out] t_star_histogram and batch_summary all-reduced under NCCL equal their local values: "
            f"{int(hist.sum())} T*, n {int(summ['n'])}, n_success {int(summ['n_success'])}, success_rate "
            f"{float(summ['success_rate'])!r}")
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["--cases", "DoubleIntegrator", "--trials", "5", "--solvers", "ourmethod,baseline1"]
            reset_launches()
            run_suite.main(argv + ["--distributed", "--outdir", os.path.join(tmp, "dist")])
            c = launches()
            for name in ("lft_select", "backward", "linesearch"):
                require(c[name] > 0, f"runner --distributed: kernel {name} was never launched")
            count(c)
            run_suite.main(argv + ["--outdir", os.path.join(tmp, "single")])
            rows = {}
            for k in ("dist", "single"):
                with open(os.path.join(tmp, k, "summary_all.csv"), newline="") as f:
                    rows[k] = [(r["solver"], r["trial"], r["T_star"]) for r in csv.DictReader(f)]
            require(rows["dist"] == rows["single"], f"runner --distributed T* {rows['dist']} vs {rows['single']}")
            log(f"[scale-out] runner --distributed (NCCL, DoubleIntegrator 5 trials, ourmethod,baseline1): T* "
                f"identical to the runner without it on all {len(rows['dist'])} rows | launches {c}")
    finally:
        if distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if cards >= 2:
        with tempfile.TemporaryDirectory() as tmp:
            out = os.path.join(tmp, "ranks.npz")
            t0 = time.perf_counter()
            mp.spawn(_rank_worker, args=(cards, _free_port(), out), nprocs=cards, join=True)
            z = np.load(out)
            check_same_solve(types.SimpleNamespace(**z), want, f"{cards} NCCL ranks (torch.multiprocessing, one a "
                                                               f"card, {time.perf_counter() - t0:.1f} s), gathered")
    else:
        log("[scale-out] one card: the multi-rank path was covered only on the CPU under gloo "
            "(tests/test_torch_parallel.py) and is not gated here")
    return total


# Phase 10, float32 (float32 in device memory, float64 in the kernels'
# registers). Each kernel's float32 instantiation against its plain version
# (float64 arithmetic on the same float32 inputs, one rounding on the way
# out): where the two agree to ~1e-10 in float64 (phase 3's bounds) and
# each rounds to float32 once (an ulp is 1.2e-7 relative), J within F32_REL
# relative (F32_SELECT_BOUND) with argmin T* equal or tied within F32_REL; X, U and J of the
# line search within F32_REL / F32_ATOL elementwise (the one-pass rows per
# rollout, on the accepted alphas); kappa and K within F32_REL of each
# problem's largest entry (a gain near zero carries the absolute error of
# the terms that sum to it, as BACKWARD_NORM_B1024 reads in float64), ok
# identical.
F32_REL = 3e-7
F32_ATOL = 1e-12
# The selects at float32, read as SELECT_BOUND: the quadrotor within
# F32_REL. On PointMass the plain version's explicit inverses lose digits
# at the zero position weights, as SELECT_BOUND says of float64 (there the
# pair reads 4.85e-4 normwise, 1.15e-3 elementwise; PERF.md section 6); at
# the float32 path's q_reg 1e-5 the first reading on the card was 1.04e-5
# normwise (9.3e-5 elementwise; argmin equal on all 1,024), and the bound
# is 10 times that. The plain version computed in float32 arithmetic (no
# upcast) is the reading above it: 57 normwise on the CPU, printed on the
# card. Which side loses the digits is read against a long-double witness
# of the kernel's math on the same float32 inputs (witness_select, every
# problem): the kernel's order run in float64 on the CPU reads 1.04e-7
# relative off it before its rounding to float32 and 1.01e-7 after, the
# plain version 5.0e-5 (PERF.md section 6). The kernel's J must be within
# F32_WITNESS_REL of the witness's, 10 times that CPU reading, with its
# argmin T* tied within F32_REL; the plain version would fail it.
F32_SELECT_BOUND = {"Quadrotor": ("rel", F32_REL), "PointMass_Navigation": ("norm", 1e-4)}
F32_WITNESS_REL = 1e-6
# The JAX package's float32 pipeline on a TPU: its T* for the same 128
# problems of each oracle set; the port's float32 solve must score
# exact-or-tied no lower against results/oracle_f64*.npz.
F32_ARTIFACT = "oracle_f32_dense"
F32_RUNNER_CASES = ("DoubleIntegrator", "Quadrotor")
TPU_F32_CSV = os.path.join(ROOT, "results", "tpu_f32", "summary_all.csv")
# bench.py's output keys, which bench_torch.py's one line must have
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "batch", "pipeline", "batch_time_s", "success_rate",
              "T_star_median")


def phase_f32_kernels(device) -> dict:
    """Phase 10 (a): the four kernels' float32 instantiations against their
    plain versions at phase 3's shapes, on the float32 first iterates of
    the oracle problem sets at B=1024: the fused select, the backward (at
    the plain select's T*), the line search and the line search from start
    states (the one-pass method's rollouts, 3 x 1024) on the quadrotor
    (N=160); the generic select and the backward on PointMass (N = T_max =
    220 for the select). Each timed as phase 3 times it, with its bound at
    float32 bytes (ops/work.py, itemsize 4). Returns the numbers by kernel."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import cuda_forward, work
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    f32 = torch.float32
    opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
    out, iters = {}, {}
    for case, name in (("Quadrotor", "lft_select"), ("PointMass_Navigation", "lft_select_generic")):
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_FULL, device, f32)
        X, U, A, Bj = first_iterate(system, probs)
        kernel, plain, s = select_pair(system, probs, opts, X, U, A, Bj)
        J_k, J_p = kernel(), plain()
        torch.cuda.synchronize()
        require(J_k.dtype == J_p.dtype == f32 and X.dtype == A.dtype == f32, f"{name} float32: dtypes")
        err, T_p = check_select(J_k, J_p, s, probs, F32_SELECT_BOUND[case], f"{name} float32 ({case} B={B_FULL})",
                                tie=F32_REL)
        if name == "lft_select_generic":
            witness_f32_select(system, probs, opts, X, U, A, Bj, J_k, J_p, s, f"{name} float32 ({case} B={B_FULL})")
        b2b, ms, pms = device_ms(kernel), cuda_ms(kernel, reps=5), cuda_ms(plain, reps=3)
        count = work.select_fused if name == "lft_select" else work.select_generic
        out[name] = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                         **count(B_FULL, probs.N, system.n, system.m, probs.T_min, itemsize=4))
        log(f"[float32] {name}: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")
        iters[case] = (system, probs, X, U, A, Bj, T_p)
    for case, (system, probs, X, U, A, Bj, T_p) in iters.items():
        bw_args = backward_args(system, probs, X, U, A, Bj, T_p, opts.lm_init)
        _, plain_out, nums = check_backward(bw_args, f"backward float32 ({case} B={B_FULL})", timed=True,
                                            norm=F32_REL, witness=False)
        nums.update(work.backward(T_p.tolist(), probs.N, system.n, system.m, itemsize=4))
        if case == "Quadrotor":
            out["backward"] = nums
            kap_p, K_p, _ = plain_out
            require(K_p.dtype == f32, "backward float32: K is not float32")
        else:
            out["backward"]["pointmass"] = nums

    system, probs, X, U, A, Bj, T_p = iters["Quadrotor"]
    ls_args = (system, probs, X, U, K_p, kap_p, T_p, opts.alphas)
    err = check_linesearch(*ls_args, f"line search float32 (Quadrotor B={B_FULL})", gate_all=True, rtol=F32_REL,
                           atol=F32_ATOL)
    b2b = device_ms(lambda: cuda_forward.linesearch(*ls_args))
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args), reps=3)
    out["linesearch"] = dict(max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
                             **work.linesearch(system.name, T_p.tolist(), probs.N, system.n, system.m,
                                               len(opts.alphas), itemsize=4))
    log(f"[float32] line search: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, plain {pms:.3f} ms")

    ls_args, x_start, J_prev = onepass_rollout_args(system, probs, X, U, A, Bj)
    nJ = ls_args[2].shape[0]
    require(x_start.dtype == f32, "one-pass rollouts float32: start states are not float32")
    err = check_onepass_rollout(ls_args, x_start, J_prev, f"line search float32 from start states (one-pass "
                                                          f"rollouts, Quadrotor {nJ} = 3 x {B_FULL})",
                                rtol=F32_REL, atol=F32_ATOL)
    b2b = device_ms(lambda: cuda_forward.linesearch(*ls_args, x_start=x_start))
    ms = cuda_ms(lambda: cuda_forward.linesearch(*ls_args, x_start=x_start), reps=5)
    pms = cuda_ms(lambda: cuda_forward.linesearch_plain(*ls_args, x_start=x_start), reps=1)
    out["linesearch"]["onepass_rollout"] = dict(
        rollouts=nJ, alphas=len(ls_args[-1]), max_abs_err=err, ms=ms, ms_back_to_back=b2b, plain_ms=pms,
        **work.linesearch(system.name, ls_args[6].tolist(), ls_args[2].shape[1] - 1, system.n, system.m,
                          len(ls_args[-1]), x_start=True, itemsize=4))
    log(f"[float32] line search from start states: kernel {ms:.3f} ms one call, {b2b:.3f} ms back to back, "
        f"plain {pms:.3f} ms")
    out.update(f32_scan_query(*iters["Quadrotor"][:6]))
    return out


def bitwise(a, b) -> bool:
    """a and b of one dtype, equal bit for bit (NaNs included)."""
    import torch

    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.dtype == b.dtype and bool(torch.equal(a.contiguous().view(bits), b.contiguous().view(bits)))


def f32_scan_query(system, probs, X, U, A, Bj, levels: int = 2) -> dict:
    """Phase 10 (a), the unfused select's kernels at float32 on the float32
    blocks of (X, U, A, B) at consistency_check's levels 2, as phase 3:
    - the scan's float32 entry (float64 prefixes) against its plain version
      through phase 3's gate of the chain, SCAN_QUERY_FIRST_BOUND on J in
      float64 (the query's float64 entry on each side's prefixes, C
      upcast), E, F, G normwise printed;
    - the query's float32 entry on the plain prefixes against the plain
      query, within F32_REL (phase 3's QUERY_BOUND, then one rounding);
    - each against its own float64 entry on the upcast inputs, bit for bit:
      the prefixes, and J the float64 J rounded once (float32 to float64 is
      exact and the arithmetic is the same code);
    - both entries of each timed in turns (float32, float64, float64,
      float32), with their bounds at float32 bytes (ops/work.py).
    Returns the float32 entries' numbers by kernel."""
    import torch
    from timeopt_tpu_torch.ops import cuda_lft_query, cuda_lft_scan, work
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb

    f32, f64 = torch.float32, torch.float64
    Bsz = probs.batch
    blk = build_augmented(system, probs, X, U, A, Bj, psd_levels=levels)
    C = build_terminal_factors(probs, X, s=blk.s).contiguous()
    args = [t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)]
    require(all(t.dtype == f32 for t in (*args, C)), "scan+query float32: the blocks are not float32")
    args64, C64 = [t.double() for t in args], C.double()
    pre_k = cuda_lft_scan.lft_scan(*args, levels=levels)
    pre_p = cuda_lft_scan.lft_scan_plain(*args, levels=levels)
    pre_64 = cuda_lft_scan.lft_scan(*args64, levels=levels)
    J_k = cuda_lft_query.lft_query(*pre_k, C, levels=levels)
    J_64 = cuda_lft_query.lft_query(*pre_k, C64, levels=levels)
    J_kq = cuda_lft_query.lft_query(*pre_p, C, levels=levels)
    J_p = cuda_lft_query.lft_query_plain(*pre_p, C, levels=levels)
    J_p64 = cuda_lft_query.lft_query_plain(*pre_p, C64, levels=levels)
    torch.cuda.synchronize()
    require(all(t.dtype == f64 for t in pre_k) and J_k.dtype == J_kq.dtype == J_p.dtype == f32,
            "scan+query float32: the prefixes are not float64 or J not float32")
    label = f"(Quadrotor B={Bsz}, float32 first iterate, levels {levels})"
    efg = [normwise(k, p, f"lft_scan float32 {label}") for k, p in zip(pre_k, pre_p)]
    log(f"[float32] lft_scan {label}: prefixes (float64) vs the plain scan's normwise E {efg[0]:.3e}, F {efg[1]:.3e}, "
        f"G {efg[2]:.3e}")
    scan_err, _ = check_select(J_64, J_p64, blk.s, probs, SCAN_QUERY_FIRST_BOUND,
                               f"lft_scan float32 {label}: the chain's J in float64 vs the plain chain's",
                               inf_below=False)
    q_err, _ = check_select(J_kq, J_p, blk.s, probs, ("rel", F32_REL),
                            f"lft_query float32 {label} on the plain prefixes vs the plain query", inf_below=False,
                            tie=F32_REL)
    same_scan = all(bitwise(a, b) for a, b in zip(pre_k, pre_64))
    same_query = bitwise(J_k, J_64.float())
    log(f"[float32] {label}: lft_scan_f32 prefixes bitwise the float64 entry's on the upcast blocks: {same_scan} "
        f"(max |diff| {max(max_err(a, b)[0] for a, b in zip(pre_k, pre_64)):.3e}); lft_query_f32 J bitwise the "
        f"float64 entry's J rounded once: {same_query}")
    require(same_scan and same_query, f"scan+query float32 {label}: not bitwise the float64 entries on upcast inputs")

    calls = {"lft_scan": (lambda: cuda_lft_scan.lft_scan(*args, levels=levels),
                          lambda: cuda_lft_scan.lft_scan(*args64, levels=levels),
                          lambda: cuda_lft_scan.lft_scan_plain(*args, levels=levels)),
             "lft_query": (lambda: cuda_lft_query.lft_query(*pre_k, C, levels=levels),
                           lambda: cuda_lft_query.lft_query(*pre_k, C64, levels=levels),
                           lambda: cuda_lft_query.lft_query_plain(*pre_k, C, levels=levels))}
    count = {"lft_scan": work.lft_scan, "lft_query": work.lft_query}
    out = {}
    for name, (k32, k64, plain) in calls.items():
        t = {"f32": [], "f64": [], "f32_one_call": [], "f64_one_call": []}
        for tag in ("f32", "f64", "f64", "f32"):
            fn = k32 if tag == "f32" else k64
            t[tag].append(device_ms(fn))
            t[tag + "_one_call"].append(cuda_ms(fn, reps=5))
        pms = cuda_ms(plain, reps=3)
        out[name] = dict(max_abs_err=scan_err if name == "lft_scan" else q_err, ms=statistics.mean(t["f32_one_call"]),
                         ms_back_to_back=statistics.mean(t["f32"]), plain_ms=pms,
                         float64_entry_ms=statistics.mean(t["f64_one_call"]),
                         float64_entry_ms_back_to_back=statistics.mean(t["f64"]),
                         **count[name](Bsz, probs.N, system.n, itemsize=4))
        log(f"[float32] {name} {label}, back to back in turns: float32 {t['f32'][0]:.3f} / float64 {t['f64'][0]:.3f} / "
            f"float64 {t['f64'][1]:.3f} / float32 {t['f32'][1]:.3f} ms; one call: {t['f32_one_call'][0]:.3f} / "
            f"{t['f64_one_call'][0]:.3f} / {t['f64_one_call'][1]:.3f} / {t['f32_one_call'][1]:.3f} ms; plain "
            f"{pms:.3f} ms | {smi()}")
    return out


def witness_f32_select(system, probs, opts, X, U, A, Bj, J_k, J_p, s, label: str) -> None:
    """The float32 generic select's two readings around F32_SELECT_BOUND
    and its witness: the plain version computed in float32 arithmetic
    against the plain version (float64 inside), printed as the reading above
    the bound; then kernel and plain against the long-double witness on
    every problem (witness_select: F32_WITNESS_REL, argmin tied within
    F32_REL), with the float32-arithmetic plain version's distance to the
    witness printed beside them."""
    import torch
    from timeopt_tpu_torch.ops.precision import no_tf32
    from timeopt_tpu_torch.solver.horizon import select_generic_plain
    from timeopt_tpu_torch.solver.ilqr import select_inputs

    _, args, _ = select_inputs(system, probs, opts, X, U, A, Bj)
    with no_tf32():
        J_32 = select_generic_plain(*args)
    require(J_32.dtype == torch.float32, f"{label}: the float32-arithmetic plain version is not float32")
    t = probs.T_min - 1

    def reading(J, ref):
        d = (J[:, t:].double() - ref[:, t:]).abs().nan_to_num(float("inf"))
        return (d / ref[:, t:].abs()).max().item(), (d.amax(1) / ref[:, t:].abs().amax(1)).max().item()

    up = reading(J_32, J_p.double())
    log(f"[float32] {label}: the plain version in float32 arithmetic against the plain version (float64 inside): "
        f"max rel err {up[0]:.3e}, normwise {up[1]:.3e} (the reading above F32_SELECT_BOUND "
        f"{F32_SELECT_BOUND['PointMass_Navigation']})")
    J_w = witness_select(args, J_k, J_p, s, probs, label, rel=F32_WITNESS_REL, tie=F32_REL)
    w32 = reading(J_32, J_w)
    log(f"[float32] {label}: the plain version in float32 arithmetic against the long-double witness: max rel err "
        f"{w32[0]:.3e}, normwise {w32[1]:.3e}")


def f32_artifact_tied(case: str) -> int:
    """Exact-or-tied of the JAX package's float32 T* (results/
    oracle_f32_dense*.npz) against the float64 oracle, by score's rule."""
    suffix = "" if case == "Quadrotor" else f"_{case}"
    T32 = np.load(os.path.join(ROOT, "results", f"{F32_ARTIFACT}{suffix}.npz"))["T"].astype(np.int64)
    orc = load_oracle(case)
    exact, tied = score(T32, orc["T"].astype(np.int64), orc["J_curve"], oracle_w(case))
    return int((exact | tied).sum())


def phase_f32_oracle(case: str, device) -> dict:
    """Phase 10 (b): the case's 128 oracle problems as float32 problems
    (oracle_problems' perturbation, then rounded), solved on the card,
    scored against the float64 oracle: exact-or-tied no lower than the JAX
    package's float32 pipeline scores (f32_artifact_tied), each kernel of
    the case's path launched. Returns the launch counts."""
    import torch
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    o = solve_oracle_set(case, device, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1),
                         dtype=torch.float32)
    require(o["res"].X.dtype == o["res"].J_star.dtype == torch.float32, f"float32 oracle {case}: results not float32")
    counts, Bo = o["counts"], len(o["T_o"])
    select = "lft_select" if o["system"].extra_cost is None else "lft_select_generic"
    for name in (select, "backward", "linesearch"):
        require(counts[name] > 0, f"float32 oracle solve {case}: kernel {name} was never launched")
    tied, want = int(o["tied"].sum()), f32_artifact_tied(case)
    log(f"[float32] oracle {case} B={Bo}: T* exact {int(o['exact'].sum())}/{Bo}, exact-or-tied {tied}/{Bo} (the JAX "
        f"float32 pipeline's {F32_ARTIFACT}: {want}/{Bo}; this port in float64, phase 4: {ORACLE_TIED.get(case)}/{Bo}) "
        f"| J* rel gap median {np.median(o['gap']):.3e} max {o['gap'].max():.3e} | success@0.5 {o['succ']:.3f} | "
        f"{o['note']} | launches {counts}")
    bad = np.nonzero(~o["tied"])[0]
    if len(bad):
        log(f"[float32] oracle {case} not tied: idx {bad.tolist()} T* {o['T'][bad].tolist()} oracle "
            f"{o['T_o'][bad].tolist()}")
    require(tied >= want, f"float32 oracle {case}: exact-or-tied {tied}/{Bo} < the JAX float32 pipeline's {want}")
    if case in PREFIX_ROUNDING_CPU:
        prefix_rounding(o["system"], o["probs"], o["res"])
    return counts


# The largest relative change of J(T), T >= T_min, when the float64
# prefixes are rounded to float32 before the query (prefix_rounding), read
# on the CPU with the plain versions on 8 float32 oracle problems of each
# system at the final iterate of their float32 solve: why the float32 path
# keeps its prefixes in float64 (PERF.md section 6).
PREFIX_ROUNDING_CPU = {"Segway_Balance": 2.2e-2, "Quadrotor": 1.4e-5}


def prefix_rounding(system, probs, res) -> None:
    """Diagnostic, not gated: the blocks of the float32 solve's final
    iterate built in float64 (the float32 select's q_reg, psd_levels 1),
    their prefixes by the scan kernel, then J by the query kernel's float64
    entry twice, on the prefixes and on the prefixes rounded to float32;
    prints the largest relative change of J(T), T >= T_min."""
    import torch
    from timeopt_tpu_torch.ops import _build, cuda_lft_query, cuda_lft_scan
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, resolve_q_reg
    from timeopt_tpu_torch.solver.linearize import linearize

    Tm, f64 = probs.T_max, torch.float64
    p64 = _build.cast(probs, f64)
    X, U = res.X[:, : Tm + 1].double(), res.U[:, :Tm].double()
    A, Bj = linearize(system.step, X, U)
    q_reg = resolve_q_reg(SolveOptions(), torch.float32)
    blk = build_augmented(system, p64, X, U, A, Bj, q_reg=q_reg, psd_levels=1)
    C = build_terminal_factors(p64, X, s=blk.s).contiguous()
    pre = cuda_lft_scan.lft_scan(*(t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug)),
                                 levels=1)
    J = cuda_lft_query.lft_query(*pre, C, levels=1)[:, probs.T_min - 1 :]
    J_r = cuda_lft_query.lft_query(*(t.float().double() for t in pre), C, levels=1)[:, probs.T_min - 1 :]
    change = ((J_r - J).abs() / J.abs()).max().item()
    log(f"[float32] diagnostic {system.name} B={probs.batch}: J(T) change from rounding the float64 prefixes to "
        f"float32 (blocks in float64 at the float32 final iterates, q_reg {q_reg:g}, levels 1): max rel "
        f"{change:.3e} (the CPU's reading on 8 problems: {PREFIX_ROUNDING_CPU[system.name]:.1e})")


# Phase 10 (b)'s float32 modes: each oracle set as float32 problems solved
# through the scan and query kernels' float32 entries (the inverse query
# with the sequential scan) or the plain latency-mode scans and the query.
F32_MODES = (("inverse", dict(terminal_mode="inverse")), ("associative", dict(scan_mode="associative")),
             ("assoc_df", dict(scan_mode="assoc_df")))
# The sets of each float32 mode whose captured solve is also run by the
# eager driver and held to it bit for bit: the widest state (n = 12) and
# the extra stage cost. The same comparison runs on all six sets of every
# float64 mode (phases 4, 5, 8 (a)) and of the float32 sequential solve
# (10 (b)); on every set here it would cost ~11 s more of the run.
F32_MODES_EAGER = ("Quadrotor", "PointMass_Navigation")


def phase_f32_modes(device) -> dict:
    """Phase 10 (b), the float32 paths through #9 and #10: each oracle set as
    float32 problems solved in each of F32_MODES, scored against the
    float64 oracle and gated as phase 8 gates its modes, at float32
    resolution (tied_f32: the misses within REFERENCE_MISSES, and
    ASSOC_MISSES for "associative"; PointMass exact-or-tied no lower than
    the JAX float32 pipeline's, as phase 10 (b)'s sequential solve), the
    same mode's float64 score beside (phase 8; the inverse query's from
    phase 5, the quadrotor only); then consistency_check on each result
    (check_consistency: phase 5's CC_NORM_BOUND, its float64 reading
    beside). Returns the launch counts summed over both paths."""
    import torch
    from timeopt_tpu_torch.solver.ilqr import SolveOptions

    total = {name: 0 for name in _counted()}

    def add(c: dict) -> None:
        for name, v in c.items():
            total[name] += v

    for mode, kw in F32_MODES:
        for case in CASES:
            o = solve_oracle_set(case, device, SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1, **kw),
                                 dtype=torch.float32, eager=case in F32_MODES_EAGER)
            counts, Bo = o["counts"], len(o["T_o"])
            require(o["res"].J_star.dtype == torch.float32, f"float32 {mode} {case}: results not float32")
            path = ("lft_scan",) if mode == "inverse" else ("lft_query",)
            for name in path + ("backward", "linesearch"):
                require(counts[name] > 0, f"float32 {mode} {case}: kernel {name} was never launched")
            require(counts["lft_select"] == counts["lft_select_generic"] == 0,
                    f"float32 {mode} {case}: a sequential select kernel was launched")
            add(counts)
            tied = int(o["tied"].sum())
            res32 = tied_f32(o["T"], o["T_o"], load_oracle(case)["J_curve"], oracle_w(case))
            bad = np.nonzero(~res32)[0]
            f64 = MODE_TIED.get((mode, case))
            log(f"[float32] {mode} {case} B={Bo}: T* exact {int(o['exact'].sum())}/{Bo}, exact-or-tied {tied}/{Bo}, at "
                f"float32 resolution {int(res32.sum())}/{Bo} (this mode in float64: "
                f"{f'{f64}/{Bo}' if f64 is not None else 'not run'}) | J* rel gap max "
                f"{o['gap'].max():.3e} | success@0.5 {o['succ']:.3f} | {o['note']} | launches {counts}"
                + (f" | not tied: idx {bad.tolist()} T* {o['T'][bad].tolist()} oracle {o['T_o'][bad].tolist()}"
                   if len(bad) else ""))
            if case == "PointMass_Navigation":
                want = f32_artifact_tied(case)
                require(tied >= want, f"float32 {mode} {case}: exact-or-tied {tied}/{Bo} < the JAX float32 "
                                      f"pipeline's {want}")
            else:
                allowed = set(REFERENCE_MISSES.get(case, ()))
                if mode == "associative":
                    allowed |= set(ASSOC_MISSES.get(case, ()))
                require(set(bad.tolist()) <= allowed, f"float32 {mode} {case}: exact-or-tied at float32 resolution "
                                                      f"{int(res32.sum())}/{Bo}, misses "
                                                      f"{sorted(set(bad.tolist()) - allowed)} beyond the allowed")
            cc_counts, _ = check_consistency(
                o["system"], o["probs"], o["res"].X, o["res"].U, CC_NORM_BOUND[case],
                f"[float32] consistency {mode} {case} B={Bo} (phase 5's float64 reading "
                f"{CC_READ.get(case, float('nan')):.3e})")
            add(cc_counts)
    return total


def phase_bench_torch() -> dict:
    """Phase 10 (c), second half: `python3 bench_torch.py` at its defaults
    (bench.py's configuration: quadrotor, float32, B=1024, dp-sharded over
    every card), its one JSON line echoed here with bench.py's keys checked;
    returns the record."""
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_torch.py")], capture_output=True, text=True,
                          cwd=ROOT, timeout=900)
    for ln in proc.stderr.strip().splitlines()[-4:]:
        log(f"[bench_torch] (stderr) {ln}")
    require(proc.returncode == 0, f"bench_torch.py exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    require(len(lines) == 1, f"bench_torch.py printed {len(lines)} lines on stdout, not one")
    rec = json.loads(lines[0])
    require(tuple(rec) == BENCH_KEYS, f"bench_torch.py's keys {tuple(rec)} are not bench.py's")
    require("float32" in rec["metric"] and "dp-sharded" in rec["metric"] and rec["success_rate"] > 0.0,
            "bench_torch.py: metric or success")
    log(f"[bench_torch] {lines[0]} | {smi()}")
    return rec


def phase_f32_runner() -> dict:
    """Phase 10 (d): the port's runner with --f32 --consistency in-process
    on the card, the double integrator and the quadrotor, 5 trials, the
    three solvers: every row finite (T*, J*, final_err), the kernels
    launched (#9 and #10 by the consistency check), each row's T* printed
    beside the JAX package's float32 run on a TPU
    (results/tpu_f32/summary_all.csv), and each solver's trial-0
    consistency_max_abs finite and no larger than that run's, the
    committed float64 run's (results/cpu_f64_25) beside it. Returns the
    launch counts."""
    import csv
    import tempfile

    from timeopt_tpu_torch.runner import run_suite

    solvers = ("ourmethod", "baseline1", "baseline2")
    with open(TPU_F32_CSV, newline="") as f:
        want = {(r["case"], r["solver"], r["trial"]): r for r in csv.DictReader(f)}
    with open(COMMITTED_CSV, newline="") as f:
        f64_rows = {(r["case"], r["solver"], r["trial"]): r for r in csv.DictReader(f)}
    with tempfile.TemporaryDirectory() as out:
        reset_launches()
        t0 = time.perf_counter()
        run_suite.main(["--cases", ",".join(F32_RUNNER_CASES), "--trials", "5", "--solvers", ",".join(solvers),
                        "--f32", "--consistency", "--outdir", out])
        secs = time.perf_counter() - t0
        counts = launches()
        with open(os.path.join(out, "summary_all.csv"), newline="") as f:
            got = list(csv.DictReader(f))
    require(len(got) == len(F32_RUNNER_CASES) * len(solvers) * 5, f"runner --f32: {len(got)} rows")
    for name in ("lft_select", "backward", "linesearch", "lft_scan", "lft_query"):
        require(counts[name] > 0, f"runner --f32 --consistency: kernel {name} was never launched")
    for r in got:
        fin = all(np.isfinite(float(r[k])) for k in ("J_star", "final_err")) and int(r["T_star"]) > 0
        require(fin, f"runner --f32: {r['case']} {r['solver']} trial {r['trial']} is not finite")
    log(f"[float32] runner --f32 --consistency, {','.join(F32_RUNNER_CASES)} x 5 trials x {solvers}: {secs:.1f} s | "
        f"launches {counts}")
    for case in F32_RUNNER_CASES:
        for sv in solvers:
            rows = [r for r in got if r["case"] == case and r["solver"] == sv]
            mine = " ".join(r["T_star"] for r in rows)
            tpu = " ".join(want[(case, sv, r["trial"])]["T_star"] for r in rows)
            succ = sum(r["success"] == "True" for r in rows)
            log(f"[float32] runner {case} {sv}: T* {mine} | the JAX package's float32 run on a TPU: {tpu} | "
                f"success {succ}/5 | J* trial 0 {float(rows[0]['J_star']):.6g} (TPU "
                f"{float(want[(case, sv, '0')]['J_star']):.6g})")
            cc, tpu_cc = float(rows[0]["consistency_max_abs"]), float(want[(case, sv, "0")]["consistency_max_abs"])
            log(f"[float32] runner {case} {sv}: trial-0 consistency_max_abs {cc!r} (the JAX package's float32 run on "
                f"a TPU: {tpu_cc!r}; the committed float64 run, results/cpu_f64_25: "
                f"{float(f64_rows[(case, sv, '0')]['consistency_max_abs'])!r}), rmse {float(rows[0]['consistency_rmse'])!r}")
            require(np.isfinite(cc) and cc <= tpu_cc, f"runner --f32 --consistency {case} {sv}: trial-0 "
                                                      f"consistency_max_abs {cc!r} is not finite or above {tpu_cc!r}")
    return counts


# Phase 11, the serving entries: bench_torch.py's dp-sharded batch solved in
# place on every card, its B=BIG_BATCH point, and bench_sustained_torch.py's
# stream (its record's keys are the JAX script's, SUSTAINED_RECORD).
BIG_BATCH = 8192
BIG_J_RTOL = 1e-5
SUSTAINED_S = "10"
SUSTAINED_RECORD = os.path.join(ROOT, "results", "bench_sustained_r05.json")


def sync_cards() -> None:
    import torch

    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def host_rows(results: list, field: str, rows: int) -> np.ndarray:
    """The first `rows` rows of a field of per-card results, on the host in
    batch order (only the cards that hold them are read)."""
    import torch

    out, have = [], 0
    for r in results:
        if have >= rows:
            break
        out.append(getattr(r, field)[: rows - have].cpu())
        have += out[-1].shape[0]
    return torch.cat(out).numpy()


def phase_serving(device) -> dict:
    """Phase 11 (a) and (b): the serving entry of bench_torch.py on every
    card. (a) bench_problems("Quadrotor", 1024, 0) split by shard_problems
    over make_mesh() and solved in place (solve_batch_resident): one program
    built a card, and each card's result bitwise the solve_batch of its own
    chunk on its card. (b) the B=BIG_BATCH set, whose first 1024 x0 rows are
    (a)'s bit for bit, solved the same way: one more program a card, its
    rows 0-1023 with (a)'s T* equal or tied at float32 resolution (tied_f32
    on (a)'s own J curve) and J* within BIG_J_RTOL where T* is equal; the
    largest J* difference and bitwise equality printed, with each new
    program's warm-up, capture and pool. Returns the launch counts."""
    import torch

    import bench_torch
    from timeopt_tpu_torch.parallel import make_mesh, shard_problems, solve_batch_resident
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, solve_batch

    cards = torch.cuda.device_count()
    mesh = make_mesh()
    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    total = {name: 0 for name in _counted()}
    system, probs = bench_torch.bench_problems("Quadrotor", B_FULL, 0)

    def solve_counted(parts, label: str) -> tuple:
        """The resident solve of `parts` twice: the first call builds any
        program it needs, the second is timed and its launches counted."""
        before = compiled.programs()
        t0 = time.perf_counter()
        solve_batch_resident(system, parts, options=opts)
        sync_cards()
        first_s = time.perf_counter() - t0
        built = [p for p in compiled.programs() if not any(p is q for q in before)]
        require(len(built) == cards, f"{label}: {len(built)} programs built for {cards} card(s)")
        reset_launches()
        t0 = time.perf_counter()
        res = solve_batch_resident(system, parts, options=opts)
        sync_cards()
        secs = time.perf_counter() - t0
        c = launches()
        for name in ("lft_select", "backward", "linesearch"):
            require(c[name] > 0, f"{label}: kernel {name} was never launched")
        for name, v in c.items():
            total[name] += v
        require(len(res) == cards and all(r.T_star.device == p.x0.device for r, p in zip(res, parts)),
                f"{label}: not one result a card, on its card")
        return res, built, first_s, secs, c

    parts = shard_problems(probs, mesh)
    res, built, first_s, secs, c = solve_counted(parts, f"resident B={B_FULL}")
    for i, (p, r) in enumerate(zip(parts, res)):
        want = solve_batch(system, p, options=opts)
        diff = differing(r, want)
        require(not diff, f"resident B={B_FULL}: card {i}'s result differs from solve_batch of its chunk in {diff}")
    require(len(compiled.programs()) == cards, f"resident B={B_FULL}: the chunks' own solves built programs")
    log(f"[serving] (a) solve_batch_resident, bench_torch's quadrotor set B={B_FULL} float32 over {cards} card(s) "
        f"({[p.batch for p in parts]} a card): {cards} program(s) built, each card's result bitwise solve_batch of "
        f"its chunk on its card (every field) | first call {first_s:.2f} s, then {secs:.3f} s = "
        f"{B_FULL / secs:.2f} solves/s | launches {c} | {'; '.join(program_line(q) for q in built)} | {smi()}")

    _, probs_big = bench_torch.bench_problems("Quadrotor", BIG_BATCH, 0)
    require(probs_big.x0[:B_FULL].numpy().tobytes() == probs.x0.numpy().tobytes(),
            f"bench_problems: the B={BIG_BATCH} set's first {B_FULL} x0 rows are not the B={B_FULL} set's")
    big_parts = shard_problems(probs_big, mesh)
    big, built, first_s, secs, c = solve_counted(big_parts, f"resident B={BIG_BATCH}")
    T_b, J_b = host_rows(big, "T_star", B_FULL), host_rows(big, "J_star", B_FULL).astype(np.float64)
    T_s, J_s = host_rows(res, "T_star", B_FULL), host_rows(res, "J_star", B_FULL).astype(np.float64)
    curve = host_rows(res, "J_curve", B_FULL).astype(np.float64)
    tied = tied_f32(T_b, T_s, curve, float(probs.w[0]))
    eq = T_b == T_s
    J_rel = np.abs(J_b - J_s)[eq] / np.abs(J_s)[eq]
    bitwise = {f: host_rows(big, f, B_FULL).tobytes() == host_rows(res, f, B_FULL).tobytes()
               for f in ("T_star", "J_star", "X", "U")}
    pools = [q.pool_bytes for q in built]
    log(f"[serving] (b) solve_batch_resident B={BIG_BATCH} float32 over {cards} card(s) "
        f"({[p.batch for p in big_parts]} a card): rows 0-{B_FULL - 1} against (a): T* equal {int(eq.sum())}, "
        f"equal or tied at float32 resolution {int(tied.sum())} of {B_FULL}; J* where T* is equal: max rel diff "
        f"{J_rel.max():.3e} (bound {BIG_J_RTOL:g}), max abs diff {np.abs(J_b - J_s)[eq].max():.3e}; bitwise "
        f"{bitwise} | first call {first_s:.2f} s, then {secs:.3f} s = {BIG_BATCH / secs:.2f} solves/s | launches "
        f"{c} ({cards} card(s)) | pool bytes a card {pools} ({sum(pools) / 2**30:.2f} GiB in all) | "
        f"{'; '.join(program_line(q) for q in built)} | {smi()}")
    require(bool(tied.all()), f"resident B={BIG_BATCH}: T* neither equal nor tied on rows "
                              f"{np.flatnonzero(~tied)[:10].tolist()}")
    require(J_rel.max() <= BIG_J_RTOL, f"resident B={BIG_BATCH}: J* rel diff {J_rel.max():.3e} > {BIG_J_RTOL:g}")
    return total


# Phase 12 (a): the loop condition kernel against its plain version, on
# (B, done pattern) x (it before, max_iter, early_exit, first)
LOOP_COND_B = (1, 37, 8192)
LOOP_COND_DONE = ("none", "all", "last", "random")
LOOP_COND_STEPS = ((0, MAX_ITER, True, True), (0, MAX_ITER, False, True), (0, 0, True, True),
                   (4, MAX_ITER, True, False), (MAX_ITER - 1, MAX_ITER, True, False),
                   (MAX_ITER - 1, MAX_ITER, False, False), (5, MAX_ITER, False, False))


def loop_done(B: int, pattern: str, device):
    """(B,) bool done flags: none, all, all but the last, or random (70%
    done, seeded)."""
    import torch

    d = np.random.default_rng(SEED).random(B) < 0.7 if pattern == "random" else np.full(B, pattern != "none")
    if pattern == "last":
        d[-1] = False
    return torch.as_tensor(d, device=device)


def sync_debug(fn):
    """fn() under torch.cuda.set_sync_debug_mode("error"): any call that
    synchronizes the host with the card (a read to the host, a
    synchronizing copy) raises. Returns (fn's value, host seconds)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        out = fn()
        secs = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return out, secs


def counted_steps(fn) -> tuple:
    """(fn's value, the step bodies it ran): compiled.bodies wrapped, as
    _solve_traced takes it, to count its steps."""
    from timeopt_tpu_torch.solver import compiled

    plain, steps = compiled.bodies, []

    def counted(opts):
        b = plain(opts)
        return compiled.Bodies(b.state, b.init, lambda *a: (steps.append(1), b.step(*a)))

    compiled.bodies = counted
    try:
        return fn(), len(steps)
    finally:
        compiled.bodies = plain


def phase_device_loop(device) -> dict:
    """Phase 12: the device-side outer loop (solver/compiled.py: one
    loop-graph launch a solve, its early exit decided on the card).
    (a) the loop condition kernel (cuda_loop.loop_cond) against its plain
    version on every case of LOOP_COND_B x LOOP_COND_DONE x LOOP_COND_STEPS:
    the four counters bitwise equal; timed at B=1024 (one launch between
    two events, and back to back) beside the plain version; its launches
    here count nowhere. (b) a warmed quadrotor float32 B=1024 solve_batch
    (bench_torch's set) three times under set_sync_debug_mode("error"): no
    call synchronizes, each returns before its solve ends on the card (host
    seconds against the device seconds between two events). (c) four
    solves of four problem sets (seeds 0-3) queued on that one program with
    no sync between them, under the same mode: each result bitwise its own
    set's solve run alone. (d) the quadrotor's oracle problem 0 at B=1,
    float64: the steps on the device counter (CompiledSolve.iterations) the
    steps _solve_traced takes, the result bitwise its. (e) bench_torch's
    B=1024 set split over every card (shard_problems) and solved in place by
    solve_batch_resident under the same mode: no sync, each chunk bitwise its
    own solve_batch. Returns the kernel's numbers for the kernels line."""
    import statistics as st

    import torch

    import bench_torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import cuda_loop, work
    from timeopt_tpu_torch.parallel import make_mesh, shard_problems, solve_batch_resident
    from timeopt_tpu_torch.solver import compiled
    from timeopt_tpu_torch.solver.ilqr import SolveOptions, prepare, solve_batch

    kept = cuda_loop.LAUNCHES  # the comparisons' launches count nowhere
    rows = 0
    for B in LOOP_COND_B:
        for pattern in LOOP_COND_DONE:
            done = loop_done(B, pattern, device)
            for it, max_iter, early, first in LOOP_COND_STEPS:
                start = torch.tensor([it, 1, 3, 17], dtype=torch.int64, device=device)
                got, want = start.clone(), start.clone()
                cuda_loop.loop_cond(done, got, max_iter, early, first)
                cuda_loop.loop_condition(done, want, max_iter, early, first)
                require(torch.equal(got, want), f"loop_cond B={B} done={pattern} it={it} max_iter={max_iter} "
                                                f"early_exit={early} first={first}: {got.tolist()} against the plain "
                                                f"version's {want.tolist()}")
                rows += 1
    done = loop_done(B_FULL, "random", device)
    ctr = cuda_loop.new_counters(device)
    numbers = dict(
        max_abs_err=0.0, rows=rows,
        ms=cuda_ms(lambda: cuda_loop.loop_cond(done, ctr, MAX_ITER, True), reps=20, warmup=3),
        ms_back_to_back=device_ms(lambda: cuda_loop.loop_cond(done, ctr, MAX_ITER, True), reps=20),
        plain_ms=cuda_ms(lambda: cuda_loop.loop_condition(done, ctr, MAX_ITER, True), reps=20, warmup=3),
        bytes=B_FULL + 2 * 4 * 8, flops=B_FULL, bound_by="bytes")
    numbers["bound_ms"] = 1e3 * max(numbers["bytes"] / work.PEAK_BYTES, numbers["flops"] / work.PEAK_FLOPS_CUDA_CORES)
    cuda_loop.LAUNCHES = kept
    log(f"[loop] (a) loop_cond against loop_condition on {rows} cases (B {LOOP_COND_B}, done {LOOP_COND_DONE}): "
        f"every counter bitwise equal | B={B_FULL}: one call {numbers['ms']:.4f} ms, back to back "
        f"{numbers['ms_back_to_back']:.4f} ms, plain {numbers['plain_ms']:.4f} ms, bound {numbers['bound_ms']:.3e} ms "
        f"by bytes ({numbers['bytes']} B)")

    opts = SolveOptions(method="propagator", max_iter=MAX_ITER, psd_levels=1)
    system, mk = get_system("Quadrotor")
    probs = bench_torch.bench_problems("Quadrotor", B_FULL, 0)[1].to(device)
    solve_batch(system, probs, options=opts)
    torch.cuda.synchronize()
    p, U = prepare(probs, None)
    prog = compiled.program(system, opts, p, U)
    calls = []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        (res, host_s) = sync_debug(lambda: (start.record(), solve_batch(system, probs, options=opts), end.record())[1])
        torch.cuda.synchronize()
        calls.append((host_s, start.elapsed_time(end) / 1e3, prog.iterations()))
    require(all(h < d for h, d, _ in calls), f"(b) a solve_batch call took longer on the host than on the card: {calls}")
    numbers["host_s"], numbers["device_s"] = [c[0] for c in calls], [c[1] for c in calls]
    log(f"[loop] (b) warmed solve_batch quadrotor float32 B={B_FULL} under set_sync_debug_mode('error'): no sync; "
        f"host seconds of the call {', '.join(f'{c[0]:.6f}' for c in calls)} against the solve's device seconds "
        f"{', '.join(f'{c[1]:.6f}' for c in calls)}; {calls[0][2]} steps on the device counter | {smi()}")

    sets = [oracle_problems(system, mk, B_FULL, device, torch.float32, seed=seed) for seed in range(4)]
    alone = []
    for q in sets:
        alone.append(solve_batch(system, q, options=opts))
        torch.cuda.synchronize()
    require(len(compiled.programs()) == 1, f"(c) the four sets took {len(compiled.programs())} programs, not one")
    t0 = time.perf_counter()
    queued, host_s = sync_debug(lambda: [solve_batch(system, q, options=opts) for q in sets])
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    for seed, (got, want) in enumerate(zip(queued, alone)):
        diff = differing(got, want)
        require(not diff, f"(c) queued solve of seed {seed} differs from its solve alone in {diff}")
    require(len({float(r.J_star.double().sum()) for r in queued}) == 4, "(c) the four queued results are not four")
    log(f"[loop] (c) four solves of four sets (seeds 0-3, quadrotor float32 B={B_FULL}) queued on one program under "
        f"set_sync_debug_mode('error'): each bitwise its set's solve alone | host {host_s:.6f} s to queue them, "
        f"{total_s:.3f} s until the last ended")

    probs = oracle_problems(system, mk, B_ORACLE, device)
    prob, U1 = prepare(probs.replace(**{f: t[:1].contiguous() for f, t in probs.tensors().items()}), None)
    solve_batch(system, prob, options=opts)
    prog1 = compiled.program(system, opts, prob, U1)
    lat = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = solve_batch(system, prob, options=opts)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    it = prog1.iterations()
    want, steps = counted_steps(lambda: compiled._solve_traced(system, opts, prob, U1))
    diff = differing(res, want)
    require(not diff, f"(d) B=1 captured solve differs from _solve_traced in {diff}")
    require(it == steps, f"(d) B=1: {it} steps on the device counter, _solve_traced took {steps}")
    numbers["b1_ms"], numbers["b1_steps"] = [1e3 * t for t in lat], it
    log(f"[loop] (d) quadrotor oracle problem 0, B=1, float64: {it} steps on the device counter, _solve_traced "
        f"{steps}; bitwise equal; T* {int(res.T_star[0])}; synchronized solves {', '.join(f'{1e3 * t:.2f}' for t in lat)} "
        f"ms (median {1e3 * st.median(lat):.2f}) | {smi()}")

    cards = torch.cuda.device_count()
    parts = shard_problems(bench_torch.bench_problems("Quadrotor", B_FULL, 0)[1], make_mesh())
    solve_batch_resident(system, parts, options=opts)
    sync_cards()
    res, host_s = sync_debug(lambda: solve_batch_resident(system, parts, options=opts))
    sync_cards()
    for i, (q, r) in enumerate(zip(parts, res)):
        diff = differing(r, solve_batch(system, q, options=opts))
        require(not diff, f"(e) card {i}'s chunk differs from its own solve_batch in {diff}")
    log(f"[loop] (e) solve_batch_resident, B={B_FULL} over {cards} card(s) ({[q.batch for q in parts]} a card) under "
        f"set_sync_debug_mode('error'): no sync, host {host_s:.6f} s; each chunk bitwise its own solve_batch")
    return numbers


def phase_sustained(bench_rec: dict) -> None:
    """Phase 11 (c): `python3 bench_sustained_torch.py` with DURATION_S=
    SUSTAINED_S and BIG_BATCH, its one JSON line echoed with its keys
    checked against the JAX script's record (SUSTAINED_RECORD), its
    success rate equal to bench_torch.py's (phase 10 (c): the same problems
    and entry), and its own checks read from its stderr: no program built
    in the stream's window, the last batch's T* and J* bitwise the first's."""
    with open(SUSTAINED_RECORD) as f:
        want = json.load(f)
    env = {k: v for k, v in os.environ.items() if k != "SUS_OUT"}
    env.update(DURATION_S=SUSTAINED_S, BIG_BATCH=str(BIG_BATCH))
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "bench_sustained_torch.py")], capture_output=True,
                          text=True, cwd=ROOT, env=env, timeout=600)
    err = proc.stderr.strip().splitlines()
    for ln in err[-8:]:
        log(f"[sustained] (stderr) {ln}")
    require(proc.returncode == 0, f"bench_sustained_torch.py exited {proc.returncode}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    require(len(lines) == 1, f"bench_sustained_torch.py printed {len(lines)} lines on stdout, not one")
    rec = json.loads(lines[0])
    require(list(rec) == list(want) and list(rec["big_batch"]) == list(want["big_batch"]),
            f"bench_sustained_torch.py's keys {list(rec)} are not those of {SUSTAINED_RECORD}")
    require("float32" in rec["metric"] and rec["big_batch"]["batch"] == BIG_BATCH, "bench_sustained_torch.py: metric")
    require(rec["success_rate"] == bench_rec["success_rate"],
            f"bench_sustained_torch.py success_rate {rec['success_rate']} != bench_torch.py's "
            f"{bench_rec['success_rate']}")
    for check in ("programs built in the stream's window: 0", "last batch's T* and J* bitwise the first's: True"):
        require(check in proc.stderr, f"bench_sustained_torch.py did not report '{check}'")
    log(f"[sustained] {lines[0]} | {smi()}")


class ABRun:
    """What phase_ab's rows share: the two versions' kernels (`kernels`),
    both versions' outputs on one input (`both`), their times in turns
    (`turns`), one row of the table (`row`) and the first iterates of the
    oracle problem sets (`setup`)."""

    def __init__(self, device, old: Path):
        from timeopt_tpu_torch.solver.ilqr import SolveOptions

        self.device, self.old = device, old
        self.opts = SolveOptions(max_iter=MAX_ITER, psd_levels=1)
        self.every = [(c, B_ORACLE) for c in CASES]
        self.cache = {}

    @contextmanager
    def kernels(self, tag):
        """Inside the block the wrappers launch the old kernels for tag
        "old", this checkout's for "new"; a kernel the old sources lack
        (linearize before it existed) runs this checkout's in both. A
        captured solve holds the kernels it was captured with, so the
        programs are dropped on the way in and out: each version's solves
        capture its own."""
        from timeopt_tpu_torch.ops import _build
        from timeopt_tpu_torch.solver import compiled

        load = _build.load
        compiled.clear_compiled()
        if tag == "old":
            _build.load = lambda name: load(name, self.old if (self.old / f"{name}.cu").exists() else _build.CSRC)
        try:
            yield
        finally:
            _build.load = load
            compiled.clear_compiled()

    def both(self, fn, fn_new=None):
        """fn() with the old kernels, then fn_new() (default fn) with the new."""
        import torch

        with self.kernels("old"):
            a = fn()
        b = (fn_new or fn)()
        torch.cuda.synchronize()
        return a, b

    def turns(self, fn, fn_new=None) -> dict:
        """Back-to-back ms (and one-call ms) of old (fn) and new (fn_new,
        default fn), in turns."""
        t = {"old": [], "new": [], "old_one_call": [], "new_one_call": []}
        for tag in ("old", "new", "new", "old"):
            f = (fn_new or fn) if tag == "new" else fn
            with self.kernels(tag):
                t[tag].append(device_ms(f))
                t[tag + "_one_call"].append(cuda_ms(f, reps=5))
        return t

    def row(self, name: str, case: str, BN: tuple, fn, outs, fn_new=None) -> dict:
        """BN: (B, N); outs: the old and the new version's outputs (tuples
        of tensors); fn_new: the new version's call where it differs."""
        import torch

        o, n = outs
        diff = max((max_err(a, b)[0] for a, b in zip(o, n) if a.is_floating_point()), default=0.0)
        same = all(bitwise(a, b) if a.is_floating_point() else bool(torch.equal(a, b)) for a, b in zip(o, n))
        return dict(kernel=name, case=case, B=BN[0], N=BN[1], max_abs_diff=diff, bitwise=same,
                    **{f"{k}_ms": v for k, v in self.turns(fn, fn_new).items()})

    def setup(self, case: str, Bsz: int, dtype=None):
        """(system, probs, X, U, A, Bj, select kernel, its plain version, s,
        the select kernel's T*), in float64 or `dtype` (float32)."""
        from timeopt_tpu_torch.models import get_system
        from timeopt_tpu_torch.solver.cost import argmin_T

        if (case, Bsz, dtype) not in self.cache:
            system, mk = get_system(case)
            probs = oracle_problems(system, mk, Bsz, self.device, dtype)
            X, U, A, Bj = first_iterate(system, probs)
            kernel, plain, s = select_pair(system, probs, self.opts, X, U, A, Bj)
            T = argmin_T(s[:, :1] ** 2 * kernel(), probs.T_min, probs.T_max)
            self.cache[(case, Bsz, dtype)] = (system, probs, X, U, A, Bj, kernel, plain, s, T)
        return self.cache[(case, Bsz, dtype)]

    def f32(self, name: str, entry: str):
        """float32 when the old sources' kernel `name` has the float32 entry
        `entry` (its rows then compare old and new float32 instantiations),
        else None."""
        import torch
        from timeopt_tpu_torch.ops import _build

        return torch.float32 if hasattr(_build.load(name, self.old), entry) else None


def ab_lft_select(ab: ABRun) -> list:
    """Every size tier the kernel instantiates, float64 and float32 where
    the old sources have the float32 entry: the quadrotor at B=1024 (n = 12,
    the registry's tier) and the lander at its cell's size (LANDER, B=1024,
    N=200, the wide tier), each also held against the plain version as
    phases 3 and 3 (c) hold them; every registry system of the fused select
    at B=128 (n <= 4 the narrow tier); and random inputs of OFF_REGISTRY_FUSED
    (a run-time n below the register tile's rows), plain and negated
    (random_fused_args), held against the plain version at rtol 1e-9."""
    import types

    import torch
    from timeopt_tpu_torch.ops import cuda_lft

    f32 = ab.f32("lft_select", "lft_select_fused_f32")
    rows = []
    for case, dtype in [("Quadrotor", None), (LANDER, None)] + ([("Quadrotor", f32), (LANDER, f32)] if f32 else []):
        system, probs, X, U, A, Bj, kernel, plain, s, _ = ab.setup(case, B_FULL, dtype)
        J_o, J_n = ab.both(kernel)
        tag = "" if dtype is None else " float32"
        label = f"ab: new lft_select{tag} vs plain ({case} B={B_FULL} N={probs.N})"
        if case == LANDER:
            hold_lander_select(system, probs, X, U, A, Bj, J_n, plain(), s, label, dtype is not None)
        elif dtype is None:
            check_select(J_n, plain(), s, probs, SELECT_BOUND[case], label)
        else:
            check_select(J_n, plain(), s, probs, F32_SELECT_BOUND[case], label, tie=F32_REL)
        rows.append(ab.row("lft_select", case + tag, (B_FULL, probs.N), kernel, ((J_o,), (J_n,))))
    for case, Bsz in ab.every:
        system, probs, X, U, A, Bj, kernel, plain, s, _ = ab.setup(case, Bsz)
        if system.extra_cost is not None:  # the generic select's
            continue
        J_o, J_n = ab.both(kernel)
        check_select(J_n, plain(), s, probs, SELECT_BOUND[case], f"ab: new lft_select vs plain ({case} B={Bsz})")
        rows.append(ab.row("lft_select", f"{case} (n = {system.n}, tier {cuda_lft.tier(system.n, system.m)})",
                           (Bsz, probs.N), kernel, ((J_o,), (J_n,))))
    for n, m in OFF_REGISTRY_FUSED:  # the run-time-size path of the registry's tier
        for negated in (False, True):
            args = random_fused_args(n, m, B_OFF, N_OFF, ab.device, negated=negated)
            fn = lambda: cuda_lft.propagator_select_fused(*args, t_min=1)  # noqa: E731
            J_o, J_n = ab.both(fn)
            what = f"random n={n} m={m}" + (" negated" if negated else "")
            probs = types.SimpleNamespace(T_min=1, T_max=N_OFF)
            s = torch.ones((B_OFF, N_OFF + 1), dtype=torch.float64, device=ab.device)
            check_select(J_n, cuda_lft.select_fused_plain(*args), s, probs, ("rel", 1e-9),
                         f"ab: new lft_select vs plain ({what})")
            rows.append(ab.row("lft_select", what, (B_OFF, N_OFF), fn, ((J_o,), (J_n,))))
    return rows


def ab_linesearch(ab: ABRun) -> list:
    """The quadrotor at B=1024 and every system at B=128, at the select
    kernel's T*; on each, the new kernel also through its start-state entry
    (start states X[:, 0] as a view of X, then as a copy) against the old
    kernel's ordinary entry."""
    from timeopt_tpu_torch.ops import cuda_backward, cuda_forward

    rows = []
    for case, Bsz in [("Quadrotor", B_FULL)] + ab.every:
        system, probs, X, U, A, Bj, _, _, _, T = ab.setup(case, Bsz)
        kap, K, _ = cuda_backward.backward_truncated_core(*backward_args(system, probs, X, U, A, Bj, T, ab.opts.lm_init))
        args = (system, probs, X, U, K, kap, T, ab.opts.alphas)
        fn = lambda: cuda_forward.linesearch(*args)  # noqa: E731
        outs = ab.both(fn)
        check_linesearch(*args, f"ab: new line search vs plain ({case} B={Bsz})", gate_all=Bsz == B_FULL)
        rows.append(ab.row("linesearch", case, (Bsz, probs.N), fn, outs))
        for how, x0 in (("view", X[:, 0]), ("copy", X[:, 0].clone())):
            fn_new = lambda x0=x0: cuda_forward.linesearch(*args, x_start=x0)  # noqa: E731
            rows.append(ab.row("linesearch", f"{case}, new from x_start = X[:, 0] ({how})", (Bsz, probs.N), fn,
                               ab.both(fn, fn_new), fn_new))
    f32 = ab.f32("linesearch", "linesearch_rollout_from_f32")
    if f32 is not None:  # both entries at float32, the start states X_ext[:, S] of the one-pass rollouts
        system, probs, X, U, A, Bj, _, _, _, T = ab.setup("Quadrotor", B_FULL, f32)
        kap, K, _ = cuda_backward.backward_truncated_core(*backward_args(system, probs, X, U, A, Bj, T, ab.opts.lm_init))
        args = (system, probs, X, U, K, kap, T, ab.opts.alphas)
        fn = lambda: cuda_forward.linesearch(*args)  # noqa: E731
        rows.append(ab.row("linesearch", "Quadrotor float32", (B_FULL, probs.N), fn, ab.both(fn)))
        ls_args, x_start, _ = onepass_rollout_args(system, probs, X, U, A, Bj)
        fn = lambda: cuda_forward.linesearch(*ls_args, x_start=x_start)  # noqa: E731
        rows.append(ab.row("linesearch", "Quadrotor float32, one-pass rollouts from start states",
                           (ls_args[2].shape[0], probs.N), fn, ab.both(fn)))
    return rows


def ab_lft_select_generic(ab: ABRun) -> list:
    """PointMass at B=1024, the assembled blocks of every system at B=128
    (p = 3, 5 and 13) and the random blocks of OFF_REGISTRY_SELECT."""
    from timeopt_tpu_torch.ops import cuda_lft_generic

    system, probs, X, U, A, Bj, kernel, plain, s, _ = ab.setup("PointMass_Navigation", B_FULL)
    J_o, J_n = ab.both(kernel)
    check_select(J_n, plain(), s, probs, SELECT_BOUND["PointMass_Navigation"],
                 f"ab: new lft_select_generic vs plain (PointMass_Navigation B={B_FULL})")
    rows = [ab.row("lft_select_generic", "PointMass_Navigation", (B_FULL, probs.N), kernel, ((J_o,), (J_n,)))]
    for case, Bsz in ab.every:
        system, probs, X, U, A, Bj, _, _, _, _ = ab.setup(case, Bsz)
        args, _ = generic_block_args(system, probs, X, U, A, Bj)
        fn = lambda: cuda_lft_generic.propagator_select_generic(*args, t_min=probs.T_min)  # noqa: E731
        J_o, J_n = ab.both(fn)
        rows.append(ab.row("lft_select_generic", f"{case} blocks", (Bsz, probs.N), fn, ((J_o,), (J_n,))))
    for p, m in OFF_REGISTRY_SELECT:  # the run-time-size path
        args = random_select_args(p, m, B_OFF, N_OFF, ab.device)
        fn = lambda: cuda_lft_generic.propagator_select_generic(*args, t_min=1)  # noqa: E731
        J_o, J_n = ab.both(fn)
        rows.append(ab.row("lft_select_generic", f"random p={p} m={m}", (B_OFF, N_OFF), fn, ((J_o,), (J_n,))))
    f32 = ab.f32("lft_select_generic", "lft_select_generic_f32")
    if f32 is not None:
        system, probs, X, U, A, Bj, kernel, plain, s, _ = ab.setup("PointMass_Navigation", B_FULL, f32)
        J_o, J_n = ab.both(kernel)
        check_select(J_n, plain(), s, probs, F32_SELECT_BOUND["PointMass_Navigation"],
                     "ab: new lft_select_generic float32 vs plain", tie=F32_REL)
        rows.append(ab.row("lft_select_generic", "PointMass_Navigation float32", (B_FULL, probs.N), kernel,
                           ((J_o,), (J_n,))))
    return rows


def ab_backward(ab: ABRun) -> list:
    """The quadrotor and PointMass at B=1024, every system at B=128, at the
    select kernel's T*, and the random inputs of OFF_REGISTRY_BACKWARD."""
    from timeopt_tpu_torch.ops import cuda_backward

    rows = []
    for case, Bsz in [("Quadrotor", B_FULL), ("PointMass_Navigation", B_FULL)] + ab.every:
        system, probs, X, U, A, Bj, _, _, _, T = ab.setup(case, Bsz)
        bw_args = backward_args(system, probs, X, U, A, Bj, T, ab.opts.lm_init)
        fn = lambda: cuda_backward.backward_truncated_core(*bw_args)  # noqa: E731
        outs = ab.both(fn)
        if Bsz == B_FULL:
            check_backward(bw_args, f"ab: new backward vs plain ({case} B={Bsz})", norm=BACKWARD_NORM_B1024.get(case))
        rows.append(ab.row("backward", case, (Bsz, probs.N), fn, outs))
    for n, m in OFF_REGISTRY_BACKWARD:  # the run-time-size path
        bw_args = random_backward_args(n, m, B_OFF, N_OFF, ab.device)
        fn = lambda: cuda_backward.backward_truncated_core(*bw_args)  # noqa: E731
        rows.append(ab.row("backward", f"random n={n} m={m}", (B_OFF, N_OFF), fn, ab.both(fn)))
    f32 = ab.f32("backward", "backward_truncated_f32")
    for case in ("Quadrotor", "PointMass_Navigation") if f32 is not None else ():
        system, probs, X, U, A, Bj, _, _, _, T = ab.setup(case, B_FULL, f32)
        bw_args = backward_args(system, probs, X, U, A, Bj, T, ab.opts.lm_init)
        fn = lambda: cuda_backward.backward_truncated_core(*bw_args)  # noqa: E731
        rows.append(ab.row("backward", f"{case} float32", (B_FULL, probs.N), fn, ab.both(fn)))
    return rows


def scan_sets(ab: ABRun) -> list:
    """(label, (A_aug, BRB, Q_aug), C) of the scan and query rows: the
    quadrotor's first-iterate blocks at B=1024 and every system's at B=128
    (p = 13, 3 and 5); the random blocks of OFF_REGISTRY_SELECT (the
    run-time-size paths; B_OFF, N_OFF leave the last block partial); N = 1
    (the quadrotor's blocks cut to their first step, and random p = 4); and
    the rung-2 sets of random_rung2_args at p = 4, 5 and 13."""
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb

    if "scan_sets" not in ab.cache:
        sets = []
        for case, Bsz in [("Quadrotor", B_FULL)] + ab.every:
            system, probs, X, U, A, Bj, *_ = ab.setup(case, Bsz)
            blk = build_augmented(system, probs, X, U, A, Bj)
            args = tuple(t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv), blk.Q_aug))
            C = build_terminal_factors(probs, X, s=blk.s).contiguous()
            sets.append((f"{case} blocks", args, C))
            if case == "Quadrotor" and Bsz == B_ORACLE:
                sets.append((f"{case} blocks, step 1 only", tuple(t[:, :1].contiguous() for t in args),
                             C[:, :1].contiguous()))
        for p, m, N in [(p, m, N_OFF) for p, m in OFF_REGISTRY_SELECT] + [(4, 1, 1)]:
            A, Bm, Q, Ri, C = random_select_args(p, m, B_OFF, N, ab.device)
            sets.append((f"random p={p} m={m}", (A, brb(Bm, Ri).contiguous(), Q), C))
        for p in (4, 5, 13):
            args, C = random_rung2_args(p, B_OFF, N_OFF, ab.device)
            sets.append((f"rung 2 p={p}", args, C))
        ab.cache["scan_sets"] = sets
    return ab.cache["scan_sets"]


def scan_sets_f32(ab: ABRun) -> list:
    """scan_sets' float32 rows: the quadrotor's float32 first-iterate blocks
    at B=1024 and the random blocks of OFF_REGISTRY_SELECT rounded to
    float32 (the run-time-size paths)."""
    import torch
    from timeopt_tpu_torch.solver.augmented import build_augmented, build_terminal_factors
    from timeopt_tpu_torch.solver.horizon import brb

    if "scan_sets_f32" not in ab.cache:
        system, probs, X, U, A, Bj, *_ = ab.setup("Quadrotor", B_FULL, torch.float32)
        blk = build_augmented(system, probs, X, U, A, Bj)
        sets = [("Quadrotor float32 blocks", tuple(t.contiguous() for t in (blk.A_aug, brb(blk.B_aug, blk.R_inv),
                                                                             blk.Q_aug)),
                 build_terminal_factors(probs, X, s=blk.s).contiguous())]
        for p, m in OFF_REGISTRY_SELECT:
            A, Bm, Q, Ri, C = random_select_args(p, m, B_OFF, N_OFF, ab.device)
            sets.append((f"random p={p} m={m} float32", tuple(t.float().contiguous() for t in (A, brb(Bm, Ri), Q)),
                         C.float().contiguous()))
        ab.cache["scan_sets_f32"] = sets
    return ab.cache["scan_sets_f32"]


def _hold_unfused_b1024(ab: ABRun) -> None:
    """The new scan and query at B=1024 against the plain versions and the
    generic select kernel, as phase 3 holds them."""
    if "unfused_held" not in ab.cache:
        system, probs, X, U, A, Bj, *_ = ab.setup("Quadrotor", B_FULL)
        scan_query_pair(system, probs, X, U, A, Bj, 2, SCAN_QUERY_FIRST_BOUND, f"ab: new scan+query (Quadrotor B={B_FULL})")
        ab.cache["unfused_held"] = True


def ab_lft_scan(ab: ABRun) -> list:
    """E, F, G on every set of scan_sets, at levels 1 and 2 (and of
    scan_sets_f32 where the old sources have the float32 entry)."""
    from timeopt_tpu_torch.ops import cuda_lft_scan

    _hold_unfused_b1024(ab)
    rows = []
    f32 = scan_sets_f32(ab) if ab.f32("lft_scan", "lft_scan_f32") is not None else []
    for label, args, _ in scan_sets(ab) + f32:
        for levels in (1, 2):
            fn = lambda: cuda_lft_scan.lft_scan(*args, levels=levels)  # noqa: E731
            rows.append(ab.row("lft_scan", f"{label} levels {levels}", args[0].shape[:2], fn, ab.both(fn)))
    return rows


def ab_lft_query(ab: ABRun) -> list:
    """J on every set of scan_sets, at levels 1 and 2, on the new scan's
    prefixes of that set (and of scan_sets_f32, float32 C, where the old
    sources have the float32 entry)."""
    from timeopt_tpu_torch.ops import cuda_lft_query, cuda_lft_scan

    _hold_unfused_b1024(ab)
    rows = []
    f32 = scan_sets_f32(ab) if ab.f32("lft_query", "lft_query_f32") is not None else []
    for label, args, C in scan_sets(ab) + f32:
        for levels in (1, 2):
            pre = cuda_lft_scan.lft_scan(*args, levels=levels)
            fn = lambda: cuda_lft_query.lft_query(*pre, C, levels=levels)  # noqa: E731
            J_o, J_n = ab.both(fn)
            rows.append(ab.row("lft_query", f"{label} levels {levels}", args[0].shape[:2], fn, ((J_o,), (J_n,))))
    return rows


# phase_ab's rows of each kernel, in the order of KERNELS
AB_ROWS = {"lft_select": ab_lft_select, "lft_select_generic": ab_lft_select_generic, "backward": ab_backward,
           "linesearch": ab_linesearch, "lft_scan": ab_lft_scan, "lft_query": ab_lft_query}


def phase_ab(device, old: str) -> list:
    """The kernels whose sources differ between an earlier csrc/ directory
    (`old`, e.g. an earlier commit's timeopt_tpu_torch/csrc) and this
    checkout's (changed_kernels: the .cu, or a header it includes), old
    against new on one card, in turns old, new, new, old (each turn the
    median of CUDA-event timings), on the rows of AB_ROWS: each kernel's
    first iterates of the oracle problem sets, and random inputs of shapes
    no system has (the run-time-size paths). Each row prints the largest
    difference between the two versions' outputs and whether they are equal
    bit for bit; at B=1024 the new version is also held against the plain
    one as phase 3 holds it. Then one B=1024 solve of the quadrotor and of
    PointMass with each version's kernels, in turns. After every row is
    printed, it fails unless each kernel row is bitwise equal and each
    solve's T*, J*, X and U identical."""
    import torch
    from timeopt_tpu_torch.models import get_system
    from timeopt_tpu_torch.ops import _build
    from timeopt_tpu_torch.solver.ilqr import solve_batch

    old = Path(old).resolve()
    names = changed_kernels(old, _build.CSRC, list(KERNELS))
    require(names, f"no kernel's sources differ between {old} and {_build.CSRC}")
    t0 = time.perf_counter()
    _build.load_all(names, old)
    _build.load_all(names)
    log(f"[ab] {names} differ; built from {old} (old) and from this checkout (new) in "
        f"{time.perf_counter() - t0:.1f} s")
    for tag, csrc in (("old", old), ("new", _build.CSRC)):
        for name in names:
            report = _build.build_info(name, csrc)[1]
            lines = [ln.split("ptxas info    : ")[-1] for ln in report.splitlines() if "registers" in ln or "spill" in ln]
            log(f"[ab] {tag} {name}: " + " | ".join(lines))
            if name == "lft_select":
                log(f"[ab] {tag} lft_select sass: " + select_sass_line(_build.load(name, csrc)._name))
    residency()

    ab = ABRun(device, old)
    rows = []
    for name in names:
        rows += AB_ROWS[name](ab)
        require(any(r["kernel"] == name for r in rows), f"--ab has no rows for {name}, whose sources differ")
    # end to end: one B=1024 solve with each version's kernels, in turns
    for case in ("Quadrotor", "PointMass_Navigation"):
        system, mk = get_system(case)
        probs = oracle_problems(system, mk, B_FULL, device)
        res, secs = {}, {"old": [], "new": []}
        for tag in ("old", "new", "new", "old"):
            with ab.kernels(tag):
                solve_batch(system, probs, options=ab.opts)  # warm-up
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res[tag] = solve_batch(system, probs, options=ab.opts)
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
    differ = [f"{r['kernel']} ({r['case']})" for r in rows
              if not r.get("bitwise", True) or not r.get("same_result", True)]
    require(not differ, f"--ab: old and new are not bitwise equal on {differ}")
    return rows


def main() -> None:
    import torch

    from timeopt_tpu_torch.solver import compiled

    start = time.perf_counter()
    phase_device()
    device = torch.device("cuda", 0)
    phase_build()
    numbers = phase_kernels(device)
    lin_numbers = phase_linearize(device)
    observe_programs()
    counts = {name: 0 for name in _counted()}
    from timeopt_tpu_torch.ops import cuda_loop

    compiled.settle_launches()
    cuda_loop.LAUNCHES = 0  # the loop condition's count over the main path, phases 4-11

    def add(c: dict) -> None:
        for name, v in c.items():
            counts[name] += v

    def phase(label: str, fn):
        """fn() with no captured program left from the phase before (their
        memory returned), its seconds logged."""
        compiled.clear_compiled()
        t0 = time.perf_counter()
        out = fn()
        log(f"[time] {label}: {time.perf_counter() - t0:.1f} s ({time.perf_counter() - start:.1f} s since the start)")
        return out

    lander = phase("3 (c) lander", lambda: phase_lander(device))
    for case in CASES:
        add(phase(f"4 oracle {case}", lambda: phase_oracle(case, device)))
    add(phase("4 (b) generated line search", lambda: phase_generated(device)))
    for case in CASES:
        add(phase(f"5 brute force {case}", lambda: phase_bruteforce(case, device)))
    add(phase("5 inverse query", lambda: phase_inverse(device)))
    add(phase("6 runner", phase_runner))
    per_solve = {case: phase(f"7 throughput {case}", lambda: phase_throughput(case, device))
                 for case in ("Quadrotor", "PointMass_Navigation")}
    per_solve["Quadrotor_onepass"] = phase("7 throughput one-pass", lambda: phase_throughput_onepass(device))
    add(phase("8 (a) latency modes", lambda: phase_latency_oracle(device)))
    add(phase("8 (b) B=1", lambda: phase_latency_b1(device)))
    add(phase("9 scale-out", lambda: phase_scaleout(device)))
    f32_numbers = phase("10 (a) float32 kernels", lambda: phase_f32_kernels(device))
    for case in CASES:
        add(phase(f"10 (b) float32 oracle {case}", lambda: phase_f32_oracle(case, device)))
    add(phase("10 (b) float32 modes", lambda: phase_f32_modes(device)))
    per_solve_f32 = {case: phase(f"10 (c) float32 throughput {case}", lambda: phase_throughput(case, device, torch.float32))
                     for case in ("Quadrotor", "PointMass_Navigation")}
    per_solve_f32["Quadrotor_onepass"] = phase("10 (c) float32 throughput one-pass",
                                               lambda: phase_throughput_onepass(device, torch.float32))
    bench_rec = phase("10 (c) bench_torch.py", phase_bench_torch)
    add(phase("10 (d) runner --f32", phase_f32_runner))
    add(phase("11 (a), (b) serving entry", lambda: phase_serving(device)))
    phase("11 (c) bench_sustained_torch.py", lambda: phase_sustained(bench_rec))
    compiled.clear_compiled()
    counts[LOOP[0]] = loop_launches()
    require(counts[LOOP[0]] > 0, f"{LOOP[0]}: never launched on the main path")
    loop_numbers = phase("12 device-side loop", lambda: phase_device_loop(device))
    compiled.clear_compiled()
    require(TRACED["programs"] > 0, "no captured program was traced")
    log(f"[trace] {TRACED['programs']} programs built on the main path, each graph's replay traced once: "
        f"{TRACED['events']} device events, every kernel count equal to the launches booked "
        f"({TRACED['secs']:.1f} s of tracing; {TRACED['retraced']} short traces taken again)")

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
        if name in f32_numbers:
            k["float32"] = dict(**f32_numbers[name], launches_per_solve={c: v[name] for c, v in per_solve_f32.items()})
            k["float32"]["share_of_bound"] = k["float32"]["bound_ms"] / k["float32"]["ms_back_to_back"]
        kernels.append(k)
        log(f"[bounds] {name}: {k['ms_back_to_back']:.3f} ms back to back ({k['ms']:.3f} one call), bound {k['bound_ms']:.4f} ms by {k['bound_by']} "
            f"({k['flops'] / 1e9:.3f} GFLOP, {k['bytes'] / 1e6:.1f} MB; {k['bound_ms_cuda_cores']:.4f} ms at "
            f"{work.PEAK_FLOPS_CUDA_CORES / 1e12:g} TFLOP/s), share of bound {k['share_of_bound']:.4f}, "
            f"launches per B={B_FULL} solve {k['launches_per_solve']}")
    op = numbers["linesearch"]["onepass_rollout"]
    op["share_of_bound"] = op["bound_ms"] / op["ms_back_to_back"]
    log(f"[bounds] linesearch (one-pass rollouts from their start states, {op['rollouts']} x {op['alphas']} alphas, "
        f"their own T*): {op['ms_back_to_back']:.3f} ms back to back ({op['ms']:.3f} one call, plain "
        f"{op['plain_ms']:.3f}), bound {op['bound_ms']:.4f} ms by {op['bound_by']} ({op['flops'] / 1e9:.3f} GFLOP, "
        f"{op['bytes'] / 1e6:.1f} MB), share of bound {op['share_of_bound']:.4f}")
    bpm = numbers["backward"]["pointmass"]
    bpm["share_of_bound"] = bpm["bound_ms"] / bpm["ms_back_to_back"]
    log(f"[bounds] backward (PointMass_Navigation B={B_FULL}, its own T*): {bpm['ms_back_to_back']:.3f} ms back to back "
        f"({bpm['ms']:.3f} one call, plain {bpm['plain_ms']:.3f}), bound {bpm['bound_ms']:.4f} ms by {bpm['bound_by']} "
        f"({bpm['flops'] / 1e9:.3f} GFLOP, {bpm['bytes'] / 1e6:.1f} MB), share of bound {bpm['share_of_bound']:.4f}")
    for name, f in ((n, k["float32"]) for n, k in zip(KERNELS, kernels) if "float32" in k):
        log(f"[bounds] {name} float32: {f['ms_back_to_back']:.3f} ms back to back ({f['ms']:.3f} one call, plain "
            f"{f['plain_ms']:.3f}), bound {f['bound_ms']:.4f} ms by {f['bound_by']} ({f['flops'] / 1e9:.3f} GFLOP, "
            f"{f['bytes'] / 1e6:.1f} MB at float32 storage), share of bound {f['share_of_bound']:.4f}, launches per "
            f"B={B_FULL} float32 solve {f['launches_per_solve']}")
        for sub in ("pointmass", "onepass_rollout"):
            if sub in f:
                g = f[sub]
                g["share_of_bound"] = g["bound_ms"] / g["ms_back_to_back"]
                log(f"[bounds] {name} float32 ({sub}): {g['ms_back_to_back']:.3f} ms back to back ({g['ms']:.3f} one "
                    f"call, plain {g['plain_ms']:.3f}), bound {g['bound_ms']:.4f} ms by {g['bound_by']}, share of "
                    f"bound {g['share_of_bound']:.4f}")
    name, route, src, rep = GENERATED
    g = dict(name=name, route=route, source=src, replaces=rep, launches=counts[name],
             launches_per_solve={case: c[name] for case, c in per_solve.items()}, **numbers[name], library_ms=None,
             library="none: no single PyTorch call computes it")
    g["share_of_bound"] = g["bound_ms"] / g["ms_back_to_back"]
    kernels.append(g)
    log(f"[bounds] {name} (Quadrotor's device_id=None twin): {g['ms_back_to_back']:.3f} ms back to back "
        f"({g['ms']:.3f} one call; the hand-written kernel in turns {g['hand_written_ms_back_to_back']}), bound "
        f"{g['bound_ms']:.4f} ms by {g['bound_by']}, share of bound {g['share_of_bound']:.4f}, launches "
        f"{g['launches']} (phases 4 and 4 (b)); nvcc seconds {g['build_s']}")
    require(counts[name] > 0, f"{name}: never launched on the main path")
    name, route, src, rep = LOOP
    lp = dict(name=name, route=route, source=src, replaces=rep, launches=counts[name],
              launches_per_solve={case: c[name] for case, c in per_solve.items()}, **loop_numbers, library_ms=None,
              library="none: no single PyTorch call computes it (done.all() is one part of it)")
    lp["share_of_bound"] = lp["bound_ms"] / lp["ms_back_to_back"]
    kernels.append(lp)
    log(f"[bounds] {name} (port only, B={B_FULL}): {lp['ms_back_to_back']:.4f} ms back to back ({lp['ms']:.4f} one "
        f"call, plain {lp['plain_ms']:.4f}), bound {lp['bound_ms']:.3e} ms by {lp['bound_by']}, share of bound "
        f"{lp['share_of_bound']:.4f}, launches {lp['launches']} (phases 4-11), per B={B_FULL} solve "
        f"{lp['launches_per_solve']}")
    name, route, src, rep = LINEARIZE
    ln = dict(name=name, route=route, source=src, replaces=rep, launches=counts[name],
              launches_per_solve={case: c[name] for case, c in per_solve.items()},
              launches_per_solve_float32={case: c[name] for case, c in per_solve_f32.items()}, **lin_numbers,
              library_ms=None, library="none: torch.func.vmap(jacfwd) is its plain version, many small ops")
    ln["share_of_bound"] = ln["bound_ms"] / ln["ms_back_to_back"]
    kernels.append(ln)
    log(f"[bounds] {name} (port only, Quadrotor B={B_FULL} float32): {ln['ms_back_to_back']:.4f} ms back to back "
        f"({ln['ms']:.4f} one call, plain {ln['plain_ms']:.3f}), bound {ln['bound_ms']:.4f} ms by {ln['bound_by']}, "
        f"share of bound {ln['share_of_bound']:.4f}, launches {ln['launches']} (phases 4-11), per B={B_FULL} solve "
        f"{ln['launches_per_solve']}, float32 {ln['launches_per_solve_float32']}")
    require(counts[name] > 0, f"{name}: never launched on the main path")
    print(json.dumps({"kernels": kernels, "lander": lander}))
    print(smi())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))


def main_lander() -> None:
    """Phases 1 and 3 (c) alone, the lander's program traced as on the main
    path."""
    import torch

    phase_device()
    observe_programs()
    t0 = time.perf_counter()
    lander = phase_lander(torch.device("cuda", 0))
    log(f"[time] 3 (c) lander: {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"lander": lander}))
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
    elif sys.argv[1:2] == ["--lander"]:
        main_lander()
    else:
        main()
