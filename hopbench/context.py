"""What a per-layer metric's reader (hopbench/metrics/<metric>.py) gets.

`Context` holds the traced run's records and helpers, and computes the
kernels' inputs at most once for every reader that needs them:

- `cfg`, `mix`, `system` (the program's System), `opts` (its
  SolveOptions), `pool` (the cell's batches whole, on its first card),
  `device` (that card);
- `window`: the window's batches (hopbench/loop.py: host times, and the
  device start and end of each batch on each card from CUDA events);
- `counters`: the program's device loop counters over the window (`runs`,
  the loop-graph launches that finished, and `steps`, the outer steps they
  ran), read after it;
- `device_ms(fn)`: milliseconds per call of fn launched back to back
  between two CUDA events, after a warm-up (a kernel: one launch a call);
- `graph_ms(fn)`: the same of fn captured into a CUDA graph and replayed,
  for a phase of many small torch ops, as the program's captured step runs
  it (launched eagerly, the host's dispatch of each op would be timed);
- `first_iterate()`, `select()`, `gains()`: the solve's first iterate of the
  pool's first batch (U = u_ref tiled, its rollout and Jacobians), the
  select's inputs and T* there, and the backward pass's gains at that T*;
  each kernel reader times its kernel alone on them;
- `work`: hopbench/work.py, the frozen work counts; `itemsize` the
  storage dtype's bytes.

A reader returns None where the cell has nothing for it to read.
"""

from __future__ import annotations

import torch

from hopbench import work


class Context:
    def __init__(self, cfg: dict, mix: dict, system, opts, pool: list, window, counters: dict, device):
        self.cfg, self.mix, self.system, self.opts = cfg, mix, system, opts
        self.pool, self.window, self.counters, self.device = pool, window, counters, device
        self.work = work
        self.itemsize = torch.empty((), dtype=getattr(torch, cfg["dtype"])).element_size()
        self._memo: dict = {}

    def cached(self, key: str, fn):
        if key not in self._memo:
            self._memo[key] = fn()
        return self._memo[key]

    def peek(self, key: str):
        """What `cached` made under `key`, or None where nothing asked for it."""
        return self._memo.get(key)

    def device_ms(self, fn, reps: int = 10) -> float:
        fn()
        torch.cuda.synchronize(self.device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize(self.device)
        return start.elapsed_time(end) / reps

    def graph_ms(self, fn, reps: int = 10) -> float:
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            fn()  # the warm-up a capture needs
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self.device_ms(graph.replay, reps)

    def first_iterate(self) -> tuple:
        """(prob, X, U, A, B) of the pool's first batch at the solve's start."""
        def make():
            from timeopt_tpu_torch.solver.cost import rollout
            from timeopt_tpu_torch.solver.ilqr import default_U_init
            from timeopt_tpu_torch.solver.linearize import linearize

            prob = self.pool[0]
            U = default_U_init(prob)
            X = rollout(self.system, prob, prob.x0, U)
            A, B = linearize(self.system.step, X, U, self.opts.linearize_mode)
            return prob, X, U, A, B

        return self.cached("first_iterate", make)

    def select(self) -> tuple:
        """(generic, args, s, T*): the select's inputs on the first iterate
        (ilqr.select_inputs), and T* of its curve."""
        def make():
            from timeopt_tpu_torch.solver.cost import argmin_T
            from timeopt_tpu_torch.solver.horizon import propagator_select_fused, propagator_select_generic
            from timeopt_tpu_torch.solver.ilqr import select_inputs

            prob, X, U, A, B = self.first_iterate()
            generic, args, s = select_inputs(self.system, prob, self.opts, X, U, A, B)
            J = (propagator_select_generic if generic else propagator_select_fused)(*args, prob.T_min)
            return generic, args, s, argmin_T(J, prob.T_min, prob.T_max)

        return self.cached("select", make)

    def gains(self) -> tuple:
        """(K, kappa, T*): the backward pass at the select's T*."""
        def make():
            from timeopt_tpu_torch.solver.backward import backward_truncated

            prob, X, U, A, B = self.first_iterate()
            T = self.select()[3]
            lm = torch.full((prob.batch,), self.opts.lm_init, dtype=X.dtype, device=X.device)
            bw = backward_truncated(self.system, prob, A, B, X, U, T, lm)
            return bw.K, bw.kappa, T

        return self.cached("gains", make)
