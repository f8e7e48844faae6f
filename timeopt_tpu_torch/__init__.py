"""timeopt_tpu_torch: the HOP-DDP horizon-optimal trajectory optimizer in
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package `timeopt_tpu`, which stays the reference. The
batch is an explicit leading axis everywhere. Problems solve in float64,
or in float32 as the JAX package's f32 path does: float32 storage, every
recursion in float64 and its result rounded once (where the JAX package
runs df32 on the TPU). Each phase that the JAX package ran as Pallas TPU
kernels has a dispatch point per kernel: on a CPU tensor it runs its plain
PyTorch version; on a CUDA float64 or float32 tensor it launches its
kernel (csrc/, built with nvcc at first use); any other dtype raises.

- select, stationary stage cost: ops/cuda_lft.py         (csrc/lft_select.cu)
- select, extra stage cost:      ops/cuda_lft_generic.py (csrc/lft_select_generic.cu)
- backward:                      ops/cuda_backward.py    (csrc/backward.cu)
- line search:                   ops/cuda_forward.py     (csrc/linesearch.cu; a System
                                 without a device_id: ops/dyngen.py, its own xdot, guard
                                 and extra cost in csrc/linesearch_kernel.cuh)
- every prefix (unfused select): ops/cuda_lft_scan.py    (csrc/lft_scan.cu)
- terminal queries:              ops/cuda_lft_query.py   (csrc/lft_query.cu)

The port's own kernels, which replace no TPU kernel: the Jacobians of a
registry system's step (ops/cuda_linearize.py, csrc/linearize.cu; dual
numbers on the dynamics of csrc/systems.cuh, which the line search
integrates) and the compiled solve's loop condition (ops/cuda_loop.py,
csrc/loop_graph.cu).

This package never imports jax.
"""

from timeopt_tpu_torch.models import SYSTEMS, get_system
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, solve, solve_batch

__version__ = "0.1.0"

__all__ = ["solve", "solve_batch", "SolveOptions", "SolveResult", "get_system", "SYSTEMS"]
