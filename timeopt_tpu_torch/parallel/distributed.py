"""Several processes (one per card, or one per host): the process group, the
batch split over the ranks and the results gathered back; port of
timeopt_tpu/parallel/distributed.py on torch.distributed.

- `initialize()` wraps `torch.distributed.init_process_group` with `env://`
  (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them) or
  explicit arguments. It is idempotent, and a no-op for one process with no
  such environment, so every function here also works in a plain
  single-process run. The backend is NCCL for a CUDA run and gloo for
  device="cpu"; a failing NCCL initialization raises, nothing falls back to
  gloo or to the CPU.
- Each rank solves its contiguous slice of the global batch
  (`process_batch_bounds`, the first `rem` ranks one problem more) on its
  own card (`local_device`, cuda:{LOCAL_RANK % device_count}); the solves
  are independent, so only the results cross between processes.
- `gather_results()` all-gathers every SolveResult tensor in rank order to
  host numpy on every rank (unequal slices padded, then trimmed); the
  runner's rank 0 writes the artifacts.

The JAX module's global mesh and `distribute_batch` (a globally sharded
jax.Array) have no torch counterpart: each rank holds its own slice.
Exercised without several hosts by a 2-process gloo test on the CPU
(tests/test_torch_parallel.py) and, on the card, at world size 1 with NCCL
(chip_smoke.py).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.parallel.mesh import device_context
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, solve_batch


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def initialize(
    device="cuda",
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group (idempotent). With no arguments the
    environment says where (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT);
    without WORLD_SIZE or num_processes this is one process and nothing is
    initialized. coordinator_address "host:port" replaces MASTER_ADDR and
    MASTER_PORT. `device` "cuda" takes NCCL (and makes the rank's card
    current), "cpu" gloo."""
    if is_initialized():
        return
    world = num_processes if num_processes is not None else os.environ.get("WORLD_SIZE")
    if world is None:
        return
    rank = process_id if process_id is not None else int(os.environ.get("RANK", "0"))
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(local_device("cuda"))
        backend = "nccl"
    else:
        backend = "gloo"
    init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend, init_method=init, world_size=int(world), rank=int(rank))


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def is_multiprocess() -> bool:
    return process_count() > 1


def process_batch_bounds(global_batch: int) -> tuple:
    """[start, end) of this rank's contiguous slice of a global batch split
    as evenly as possible (the first `rem` ranks get one element more)."""
    pc, pi = process_count(), process_index()
    base, rem = divmod(global_batch, pc)
    start = pi * base + min(pi, rem)
    return start, start + base + (1 if pi < rem else 0)


def local_device(device=None) -> torch.device:
    """This rank's device: cuda:{LOCAL_RANK % device_count} for a CUDA run,
    the CPU for device="cpu" or a gloo group. With no device given, the
    group's backend decides, and without a group the card."""
    if device is None:
        gloo = is_initialized() and dist.get_backend() == "gloo"
        device = "cpu" if gloo else "cuda"
    if torch.device(device).type == "cpu":
        return torch.device("cpu")
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("local_device: no CUDA device (pass device='cpu' for a CPU run)")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")) % count)


def _collective_device() -> torch.device:
    """Where the group's collectives take their tensors: the current card
    for NCCL, the CPU for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """t summed over the process group (a new tensor on t's device); t
    itself without a group."""
    if not is_initialized():
        return t
    x = t.to(_collective_device(), copy=True)
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x.to(t.device)


def solve_batch_global(
    system: System,
    local_probs: Problem,
    U_inits=None,
    options: Optional[SolveOptions] = None,
    device=None,
) -> SolveResult:
    """Solve this rank's slice of the global batch (`local_probs`, e.g.
    rows process_batch_bounds(B) of the global problems) on its device
    (local_device() unless given). Returns the slice's result; use
    gather_results for the whole batch."""
    dev = torch.device(device) if device is not None else local_device()
    U = None if U_inits is None else U_inits.to(dev)
    with device_context(dev):
        return solve_batch(system, local_probs.to(dev), U, options)


def gather_results(res: SolveResult) -> SolveResult:
    """Every tensor of the ranks' results concatenated in rank order, as host
    numpy, on every rank (the rank's own result alone without a group).
    Slices of unequal length are padded for the all-gather and trimmed."""
    if not is_multiprocess():
        return SolveResult(**{f.name: getattr(res, f.name).cpu().numpy() for f in dataclasses.fields(res)})
    dev = _collective_device()
    sizes = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(process_count())]
    dist.all_gather(sizes, torch.tensor([res.T_star.shape[0]], dtype=torch.int64, device=dev))
    sizes = [int(s) for s in sizes]
    out = {}
    for f in dataclasses.fields(res):
        t = getattr(res, f.name)
        x = t.to(dev, dtype=torch.uint8 if t.dtype == torch.bool else t.dtype)
        x = torch.cat([x, x.new_zeros((max(sizes) - x.shape[0],) + x.shape[1:])]).contiguous()
        parts = [torch.empty_like(x) for _ in sizes]
        dist.all_gather(parts, x)
        y = torch.cat([p[:s] for p, s in zip(parts, sizes)])
        out[f.name] = y.to(t.dtype).cpu().numpy()
    return SolveResult(**out)


def sync_processes(name: str = "barrier") -> None:
    """Barrier over the process group (a no-op for one process). `name` is
    kept for the JAX package's signature; torch's barrier has none."""
    if is_multiprocess():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
