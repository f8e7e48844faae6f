"""Several devices in one process: a device mesh, the batch split over it
(dp), and the terminal queries split over it (hs); port of
timeopt_tpu/parallel/mesh.py.

- **dp (batch axis):** the solves of a batch are independent, so each
  device of the mesh's "dp" axis solves a contiguous chunk of it, with no
  communication. `shard_problems` places the chunks once;
  `solve_batch_resident` solves chunks already in place and leaves each
  result on its device (the serving entry of bench_torch.py, as the JAX
  package's bench passes a Problem sharded with `P("dp")` to its jitted
  solve); `solve_batch_sharded` does both and concatenates the results in
  mesh order on the mesh's first device.
- **hs (horizon-candidate axis):** the N terminal queries of the
  propagator select split over the "hs" devices: the prefixes are computed
  once, each device queries its slice of candidate horizons, and the
  slices are gathered back in order.

A mesh of CUDA devices covers the local cards; a mesh of k entries of
`torch.device("cpu")` runs the same split and order on the CPU, as the JAX
package's tests run its mesh on virtual CPU devices.

One process drives every card's chunk. On the card a chunk's solve is a
captured program (solver/compiled.py): the whole solve, its early exit
included, is one launch of a graph that reads nothing back, so the process
launches every card's solve before it copies out any result, and the cards
run their chunks at once, as the JAX package's dp mesh runs its shards. No
Python runs on the solve's path, so torch.func's process-global
forward-mode AD state (the linearization's jacfwd) is touched only while a
program is captured, once, card after card. A mesh of CPU entries is
driven the same way, its programs run eagerly, so one after another.
Processes, one a card, are the other way to scale
(parallel/distributed.py). The hs-sharded queries launch on their
cards without waiting, so they overlap.
"""

from __future__ import annotations

import dataclasses
from contextlib import nullcontext
from typing import Optional

import numpy as np
import torch

from timeopt_tpu_torch.models.base import Problem, System
from timeopt_tpu_torch.ops import cuda_lft_query
from timeopt_tpu_torch.ops.precision import full_matmul_precision
from timeopt_tpu_torch.solver import compiled
from timeopt_tpu_torch.solver.augmented import AugmentedBlocks
from timeopt_tpu_torch.solver.horizon import LFTElements, propagator_select_prefixes
from timeopt_tpu_torch.solver.ilqr import SolveOptions, SolveResult, prepare, solve_batch
from timeopt_tpu_torch.utils import trace


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of devices with named axes (a small stand-in for
    jax.sharding.Mesh): `devices` is an object array of torch.device of
    shape len(axis_names)."""

    devices: np.ndarray
    axis_names: tuple

    @property
    def shape(self) -> dict:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> list:
        """The devices along `axis`, the other axes at index 0 (a chunk
        split over `axis` is replicated over the others)."""
        i = self.axis_names.index(axis)
        idx = tuple(slice(None) if k == i else 0 for k in range(len(self.axis_names)))
        return list(self.devices[idx])


def make_mesh(n_devices: Optional[int] = None, axis_names=("dp",), shape=None, device_type: str = "cuda") -> Mesh:
    """A mesh over the local CUDA devices (or the first n_devices of them),
    1D ("dp",) by default; pass shape=(a, b) and axis_names=("dp", "hs")
    for a 2D mesh. device_type="cpu" makes a mesh of n_devices (default 1)
    entries of the CPU."""
    if device_type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: no CUDA device (use device_type='cpu' for a CPU mesh)")
        devs = [torch.device("cuda", i) for i in range(count)][:n_devices]
    elif device_type == "cpu":
        devs = [torch.device("cpu")] * (n_devices or 1)
    else:
        raise ValueError(f"make_mesh: unknown device_type {device_type!r}")
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape required for multi-axis mesh")
        shape = (len(devs),)
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(shape), tuple(axis_names))


def _chunks(x: torch.Tensor, k: int) -> list:
    """k contiguous chunks along axis 0, the first B mod k one longer."""
    return list(torch.tensor_split(x, k, dim=0))


def shard_problems(probs: Problem, mesh: Mesh, axis: str = "dp") -> list:
    """The batch split into contiguous chunks, one for each device along
    `axis` in mesh order, each moved to its device: a list of Problems
    (empty chunks where the batch is smaller than the axis)."""
    devs = mesh.axis_devices(axis)
    parts = {f: _chunks(t, len(devs)) for f, t in probs.tensors().items()}
    return [probs.replace(**{f: parts[f][i].to(d) for f in parts}) for i, d in enumerate(devs)]


def device_context(device: torch.device):
    """The current-device context for kernel launches on `device` (the
    kernels launch on the current device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def solve_batch_resident(
    system: System,
    parts: list,
    U_inits: Optional[list] = None,
    options: Optional[SolveOptions] = None,
) -> list:
    """Batch-solve a batch already split over devices: `parts` as
    shard_problems returns them, each chunk on its device, and U_inits
    (default: each chunk's u_ref tiled, made on its device) one tensor a
    chunk, on the chunk's device. Each chunk is solved as solve_batch would
    solve it: every card's program is launched (one loop-graph launch a
    card, its early exit decided on the card, nothing read back) before any
    result is copied out (compiled.solve_programs), so the cards run at
    once and the call returns before they finish. Returns one SolveResult for each non-empty
    chunk, in order, left on that chunk's device: nothing is split, copied
    between devices or gathered. The counterpart of the JAX package's
    sharded Problem passed to its jitted batch solve. While tracing is on
    (utils/trace.py) the call records `entry.call` and its children."""
    with trace.span("entry.call"):
        opts = options or SolveOptions()
        opts.check()
        if U_inits is None:
            U_inits = [None] * len(parts)
        if len(U_inits) != len(parts):
            raise ValueError(f"solve_batch_resident: {len(U_inits)} U_inits for {len(parts)} parts")
        with trace.span("entry.prepare"):
            prepared = [prepare(p, U) for p, U in zip(parts, U_inits) if p.batch]
        return compiled.solve_programs(system, opts, prepared)


def solve_batch_sharded(
    system: System,
    probs: Problem,
    U_inits=None,
    options: Optional[SolveOptions] = None,
    mesh: Optional[Mesh] = None,
    axis: str = "dp",
) -> SolveResult:
    """Batch-solve with the batch split over the mesh's `axis`: the batch
    (and U_inits) split and placed by shard_problems, solved by
    solve_batch_resident, and the results concatenated in batch order on
    the axis's first device. Without a mesh, one solve_batch."""
    opts = options or SolveOptions()
    if mesh is None:
        return solve_batch(system, probs, U_inits, opts)
    parts = shard_problems(probs, mesh, axis)
    if U_inits is not None:
        U_inits = [U.to(p.x0.device) for p, U in zip(parts, _chunks(U_inits, len(parts)))]
    results = solve_batch_resident(system, parts, U_inits, opts)
    home = mesh.axis_devices(axis)[0]
    return SolveResult(**{
        f.name: torch.cat([getattr(r, f.name).to(home) for r in results], dim=0)
        for f in dataclasses.fields(SolveResult)
    })


@full_matmul_precision
def propagator_select_sharded(
    blocks: AugmentedBlocks,
    C: torch.Tensor,
    mesh: Mesh,
    *,
    hs_axis: str = "hs",
    scan_mode: str = "sequential",
    psd_levels: int = 2,
) -> torch.Tensor:
    """The propagator's J(T) (B, N), unscaled, with the terminal queries
    (the candidate-horizon axis) split over the mesh's `hs_axis`. `blocks`
    are build_augmented's, C the factored terminal of
    build_terminal_factors (B, N, n, p).

    The prefixes are computed once, on the blocks' device (the scan kernel,
    or the plain associative scan with scan_mode="associative"); the N
    candidates are padded to a multiple of the hs devices (the padded C
    rows the identity, so their queries stay well conditioned), each
    device queries its contiguous slice (the query kernel on a card), and
    the slices are gathered back in order on the blocks' device. On
    float32 blocks the prefixes travel in float64 and C in float32 (each
    padding keeps its operand's dtype), and J comes back in float32, as
    horizon.propagator_select gives it; TF32 is off inside."""
    pre = propagator_select_prefixes(blocks.A_aug, blocks.B_aug, blocks.Q_aug, blocks.R_inv,
                                     scan_mode=scan_mode, psd_levels=psd_levels)
    devs = mesh.axis_devices(hs_axis)
    Bsz, N, n, p = C.shape
    pad = (-N) % len(devs)
    if pad:
        eye = torch.eye(n, p, dtype=C.dtype, device=C.device).expand(Bsz, pad, n, p)
        C = torch.cat([C, eye], dim=1)
        pre = LFTElements(*(torch.cat([x, x.new_zeros((Bsz, pad, p, p))], dim=1) for x in pre))
    width = (N + pad) // len(devs)
    parts = []
    for i, d in enumerate(devs):
        sl = slice(i * width, (i + 1) * width)
        with device_context(d):
            parts.append(cuda_lft_query.lft_query(*(x[:, sl].to(d).contiguous() for x in pre),
                                                  C[:, sl].to(d).contiguous(), levels=psd_levels))
    return torch.cat([j.to(C.device) for j in parts], dim=1)[:, :N]
