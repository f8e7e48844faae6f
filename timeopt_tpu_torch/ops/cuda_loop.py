"""The compiled solve's device-side outer loop: the condition kernel, its
plain version, and the loop graph around a program's captured init and step
graphs.

The counterpart of the JAX package's outer loop, the lax.while_loop of
timeopt_tpu/solver/ilqr.py::_run_outer_loop, whose condition
(it < max_iter) & ~done.all() runs on the device. It replaces no Pallas
kernel (the TPU evaluates that condition inside its jitted program); it is
a kernel of the port alone. Kernel and graph: csrc/loop_graph.cu, sm_90a,
built by ops/_build.py at first use.

A program's loop state is `ctr`, four int64 counters [it, cond, runs,
steps]: the current iteration, the condition, and the loops finished and
steps run since the program was built, from which solver/compiled.py books
the kernel launches of its solves when asked (`settle_launches`), without a
read to the host on the solve's path.

`loop_cond` on a CPU tensor runs `loop_condition`, the plain version; on a
CUDA tensor it launches the kernel on its own (outside any graph). Inside a
loop graph the same kernel also sets the WHILE node's condition.
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # loop_cond launches since the last reset (booked from the counters inside loop graphs)
IT, COND, RUNS, STEPS = range(4)


def new_counters(device) -> torch.Tensor:
    """A program's loop counters [it, cond, runs, steps], zero."""
    return torch.zeros(4, dtype=torch.int64, device=device)


def loop_condition(done: torch.Tensor, ctr: torch.Tensor, max_iter: int, early_exit: bool,
                   first: bool = False) -> tuple:
    """The plain version of loop_cond: it = 0 (first) or it + 1, cond = it <
    max_iter and not (early_exit and every problem done), written to ctr;
    when cond is false the loop ends: runs += 1, steps += it. Returns (it,
    cond), views of ctr. Capture-safe: no read to the host."""
    it = torch.zeros_like(ctr[IT]) if first else ctr[IT] + 1
    go = it < max_iter
    if early_exit:
        go = go & ~done.all()
    stop = ~go
    ctr[IT].copy_(it)
    ctr[COND].copy_(go)
    ctr[RUNS].add_(stop.to(ctr.dtype))
    ctr[STEPS].add_(torch.where(stop, it, torch.zeros_like(it)))
    return ctr[IT], ctr[COND]


def _check(done: torch.Tensor, ctr: torch.Tensor) -> None:
    if done.dtype != torch.bool or done.dim() != 1 or not done.is_contiguous():
        raise ValueError(f"loop_cond: done must be a contiguous 1-d bool tensor, got {done.dtype} "
                         f"{tuple(done.shape)}")
    _build.check(ctr, (4,), torch.int64, done.device, "ctr")


def loop_cond(done: torch.Tensor, ctr: torch.Tensor, max_iter: int, early_exit: bool, first: bool = False) -> tuple:
    """One step of the loop's condition on (done (B,) bool, ctr (4,) int64),
    in place: the kernel on a CUDA tensor, loop_condition on a CPU one.
    Returns (it, cond), views of ctr."""
    if done.device.type == "cpu":
        return loop_condition(done, ctr, max_iter, early_exit, first)
    if done.device.type != "cuda":
        raise ValueError(f"loop_cond: unsupported device {done.device}")
    global LAUNCHES
    _check(done, ctr)
    fn = _build.bind(_build.load("loop_graph"), "loop_cond_launch", 1,
                     [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int])
    rc = fn(done.data_ptr(), done.numel(), ctr.data_ptr(), int(first), int(max_iter), int(early_exit),
            _build.stream_ptr(done.device))
    _build.raise_on_error(rc, "loop_cond_launch")
    LAUNCHES += 1
    return ctr[IT], ctr[COND]


def _destroy(lib, device: torch.device, exec_: int, graph: int) -> None:
    """Free a loop graph once its device's queued work is done (any launch
    of it included); at interpreter exit, when CUDA may be gone, quietly."""
    try:
        with torch.cuda.device(device):
            lib.loop_graph_destroy(ctypes.c_void_p(exec_), ctypes.c_void_p(graph))
    except Exception:  # noqa: BLE001 - a finalizer must not raise
        pass


class LoopGraph:
    """The instantiated loop graph of one program on the card:

        [init graph] -> loop_cond(first) -> WHILE(cond) { [step graph] -> loop_cond }

    init and step are torch.cuda.CUDAGraph captured with keep_graph=True;
    their graphs are cloned into child-graph nodes, which address the
    captures' memory pool, so this object holds the two CUDAGraph objects
    (the pool's owners) for as long as it lives. `launch()` enqueues one
    solve on the current stream and reads nothing back. Raises
    RuntimeError naming what failed when the graph cannot be built (the
    instantiation's result and the node it names, such as one that a
    conditional body does not take)."""

    def __init__(self, init: torch.cuda.CUDAGraph, step: torch.cuda.CUDAGraph, done: torch.Tensor,
                 ctr: torch.Tensor, max_iter: int, early_exit: bool):
        _check(done, ctr)
        self.device = done.device
        self.graphs = (init, step)
        lib = _build.load("loop_graph")
        build = lib.loop_graph_build
        build.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
                          + [ctypes.POINTER(ctypes.c_void_p)] * 2 + [ctypes.c_char_p, ctypes.c_int])
        build.restype = ctypes.c_int
        lib.loop_graph_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.loop_graph_launch.restype = ctypes.c_int
        lib.loop_graph_destroy.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.loop_graph_destroy.restype = ctypes.c_int
        exec_, graph = ctypes.c_void_p(), ctypes.c_void_p()
        err = ctypes.create_string_buffer(1024)
        with torch.cuda.device(self.device):
            rc = build(init.raw_cuda_graph(), step.raw_cuda_graph(), done.data_ptr(), done.numel(), ctr.data_ptr(),
                       int(max_iter), int(early_exit), ctypes.byref(exec_), ctypes.byref(graph), err, len(err))
        if rc != 0:
            raise RuntimeError(f"the loop graph could not be built (CUDA error {rc}): {err.value.decode()}")
        self._launch = lib.loop_graph_launch
        self._exec = exec_.value
        self._free = weakref.finalize(self, _destroy, lib, self.device, exec_.value, graph.value)

    def launch(self) -> None:
        """One solve: the loop graph launched on the device's current stream."""
        rc = self._launch(self._exec, _build.stream_ptr(self.device))
        _build.raise_on_error(rc, "loop_graph_launch")

    def close(self) -> None:
        """Wait for the device, free the graph, then let go of the captures."""
        self._free()
        self.graphs = None
