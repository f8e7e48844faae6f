"""The device phase stamp of the port's tracing (utils/trace.py): the
wrapper of csrc/trace.cu, sm_90a, built by ops/_build.py at first use.

A stamp log on the card is `rows` (capacity, 5) int64, one row a stamp
(launch, iteration, code, t_ns, count; the kernel's header says what each
holds), and `head` (2,) int64 [cursor, dropped]. `stamp` launches one block
on the device's current stream, so inside a capture it becomes a kernel node
of the graph. It replaces no Pallas kernel: the JAX package has no device
tracing; it is a kernel of the port alone.
"""

from __future__ import annotations

import ctypes

import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # stamp launches since the last reset (booked from the loop counters inside loop graphs)
FIELDS = ("launch", "iteration", "code", "t_ns", "count")


def new_log(capacity: int, device) -> tuple:
    """(rows, head) of an empty stamp log of `capacity` rows on `device`."""
    rows = torch.zeros((capacity, len(FIELDS)), dtype=torch.int64, device=device)
    head = torch.zeros(2, dtype=torch.int64, device=device)
    return rows, head


def stamp(rows: torch.Tensor, head: torch.Tensor, ctr: torch.Tensor | None, done: torch.Tensor | None, init: bool,
          code: int) -> None:
    """One stamp of phase code `code` into the log (rows, head) on the card,
    tagged with the loop counters `ctr` (launch and iteration; -1 without)
    and, with `done` (B,) bool, the count of problems not done."""
    global LAUNCHES
    dev = rows.device
    _build.check(head, (2,), torch.int64, dev, "head")
    if ctr is not None:
        _build.check(ctr, (4,), torch.int64, dev, "ctr")
    if done is not None and (done.dtype != torch.bool or done.dim() != 1 or not done.is_contiguous()):
        raise ValueError(f"trace stamp: done must be a contiguous 1-d bool tensor, got {done.dtype} {tuple(done.shape)}")
    fn = _build.bind(_build.load("trace"), "trace_stamp", 4,
                     [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong])
    rc = fn(rows.data_ptr(), head.data_ptr(), None if ctr is None else ctr.data_ptr(),
            None if done is None else done.data_ptr(), rows.shape[0], 0 if done is None else done.numel(),
            int(init), int(code), _build.stream_ptr(dev))
    _build.raise_on_error(rc, "trace_stamp")
    LAUNCHES += 1
