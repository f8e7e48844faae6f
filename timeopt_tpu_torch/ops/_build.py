"""Build and load the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. Libraries go to `timeopt_tpu_torch/_build/`, named by a hash of the
sources and the flags, so a changed source rebuilds and an unchanged one
loads from the cache. Nothing is built at import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# (name, source directory) -> (ctypes.CDLL, build seconds, ptxas report);
# filled on first use
_LOADED: dict = {}


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels cannot be built")
    return path


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """Build <csrc>/<name>.cu if its cached library is missing, then load it.
    Another directory than the package's csrc/ serves only to time an
    earlier version of the sources against this one."""
    if (name, csrc) in _LOADED:
        return _LOADED[(name, csrc)][0]
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(csrc.glob("*.cuh"))]:
        h.update(f.name.encode() + f.read_bytes())
    out = BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"
    seconds, report = 0.0, "cached"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-I", str(csrc), "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        report = proc.stderr.strip()
    lib = ctypes.CDLL(str(out))
    _LOADED[(name, csrc)] = (lib, seconds, report)
    return lib


def load_all(names, csrc: Path = CSRC) -> None:
    """Build and load several kernels at once: one nvcc process per source,
    all started together."""
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        list(pool.map(lambda name: load(name, csrc), names))


def build_info(name: str, csrc: Path = CSRC) -> tuple[float, str]:
    """(build seconds, ptxas resource report) of a loaded kernel library."""
    load(name, csrc)
    return _LOADED[(name, csrc)][1:]


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, tail: list) -> ctypes._CFuncPtr:
    """Declare `fn(void* x n_ptr, *tail, void* stream) -> int`."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + list(tail) + [ctypes.c_void_p]
    f.restype = ctypes.c_int
    return f


def on_card(x: torch.Tensor, phase: str) -> bool:
    """The dispatch rule of every phase: False for a CPU tensor (plain
    PyTorch version), True for a CUDA float64 tensor (the kernel). A CUDA
    tensor of another dtype raises: plain f32 is wrong for these recursions."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{phase}: unsupported device {x.device}")
    if x.dtype != torch.float64:
        raise TypeError(
            f"{phase}: CUDA tensors must be float64 (got {x.dtype}); float32 is wrong "
            "for the propagator and Riccati recursions"
        )
    return True


def check(t: torch.Tensor, shape: tuple, dtype: torch.dtype, device: torch.device, name: str) -> None:
    """Raise unless t has exactly this shape, dtype and device and is contiguous."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.device != device:
        raise ValueError(f"{name}: device {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def raise_on_error(rc: int, fn: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{fn}: CUDA error {rc} at launch")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
