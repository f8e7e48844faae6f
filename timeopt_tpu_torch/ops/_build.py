"""Build and load the hand-written CUDA kernels of csrc/.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), loaded with
ctypes. Libraries go to `timeopt_tpu_torch/_build/`, named by a hash of the
sources and the flags, so a changed source rebuilds and an unchanged one
loads from the cache. Nothing is built at import: the first launch builds.
A source generated at run time (ops/dyngen.py: the line search of a System
without a device_id) is written to `_build/gen_<hash>.cu` and built the
same way, against csrc/'s headers.
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

from timeopt_tpu_torch.utils import trace

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
    earlier version of the sources against this one. A generated source
    (load_generated) is loaded by its name once it is built."""
    if (name, csrc) not in _LOADED:
        _LOADED[(name, csrc)] = _compile(csrc / f"{name}.cu", csrc)
    return _LOADED[(name, csrc)][0]


def _compile(src: Path, include: Path) -> tuple:
    """(library, build seconds, ptxas report) of src built with -I include
    into BUILD_DIR, named by a hash of the source, the headers in include/
    and the flags; a library of that name already there is loaded as it is.
    Each load is a `build.kernels` span (utils/trace.py)."""
    with trace.build_span("build.kernels", lib=src.stem) as sp:
        lib, seconds, report = _compile_load(src, include)
        sp.args["nvcc_s"] = seconds
    return lib, seconds, report


def _compile_load(src: Path, include: Path) -> tuple:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in [src, *sorted(include.glob("*.cuh"))]:
        h.update(f.name.encode() + f.read_bytes())
    out = BUILD_DIR / f"lib{src.stem}-{h.hexdigest()[:16]}.so"
    seconds, report = 0.0, "cached"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-I", str(include), "-o", str(tmp), str(src)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        report = proc.stderr.strip()
    return ctypes.CDLL(str(out)), seconds, report


def generated_name(text: str) -> str:
    """The name of a generated source's library: gen_<hash of the text>."""
    return "gen_" + hashlib.sha256(text.encode()).hexdigest()[:16]


def load_generated(text: str) -> tuple:
    """Write a generated CUDA source (ops/dyngen.py) to
    BUILD_DIR/gen_<hash of the text>.cu, build it against csrc/'s headers
    as load builds a kernel of csrc/, load it; (its name, under which
    build_info() finds it, and the library)."""
    name = generated_name(text)
    if (name, CSRC) not in _LOADED:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = BUILD_DIR / f"{name}.cu"
        if not src.exists():  # the name is the text's hash
            tmp = src.with_name(f"{src.name}.{os.getpid()}.tmp")
            tmp.write_text(text)
            os.replace(tmp, src)
        _LOADED[(name, CSRC)] = _compile(src, CSRC)
    return name, _LOADED[(name, CSRC)][0]


def load_generated_all(texts: list) -> list:
    """load_generated of each text, one nvcc process each, all started
    together; their (name, library) in order."""
    with ThreadPoolExecutor(max_workers=max(1, len(texts))) as pool:
        return list(pool.map(load_generated, texts))


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


# The storage dtypes of the kernels: each has a float64 and a float32
# instantiation (f32 in device memory, float64 in registers).
STORAGE_DTYPES = (torch.float64, torch.float32)


def on_card(x: torch.Tensor, phase: str) -> bool:
    """The dispatch rule of every phase: False for a CPU tensor (plain
    PyTorch version), True for a CUDA tensor (the kernel). The dtype must be
    float64 or float32; any other raises TypeError, on every device, so
    that nothing is upcast or sent to the CPU silently."""
    if x.dtype not in STORAGE_DTYPES:
        raise TypeError(f"{phase}: dtype {x.dtype}: the kernels store float64 or float32")
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{phase}: unsupported device {x.device}")
    return True


# (values, dtype, device) -> tensor; see constant()
_CONSTANTS: dict = {}


def constant(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """The tensor of a tuple of Python numbers on `device`, made once and
    kept. A body captured into a CUDA graph (solver/compiled.py) may not copy
    host data to the card, so its constants come from here: the eager
    warm-up before the capture makes each one, the capture finds it made."""
    key = (values, dtype, torch.device(device))
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.tensor(values, dtype=dtype, device=device)
    return t


def cast(a, dtype: torch.dtype):
    """A floating tensor, or a Problem's floating tensors (anything with
    .tensors()), cast to dtype; anything else as it is."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype) if a.is_floating_point() else a
    if hasattr(a, "tensors"):
        return a.replace(**{f: cast(t, dtype) for f, t in a.tensors().items()})
    return a


def in_f64(fn, *args, **kw):
    """fn on its arguments upcast to float64, its floating outputs cast back
    to the dtype of the first floating tensor argument: the rule of the
    float32 path's plain versions (float32 storage, float64 arithmetic, one
    rounding on the way out). On float64 arguments it is fn itself."""
    dtype = next(a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point())
    if dtype == torch.float64:
        return fn(*args, **kw)

    def down(o):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            return o.to(dtype)
        if isinstance(o, tuple):  # a NamedTuple keeps its type
            vals = [down(v) for v in o]
            return type(o)(*vals) if hasattr(o, "_fields") else tuple(vals)
        return o

    f64 = torch.float64
    return down(fn(*(cast(a, f64) for a in args), **{k: cast(v, f64) for k, v in kw.items()}))


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
