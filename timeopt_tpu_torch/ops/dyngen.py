"""A line-search kernel for a System without a `device_id`: its own xdot,
guard and extra stage cost, traced and emitted as C++, in the kernel
template of the registry systems (csrc/linesearch_kernel.cuh).

The JAX package traces a system's `xdot_rows` and `guard_rows` into its
Pallas line search (timeopt_tpu/ops/pallas_forward.py::_fwd_kernel). Here
`system.xdot`, `system.guard` and `system.extra_cost` are traced with
`make_fx` on float64 CPU inputs of shape (1, n) and (1, m), and each aten
node of the graph becomes one SSA statement per element of its value (a
numpy object array of C names, so that broadcasting, views, stacking and
reductions follow numpy's rules on those names). The statements form one
struct, `Generated`, with the interface of the hand-written ones in
csrc/systems.cuh: n, m, xdot(x, u, xd), guard(x, u), extra_cost(x, u); a
missing guard or extra cost is NoExtras' default (false, 0.0). Nothing is
simplified: `- 0.0` and `0.0 * w` stay (a non-finite rate reaches the same
entries), constants are inlined as exact literals, sums run in index order
from 0.0 (as the hand-written structs' loops), `x ** 2` is `x * x` (as
ATen computes it). The
functions are `__host__ __device__` under nvcc and plain C++ under a host
compiler (tests/test_torch_dyngen.py builds the struct with g++).

`library(system)` builds the kernel once per (xdot, guard, extra_cost,
step, n, m, dt, wrap_idx): `_build.load_generated` writes the source to
`timeopt_tpu_torch/_build/gen_<hash>.cu` and compiles it with nvcc. The
compiled solve calls it first in its eager warm-up, never inside a capture.
An op outside `OPS`, a trace that fails (data-dependent Python control flow,
a read to the host), a step that is not `euler_step_fn` of the system's own
ingredients, or sizes the kernel does not take raise; nothing falls back.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from timeopt_tpu_torch.ops import _build

LAUNCHES = 0  # generated-kernel launches (ops/cuda_forward.py) since the last reset

# The kernel's limits (csrc/linesearch_kernel.cuh): a rollout's group of
# lanes, n rounded up to a power of two, fits a warp; lanes j < m form the
# controls; a block's static shared memory (two chunks of CH steps of
# inputs, Q, Qf, R, xg, u_ref, for 32 / G problems) stays within 48 KiB.
WARP, CH, SHARED_BYTES = 32, 8, 48 * 1024


def group_width(n: int) -> int:
    return next(g for g in (2, 4, 8, 16, 32) if n <= g) if n <= 32 else 0


def check_sizes(n: int, m: int) -> None:
    """Raise ValueError unless the kernel template takes n states, m controls."""
    G = group_width(n)
    if not (1 <= n <= WARP and 1 <= m <= G):
        raise ValueError(f"the line-search kernel takes 1 <= n <= {WARP} and 1 <= m <= the group width "
                         f"(n rounded up to a power of two): n={n}, m={m}")
    PB, D = WARP // G, n + m + m * n + m
    shared = 8 * (2 * PB * CH * D + PB * (2 * n * (n + 1) + m * m + n + m))
    if shared > SHARED_BYTES:
        raise ValueError(f"the line-search kernel at n={n}, m={m} needs {shared} B of static shared memory "
                         f"a block, above {SHARED_BYTES}")


def check_system(system) -> None:
    """The counterpart of the JAX package's gate for its in-kernel dynamics
    (timeopt_tpu/solver/forward.py, _kernel_applicable): the kernel steps
    x + dt xdot(x, u), wraps system.wrap_idx and poisons where the guard
    holds, so system.step must be euler_step_fn of exactly this system's
    xdot, dt, n, wrap_idx and guard (it tags the step it returns)."""
    check_sizes(system.n, system.m)
    got = getattr(system.step, "euler_ingredients", None)
    want = (system.xdot, float(system.dt), system.n, tuple(int(i) for i in system.wrap_idx), system.guard)
    same = got is not None and got[0] is want[0] and got[1:4] == want[1:4] and got[4] is want[4]
    if not same:
        raise ValueError(f"{system.name}: system.step is not euler_step_fn(xdot, dt, n, wrap_idx, guard) of the "
                         "system's own xdot, dt, n, wrap_idx and guard, which the generated line-search kernel "
                         "computes")


# ---------------------------------------------------------------------------
# The emitter
# ---------------------------------------------------------------------------


def literal(v) -> str:
    """An exact C++ literal of a Python or numpy scalar (bool, or a double)."""
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    v = float(v)
    if math.isnan(v):
        return "NAN"
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    s = "%.17g" % v
    if not any(c in s for c in ".en"):
        s += ".0"
    return f"({s})" if s.startswith("-") else s


_UNARY = {
    "neg": "-{}", "reciprocal": "1.0 / {}", "abs": "fabs({})", "sin": "sin({})", "cos": "cos({})",
    "tan": "tan({})", "exp": "exp({})", "log": "log({})", "sqrt": "sqrt({})", "tanh": "tanh({})",
    "bitwise_not": "!{}", "logical_not": "!{}",
}
# (double form, bool form) of the elementwise binary ops; None: not for that type
_BINARY = {
    "add": ("{} + {}", "{} || {}"), "sub": ("{} - {}", None), "mul": ("{} * {}", "{} && {}"),
    "div": ("{} / {}", None), "atan2": ("atan2({}, {})", None),
    "eq": ("{} == {}",) * 2, "ne": ("{} != {}",) * 2, "lt": ("{} < {}",) * 2, "le": ("{} <= {}",) * 2,
    "gt": ("{} > {}",) * 2, "ge": ("{} >= {}",) * 2,
    "bitwise_or": (None, "{} || {}"), "bitwise_and": (None, "{} && {}"), "bitwise_xor": (None, "{} != {}"),
    "logical_or": ("{} || {}",) * 2, "logical_and": ("{} && {}",) * 2,
}
# x ** e as ATen's CPU kernel computes these exponents; any other is pow(x, e)
_POW = {2.0: "{0} * {0}", 3.0: "{0} * {0} * {0}", 0.5: "sqrt({0})", -0.5: "1.0 / sqrt({0})", -1.0: "1.0 / {0}",
        -2.0: "1.0 / ({0} * {0})"}
_IDENTITY = ("clone", "alias", "detach", "lift_fresh_copy")
OPS = tuple(sorted(
    [f"aten.{k}.default" for k in _UNARY]
    + [f"aten.{k}.Tensor" for k in ("add", "sub", "mul", "div", "eq", "ne", "lt", "le", "gt", "ge", "rsub",
                                    "bitwise_or", "bitwise_and", "bitwise_xor")]
    + [f"aten.{k}.Scalar" for k in ("add", "sub", "mul", "div", "eq", "ne", "lt", "le", "gt", "ge", "rsub")]
    + [f"aten.{k}.default" for k in _IDENTITY + ("atan2", "logical_or", "logical_and", "stack", "cat", "unsqueeze",
                                                 "permute", "t", "view", "_unsafe_view", "reshape", "expand",
                                                 "zeros_like", "ones_like", "full_like")]
    + ["aten.pow.Tensor_Scalar", "aten.where.self", "aten.select.int", "aten.slice.Tensor", "aten.transpose.int",
       "aten.squeeze.dim", "aten.squeeze.dims", "aten.sum.dim_IntList", "aten.all.dim", "aten.all.dims",
       "aten.any.dim", "aten.any.dims"]))


def _bind(node) -> dict:
    """The node's arguments by their schema names, defaults filled in."""
    out = {}
    for i, a in enumerate(node.target._schema.arguments):
        if i < len(node.args):
            out[a.name] = node.args[i]
        elif a.name in node.kwargs:
            out[a.name] = node.kwargs[a.name]
        else:
            out[a.name] = a.default_value if a.has_default_value() else None
    return out


class _Emitter:
    """One function's statements: `lines` (C++), `env` fx node -> (numpy
    object array of C names, "double" | "bool")."""

    def __init__(self, owner: str):
        self.owner, self.lines, self.env, self.k = owner, [], {}, 0

    def value(self, a):
        """(names, C type) of an fx node or a Python scalar argument."""
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        if isinstance(a, (bool, int, float)):
            return np.array(literal(a), dtype=object), "bool" if isinstance(a, bool) else "double"
        raise NotImplementedError(f"{self.owner}: argument {a!r} of type {type(a).__name__}")

    def statements(self, ctype: str, fmt: str, *operands) -> np.ndarray:
        """One `const <ctype> v<k> = fmt(...)` a broadcast element; the array of names."""
        arrs = np.broadcast_arrays(*[np.asarray(o, dtype=object) for o in operands])
        out = np.empty(arrs[0].shape, dtype=object)
        for idx in np.ndindex(out.shape):
            name = f"v{self.k}"
            self.k += 1
            self.lines.append(f"const {ctype} {name} = {fmt.format(*(a[idx] for a in arrs))};")
            out[idx] = name
        return out

    def reduce(self, names: np.ndarray, dims, keepdim: bool, op: str, ctype: str) -> np.ndarray:
        """Reduce the dims in index order: sum from 0.0, all / any as a
        chain of && / ||."""
        nd = names.ndim
        dims = list(range(nd)) if dims is None or (isinstance(dims, (list, tuple)) and len(dims) == 0) else dims
        dims = sorted({d % nd for d in ([dims] if isinstance(dims, int) else dims)})
        keep = [d for d in range(nd) if d not in dims]
        moved = np.transpose(names, keep + dims)
        flat = moved.reshape(moved.shape[:len(keep)] + (-1,))
        out = np.empty(flat.shape[:-1], dtype=object)
        for idx in np.ndindex(out.shape):
            terms = list(flat[idx])
            if op == "sum":
                expr = "0.0"
                for t in terms:
                    expr = f"({expr} + {t})"
            else:
                expr = f" {'&&' if op == 'all' else '||'} ".join(terms) or ("true" if op == "all" else "false")
            out[idx] = expr
        out = self.statements(ctype, "{}", out)
        if keepdim:
            for d in dims:
                out = np.expand_dims(out, d)
        return out

    def node(self, node) -> None:
        val = node.meta.get("val")
        if not isinstance(val, torch.Tensor):
            raise NotImplementedError(f"{self.owner}: {node.target} gives no tensor")
        if val.dtype not in (torch.float64, torch.bool):
            raise NotImplementedError(f"{self.owner}: {node.target} gives dtype {val.dtype}; the generated kernel "
                                      "computes float64 and bool values only")
        ctype = "bool" if val.dtype == torch.bool else "double"
        op = node.target.overloadpacket.__name__
        if str(node.target) not in OPS:
            raise NotImplementedError(f"{self.owner}: aten op {node.target} is not among the ops the line-search "
                                      "generator takes (timeopt_tpu_torch/ops/dyngen.py, OPS)")
        a = _bind(node)
        if a.get("alpha") not in (None, 1):
            raise NotImplementedError(f"{self.owner}: {node.target} with alpha={a['alpha']}")
        if a.get("dtype") is not None and op not in ("zeros_like", "ones_like", "full_like"):
            raise NotImplementedError(f"{self.owner}: {node.target} with dtype={a['dtype']}")
        x = lambda k: self.value(a[k])[0]  # noqa: E731
        if op in _IDENTITY:
            out = x("self")
        elif op in _UNARY:
            out = self.statements(ctype, _UNARY[op], x("self"))
        elif op in _BINARY or op == "rsub":
            (sa, ta), (sb, tb) = self.value(a["self"]), self.value(a["other"])
            if op == "rsub":
                op, sa, sb, ta, tb = "sub", sb, sa, tb, ta
            fmt = _BINARY[op][1 if ta == tb == "bool" else 0]
            if fmt is None:
                raise NotImplementedError(f"{self.owner}: {node.target} on {ta} and {tb} operands")
            out = self.statements(ctype, fmt, sa, sb)
        elif op == "pow":
            e = float(a["exponent"])
            out = self.statements(ctype, _POW.get(e, "pow({0}, %s)" % literal(e)), x("self"))
        elif op == "where":
            out = self.statements(ctype, "{} ? {} : {}", x("condition"), x("self"), x("other"))
        elif op in ("sum", "all", "any"):
            out = self.reduce(x("self"), a["dim"], bool(a["keepdim"]), op, ctype)
        elif op == "select":
            out = np.take(x("self"), a["index"], axis=a["dim"])
        elif op == "slice":
            s = x("self")
            sl = [slice(None)] * s.ndim
            sl[a["dim"]] = slice(a["start"], a["end"], a["step"])
            out = s[tuple(sl)]
        elif op == "unsqueeze":
            s = x("self")
            out = np.expand_dims(s, a["dim"] % (s.ndim + 1))
        elif op == "squeeze":
            out = x("self").reshape(tuple(val.shape))
        elif op in ("view", "_unsafe_view", "reshape"):
            out = x("self").reshape(tuple(val.shape))
        elif op == "expand":
            out = np.broadcast_to(x("self"), tuple(val.shape))
        elif op == "permute":
            out = np.transpose(x("self"), a["dims"])
        elif op == "transpose":
            out = np.swapaxes(x("self"), a["dim0"], a["dim1"])
        elif op == "t":
            out = x("self").T
        elif op in ("stack", "cat"):
            parts = [self.value(t)[0] for t in a["tensors"]]
            out = (np.stack if op == "stack" else np.concatenate)(parts, axis=a["dim"])
        elif op in ("zeros_like", "ones_like", "full_like"):
            fill = {"zeros_like": 0, "ones_like": 1}.get(op, a.get("fill_value"))
            out = np.full(tuple(val.shape), literal(bool(fill) if ctype == "bool" else fill), dtype=object)
        else:  # pragma: no cover - OPS and the branches above list the same ops
            raise NotImplementedError(f"{self.owner}: {node.target}")
        out = np.asarray(out, dtype=object)
        if tuple(out.shape) != tuple(val.shape):
            raise NotImplementedError(f"{self.owner}: {node.target} gives shape {tuple(val.shape)}, the emitter "
                                      f"{tuple(out.shape)}")
        self.env[node] = (out, ctype)


def trace(fn, n: int, m: int, owner: str):
    """fn(x (1, n), u (1, m)) traced with make_fx on float64 CPU zeros."""
    from torch.fx.experimental.proxy_tensor import make_fx

    x, u = torch.zeros((1, n), dtype=torch.float64), torch.zeros((1, m), dtype=torch.float64)
    try:
        return make_fx(fn)(x, u)
    except Exception as exc:  # noqa: BLE001 - any failure of the trace is reported as the refusal it is
        raise NotImplementedError(f"{owner}: tracing with make_fx failed ({type(exc).__name__}: {exc}); the "
                                  "line-search generator takes functions of (x, u) made of tensor ops, without "
                                  "data-dependent Python control flow or reads to the host") from exc


def emit(fn, n: int, m: int, owner: str, shape: tuple, dtype: torch.dtype) -> tuple:
    """(statements, names of the result) of fn traced at (1, n), (1, m),
    whose result must have this shape and dtype."""
    gm = trace(fn, n, m, owner)
    em = _Emitter(owner)
    inputs = [np.array([[f"{v}[{i}]" for i in range(k)]], dtype=object) for v, k in (("x", n), ("u", m))]
    result = None
    for node in gm.graph.nodes:
        if node.op == "placeholder":
            em.env[node] = (inputs.pop(0), "double")
        elif node.op == "get_attr":
            t = getattr(gm, node.target).detach().cpu()
            lits = np.vectorize(literal, otypes=[object])(t.numpy()) if t.numel() else np.empty(t.shape, object)
            em.env[node] = (np.asarray(lits, dtype=object).reshape(tuple(t.shape)),
                            "bool" if t.dtype == torch.bool else "double")
        elif node.op == "call_function":
            em.node(node)
        elif node.op == "output":
            out = node.args[0]
            if not isinstance(out, torch.fx.Node) or out.meta["val"].dtype != dtype \
                    or tuple(out.meta["val"].shape) != shape:
                got = out.meta["val"] if isinstance(out, torch.fx.Node) else out
                raise ValueError(f"{owner}: returns {getattr(got, 'dtype', type(got).__name__)} of shape "
                                 f"{tuple(getattr(got, 'shape', ()))} at x (1, {n}), u (1, {m}); expected {dtype} "
                                 f"of shape {shape}")
            result = em.env[out][0]
        else:
            raise NotImplementedError(f"{owner}: fx node {node.op} {node.target}")
    return em.lines, result


MACRO = "TIMEOPT_DYN"


def struct_source(system) -> str:
    """The C++ struct `Generated` of the system's xdot, guard and extra cost
    (check_system first)."""
    check_system(system)
    n, m = system.n, system.m
    body, res = emit(system.xdot, n, m, f"{system.name} xdot", (1, n), torch.float64)
    fns = [(f"static void xdot(const double* x, const double* u, double* xd)",
            body + [f"xd[{i}] = {res[0, i]};" for i in range(n)])]
    for name, ret, dtype, default in (("guard", "bool", torch.bool, "false"),
                                      ("extra_cost", "double", torch.float64, "0.0")):
        fn = getattr(system, name)
        if fn is None:
            lines = [f"return {default};"]
        else:
            body, res = emit(fn, n, m, f"{system.name} {name}", (1,), dtype)
            lines = body + [f"return {res[0]};"]
        fns.append((f"static {ret} {name}(const double* x, const double* u)", lines))
    out = [f"// generated by timeopt_tpu_torch/ops/dyngen.py from {system.name}'s xdot, guard and extra_cost",
           f"#ifndef {MACRO}", "#ifdef __CUDACC__", f"#define {MACRO} __host__ __device__", "#else",
           f"#define {MACRO}", "#endif", "#endif", "struct Generated {",
           f"  static constexpr int n = {n}, m = {m};"]
    for sig, lines in fns:
        out += [f"  {MACRO} {sig} {{", "    (void)x;", "    (void)u;"] + [f"    {ln}" for ln in lines] + ["  }"]
    return "\n".join(out + ["};", ""])


_ENTRY = """
extern "C" int linesearch_rollout_from{sfx}(const void* X, const void* U, const void* K, const void* kap,
    const void* T_star, const void* xg, const void* u_ref, const void* Q, const void* R, const void* Qf,
    const void* w, const void* wrap_mask, const void* alphas, void* Xs, void* Us, void* Js, const void* x0,
    int B, int N, int n, int m, int A, double dt, int state_wrap_bits, long long x0_stride, void* stream) {{
  return launch<Generated, {fp}>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us, Js,
                                 x0, x0_stride, B, N, n, m, A, dt, state_wrap_bits, (cudaStream_t)stream);
}}

extern "C" int linesearch_rollout{sfx}(const void* X, const void* U, const void* K, const void* kap,
    const void* T_star, const void* xg, const void* u_ref, const void* Q, const void* R, const void* Qf,
    const void* w, const void* wrap_mask, const void* alphas, void* Xs, void* Us, void* Js, int B, int N,
    int n, int m, int A, double dt, int state_wrap_bits, void* stream) {{
  return linesearch_rollout_from{sfx}(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us,
                                      Js, X, B, N, n, m, A, dt, state_wrap_bits, (long long)(N + 1) * n, stream);
}}
"""


def kernel_source(system) -> str:
    """The CUDA source of the system's line-search library: the kernel
    template, the struct, and the entries linesearch_rollout[_from][_f32]
    (those of csrc/linesearch.cu without the system_id argument)."""
    return "\n".join([
        "// The line-search kernel (csrc/linesearch_kernel.cuh) on dynamics generated from a System's own",
        "// Python functions by timeopt_tpu_torch/ops/dyngen.py.",
        '#include "linesearch_kernel.cuh"', "", "namespace {", "", struct_source(system), "}  // namespace",
        _ENTRY.format(sfx="", fp="double"), _ENTRY.format(sfx="_f32", fp="float")])


# ---------------------------------------------------------------------------
# The library of each system
# ---------------------------------------------------------------------------

# the system's functions and sizes -> (library name in _build, ctypes.CDLL)
_LIBS: dict = {}


def _key(system) -> tuple:
    """What the library and its preconditions depend on. Not the System:
    its __eq__ ignores the functions (compare=False)."""
    return (system.xdot, system.guard, system.extra_cost, system.step, system.n, system.m, float(system.dt),
            tuple(int(i) for i in system.wrap_idx))


def library(system):
    """The system's generated line-search library, traced and built with
    nvcc on its first call, loaded from the memo after. Raises inside a
    CUDA-graph capture if it was not built before."""
    hit = _LIBS.get(_key(system))
    if hit is None:
        if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{system.name}: the generated line-search kernel must be built before a capture "
                               "(the compiled solve's eager warm-up builds it)")
        build_all([system])
        hit = _LIBS[_key(system)]
    return hit[1]


def build_all(systems) -> None:
    """Generate the sources of the systems not yet built, one after another,
    then compile them with nvcc, one process each, all started together."""
    todo = {}
    for s in systems:
        if _key(s) not in _LIBS and _key(s) not in todo:
            todo[_key(s)] = kernel_source(s)
    if not todo:
        return
    for key, built in zip(todo, _build.load_generated_all(list(todo.values()))):
        _LIBS[key] = built


def build_info(system) -> tuple:
    """(library name, nvcc seconds, ptxas report) of the system's library."""
    library(system)
    name = _LIBS[_key(system)][0]
    return (name, *_build.build_info(name))
