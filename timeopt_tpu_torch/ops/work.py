"""The work each CUDA kernel of the port must do, and its least time on the card.

For each kernel: the floating-point operations its algorithm needs on given
inputs (a multiply-add counts 2, an add, multiply, divide or square root 1,
a sine or cosine 1) and the bytes it must move (each input read once, each
output written once, each float at its storage dtype's `itemsize`: 8 on
the float64 path, 4 on the float32 path, whose arithmetic is float64 all
the same, so the operations meet the float64 peak on both; the fused
select's k-constants and the line search's alphas are float64 on both, the
T* and wrap-mask inputs int64 and bool). Work that depends on the data
is counted from the data: the select's queries run for horizons
t >= T_min only, the backward pass reads and eliminates only the steps
t < T* of each problem. The counts are of what the algorithm needs, not
of what a kernel happens to issue: an elimination charges each pivot only
for the columns it still changes, a sweep that only needs its last pivot
counts the trailing forward elimination, and a matrix used twice (the
query's FEt) is formed once.

`bound` turns (flops, bytes) into the roofline's least time on one H100
SXM: the larger of flops over the float64 peak and bytes over the memory
rate, and which of the two it is. NVIDIA's data sheet gives 67 TFLOP/s for
float64 on the tensor cores and 34 TFLOP/s on the CUDA cores; the 13 x 13
eliminations here run on the CUDA cores, so the bound at 34 TFLOP/s is
returned beside the other.
"""

from __future__ import annotations

PEAK_FLOPS = 67e12  # float64, tensor cores, H100 SXM
PEAK_FLOPS_CUDA_CORES = 34e12  # float64, CUDA cores, H100 SXM
PEAK_BYTES = 3.35e12  # HBM3, H100 SXM
F64 = 8


def bound(flops: float, nbytes: float) -> dict:
    """The least time (ms) of `flops` and `nbytes` on the card, and what sets it."""
    t_f, t_b = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return dict(flops=float(flops), bytes=float(nbytes), bound_ms=1e3 * max(t_f, t_b),
                bound_by="operations" if t_f >= t_b else "bytes",
                bound_ms_cuda_cores=1e3 * max(flops / PEAK_FLOPS_CUDA_CORES, t_b))


def mm(r: int, c: int, k: int) -> int:
    """(r x k) times (k x c)."""
    return 2 * r * c * k


def sym(r: int) -> int:
    """(M + M') / 2 of an r x r matrix: one add and one multiply per pair i <= j."""
    return r * (r + 1)


def gj(r: int, c: int) -> int:
    """Pivot-free Gauss-Jordan sweep of an r x c system [M | R] (r pivots).
    Pivot i divides in its row, and updates in the other r - 1 rows, only
    the columns it still changes: the r - 1 - i columns of M right of it
    (those left of it are unit vectors already) and the c - r of R."""
    return sum(((r - 1 - i) + (c - r)) * (1 + 2 * (r - 1)) for i in range(r))


def last_pivot(r: int) -> int:
    """Forward elimination of an r x r matrix down to its last pivot."""
    return sum((r - 1 - i) + 2 * (r - 1 - i) ** 2 for i in range(r - 1))


def _compose(p: int) -> int:
    """Carry o element: sym(E + Gbar) + jitter I, the [. | Fbar' | F] sweep,
    then Ebar - Fbar X1, Fbar X2, G - F' X2 and the two symmetrizations."""
    return p * p + sym(p) + p + gj(p, 3 * p) + 3 * mm(p, p, p) + 2 * p * p + 2 * sym(p)


def _query(n: int, p: int) -> int:
    """W0- or C-form terminal query: the n x (n + p) sweep, X0 = Ebar - FC Y,
    sym(X0) + jitter I, its last pivot and J = 0.5 / pivot."""
    return gj(n, n + p) + mm(p, p, n) + p * p + sym(p) + p + last_pivot(p) + 1


def _c_form(n: int, p: int) -> int:
    """The C-form query's inputs: C Gbar, Fbar C' and S = sym(I + C Gbar C')."""
    return mm(n, p, p) + mm(p, n, p) + mm(n, n, p) + n + sym(n)


def select_fused(B: int, N: int, n: int, m: int, t_min: int, itemsize: int = F64) -> dict:
    """csrc/lft_select.cu on (B, N) steps of dimension n, m."""
    p = n + 1
    elem = (mm(n, m, m) + 2 * n  # B R^-1; q = Qe / s_k and e~
            + mm(n, 1, n) + 2 * n + 5  # w = iQq q; 1 / s
            + (n + 1) + mm(p, 1, p) + mm(n, n, n)  # A_aug's last column; v = A_aug u; DAt = iQq A'
            + p + p * p + n * p  # F = [DAt; 0] + (u / s) v'
            + mm(n, n, n) + p + p * p + 2 * n * n + mm(n, n, m) + sym(p)  # G = sym(A DAt + (v / s) v' + B R^-1 B')
            + p * p + n * n)  # E = blkdiag(iQq, 0) + (u / s) u'
    w0_form = 6 * n * n + n + 2 * n * p  # K = W0 + G11 + e~ g' + g e~' + g22 e~ e~'; FEt = Fbar[:, :n] + Fbar[:, n] e~'
    n_query = B * max(0, N - max(t_min, 1) + 1)
    flops = B * N * elem + B * max(0, N - 1) * _compose(p) + n_query * (_query(n, p) + w0_form)
    nbytes = itemsize * (B * N * (n * n + n * m + 4 * n + 4) + B * N) + F64 * B * (2 * n * n + m * m)
    return bound(flops, nbytes)


def select_generic(B: int, N: int, n: int, m: int, t_min: int, itemsize: int = F64) -> dict:
    """csrc/lft_select_generic.cu on assembled blocks (B, N, p, p)."""
    p = n + 1
    # [sym(Q) + jitter I | A' | I] sweep, B R^-1, G = sym(A F + B R^-1 B')
    elem = sym(p) + p + gj(p, 3 * p) + mm(p, m, m) + mm(p, p, p) + mm(p, p, m) + p * p + sym(p)
    n_query = B * max(0, N - max(t_min, 1) + 1)
    flops = B * N * elem + B * max(0, N - 1) * _compose(p) + n_query * (_query(n, p) + _c_form(n, p))
    nbytes = itemsize * (B * N * (2 * p * p + p * m + n * p) + B * m * m + B * N)
    return bound(flops, nbytes)


def lft_scan(B: int, N: int, n: int, itemsize: int = F64) -> dict:
    """csrc/lft_scan.cu: element and compose of every step, every prefix
    written (the first jitter rung); the blocks at `itemsize`, the prefixes
    float64 on both paths."""
    p = n + 1
    elem = sym(p) + p + gj(p, 3 * p) + mm(p, p, p) + p * p + sym(p)  # as select_generic's, B R^-1 B' given
    flops = B * N * elem + B * max(0, N - 1) * _compose(p)
    nbytes = itemsize * 3 * B * N * p * p + F64 * 3 * B * N * p * p
    return bound(flops, nbytes)


def lft_query(B: int, N: int, n: int, itemsize: int = F64) -> dict:
    """csrc/lft_query.cu: the C-form query of every (problem, horizon); the
    prefixes float64, C and J at `itemsize`."""
    p = n + 1
    flops = B * N * (_query(n, p) + _c_form(n, p))
    nbytes = B * N * (F64 * 3 * p * p + itemsize * (n * p + 1))
    return bound(flops, nbytes)


def backward(T_star, N: int, n: int, m: int, itemsize: int = F64) -> dict:
    """csrc/backward.cu: the active steps t < T* of each problem (T_star a
    sequence of ints); gains written for all N steps."""
    active = sum(min(max(int(t), 0), N) for t in T_star)
    B = len(T_star)
    w = m + 1 + n
    step = (mm(n, n, n) + mm(n, m, n) + mm(n, 1, n) + n + mm(n, n, n) + n * n + mm(m, m, n) + m * m
            + mm(m, n, n) + 3 * m * m + mm(m, 1, n) + m + gj(m, w) + mm(m, 1 + n, m)
            + 6 * m * n + 3 * n + 6 * m * n * n + 3 * n * n + 2 * n * n)
    flops = active * step
    reads = active * (2 * n * n + n * m + n + m + 1) + B * (n + 1 + n * n + m * m + 1)
    nbytes = itemsize * (reads + B * N * (m + m * n)) + 8 * B + B  # + T* (int64), ok (bool)
    return bound(flops, nbytes)


# sine and cosine each count 1; per step, beyond the state update
XDOT_FLOPS = {"DoubleIntegrator": 0, "Quadrotor": 70, "Cartpole_SwingUp": 25, "Segway_Balance": 6,
              "Ballbot_Balance": 25, "PointMass_Navigation": 0, "Rocket6DoF": 116}
GUARD_FLOPS = {"Quadrotor": 2 * 12 + 6, "Rocket6DoF": 6 + 2}  # the lander's: ||T|| and the two bounds
EXTRA_COST_FLOPS = {"PointMass_Navigation": 3 * 11}


def linearize(case: str, B: int, N: int, n: int, m: int, itemsize: int = F64) -> dict:
    """csrc/linearize.cu: the Jacobians A_k, B_k of B x N steps. Each of a
    step's n + m columns evaluates xdot once on dual numbers, counted as
    three times xdot's operations (each operation's value and its tangent's
    product and sum), and forms its n entries e_c + dt xdot' (a multiply-add
    each). It reads the rows k < N of X and U and writes A and B."""
    flops = B * N * (n + m) * (3 * XDOT_FLOPS[case] + 2 * n)
    nbytes = itemsize * B * N * (n + m + n * n + n * m)
    return bound(flops, nbytes)


def linesearch(case: str, T_star, N: int, n: int, m: int, A: int, x_start: bool = False, itemsize: int = F64) -> dict:
    """csrc/linesearch.cu: A rollouts of N steps per problem; the stage cost
    on the active steps k < T*, the terminal cost at min(T*, N). With
    x_start (the entry linesearch_rollout_from: each rollout starts at a
    state of its own, e.g. the one-pass method's B = 3 x batch shifted-gain
    rollouts at their own T*), those B start states are read as well."""
    B = len(T_star)
    active = sum(min(max(int(t), 0), N) for t in T_star)
    step = n + mm(m, 1, n) + 2 * m + XDOT_FLOPS[case] + GUARD_FLOPS.get(case, 0) + 2 * n
    stage = n + mm(n, 1, n) + 2 * n + m + mm(m, 1, m) + 2 * m + 5 + EXTRA_COST_FLOPS.get(case, 0)
    terminal = n + mm(n, 1, n) + 2 * n + 2
    n_term = sum(1 for t in T_star if int(t) > 0)
    flops = A * (B * N * step + active * stage + n_term * terminal)
    reads = B * ((N + 1) * n + N * (m + m * n + m)) + B * (n + m + 2 * n * n + m * m + 1)
    writes = B * A * ((N + 1) * n + N * m + 1)
    # + the alphas (float64), T* (int64) and the wrap mask (bool)
    nbytes = itemsize * (reads + writes + (B * n if x_start else 0)) + F64 * A + 8 * B + B * n
    return bound(flops, nbytes)
