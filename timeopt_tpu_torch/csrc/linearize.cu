// The Jacobians of the Euler step of a registry system along a batch of
// trajectories, for every step k of every problem b:
//   A_k = I + dt df/dx (x_k, u_k),   B_k = dt df/du (x_k, u_k),
// f the system's xdot of csrc/systems.cuh (System.device_id 0..6), the very
// formulas the line search (csrc/linesearch.cu) integrates.
//
// The port's own kernel: it replaces no TPU kernel (the JAX package leaves
// jacfwd to XLA, timeopt_tpu/solver/linearize.py). It replaces, on the card,
// solver/linearize.py::linearize_ad, vmap(jacfwd) of the step over all B * N
// steps, whose every primitive was an elementwise launch over B * N * (n + m)
// tangents. It keeps that path's semantics: the wrap (angle_normalize) has
// derivative 1 and the guard's NaN payload is additive and constant, so
// neither enters the Jacobian (a guarded state keeps a finite one), and a
// non-finite x or u reaches the entries that AD's tangents reach (the
// tangent rules of csrc/dual.cuh). Float32 or float64 X and U are read, the
// arithmetic is double, and each entry is rounded once to the storage type
// on the way out (the port's float32 rule).
//
// Bound on the H100 (timeopt_tpu_torch/ops/work.py): the bytes. At the
// quadrotor's B = 1024, N = 160 in float32 it writes A and B (~126 MB) and
// reads X and U (~10.5 MB): ~0.041 ms at 3.35 TB/s.
//
// Design: one thread per (step, Jacobian column), n + m threads a step (16
// for the quadrotor, 6 for PointMass). Each thread evaluates xdot once on
// dual numbers seeded at its column (a whole (n + m)-tangent dual in one
// thread would hold ~200 doubles and spill) and writes that column of
// [A | B]. The n + m threads of a step are adjacent, so for each row i they
// store consecutive entries of A (and of B): a step's n (n + m) entries are
// written by n store instructions, each in full sectors where a row is 32
// bytes or a multiple of it. The lanes of a step read the same x_k and u_k,
// which L1 serves once.
#include "dual.cuh"
#include "systems.cuh"

#include <stdint.h>

namespace {

// Column c of the Jacobian [A_k | B_k] of system S's Euler step at (x, u),
// into col[0 .. n-1]: xdot evaluated once on duals seeded at input c (x_c
// for c < n, else u_(c - n)), then the tangent of x + dt xdot, e_c + dt
// xdot' (e_c's entries are 0 for a column of B), as AD forms it.
template <class S>
__device__ __forceinline__ void jacobian_column(const double* xv, const double* uv, int c, double dt, double* col) {
  constexpr int n = S::n, m = S::m;
  Dual x[n], u[m], xd[n];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = {xv[i], i == c ? 1.0 : 0.0};
#pragma unroll
  for (int j = 0; j < m; ++j) u[j] = {uv[j], n + j == c ? 1.0 : 0.0};
  S::xdot(x, u, xd);
#pragma unroll
  for (int i = 0; i < n; ++i) col[i] = (i == c ? 1.0 : 0.0) + dt * xd[i].d;
}

}  // namespace

#ifdef __CUDACC__  // the kernel and its entries (the column above also builds on the host)

namespace {

constexpr int THREADS = 256;

template <class S, typename Fp>
__global__ void __launch_bounds__(THREADS) linearize_kernel(const Fp* __restrict__ X, const Fp* __restrict__ U,
                                                           Fp* __restrict__ A, Fp* __restrict__ Bm, long long steps,
                                                           int N, long long x_stride, long long u_stride, double dt) {
  constexpr int n = S::n, m = S::m, C = n + m;
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long s = t / C;  // step b * N + k
  if (s >= steps) return;
  const int c = (int)(t - s * C);
  const long long b = s / N;
  const int k = (int)(s - b * N);
  const Fp* xk = X + b * x_stride + (long long)k * n;
  const Fp* uk = U + b * u_stride + (long long)k * m;
  double x[n], u[m], col[n];
#pragma unroll
  for (int i = 0; i < n; ++i) x[i] = (double)xk[i];
#pragma unroll
  for (int j = 0; j < m; ++j) u[j] = (double)uk[j];
  jacobian_column<S>(x, u, c, dt, col);
  Fp* out = c < n ? A + s * (n * n) + c : Bm + s * (n * m) + (c - n);
  const int row = c < n ? n : m;  // the stride between the column's entries
#pragma unroll
  for (int i = 0; i < n; ++i) out[i * row] = (Fp)col[i];
}

template <class S, typename Fp>
int launch(const void* X, const void* U, void* A, void* Bm, int B, int N, int n, int m, long long x_stride,
           long long u_stride, double dt, cudaStream_t stream) {
  if (n != S::n || m != S::m || B < 0 || N < 0) return (int)cudaErrorInvalidValue;
  const long long steps = (long long)B * N;
  const long long blocks = (steps * (S::n + S::m) + THREADS - 1) / THREADS;
  if (blocks > 0) {
    linearize_kernel<S, Fp><<<(unsigned)blocks, THREADS, 0, stream>>>((const Fp*)X, (const Fp*)U, (Fp*)A, (Fp*)Bm,
                                                                     steps, N, x_stride, u_stride, dt);
  }
  return (int)cudaGetLastError();
}

// The registry's struct of system_id (systems.cuh::with_system). Problem
// b's rows of X and U start x_stride and u_stride elements after problem
// b - 1's.
template <typename Fp>
int jacobians(const void* X, const void* U, void* A, void* Bm, int B, int N, int n, int m, long long x_stride,
              long long u_stride, int system_id, double dt, void* stream) {
  return with_system(system_id, [&](auto sys) {
    return launch<decltype(sys), Fp>(X, U, A, Bm, B, N, n, m, x_stride, u_stride, dt, (cudaStream_t)stream);
  });
}

}  // namespace

// float64 X, U -> float64 A, B
extern "C" int linearize_jacobians(const void* X, const void* U, void* A, void* Bm, int B, int N, int n, int m,
                                   long long x_stride, long long u_stride, int system_id, double dt, void* stream) {
  return jacobians<double>(X, U, A, Bm, B, N, n, m, x_stride, u_stride, system_id, dt, stream);
}

// float32 X, U -> float32 A, B (double arithmetic, one rounding a store)
extern "C" int linearize_jacobians_f32(const void* X, const void* U, void* A, void* Bm, int B, int N, int n, int m,
                                       long long x_stride, long long u_stride, int system_id, double dt,
                                       void* stream) {
  return jacobians<float>(X, U, A, Bm, B, N, n, m, x_stride, u_stride, system_id, dt, stream);
}

#endif  // __CUDACC__
