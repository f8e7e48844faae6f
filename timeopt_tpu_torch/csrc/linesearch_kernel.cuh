// All-alphas forward line search (closed-loop rollouts + truncated true
// cost) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_forward.py
// linesearch_lanes_df and linesearch_dense_df (body _fwd_kernel); one kernel
// here, native float64 instead of the compensated df32 rollout; a template
// on the storage type of the data (linesearch_rollout[_from] float64, their
// _f32 twins float32, the TPU kernel's contract): each rollout carries its
// state in float64 across all N steps and stores only its float32
// rounding, as the df32 rollout lets only its high word leave. The
// first-improving-alpha selection stays outside the kernel, in torch, as
// _select_first_improving stayed outside the TPU kernel.
//
// Per (problem, alpha): N Euler steps from the start state x0 (X[0] through
// the entry linesearch_rollout; a row of any array, a batch stride apart,
// through linesearch_rollout_from: the one-pass method's shifted-gain
// rollout starts at X_ext[S] while its reference rows X_k are re-indexed)
// with
//   u_k = U_k + [k < T*] (K_k wrap(x - X_k) + alpha kappa_k),
//   x+  = x + dt xdot(x, u) (+ NaN where the system's guard holds on (x, u)),
// the raw step of the system (no norm poisoning), and the cost of
// solver/cost.py::cost_true accumulated inline: stage costs for k < T*
// (with the system's extra stage cost), the terminal cost at X[T*]. J is
// +inf unless X is finite on rows <= T*, U on the active steps, T* > 0, the
// total is finite and the whole trajectory is finite on [0, N].
//
// Bound on the H100 (chip_smoke.py's count, timeopt_tpu_torch/ops/work.py):
// the bytes. At the quadrotor's B = 1024, N = 160, A = 5 it reads X, U, K,
// kappa once (~89 MB) and writes the rollouts Xs, Us (~105 MB): ~0.059 ms
// at 3.35 TB/s, against ~0.3 GFLOP. What holds it back is the chain of N
// dependent steps of each rollout. With one thread per (problem, alpha)
// (the earlier design) 5120 threads left 92 of the 132 SMs idle, each
// thread walked the chain alone at 254 registers, its loads of K_k
// uncoalesced and its stores strided.
//
// The design spreads each rollout over a group of G lanes, G = n rounded up
// to a power of two (16 for the quadrotor, 4 for n = 4, 2 for the double
// integrator): lane i owns x_i. Each step gathers x and u by __shfl_sync
// (the n entries of x, the m controls that lanes j < m form, and the n
// entries of Q e for the stage cost), and every lane forms the error
// vectors itself from the gathered state; every shuffle and vote names the
// whole warp and is reached by every lane, idle groups included (with a
// mask per group a warp's groups took their turns; PERF.md). The
// quadrotor's sine, cosine and
// tangent of its three angles are taken once, on the three lanes that own
// them, and broadcast; every lane then evaluates the whole xdot without
// divergence and keeps its own entry. A block holds 32 / G problems and up
// to five alphas of each (160 threads; more alphas take more blocks along
// y), ~82k threads in all at the quadrotor's B = 1024 and four blocks per
// SM at <= 96 registers: one wave. The per-step inputs X_k, U_k, K_k,
// kappa_k do not depend on alpha: the block loads them for chunks of CH
// steps, coalesced and one chunk ahead with cp.async, into shared memory
// that the rollouts of a problem share; Q, R, Qf, xg and u_ref are read
// once into shared memory. Each step writes its n states as consecutive
// doubles across the group's lanes. Every entry keeps the arithmetic and
// order of the earlier kernel, and every sum over
// an index runs in that index's order on one lane (the gathered values
// summed in sequence): the results are equal bit for bit.
//
// What holds it back now (chip_smoke.py --ab, PERF.md): the step chain
// itself (the shuffles that gather x, u and Q e, and on the quadrotor the
// trigonometry), ~10x above the bound at the quadrotor's B = 1024.
//
// This header holds the kernel as a template on the system S, which gives
// n, m and static xdot(x, u, xd), guard(x, u) and extra_cost(x, u):
// csrc/linesearch.cu instantiates it for the seven hand-written systems of the
// registry (csrc/systems.cuh), ops/dyngen.py for a struct generated from a
// System's own Python functions (built at first use).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smallmat.cuh"

namespace {

constexpr int WARP = 32;
constexpr int CH = 8;       // steps per chunk of shared inputs
constexpr int A_BLOCK = 5;  // alphas per block (more alphas take more blocks along y)

// the group width: n rounded up to a power of two
__host__ __device__ constexpr int group_width(int n) {
  return n <= 2 ? 2 : n <= 4 ? 4 : n <= 8 ? 8 : n <= 16 ? 16 : 32;
}

// Every warp-level call below names the whole warp (the full mask) and is
// reached by all its lanes, idle groups included: masks that differ
// between a warp's groups made the calls run group by group (PERF.md).
constexpr unsigned FULL = 0xffffffffu;

// lane src's v within this lane's group of G lanes
template <int G>
__device__ __forceinline__ double group_read(double v, int src) {
  return __shfl_sync(FULL, v, src, G);
}

// p on every lane of this lane's group of G lanes
template <int G>
__device__ __forceinline__ bool group_all(bool p) {
  const unsigned bits = (G == WARP) ? FULL : ((1u << G) - 1u);
  return ((__ballot_sync(FULL, p) >> ((threadIdx.x & (WARP - 1)) & ~(G - 1))) & bits) == bits;
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_el(double* dst, const double* src) { cp_async8(dst, src); }
__device__ __forceinline__ void cp_async_el(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// Lane i's component of xdot(x, u), and the guard on (x, u) (uniform over
// the group). By default every lane evaluates the system's whole xdot (n <=
// 4, and the lander's 14) and keeps its own entry.
template <class S>
__device__ __forceinline__ double xdot_lane(int i, double, const double* x, const double* u, bool& bad) {
  double xd[S::n];
  S::xdot(x, u, xd);
  bad = S::guard(x, u);
  double r = 0.0;
#pragma unroll
  for (int q = 0; q < S::n; ++q)
    if (q == i) r = xd[q];
  return r;
}

// One chunk of per-step inputs of the block's problems: for each problem
// [X_k (CH x n) | U_k (CH x m) | K_k (CH x m x n) | kappa_k (CH x m)],
// steps k0 .. k0 + CH - 1 (fewer at the end), each a contiguous run of
// global memory copied one element (8 or 4 bytes) a thread, in one loop
// over the slots of all the block's problems.
template <typename Fp, int n, int m, int PB, int D>
__device__ void load_chunk(Fp (*buf)[CH * D], const Fp* X, const Fp* U, const Fp* K, const Fp* kap, int b0, int B, int N,
                           int k0) {
  constexpr int PER = CH * D;  // slots of one problem
  const int len = min(CH, N - k0);
  const int nq = min(PB, B - b0);
  for (int idx = threadIdx.x; idx < nq * PER; idx += blockDim.x) {
    const int q = idx / PER, i = idx - q * PER;
    const size_t bq = (size_t)(b0 + q);
    Fp* d = buf[q] + i;
    if (i < CH * n) {
      if (i < len * n) cp_async_el(d, X + (bq * (N + 1) + k0) * n + i);
    } else if (i < CH * (n + m)) {
      const int j = i - CH * n;
      if (j < len * m) cp_async_el(d, U + (bq * N + k0) * m + j);
    } else if (i < CH * (n + m + m * n)) {
      const int j = i - CH * (n + m);
      if (j < len * m * n) cp_async_el(d, K + (bq * N + k0) * m * n + j);
    } else {
      const int j = i - CH * (n + m + m * n);
      if (j < len * m) cp_async_el(d, kap + (bq * N + k0) * m + j);
    }
  }
  cp_async_commit();
}

// Fp: the storage type of every floating input but the alphas, and of Xs,
// Us and Js (double, or float on the float32 path). Every operation is
// double: the state is carried in double across all N steps, and only
// its rounding to Fp is stored (the counterpart of the JAX package's df32
// rollout, which lets only the high word leave).
template <class S, typename Fp>
__global__ void __launch_bounds__(WARP * A_BLOCK, 4) linesearch_kernel(const Fp* __restrict__ X, const Fp* __restrict__ U,
                                  const Fp* __restrict__ K, const Fp* __restrict__ kap,
                                  const int64_t* __restrict__ T_star,
                                  const Fp* __restrict__ xg, const Fp* __restrict__ u_ref,
                                  const Fp* __restrict__ Q, const Fp* __restrict__ R,
                                  const Fp* __restrict__ Qf, const Fp* __restrict__ w,
                                  const bool* __restrict__ wrap_mask,
                                  const double* __restrict__ alphas, Fp* __restrict__ Xs,
                                  Fp* __restrict__ Us, Fp* __restrict__ Js,
                                  const Fp* __restrict__ x0, long long x0_stride, int B, int N,
                                  int A, double dt, int state_wrap_bits) {
  constexpr int n = S::n, m = S::m;
  constexpr int G = group_width(n);
  constexpr int PB = WARP / G;          // problems per block
  constexpr int D = n + m + m * n + m;  // doubles of one step's shared inputs
  constexpr int LQ = n + 1;             // padded row of Q and Qf (no bank conflicts)
  static_assert(m <= G, "lane j < m forms control j");
  __shared__ Fp chunk[2][PB][CH * D];
  __shared__ double sQ[PB][n * LQ], sQf[PB][n * LQ], sR[PB][m * m], sxg[PB][n], sur[PB][m];

  const int tid = threadIdx.x, nt = blockDim.x;
  const int b0 = blockIdx.x * PB;
  for (int idx = tid; idx < PB * n * n; idx += nt) {
    const int q = idx / (n * n), r = idx - q * (n * n);
    if (b0 + q < B) {
      const int i = r / n, j = r - i * n;
      sQ[q][i * LQ + j] = Q[(size_t)(b0 + q) * n * n + r];
      sQf[q][i * LQ + j] = Qf[(size_t)(b0 + q) * n * n + r];
    }
  }
  for (int idx = tid; idx < PB * m * m; idx += nt) {
    const int q = idx / (m * m);
    if (b0 + q < B) sR[q][idx - q * m * m] = R[(size_t)(b0 + q) * m * m + idx - q * m * m];
  }
  for (int idx = tid; idx < PB * n; idx += nt) {
    const int q = idx / n;
    if (b0 + q < B) sxg[q][idx - q * n] = xg[(size_t)(b0 + q) * n + idx - q * n];
  }
  for (int idx = tid; idx < PB * m; idx += nt) {
    const int q = idx / m;
    if (b0 + q < B) sur[q][idx - q * m] = u_ref[(size_t)(b0 + q) * m + idx - q * m];
  }
  const int nch = (N + CH - 1) / CH;
  if (nch > 0) load_chunk<Fp, n, m, PB, D>(chunk[0], X, U, K, kap, b0, B, N, 0);

  // this thread: lane li of the group of rollout (problem b, alpha a)
  const int ab = blockDim.x / WARP;  // alphas in this block's rows
  const int grp = tid / G, li = tid - grp * G;
  const int pb = grp / ab, a = blockIdx.y * ab + (grp - pb * ab);
  const int b = b0 + pb;
  const bool valid = b < B && a < A;
  const double alpha = valid ? alphas[a] : 0.0;
  const int64_t T = valid ? T_star[b] : 0;
  const int64_t T_term = T > N ? N : T;  // cost_true clips the terminal row
  const double wb = valid ? w[b] : 0.0;
  int wm = 0;  // wrap_mask of the problem, one bit per state
  for (int i = 0; i < n && valid; ++i) wm |= (int)wrap_mask[(size_t)b * n + i] << i;
  Fp* Xo = Xs + ((size_t)(valid ? b : 0) * A + a) * (N + 1) * n;
  Fp* Uo = Us + ((size_t)(valid ? b : 0) * A + a) * N * m;

  const bool wmi = (wm >> li) & 1;
  const bool wrapi = li < n && ((state_wrap_bits >> li) & 1);

  double xi = (valid && li < n) ? x0[(size_t)b * x0_stride + li] : 0.0;
  double run = 0.0, jt = 0.0;
  if (valid && li < n) Xo[li] = xi;
  bool fa = group_all<G>(li >= n || isfinite(xi)), ft = fa, fu = true;

  for (int c = 0; c < nch; ++c) {
    if (c + 1 < nch) {
      load_chunk<Fp, n, m, PB, D>(chunk[(c + 1) & 1], X, U, K, kap, b0, B, N, (c + 1) * CH);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    {  // every group, idle ones too: they read stale rows and store nothing
      const Fp* d = chunk[c & 1][pb];
      const int k0 = c * CH, len = min(CH, N - k0);
      for (int kk = 0; kk < len; ++kk) {
        const int k = k0 + kk;
        const bool active = k < T;
        const Fp* Xk = d + kk * n;
        const Fp* Uk = d + CH * n + kk * m;
        const Fp* Kk = d + CH * (n + m) + kk * m * n;
        const Fp* ck = d + CH * (n + m + m * n) + kk * m;

        // the state whole on every lane; each lane forms the error vectors
        // itself, with lane i's arithmetic for entry i
        double x[n], e[n], u[m];
#pragma unroll
        for (int i = 0; i < n; ++i) x[i] = group_read<G>(xi, i);
#pragma unroll
        for (int i = 0; i < n; ++i) {
          const double dd = x[i] - Xk[i];
          e[i] = ((wm >> i) & 1) ? angle_normalize(dd) : dd;
        }
        double uj = 0.0;
        if (li < m) {
          double s = 0.0;
#pragma unroll
          for (int i = 0; i < n; ++i) s += Kk[li * n + i] * e[i];
          const double du = s + alpha * ck[li];
          uj = Uk[li] + (active ? du : 0.0);
        }
#pragma unroll
        for (int j = 0; j < m; ++j) u[j] = group_read<G>(uj, j);

        if (__any_sync(FULL, active)) {  // stage cost on the current state, kept where active
#pragma unroll
          for (int i = 0; i < n; ++i) {
            const double dd = x[i] - sxg[pb][i];
            e[i] = ((wm >> i) & 1) ? angle_normalize(dd) : dd;
          }
          double si = 0.0;
          if (li < n) {
#pragma unroll
            for (int j = 0; j < n; ++j) si += sQ[pb][li * LQ + j] * e[j];
          }
          double qe = 0.0, rd = 0.0;
#pragma unroll
          for (int i = 0; i < n; ++i) qe += e[i] * group_read<G>(si, i);
#pragma unroll
          for (int i = 0; i < m; ++i) {
            double s = 0.0;
#pragma unroll
            for (int j = 0; j < m; ++j) s += sR[pb][i * m + j] * (u[j] - sur[pb][j]);
            rd += (u[i] - sur[pb][i]) * s;
          }
          if (active) run += ((0.5 * qe + 0.5 * rd) + wb) + S::extra_cost(x, u);
        }

        bool bad;
        const double xdi = xdot_lane<S>(li, xi, x, u, bad);
        double v = xi + dt * xdi;
        if (wrapi) v = angle_normalize(v);
        const double xni = bad ? v + NAN : v;

        const bool term = k + 1 == T_term;
        if (__any_sync(FULL, term)) {  // terminal cost at X[T*], kept where term
          double e3i = 0.0;
          if (li < n) {
            const double dd = xni - sxg[pb][li];
            e3i = wmi ? angle_normalize(dd) : dd;
          }
#pragma unroll
          for (int i = 0; i < n; ++i) e[i] = group_read<G>(e3i, i);
          double si = 0.0;
          if (li < n) {
#pragma unroll
            for (int j = 0; j < n; ++j) si += sQf[pb][li * LQ + j] * e[j];
          }
          double qe = 0.0;
#pragma unroll
          for (int i = 0; i < n; ++i) qe += e[i] * group_read<G>(si, i);
          if (term) jt = run + 0.5 * qe;
        }

        const bool nfin = group_all<G>(li >= n || isfinite(xni));
        if (valid && li < n) Xo[(size_t)(k + 1) * n + li] = xni;
        bool ufin = true;
#pragma unroll
        for (int j = 0; j < m; ++j) ufin = ufin && isfinite(u[j]);
        if (valid && li < m) Uo[(size_t)k * m + li] = uj;
        fa = fa && nfin;
        if (k + 1 <= T) ft = ft && nfin;
        if (active) fu = fu && ufin;
        xi = xni;
      }
    }
    __syncthreads();  // chunk c & 1 is refilled next
  }
  if (valid && li == 0) {
    const bool ok = ft && fu && (T > 0) && isfinite(jt) && fa;
    Js[(size_t)b * A + a] = ok ? jt : INFINITY;
  }
}

template <class S, typename Fp>
int launch(const void* X, const void* U, const void* K, const void* kap, const void* T_star,
           const void* xg, const void* u_ref, const void* Q, const void* R, const void* Qf,
           const void* w, const void* wrap_mask, const void* alphas, void* Xs, void* Us,
           void* Js, const void* x0, long long x0_stride, int B, int N, int n, int m, int A,
           double dt, int state_wrap_bits, cudaStream_t stream) {
  if (n != S::n || m != S::m || A < 1) return (int)cudaErrorInvalidValue;
  constexpr int PB = WARP / group_width(S::n);
  const int ab = A < A_BLOCK ? A : A_BLOCK;
  const dim3 grid((B + PB - 1) / PB, (A + ab - 1) / ab);
  if (grid.x > 0) {
    linesearch_kernel<S, Fp><<<grid, WARP * ab, 0, stream>>>(
        (const Fp*)X, (const Fp*)U, (const Fp*)K, (const Fp*)kap, (const int64_t*)T_star, (const Fp*)xg,
        (const Fp*)u_ref, (const Fp*)Q, (const Fp*)R, (const Fp*)Qf, (const Fp*)w, (const bool*)wrap_mask,
        (const double*)alphas, (Fp*)Xs, (Fp*)Us, (Fp*)Js, (const Fp*)x0, x0_stride, B, N, A, dt, state_wrap_bits);
  }
  return (int)cudaGetLastError();
}

}  // namespace
