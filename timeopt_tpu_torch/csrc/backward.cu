// Truncated iLQR backward pass (reverse Riccati sweep) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_backward.py
// backward_lanes_df and backward_dense_df (body _backward_kernel ->
// _backward_step_body); one kernel here, native float64 instead of df32:
// a template on the storage type of every floating input and of kappa and
// K (backward_truncated float64, backward_truncated_f32 float32, the TPU
// kernel's contract), staged as it is, converted as it is read; the
// Riccati recursion runs in float64 on both, and each gain is rounded once,
// on its store.
// Contract of timeopt_tpu/solver/backward.py::_backward_arrays per problem:
// ok starts as T* > 0; at t+1 == T* the terminal expansion (Vx = QfeT_t,
// Vxx = Qf) is injected and ok &= eT_ok_t; each active step t < T* forms
// the Q-expansion, eliminates [sym(Quu) + lambda I | Qu | Qux] by
// pivot-free Gauss-Jordan (the pivots are the PD test), sets
// kappa = -Quu_reg^-1 Qu, K = -Quu_reg^-1 Qux, updates the value with the
// UNREGULARIZED Quu in the full K'Quu K form, and ANDs ok with
// pd & step_ok_t & finite(Vx_new, Vxx_new). Steps t >= T* get zero gains.
//
// Bound on the H100 (chip_smoke.py's count, timeopt_tpu_torch/ops/work.py):
// a step reads (2n^2 + nm + n + m + 1) doubles, 2.7 KB on the quadrotor
// (n = 12, m = 4), and does ~13 kFLOP, so the call is bound by bytes
// (~0.07 ms at B = 1024 for the T* of the first iterate). What holds it
// back is the chain of T* dependent steps a problem. The earlier design
// ran each problem in one block of 128 threads mapped over matrix entries
// (at n <= 4, m <= 2 nearly all of them idle), crossed ~18 block-wide
// barriers a step, read each step's inputs at the step's head, gathered
// the finite test in one shared flag and ran the PD test on one thread.
//
// The design: one warp a problem, four problems a block, and no
// block-wide barrier at all; each warp runs its own T* steps. Lane c < m
// holds column c of the u-block, lane m the Qu column, lane m + 1 + j
// column j of the x-block (m + 1 + n <= 21 lanes; 18 for the lander's
// (14, 3)):
// - the lanes of the x- and u-columns form Vxx [A | B] a column each, then
//   A' (Vxx A) + Qs and B' (Vxx B) + R (Qxx, Quu), the x-lanes B' (Vxx A)
//   (Qux) and lx + A' Vx, the Qu lane lu + B' Vx; the per-warp shared
//   memory only stages what another lane reads (Vxx, Vx, Quu, K, Qux);
// - [sym(Quu) + lambda I | Qu | Qux] is swept in registers, one column a
//   lane, the pivot column broadcast by __shfl_sync (csrc/warpmat.cuh);
// - Quu [kappa | K], Vx_new (kappa, Qu and Quu kappa shuffled from the Qu
//   lane) and Vxx_new a column a lane; the finite test and the PD test
//   are votes of the whole warp (__all_sync);
// - step t-1's A, B, Qs, lx, lu and step_ok are in flight by cp.async
//   into the warp's second buffer while step t computes;
// - the zero gains of the steps t >= T* are written coalesced.
// Every entry keeps the arithmetic and the operation order of the earlier
// kernel (each inner sum in index order, each division by the pivot, each
// M - col * row update, each symmetrization), so kappa, K and ok are equal
// to it bit for bit. The loops run over a compile-time n for the
// registry's shapes, and over a compile-time m where m >= 2: with m = 1
// known to the compiler the cart-pole's, segway's and ballbot's gains
// moved off the earlier kernel's in the last bits (chip_smoke.py --ab;
// the compiled difference was not pinned down), so m = 1 stays a runtime
// bound. The additions that join two sums are written __dadd_rn, which no
// contraction reaches.
//
// What holds it back now (PERF.md section 6): the quadrotor at B = 1024
// runs 0.363 ms against the earlier kernel's 1.41 (bound 0.070 ms), PointMass
// 0.380 against 2.08 (bound 0.021 ms, T* up to 220 steps). A quadrotor
// step is mostly the products Vxx [A | B] and the Q-expansion (n = 12,
// operands from shared memory) and the m-pivot sweep, whose every pivot
// waits on a shuffle and a float64 division; a PointMass step mostly the
// sweep.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "warpmat.cuh"

namespace {

using namespace warpmat;

constexpr int NMAX = 12;  // any shape at run time: n <= 12, m <= 8
constexpr int MMAX = 8;
constexpr int NWIDE = 14, MWIDE = 3;  // the 6-DoF lander's (n, m), compiled alone past NMAX
constexpr int WPB = 4;  // warps, hence problems, a block

// inputs of one step in the storage type Fp (double, or float on the float32
// path, converted to double where they are read)
template <typename Fp, int NT, int MT>
struct Stage {
  Fp A[NT * NT], B[NT * MT], Qs[NT * NT], lx[NT], lu[MT], sok;
};
template <typename Fp, int NT, int MT>
struct WarpSmem {
  Stage<Fp, NT, MT> st[2];
  double Vxx[NT * NT], Vx[NT], R[MT * MT], Quu[MT * MT], K[MT * NT], Qux[MT * NT], Vraw[NT * NT];
};

template <typename Fp, int NT, int MT>
__device__ __forceinline__ void load_step(Stage<Fp, NT, MT>& st, const Fp* A, const Fp* Bm, const Fp* Qs, const Fp* lx,
                                          const Fp* lu, const Fp* step_ok, size_t bt, int n, int m, int lane) {
  for (int i = lane; i < n * n; i += WARP) {
    cp_async_el(&st.A[i], A + bt * n * n + i);
    cp_async_el(&st.Qs[i], Qs + bt * n * n + i);
  }
  for (int i = lane; i < n * m; i += WARP) cp_async_el(&st.B[i], Bm + bt * n * m + i);
  if (lane < n) cp_async_el(&st.lx[lane], lx + bt * n + lane);
  if (lane < m) cp_async_el(&st.lu[lane], lu + bt * m + lane);
  if (lane == 0) cp_async_el(&st.sok, step_ok + bt);
  cp_async_commit();
}

// Fp: the storage type of every floating input and of kappa and K (double,
// or float on the float32 path: one rounding, as the gains are stored);
// every operation is double. NT x MT register arrays; EXN: n = NT, EXM:
// m = MT, known to the compiler
template <typename Fp, int NT, int MT, bool EXN, bool EXM>
__global__ void __launch_bounds__(WPB * WARP, 4)
backward_kernel(const Fp* __restrict__ A, const Fp* __restrict__ Bm, const Fp* __restrict__ lx,
                const Fp* __restrict__ lu, const Fp* __restrict__ Qs, const Fp* __restrict__ QfeT,
                const Fp* __restrict__ eT_ok, const Fp* __restrict__ step_ok, const Fp* __restrict__ Qf,
                const Fp* __restrict__ R, const int64_t* __restrict__ T_star, const Fp* __restrict__ lm,
                Fp* __restrict__ kappa, Fp* __restrict__ Kout, bool* __restrict__ ok_out, int Bsz, int N,
                int n_arg, int m_arg) {
  constexpr int GR = NT < 4 ? NT : 4;  // rows of Vxx_new a lane forms at a time
  const int n = EXN ? NT : n_arg, m = EXM ? MT : m_arg;
  __shared__ WarpSmem<Fp, NT, MT> S[WPB];
  const int warp = threadIdx.x / WARP, lane = threadIdx.x - warp * WARP;
  const int b = blockIdx.x * WPB + warp;
  if (b >= Bsz) return;
  WarpSmem<Fp, NT, MT>& W = S[warp];
  const int64_t T = T_star[b];
  const int t_hi = (int)(T < 0 ? 0 : (T > N ? N : T));  // active steps: t < t_hi
  const double lam = lm[b];

  // zero gains on the inactive steps t >= T*: two contiguous runs
  for (size_t i = ((size_t)b * N + t_hi) * m + lane; i < ((size_t)b + 1) * N * m; i += WARP) kappa[i] = 0.0;
  for (size_t i = ((size_t)b * N + t_hi) * m * n + lane; i < ((size_t)b + 1) * N * m * n; i += WARP) Kout[i] = 0.0;
  for (int i = lane; i < n; i += WARP) W.Vx[i] = 0.0;
  for (int i = lane; i < n * n; i += WARP) W.Vxx[i] = 0.0;
  for (int i = lane; i < m * m; i += WARP) W.R[i] = R[(size_t)b * m * m + i];
  bool ok = T > 0;

  // lane roles: u-column uc = lane < m, the Qu column at lane m, x-column
  // xj = lane - m - 1 < n
  const int uc = lane, xj = lane - m - 1;
  const bool is_u = lane < m, is_qu = lane == m, is_x = xj >= 0 && xj < n;

  if (t_hi > 0) load_step<Fp, NT, MT>(W.st[0], A, Bm, Qs, lx, lu, step_ok, (size_t)b * N + t_hi - 1, n, m, lane);
  int it = 0;
  for (int t = t_hi - 1; t >= 0; --t, ++it) {
    const size_t bt = (size_t)b * N + t;
    if (t >= 1) {
      load_step<Fp, NT, MT>(W.st[(it + 1) & 1], A, Bm, Qs, lx, lu, step_ok, bt - 1, n, m, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    if (t + 1 == T) {  // terminal injection
      for (int i = lane; i < n; i += WARP) W.Vx[i] = QfeT[bt * n + i];
      for (int i = lane; i < n * n; i += WARP) W.Vxx[i] = Qf[(size_t)b * n * n + i];
      ok = ok && (eT_ok[bt] > 0.5);
    }
    __syncwarp();
    const Stage<Fp, NT, MT>& st = W.st[it & 1];

    // Z: column xj of A (x-lanes) or uc of B (u-lanes); VZ = Vxx Z (the Qu
    // lane takes Vx instead); x-lanes: Qx = lx + A'Vx, entry xj. Every sum
    // runs over l in order; the loop over l is outside, so each l feeds NT
    // independent sums (the same operations as one sum after another).
    double Z[NT], VZ[NT];
#pragma unroll
    for (int l = 0; l < NT; ++l) {
      Z[l] = (l < n) ? (is_x ? st.A[l * n + xj] : (is_u ? st.B[l * m + uc] : 0.0)) : 0.0;
      VZ[l] = 0.0;
    }
    double qs = 0.0;
#pragma unroll
    for (int l = 0; l < NT; ++l) {
      if (l < n) {
        const double z = Z[l];
#pragma unroll
        for (int i = 0; i < NT; ++i)
          if (i < n) VZ[i] += W.Vxx[i * n + l] * z;
        qs += z * W.Vx[l];
      }
    }
    if (is_qu) {
#pragma unroll
      for (int i = 0; i < NT; ++i) VZ[i] = (i < n) ? W.Vx[i] : 0.0;
    }
    const double qx = is_x ? __dadd_rn(st.lx[xj], qs) : 0.0;
    // x-lanes: Qxx = Qs + A'(Vxx A) and Qux = B'(Vxx A), column xj;
    // u-lanes: Quu = R + B'(Vxx B), column uc; the Qu lane: Qu = lu + B'Vx
    double Q1[NT], Q2[MT];
    {
      const Fp* op = is_x ? st.A : st.B;
      const int ld = is_x ? n : m, rows = is_x ? n : (is_u ? m : 0);
      double s1[NT], s2[MT];
#pragma unroll
      for (int i = 0; i < NT; ++i) s1[i] = 0.0;
#pragma unroll
      for (int i = 0; i < MT; ++i) s2[i] = 0.0;
#pragma unroll
      for (int l = 0; l < NT; ++l) {
        if (l < n) {
          const double v = VZ[l];
#pragma unroll
          for (int i = 0; i < NT; ++i)
            if (i < rows) s1[i] += op[l * ld + i] * v;
#pragma unroll
          for (int i = 0; i < MT; ++i)
            if (i < m) s2[i] += st.B[l * m + i] * v;
        }
      }
      // float64: one pointer pick (a select per element cost the PointMass backward ~5%)
      if constexpr (std::is_same_v<Fp, double>) {
        const double* base = is_x ? st.Qs + xj : W.R + uc;
#pragma unroll
        for (int i = 0; i < NT; ++i) Q1[i] = (i < rows) ? __dadd_rn(base[i * ld], s1[i]) : 0.0;
      } else {  // st.Qs float, W.R double: a select per element
#pragma unroll
        for (int i = 0; i < NT; ++i)
          Q1[i] = (i < rows) ? __dadd_rn(is_x ? (double)st.Qs[xj + i * ld] : W.R[uc + i * ld], s1[i]) : 0.0;
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) Q2[i] = (i < m && (is_x || is_qu)) ? (is_qu ? __dadd_rn(st.lu[i], s2[i]) : s2[i]) : 0.0;
    }
    if (is_u) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < m) W.Quu[i * m + uc] = Q1[i];
    }
    __syncwarp();

    // [sym(Quu) + lambda I | Qu | Qux], column `lane`; its sweep
    bool fin = true;
    double M[1][MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      double x = 0.0;
      if (i < m) {
        if (is_u) {
          x = 0.5 * (W.Quu[i * m + uc] + W.Quu[uc * m + i]) + (i == uc ? lam : 0.0);
          fin = fin && isfinite(x);
        } else {
          x = Q2[i];
        }
      }
      M[0][i] = x;
    }
    const double piv = gj_sweep<MT, 1>(M, m, lane);
    const bool pd = __all_sync(FULL, piv > 0.0 && isfinite(piv));

    // lane m + j': column j' of Quu [kappa | K] (the unregularized Quu)
    double QK[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) QK[i] = 0.0;
#pragma unroll
    for (int l = 0; l < MT; ++l) {
      if (l < m) {
        const double x = -M[0][l];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          if (i < m) QK[i] += W.Quu[i * m + l] * x;
      }
    }
    // gains out; K and Qux staged for the transposed reads of Vxx_new
    double Kc[MT];
#pragma unroll
    for (int i = 0; i < MT; ++i) Kc[i] = -M[0][i];
    if (is_qu) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        if (i < m) kappa[bt * m + i] = Kc[i];
    }
    if (is_x) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m) {
          Kout[bt * m * n + i * n + xj] = Kc[i];
          W.K[i * n + xj] = Kc[i];
          W.Qux[i * n + xj] = Q2[i];
        }
      }
    }
    // Qu, -kappa and Quu kappa from the Qu lane (its Q2, M and QK)
    double qu[MT], xm[MT], qk[MT];
#pragma unroll
    for (int l = 0; l < MT; ++l) {
      qu[l] = __shfl_sync(FULL, Q2[l], m);
      xm[l] = __shfl_sync(FULL, M[0][l], m);
      qk[l] = __shfl_sync(FULL, QK[l], m);
    }
    __syncwarp();
    if (is_x) {
      // Vx_new = Qx + K'Qu + Qux'kappa + K'(Quu kappa), entry xj
      double a = 0.0, c = 0.0, d = 0.0;
#pragma unroll
      for (int l = 0; l < MT; ++l) {
        if (l < m) {
          a += Kc[l] * qu[l];
          c += Q2[l] * (-xm[l]);
          d += Kc[l] * qk[l];
        }
      }
      const double vx = __dadd_rn(__dadd_rn(__dadd_rn(qx, a), c), d);
      fin = fin && isfinite(vx);
      W.Vx[xj] = vx;
      // Qxx + K'Qux + Qux'K + K'(Quu K), column xj, GR rows at a time
#pragma unroll
      for (int i0 = 0; i0 < NT; i0 += GR) {
        double a2[GR], c2[GR], d2[GR];
#pragma unroll
        for (int r = 0; r < GR; ++r) a2[r] = c2[r] = d2[r] = 0.0;
#pragma unroll
        for (int l = 0; l < MT; ++l) {
          if (l < m) {
#pragma unroll
            for (int r = 0; r < GR; ++r) {
              const int i = i0 + r;
              if (i < n) {
                const double Kli = W.K[l * n + i];
                a2[r] += Kli * Q2[l];
                c2[r] += W.Qux[l * n + i] * Kc[l];
                d2[r] += Kli * QK[l];
              }
            }
          }
        }
#pragma unroll
        for (int r = 0; r < GR; ++r)
          if (i0 + r < n) W.Vraw[(i0 + r) * n + xj] = __dadd_rn(__dadd_rn(__dadd_rn(Q1[i0 + r], a2[r]), c2[r]), d2[r]);
      }
    }
    __syncwarp();
    // Vxx_new = sym(Vraw), column xj
    if (is_x) {
#pragma unroll
      for (int i = 0; i < NT; ++i) {
        if (i < n) {
          const double x = 0.5 * (W.Vraw[i * n + xj] + W.Vraw[xj * n + i]);
          fin = fin && isfinite(x);
          W.Vxx[i * n + xj] = x;
        }
      }
    }
    fin = __all_sync(FULL, fin);
    ok = ok && pd && fin && (st.sok > 0.5);
    __syncwarp();
  }
  if (lane == 0) ok_out[b] = ok;
}

template <typename Fp, int NT, int MT, bool EXN, bool EXM>
void launch(const void* A, const void* Bm, const void* lx, const void* lu, const void* Qs, const void* QfeT,
            const void* eT_ok, const void* step_ok, const void* Qf, const void* R, const void* T_star,
            const void* lm, void* kappa, void* K, void* ok, int B, int N, int n, int m, cudaStream_t stream) {
  backward_kernel<Fp, NT, MT, EXN, EXM><<<(B + WPB - 1) / WPB, WPB * WARP, 0, stream>>>(
      (const Fp*)A, (const Fp*)Bm, (const Fp*)lx, (const Fp*)lu, (const Fp*)Qs, (const Fp*)QfeT, (const Fp*)eT_ok,
      (const Fp*)step_ok, (const Fp*)Qf, (const Fp*)R, (const int64_t*)T_star, (const Fp*)lm, (Fp*)kappa, (Fp*)K,
      (bool*)ok, B, N, n, m);
}

template <typename Fp>
int backward(const void* A, const void* Bm, const void* lx, const void* lu, const void* Qs, const void* QfeT,
             const void* eT_ok, const void* step_ok, const void* Qf, const void* R, const void* T_star,
             const void* lm, void* kappa, void* K, void* ok, int B, int N, int n, int m, void* stream) {
  const bool wide = n == NWIDE && m == MWIDE;
  if (n < 1 || (n > NMAX && !wide) || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    // the registry's shapes with n known to the compiler: (n, m) = (2, 1)
    // double integrator, (4, 1) cart-pole, segway, ballbot (m at run time,
    // see the head of the file), (4, 2) PointMass, (12, 4) quadrotor, (14, 3)
    // the 6-DoF lander (45 KB of shared memory a block at float64); any other
    // shape at run time, in arrays of the bounds (ops/cuda_backward.py::tier,
    // the same rule)
#define BW_LAUNCH(NT, MT, EXN, EXM) \
  launch<Fp, NT, MT, EXN, EXM>(A, Bm, lx, lu, Qs, QfeT, eT_ok, step_ok, Qf, R, T_star, lm, kappa, K, ok, B, N, n, m, s)
    if (n == 2 && m == 1) BW_LAUNCH(2, 1, true, false);
    else if (n == 4 && m == 1) BW_LAUNCH(4, 1, true, false);
    else if (n == 4 && m == 2) BW_LAUNCH(4, 2, true, true);
    else if (n == 12 && m == 4) BW_LAUNCH(12, 4, true, true);
    else if (wide) BW_LAUNCH(NWIDE, MWIDE, true, true);
    else BW_LAUNCH(NMAX, MMAX, false, false);
#undef BW_LAUNCH
  }
  return (int)cudaGetLastError();
}

}  // namespace

// float64 inputs, kappa and K
extern "C" int backward_truncated(const void* A, const void* Bm, const void* lx,
                                  const void* lu, const void* Qs, const void* QfeT,
                                  const void* eT_ok, const void* step_ok, const void* Qf,
                                  const void* R, const void* T_star, const void* lm,
                                  void* kappa, void* K, void* ok, int B, int N, int n,
                                  int m, void* stream) {
  return backward<double>(A, Bm, lx, lu, Qs, QfeT, eT_ok, step_ok, Qf, R, T_star, lm, kappa, K, ok, B, N, n, m,
                          stream);
}

// float32 inputs, kappa and K (float64 arithmetic)
extern "C" int backward_truncated_f32(const void* A, const void* Bm, const void* lx,
                                      const void* lu, const void* Qs, const void* QfeT,
                                      const void* eT_ok, const void* step_ok, const void* Qf,
                                      const void* R, const void* T_star, const void* lm,
                                      void* kappa, void* K, void* ok, int B, int N, int n,
                                      int m, void* stream) {
  return backward<float>(A, Bm, lx, lu, Qs, QfeT, eT_ok, step_ok, Qf, R, T_star, lm, kappa, K, ok, B, N, n, m,
                         stream);
}
