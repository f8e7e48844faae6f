// Fused propagator select (HOP-DDP horizon selection) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_lft.py
// propagator_select_lanes_df_fused and propagator_select_dense_df_fused
// (body _df_select_fused_kernel -> _df_compose_query_w0). The lanes, dense
// and trisym variants are TPU layouts of one function and become this one
// kernel; the df32 (double-single) arithmetic becomes native float64.
// The kernel is a template on the storage type of the step inputs and of
// J: lft_select_fused takes float64, lft_select_fused_f32 float32, the TPU
// kernel's own float32-in, float32-out contract. The float32 inputs are
// staged in shared memory as they are (4-byte cp.async) and converted as
// they are read, every operation is float64 (where the TPU ran df32), and
// J is rounded once, on its store; the k-constants iQq, R^-1 and W0 are
// float64 on both paths. At float32 the bytes halve but the bound is the
// operations' (below), so the two instantiations take about the same time.
//
// Per problem and per step k: assemble A_aug and B R^-1 B' from the raw
// step inputs, build the arrow-form LFT element (E, F, G), compose it onto
// the prefix carry (Ebar, Fbar, Gbar), and for k+1 >= T_min run the
// W0-form terminal query J = 0.5 ((X0 + jitter I)^-1)[p-1, p-1]. Below
// T_min the output is +inf. J is unscaled (the caller multiplies by s_0^2).
//
// Bound on the H100 (chip_smoke.py's count, timeopt_tpu_torch/ops/work.py):
// ~44 kFLOP and ~1.9 KB of inputs per (problem, step) at p = 13, so at
// B = 1024, N = 160, T_min = 40 ~7.2 GFLOP against ~0.32 GB: 0.11 ms at
// 67 TFLOP/s (0.21 ms at the 34 TFLOP/s of the float64 CUDA cores, where a
// 13 x 13 elimination runs), bound by operations. What holds it back is
// the serial chain over k: each step is three dependent eliminations of
// 13-row systems. The earlier design (one block of 128 threads mapping
// over matrix entries) crossed ~88 block-wide barriers per step with 4-8
// multiply-adds between them, element and query on the chain too.
//
// The design takes the chain apart. One block of four warps runs each
// problem (B = 1024 is ~7.8 blocks per SM: one wave at 8 blocks of
// <= 27.5 KB shared memory and <= 64 registers a thread):
// - the element warp loads step k+1's inputs with cp.async while it builds
//   the element of step k (it does not depend on the carry) into a ring of
//   two slots;
// - two compose warps compose the carry with the element: each sweeps
//   [sym(E_k + Gbar) + jitter I | R] by Gauss-Jordan in registers, lane j
//   holding column j, the pivot column broadcast by __shfl_sync (no
//   barrier per pivot), R = Fbar' in one warp and F_k in the other (one
//   sweep of [left | Fbar' | F_k] needs two columns a lane and spilled);
//   they write each new carry into a ring of two slots;
// - the query warp runs the terminal query of step k off the chain, while
//   the compose proceeds with k+1; its last sweep only eliminates the
//   trailing block, which is all the last pivot reads.
// The warps hand slots over with mbarriers in shared memory (a "full" and
// a "free" barrier per slot; named barriers with a register id made ptxas
// reserve all 16 and halved the blocks per SM), and no block-wide barrier
// runs inside the step loop. Every entry keeps the arithmetic and the
// operation order of the earlier kernel (each division by the pivot, each
// M - col * row update, each inner sum in index order, each
// symmetrization); only the schedule differs, and the results are equal
// bit for bit. Per-step matrices never leave shared memory: the kernel
// reads its inputs once and writes J.
//
// What holds it back now (chip_smoke.py --ab, PERF.md): each role is one
// warp walking latency chains (pivot shuffle, division, update; dot
// products in index order) at 64 registers; compose warp B (two products
// after its sweep) paces the pipeline, the query warp close behind, and
// the kernel stays far above its bound.
//
// Two things the sweeps' speed turned on (the scan's, PERF.md section 6),
// both kept here without a change of bits: a float64 division of zero
// leaves the division's fast path, and every pivot divides zeros (the
// lanes past the matrix's edge, the eliminated entries), so the sweeps
// divide by warpmat.cuh's quot (x * pv for a zero x: the same value and
// sign); a shuffle in code that the compiler cannot prove the whole warp
// reaches (a branch on the thread index, a loop whose exit hangs on a
// barrier's spin) is compiled for a diverged warp at several
// instructions, so the roles branch on a shuffled warp index and a
// __syncwarp follows each barrier wait.
//
// Size tiers. The shared memory of a block is sized for the largest n of
// its tier, so each tier is its own instantiation: the registry's, n <= 12
// (p <= 13; n <= 4 takes a narrower register tile of the same layout), 8
// blocks an SM, and the wide tier, n <= 14 (p <= 15: the 6-DoF lander),
// ~35 KB a block, 6 blocks an SM and <= 80 registers a thread (at B = 1024
// ~1.3 waves). One warp still holds a compose sweep (2p <= 30 columns) and
// a query's [K | FEt'] (n + p <= 29), which would hold up to n = 15.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warpmat.cuh"

namespace {

using namespace warpmat;

constexpr int NMAX = 12;  // the registry's tier
constexpr int PMAX = NMAX + 1;
constexpr int NWIDE = 14;  // the wide tier
constexpr int MMAX = 8;
constexpr int THREADS = 4 * WARP;  // element, compose A, compose B, query
constexpr int RING = 2;            // slots of the element ring and of the carry ring

// The tier of an instantiation whose register tiles hold PM rows: the
// largest n its shared memory takes, and its blocks an SM.
__host__ __device__ constexpr int tier_n(int PM) { return PM <= PMAX ? NMAX : NWIDE; }
__host__ __device__ constexpr int tier_blocks(int PM) { return PM <= PMAX ? 8 : 6; }

// raw inputs of one step in the storage type Fp (double, or float on the
// float32 path, converted to double where they are read); `zero` stands in
// for the missing row n of A_left. NB: the tier's n bound.
template <typename Fp, int NB>
struct Stage {
  Fp A[NB * NB], B[NB * MMAX], vecs[4 * NB], scal[4], zero[NB];
};
template <int NB>
struct Elem {  // the element of one step; E = blkdiag(iQ, 0) + inv_s u u' is rebuilt from u
  double F[(NB + 1) * (NB + 1)], G[(NB + 1) * (NB + 1)], u[NB + 1], et[NB], inv_s;
};
template <int NB>
struct Carry {  // a prefix (Ebar, Fbar, Gbar) and the e~ of its last step
  double E[(NB + 1) * (NB + 1)], F[(NB + 1) * (NB + 1)], G[(NB + 1) * (NB + 1)], et[NB];
};
template <int NB>
struct Smem {
  uint64_t elem_full[RING], elem_free[RING], carry_full[RING], carry_free[RING];
  double iQ[NB * NB], W0[NB * NB], Ri[MMAX * MMAX];
  double BR[NB * MMAX], DAt[NB * (NB + 1)], q[NB], v[NB + 1];  // element scratch
  Elem<NB> elem[RING];
  Carry<NB> carry[RING];
  double QX[(NB + 1) * (NB + 1)], QS[(NB + 1) * (NB + 1)];  // query scratch: K^-1 FEt' and X0
};

// A_aug = [[A, atil/s_k], [0, s_{k+1}/s_k]], entry (i, j)
template <typename Fp, int NB>
__device__ __forceinline__ double aug(const Stage<Fp, NB>& st, int n, double inv_sk, double s_kp1, int i, int j) {
  if (i < n) return (j < n) ? st.A[i * n + j] : st.vecs[2 * n + i] * inv_sk;
  return (j < n) ? 0.0 : s_kp1 * inv_sk;
}

// E_k (i, j) of the element in slot el
template <int NB>
__device__ __forceinline__ double elem_E(const Smem<NB>& S, const Elem<NB>& el, int n, int i, int j) {
  const double ui = el.u[i] * el.inv_s;
  return ((i < n && j < n) ? S.iQ[i * n + j] : 0.0) + ui * el.u[j];
}

template <typename Fp, int NB>
__device__ void load_stage(Stage<Fp, NB>& st, const Fp* A, const Fp* Bm, const Fp* vecs, const Fp* scal, size_t bk,
                           int n, int m, int lane) {
  for (int i = lane; i < n * n; i += WARP) cp_async_el(&st.A[i], A + bk * n * n + i);
  for (int i = lane; i < n * m; i += WARP) cp_async_el(&st.B[i], Bm + bk * n * m + i);
  for (int i = lane; i < 4 * n; i += WARP) cp_async_el(&st.vecs[i], vecs + bk * 4 * n + i);
  if (lane < 4) cp_async_el(&st.scal[lane], scal + bk * 4 + lane);
  cp_async_commit();
}

// ---- element warp: the arrow element of one step into slot el
template <typename Fp, int NB>
__device__ void build_element(Smem<NB>& S, const Stage<Fp, NB>& st, Elem<NB>& el, int n, int m, double jitter,
                              int lane) {
  const int p = n + 1, pp = p * p;
  const double corner = st.scal[0], inv_sk = st.scal[1], s_kp1 = st.scal[2], inv_skp1 = st.scal[3];
  // B R^-1, q = Qe/s_k, e~
  for (int idx = lane; idx < n * m; idx += WARP) {
    const int i = idx / m, j = idx - (idx / m) * m;
    double sum = 0.0;
    for (int l = 0; l < m; ++l) sum += st.B[i * m + l] * S.Ri[l * m + j];
    S.BR[idx] = sum;
  }
  for (int i = lane; i < n; i += WARP) {
    S.q[i] = st.vecs[3 * n + i] * inv_sk;
    el.et[i] = st.vecs[n + i] * inv_skp1;
  }
  __syncwarp();
  // w = iQq q, u = [w; -1]
  for (int i = lane; i < n; i += WARP) {
    double s = 0.0;
#pragma unroll 4
    for (int l = 0; l < n; ++l) s += S.iQ[i * n + l] * S.q[l];
    el.u[i] = s;
  }
  if (lane == 0) el.u[n] = -1.0;
  __syncwarp();
  // s = (c + jitter) - q'w;  v = A_aug u;  DAt = iQq A_left' (row n of A_left is 0)
  if (lane == 0) {
    double qtw = 0.0;
    for (int l = 0; l < n; ++l) qtw += S.q[l] * el.u[l];
    el.inv_s = 1.0 / ((corner * inv_sk * inv_sk + jitter) - qtw);
  }
  for (int i = lane; i < p; i += WARP) {
    double s = 0.0;
    for (int l = 0; l < p; ++l) s += aug(st, n, inv_sk, s_kp1, i, l) * el.u[l];
    S.v[i] = s;
  }
  for (int idx = lane; idx < n * p; idx += WARP) {
    const int i = idx / p, j = idx - (idx / p) * p;
    const Fp* arow = (j < n) ? st.A + j * n : st.zero;
    double sum = 0.0;
#pragma unroll 4
    for (int l = 0; l < n; ++l) sum += S.iQ[i * n + l] * arow[l];
    S.DAt[idx] = sum;
  }
  __syncwarp();
  // F = [DAt; 0] + (1/s) u v';  G = A_left DAt + (1/s) v v' + [[B R^-1 B', 0], [0, 0]]
  const double inv_s = el.inv_s;
  for (int idx = lane; idx < pp; idx += WARP) {
    const int i = idx / p, j = idx - (idx / p) * p;
    const double ui = el.u[i] * inv_s;
    el.F[idx] = ((i < n) ? S.DAt[i * p + j] : 0.0) + ui * S.v[j];
    const Fp* arow = (i < n) ? st.A + i * n : st.zero;
    double g = 0.0;
#pragma unroll 4
    for (int l = 0; l < n; ++l) g += arow[l] * S.DAt[l * p + j];
    double brb = 0.0;
    if (i < n && j < n)
      for (int l = 0; l < m; ++l) brb += S.BR[i * m + l] * st.B[j * m + l];
    el.G[idx] = (g + (S.v[i] * inv_s) * S.v[j]) + brb;
  }
  __syncwarp();
  sym_inplace(el.G, p, lane);
}

// ---- compose warps: carry nc = carry pc o element el (k > 0), one right
// block each. Both sweep [sym(E_k + Gbar) + jitter I | R] with lane j
// holding column j (2p <= 30 columns): R = Fbar' for warp A, R = F_k for
// warp B. The left block's sweep is the same arithmetic in both warps, so
// each right block comes out as one sweep of [left | Fbar' | F_k] gives it.
// The pivot column i < p sits in lane i and reaches every lane by shuffle,
// row by row before that row is updated (warpmat.cuh gj_sweep, zeros
// through quot).
template <int PM, int NB = tier_n(PM)>
__device__ void sweep(const Smem<NB>& S, const Elem<NB>& el, const Carry<NB>& pc, bool right_is_Fbar, int n,
                      double jitter, int lane, double (&M)[1][PM]) {
  const int p = n + 1;
  const int j = lane;
#pragma unroll
  for (int i = 0; i < PM; ++i) {
    double x = 0.0;
    if (i < p && j < 2 * p) {
      if (j < p)
        x = 0.5 * ((elem_E(S, el, n, i, j) + pc.G[i * p + j]) + (elem_E(S, el, n, j, i) + pc.G[j * p + i])) +
            (i == j ? jitter : 0.0);
      else
        x = right_is_Fbar ? pc.F[(j - p) * p + i] : el.F[i * p + (j - p)];
    }
    M[0][i] = x;
  }
  gj_sweep<PM, 1, true>(M, p, lane);
}

// After the sweep lane p + j holds column j of the right block. Every lane
// takes a copy of one such column: lanes p .. 2p-1 their own, lanes 0 .. p-1
// (the left block's, idle now) that of lane p + lane, so that two lanes
// share the p rows of each column's products. Returns the first row of
// this lane's share; its rows end at `hi`.
template <int PM>
__device__ __forceinline__ int share_column(const double (&M)[PM], double (&X)[PM], int p, int lane, int& j,
                                            int& hi) {
  const int src = lane < p ? p + lane : lane;
#pragma unroll
  for (int l = 0; l < PM; ++l) X[l] = __shfl_sync(FULL, M[l], src);
  const int half = (p + 1) / 2;
  j = src - p;
  hi = lane < p ? p : half;
  return lane < p ? half : 0;
}

// warp A: Ebar - Fbar (W Fbar') -> nc.E
template <int PM, int NB = tier_n(PM)>
__device__ __noinline__ void compose_E(const Smem<NB>& S, const Elem<NB>& el, const Carry<NB>& pc, Carry<NB>& nc, int n,
                                       double jitter, int lane) {
  const int p = n + 1;
  double M[1][PM], X[PM];
  sweep<PM>(S, el, pc, true, n, jitter, lane, M);
  int j, hi;
  const int lo = share_column<PM>(M[0], X, p, lane, j, hi);
  if (lane < 2 * p) {
    for (int i = lo; i < hi; ++i) {
      double a = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l)
        if (l < p) a += pc.F[i * p + l] * X[l];
      nc.E[i * p + j] = pc.E[i * p + j] - a;
    }
  }
  __syncwarp();
  sym_inplace(nc.E, p, lane);
}

// warp B: Fbar (W F_k) -> nc.F;  G_k - F_k' (W F_k) -> nc.G
template <int PM, int NB = tier_n(PM)>
__device__ __noinline__ void compose_FG(const Smem<NB>& S, const Elem<NB>& el, const Carry<NB>& pc, Carry<NB>& nc,
                                        int n, double jitter, int lane) {
  const int p = n + 1;
  double M[1][PM], X[PM];
  sweep<PM>(S, el, pc, false, n, jitter, lane, M);
  int j, hi;
  const int lo = share_column<PM>(M[0], X, p, lane, j, hi);
  if (lane < 2 * p) {
    for (int i = lo; i < hi; ++i) {
      double f = 0.0, g = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l) {
        if (l < p) {
          f += pc.F[i * p + l] * X[l];
          g += el.F[l * p + i] * X[l];
        }
      }
      nc.F[i * p + j] = f;
      nc.G[i * p + j] = el.G[i * p + j] - g;
    }
  }
  for (int i = lane; i < n; i += WARP) nc.et[i] = el.et[i];
  __syncwarp();
  sym_inplace(nc.G, p, lane);
}

// ---- query warp: J of the prefix in slot cc (W0 form)
// K = W0 + G11 + e~ g' + g e~' + g22 e~ e~',  FEt = Fbar[:, :n] + Fbar[:, n] e~'
// X0 = Ebar - FEt K^-1 FEt';  J = 0.5 / (last pivot of sym(X0) + jitter I)
template <int PM, int NB = tier_n(PM)>
__device__ __noinline__ double query(Smem<NB>& S, const Carry<NB>& cc, int n, double jitter, int lane) {
  constexpr int NM = PM - 1;
  const int p = n + 1, ld = n + p;
  const double* cG = cc.G;
  const double* cF = cc.F;
  const double* et = cc.et;
  // [K | FEt'], lane j holds column j (ld <= 29)
  double M[1][NM];
  const int j = lane;
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    double x = 0.0;
    if (i < n && j < ld) {
      if (j < n) {
        const double eg = et[i] * cG[j * p + n];
        const double ge = cG[i * p + n] * et[j];
        x = S.W0[i * n + j] + (((cG[i * p + j] + eg) + ge) + (et[i] * cG[n * p + n]) * et[j]);
      } else {
        const int r = j - n;  // FEt'[i][r] = FEt[r][i]
        x = cF[r * p + i] + cF[r * p + n] * et[i];
      }
    }
    M[0][i] = x;
  }
  gj_sweep<NM, 1, true>(M, n, lane);
  // Ebar - FEt (K^-1 FEt') -> QS, the right block through shared memory so
  // that every lane takes a share of the p^2 sums
  if (j >= n && j < ld) {
#pragma unroll
    for (int l = 0; l < NM; ++l)
      if (l < n) S.QX[l * p + (j - n)] = M[0][l];
  }
  __syncwarp();
  for (int idx = lane; idx < p * p; idx += WARP) {
    const int i = idx / p, jj = idx - (idx / p) * p;
    double s = 0.0;
    for (int l = 0; l < n; ++l) s += (cF[i * p + l] + cF[i * p + n] * et[l]) * S.QX[l * p + jj];
    S.QS[idx] = cc.E[idx] - s;
  }
  __syncwarp();
  // sym(X0) + jitter I, lane j holds column j; forward elimination of the
  // trailing block: the same updates as a full sweep on every entry the
  // last pivot depends on
  double X[PM];
#pragma unroll
  for (int i = 0; i < PM; ++i)
    X[i] = (i < p && j < p) ? 0.5 * (S.QS[i * p + j] + S.QS[j * p + i]) + (i == j ? jitter : 0.0) : 0.0;
  const double last = last_pivot<PM, true>(X, p);
  __syncwarp();  // QS is read by every lane before the next query writes it
  return 0.5 / last;
}

// Fp: the storage type of the step inputs and of J (double, or float on the
// float32 path: one rounding, as J is stored); the k-constants iQq, R^-1
// and W0 are double on both paths, and every operation is double. PM: the
// rows of the register tiles, which pick the tier.
template <typename Fp, int PM>
__global__ void __launch_bounds__(THREADS, tier_blocks(PM))
lft_select_kernel(const Fp* __restrict__ A, const Fp* __restrict__ Bm, const Fp* __restrict__ vecs,
                  const Fp* __restrict__ scal, const double* __restrict__ iQq, const double* __restrict__ Rinv,
                  const double* __restrict__ W0g, Fp* __restrict__ J, int N, int n, int m, int t_min,
                  double jitter) {
  constexpr int NB = tier_n(PM);
  __shared__ Smem<NB> S;
  __shared__ Stage<Fp, NB> stage[2];
  const int b = blockIdx.x;
  // the warp's index through a shuffle, which the compiler knows every lane
  // shares: a branch on the thread index (the roles below) would have it
  // compile every shuffle in the branch for a diverged warp
  const int tid = threadIdx.x, lane = tid % WARP, warp = __shfl_sync(FULL, tid / WARP, 0);

  for (int i = tid; i < n * n; i += THREADS) {
    S.iQ[i] = iQq[(size_t)b * n * n + i];
    S.W0[i] = W0g[(size_t)b * n * n + i];
  }
  for (int i = tid; i < m * m; i += THREADS) S.Ri[i] = Rinv[(size_t)b * m * m + i];
  for (int i = tid; i < 2 * NB; i += THREADS) stage[i / NB].zero[i % NB] = 0.0;
  if (tid == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&S.elem_full[s], WARP);         // the element warp
      mbar_init(&S.elem_free[s], 2 * WARP);     // compose A and B
      mbar_init(&S.carry_full[s], 2 * WARP);    // compose A and B
      mbar_init(&S.carry_free[s], 2 * WARP);    // query, and compose A's read of the previous carry
    }
  }
  __syncthreads();  // the only block-wide barrier

  if (warp == 0) {  // element warp: step k+1's inputs in flight while step k is built
    load_stage(stage[0], A, Bm, vecs, scal, (size_t)b * N, n, m, lane);
    for (int k = 0; k < N; ++k) {
      if (k + 1 < N) {
        load_stage(stage[(k + 1) & 1], A, Bm, vecs, scal, (size_t)b * N + k + 1, n, m, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int e = k % RING;
      if (k >= RING) {
        mbar_wait(&S.elem_free[e], prev_parity(k, RING));
        __syncwarp();
      }
      build_element(S, stage[k & 1], S.elem[e], n, m, jitter, lane);
      __syncwarp();
      mbar_arrive(&S.elem_full[e]);
    }
  } else if (warp <= 2) {  // compose warps: the carry's chain
    const bool is_A = warp == 1;
    const int p = n + 1, pp = p * p;
    for (int k = 0; k < N; ++k) {
      const int s = k % RING;
      mbar_wait(&S.elem_full[s], use_parity(k, RING));
      __syncwarp();
      if (k >= RING) {
        mbar_wait(&S.carry_free[s], prev_parity(k, RING));
        __syncwarp();
      }
      const Elem<NB>& el = S.elem[s];
      Carry<NB>& nc = S.carry[s];
      if (k == 0) {  // the first element is the carry itself: no compose
        for (int idx = lane; idx < pp; idx += WARP) {
          const int i = idx / p, j = idx - (idx / p) * p;
          if (is_A) {
            nc.E[idx] = elem_E(S, el, n, i, j);
          } else {
            nc.F[idx] = el.F[idx];
            nc.G[idx] = el.G[idx];
          }
        }
        if (!is_A)
          for (int i = lane; i < n; i += WARP) nc.et[i] = el.et[i];
      } else {
        const int ps = (k - 1) % RING;
        if (is_A) {
          mbar_wait(&S.carry_full[ps], use_parity(k - 1, RING));  // warp B's Fbar, Gbar of step k-1
          __syncwarp();
          compose_E<PM>(S, el, S.carry[ps], nc, n, jitter, lane);
        } else {
          compose_FG<PM>(S, el, S.carry[ps], nc, n, jitter, lane);
        }
      }
      __syncwarp();
      if (k + RING < N) mbar_arrive(&S.elem_free[s]);
      mbar_arrive(&S.carry_full[s]);
      if (is_A && k >= 1 && k + 1 < N) mbar_arrive(&S.carry_free[(k - 1) % RING]);
    }
  } else {  // query warp: J of step k off the chain
    for (int k = 0; k < N; ++k) {
      const int s = k % RING;
      mbar_wait(&S.carry_full[s], use_parity(k, RING));
      __syncwarp();
      const size_t bk = (size_t)b * N + k;
      if (k + 1 < t_min) {
        if (lane == 0) J[bk] = INFINITY;
      } else {
        const double jv = query<PM>(S, S.carry[s], n, jitter, lane);
        if (lane == 0) J[bk] = jv;
      }
      __syncwarp();
      if (k + RING < N) mbar_arrive(&S.carry_free[s]);
    }
  }
}

template <typename Fp, int PM>
int blocks_per_sm() {
  int b = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, lft_select_kernel<Fp, PM>, THREADS, 0);
  return b;
}

// Blocks an SM holds at once of the instantiation that n states take (the
// dispatch of select_fused), from its registers and shared memory.
template <typename Fp>
int select_blocks_per_sm(int n) {
  if (n < 1 || n > NWIDE) return -1;
  if (n + 1 <= 5) return blocks_per_sm<Fp, 5>();
  if (n <= NMAX) return blocks_per_sm<Fp, PMAX>();
  return blocks_per_sm<Fp, NWIDE + 1>();
}

template <typename Fp, int PM>
void launch(const void* A, const void* Bm, const void* vecs, const void* scal, const void* iQq,
            const void* Rinv, const void* W0, void* J, int B, int N, int n, int m, int t_min,
            double jitter, cudaStream_t stream) {
  lft_select_kernel<Fp, PM><<<B, THREADS, 0, stream>>>(
      (const Fp*)A, (const Fp*)Bm, (const Fp*)vecs, (const Fp*)scal, (const double*)iQq, (const double*)Rinv,
      (const double*)W0, (Fp*)J, N, n, m, t_min, jitter);
}

template <typename Fp>
int select_fused(const void* A, const void* Bm, const void* vecs, const void* scal, const void* iQq,
                 const void* Rinv, const void* W0, void* J, int B, int N, int n, int m, int t_min, double jitter,
                 void* stream) {
  if (n < 1 || n > NWIDE || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    // p <= 5 (n <= 4) takes the narrow instantiation, n <= 12 the registry's
    // tier, n <= 14 the wide one (ops/cuda_lft.py::tier, the same rule)
    if (n + 1 <= 5) launch<Fp, 5>(A, Bm, vecs, scal, iQq, Rinv, W0, J, B, N, n, m, t_min, jitter, (cudaStream_t)stream);
    else if (n <= NMAX) launch<Fp, PMAX>(A, Bm, vecs, scal, iQq, Rinv, W0, J, B, N, n, m, t_min, jitter, (cudaStream_t)stream);
    else launch<Fp, NWIDE + 1>(A, Bm, vecs, scal, iQq, Rinv, W0, J, B, N, n, m, t_min, jitter, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int lft_select_blocks_per_sm(int n) { return select_blocks_per_sm<double>(n); }
extern "C" int lft_select_blocks_per_sm_f32(int n) { return select_blocks_per_sm<float>(n); }

// float64 step inputs and J
extern "C" int lft_select_fused(const void* A, const void* Bm, const void* vecs,
                                const void* scal, const void* iQq, const void* Rinv,
                                const void* W0, void* J, int B, int N, int n, int m,
                                int t_min, double jitter, void* stream) {
  return select_fused<double>(A, Bm, vecs, scal, iQq, Rinv, W0, J, B, N, n, m, t_min, jitter, stream);
}

// float32 step inputs and J (float64 k-constants, float64 arithmetic)
extern "C" int lft_select_fused_f32(const void* A, const void* Bm, const void* vecs,
                                    const void* scal, const void* iQq, const void* Rinv,
                                    const void* W0, void* J, int B, int N, int n, int m,
                                    int t_min, double jitter, void* stream) {
  return select_fused<float>(A, Bm, vecs, scal, iQq, Rinv, W0, J, B, N, n, m, t_min, jitter, stream);
}
