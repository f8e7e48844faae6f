// Generic propagator select (HOP-DDP horizon selection on assembled,
// step-dependent blocks) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_lft.py
// propagator_select_lanes_df and propagator_select_dense_df (body
// _df_select_kernel -> _df_select_step + _df_compose_query). The lanes,
// dense and trisym variants are TPU layouts of one function and become this
// one kernel; the df32 (double-single) arithmetic becomes native float64.
// A template on the storage type of every input and of J
// (lft_select_generic float64, lft_select_generic_f32 float32, the TPU
// kernel's contract): float32 inputs staged as they are and converted as
// they are read, float64 arithmetic, J rounded once on its store.
// The path that reaches it is a system with an extra stage cost (PointMass),
// whose Hessian makes Q_aug vary with k, so the k-constant arrow element and
// W0 query of the fused kernel (lft_select.cu) do not apply.
//
// Per problem and per step k, with p = n + 1, the element and the compose
// of lft_chain.cuh (B R^-1 B' from B R^-1 and B, no jitter ladder), then
//   query    (k+1 >= T_min) S = sym(I + C Gbar C'),  Y = S^-1 C Fbar',
//            X0 = sym(Ebar - Fbar C' Y),  J = 0.5 ((X0 + jitter I)^-1)[p-1, p-1]
//            read off the last pivot of the elimination; +inf below T_min.
// J is unscaled (the caller multiplies by s_0^2), pivot-free as the chain
// (solver/horizon.py::select_generic_plain): Q_aug may be indefinite near
// an obstacle.
//
// Bound on the H100 (chip_smoke.py's count, timeopt_tpu_torch/ops/work.py):
// at PointMass's p = 5, m = 2, B = 1024, N = 220 a step reads 1.1 KB of
// inputs and does ~3.6 kFLOP, so the call is bound by bytes at ~0.05 ms.
// What holds it back is the serial chain over k: three dependent p x p
// eliminations a step. The earlier design ran each problem in one block
// of 128 threads mapped over matrix entries, crossed ~50 block-wide
// barriers a step with a few multiply-adds between them, read each step's
// inputs at the step's head, and ran element, compose and query in series.
//
// The design takes the chain apart, as lft_select.cu does. Each problem
// has four warps (two problems a block at one column a lane, p = 3 and 5;
// one at two, any other p <= 13; the chain's size rule):
// - the element warp loads step k+1's Q_aug, A_aug and B_aug with
//   cp.async while it builds step k's element (E, F, G: it does not
//   depend on the carry) into a ring of two slots;
// - the compose warp alone is on the chain: it composes the element onto
//   the carry (with one column a lane the left block's lanes, idle after
//   the sweep, take G_k - F_k' (W F_k)) and writes the new carry into a
//   ring of four slots;
// - two query warps take the even and the odd steps, each loading its
//   steps' C with cp.async one step ahead, and run the C-form query off
//   the chain; the last sweep eliminates forward only, which gives the last
//   pivot the same bits as the full sweep.
// Warps hand slots over with mbarriers ("full" and "free" per slot), and
// no block-wide barrier runs inside the step loops.
//
// What holds it back now (PERF.md section 6): at PointMass B = 1024 the
// kernel runs 1.30 ms against the earlier kernel's 3.79 (bound 0.048 ms).
// The element, compose and query roles take about the same time a step,
// so no single role paces the pipeline; inside each role the p-row
// Gauss-Jordan sweep leads: every pivot waits on a shuffle and a float64
// division, which the bit-for-bit contract keeps.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lft_chain.cuh"

namespace {

using namespace lft_chain;

constexpr int NMAX = PMAX - 1;
constexpr int MMAX = 8;
constexpr int NQ = 2;           // query warps: step k goes to warp k % NQ
constexpr int ROLES = 2 + NQ;   // element, compose, queries
constexpr int RE = 2;           // element ring
constexpr int RC = 2 * NQ;      // carry ring; a multiple of NQ, so a slot always feeds the same query warp

template <typename Fp, int PM>
using StageB = Stage<Fp, PM, PM * MMAX>;  // Q_aug, A_aug and B_aug
template <typename Fp, int PM>
struct QueryScratch {  // one query warp's C ring (storage type) and products
  Fp C[2][(PM - 1) * PM];
  double CG[(PM - 1) * PM], FC[PM * (PM - 1)], QS[PM * PM];
};
template <typename Fp, int PM>
struct Problem {
  uint64_t elem_full[RE], elem_free[RE], carry_full[RC], carry_free[RC];
  double Ri[MMAX * MMAX], BR[PM * MMAX];
  StageB<Fp, PM> stage[2];
  Mats<PM> elem[RE], carry[RC];
  QueryScratch<Fp, PM> qs[NQ];
};

template <typename Fp, int PM>
__device__ __forceinline__ void load_stage(StageB<Fp, PM>& st, const Fp* Ag, const Fp* Bg, const Fp* Qg, size_t bk,
                                           int p, int m, int lane) {
  const int pp = p * p;
  for (int i = lane; i < pp; i += WARP) {
    cp_async_el(&st.Q[i], Qg + bk * pp + i);
    cp_async_el(&st.A[i], Ag + bk * pp + i);
  }
  for (int i = lane; i < p * m; i += WARP) cp_async_el(&st.B[i], Bg + bk * p * m + i);
  cp_async_commit();
}

// ---- element warp: step k's element from its staged inputs, B R^-1 B'
// from B R^-1 (formed here) and B
template <typename Fp, int PM, int CPL, bool EXACT>
__device__ __noinline__ void build_element(Problem<Fp, PM>& P, const StageB<Fp, PM>& st, Mats<PM>& el, int n, int m,
                                           double jitter, int lane) {
  const int p = EXACT ? PM : n + 1;
  // B R^-1 (p x m)
  for (int idx = lane; idx < p * m; idx += WARP) {
    const int i = idx / m, j = idx - (idx / m) * m;
    double sum = 0.0;
    for (int l = 0; l < m; ++l) sum += st.B[i * m + l] * P.Ri[l * m + j];
    P.BR[idx] = sum;
  }
  using Z = Size<PM, CPL, EXACT>;
  element<Z, false, false>(st, el, p, 1, jitter, lane, BRBFromFactors<Z, Fp>{st.B, P.BR, p, m});
}

// ---- compose warp: carry nc = carry pc o element el (k > 0)
template <int PM, int CPL, bool EXACT>
__device__ __noinline__ void compose(const Mats<PM>& el, const Mats<PM>& pc, Mats<PM>& nc, int n, double jitter,
                                     int lane) {
  lft_chain::compose<Size<PM, CPL, EXACT>, false, false, false>(el, pc, nc, n + 1, 1, jitter, lane);
}

// ---- query warp: J of the prefix cc with the terminal factor C (C form)
template <typename Fp, int PM, bool EXACT>
__device__ __noinline__ double query(QueryScratch<Fp, PM>& Qs, const Fp* C, const Mats<PM>& cc, int n_arg,
                                     double jitter, int lane) {
  constexpr int NM = PM - 1;
  const int n = EXACT ? NM : n_arg;
  const int p = n + 1, ld = n + p;
  // C Gbar (n x p) and Fbar C' (p x n)
  for (int idx = lane; idx < n * p; idx += WARP) {
    const int i = idx / p, l = idx - (idx / p) * p;
    double s = 0.0;
    for (int l2 = 0; l2 < p; ++l2) s += C[i * p + l2] * cc.G[l2 * p + l];
    Qs.CG[idx] = s;
  }
  for (int idx = lane; idx < p * n; idx += WARP) {
    const int i = idx / n, j = idx - (idx / n) * n;
    double s = 0.0;
    for (int l = 0; l < p; ++l) s += cc.F[i * p + l] * C[j * p + l];
    Qs.FC[idx] = s;
  }
  __syncwarp();
  // [sym(I + C Gbar C') | C Fbar'] -> [I | Y], lane j holding column j (n + p <= 25)
  const int j = lane;
  double M[1][NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) M[0][i] = 0.0;
  if (j < n) {
    double sij[NM], sji[NM];
#pragma unroll
    for (int i = 0; i < NM; ++i) sij[i] = sji[i] = 0.0;
#pragma unroll
    for (int l = 0; l < PM; ++l) {
      if (l < p) {
        const double cj = C[j * p + l], gj = Qs.CG[j * p + l];
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          if (i < n) {
            sij[i] += Qs.CG[i * p + l] * cj;
            sji[i] += gj * C[i * p + l];
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const double d = (i == j) ? 1.0 : 0.0;
      if (i < n) M[0][i] = 0.5 * __dadd_rn(__dadd_rn(d, sij[i]), __dadd_rn(d, sji[i]));
    }
  } else if (j < ld) {
#pragma unroll
    for (int i = 0; i < NM; ++i)
      if (i < n) M[0][i] = Qs.FC[(j - n) * n + i];
  }
  gj_sweep<NM, 1>(M, n, lane);
  // X0 = Ebar - (Fbar C') Y, lane n + jj forming column jj
  if (j >= n && j < ld) {
    const int jj = j - n;
    double s[PM];
#pragma unroll
    for (int i = 0; i < PM; ++i) s[i] = 0.0;
#pragma unroll
    for (int l = 0; l < NM; ++l) {
      if (l < n) {
        const double y = M[0][l];
#pragma unroll
        for (int i = 0; i < PM; ++i)
          if (i < p) s[i] += Qs.FC[i * n + l] * y;
      }
    }
#pragma unroll
    for (int i = 0; i < PM; ++i)
      if (i < p) Qs.QS[i * p + jj] = __dsub_rn(cc.E[i * p + jj], s[i]);
  }
  __syncwarp();
  // sym(X0) + jitter I, lane j holding column j; its last pivot
  double X[PM];
#pragma unroll
  for (int i = 0; i < PM; ++i)
    X[i] = (i < p && j < p) ? 0.5 * (Qs.QS[i * p + j] + Qs.QS[j * p + i]) + (i == j ? jitter : 0.0) : 0.0;
  const double last = last_pivot<PM>(X, p);
  __syncwarp();  // the scratch is read by every lane before the next query writes it
  return 0.5 / last;
}

// PPB problems a block, ROLES warps each: element, compose, NQ queries.
// EXACT: p = PM, known to the compiler. Fp: the storage type of every input
// and of J (double, or float on the float32 path: one rounding, as J is
// stored); every operation is double.
template <typename Fp, int PM, int CPL, int PPB, bool EXACT>
__global__ void __launch_bounds__(PPB * ROLES * WARP, PM <= 5 ? 4 : 3)
lft_select_generic_kernel(const Fp* __restrict__ Ag, const Fp* __restrict__ Bg, const Fp* __restrict__ Qg,
                          const Fp* __restrict__ Rinv, const Fp* __restrict__ Cg, Fp* __restrict__ J, int Bsz, int N,
                          int n_arg, int m, int t_min, double jitter) {
  const int n = EXACT ? PM - 1 : n_arg;
  __shared__ Problem<Fp, PM> S[PPB];
  const int tid = threadIdx.x, warp = tid / WARP, lane = tid - warp * WARP;
  const int slot = warp / ROLES, role = warp - slot * ROLES;
  const int b = blockIdx.x * PPB + slot;
  const bool live = b < Bsz;
  Problem<Fp, PM>& P = S[slot];
  const int p = n + 1, pp = p * p;

  if (live && role == 0) {
    for (int i = lane; i < m * m; i += WARP) P.Ri[i] = Rinv[(size_t)b * m * m + i];
    if (lane == 0) {
      for (int s = 0; s < RE; ++s) {
        mbar_init(&P.elem_full[s], WARP);   // the element warp
        mbar_init(&P.elem_free[s], WARP);   // the compose warp
      }
      for (int s = 0; s < RC; ++s) {
        mbar_init(&P.carry_full[s], WARP);  // the compose warp
        mbar_init(&P.carry_free[s], WARP);  // the query warp of the slot's steps
      }
    }
  }
  __syncthreads();  // the only block-wide barrier, before the step loops
  if (!live) return;

  if (role == 0) {  // element warp: step k+1's inputs in flight while step k is built
    load_stage<Fp, PM>(P.stage[0], Ag, Bg, Qg, (size_t)b * N, p, m, lane);
    for (int k = 0; k < N; ++k) {
      if (k + 1 < N) {
        load_stage<Fp, PM>(P.stage[(k + 1) & 1], Ag, Bg, Qg, (size_t)b * N + k + 1, p, m, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int e = k % RE;
      if (k >= RE) mbar_wait(&P.elem_free[e], prev_parity(k, RE));
      build_element<Fp, PM, CPL, EXACT>(P, P.stage[k & 1], P.elem[e], n, m, jitter, lane);
      __syncwarp();
      mbar_arrive(&P.elem_full[e]);
    }
  } else if (role == 1) {  // compose warp: the carry's chain
    for (int k = 0; k < N; ++k) {
      const int e = k % RE, c = k % RC;
      mbar_wait(&P.elem_full[e], use_parity(k, RE));
      if (k >= RC) mbar_wait(&P.carry_free[c], prev_parity(k, RC));
      const Mats<PM>& el = P.elem[e];
      Mats<PM>& nc = P.carry[c];
      if (k == 0) {  // the first element is the carry itself: no compose
        for (int idx = lane; idx < pp; idx += WARP) {
          nc.E[idx] = el.E[idx];
          nc.F[idx] = el.F[idx];
          nc.G[idx] = el.G[idx];
        }
      } else {
        compose<PM, CPL, EXACT>(el, P.carry[(k - 1) % RC], nc, n, jitter, lane);
      }
      __syncwarp();
      mbar_arrive(&P.elem_free[e]);
      mbar_arrive(&P.carry_full[c]);
    }
  } else {  // query warp q: the steps k = q, q + NQ, ... off the chain
    const int q = role - 2;
    QueryScratch<Fp, PM>& Qs = P.qs[q];
    const int np = n * p;
    if (q < N) {
      for (int i = lane; i < np; i += WARP) cp_async_el(&Qs.C[0][i], Cg + ((size_t)b * N + q) * np + i);
      cp_async_commit();
    }
    int it = 0;
    for (int k = q; k < N; k += NQ, ++it) {
      if (k + NQ < N) {
        Fp* dst = Qs.C[(it + 1) & 1];
        for (int i = lane; i < np; i += WARP) cp_async_el(dst + i, Cg + ((size_t)b * N + k + NQ) * np + i);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int c = k % RC;
      mbar_wait(&P.carry_full[c], use_parity(k, RC));
      const size_t bk = (size_t)b * N + k;
      if (k + 1 < t_min) {
        if (lane == 0) J[bk] = INFINITY;
      } else {
        const double jv = query<Fp, PM, EXACT>(Qs, Qs.C[it & 1], P.carry[c], n, jitter, lane);
        if (lane == 0) J[bk] = jv;
      }
      __syncwarp();
      mbar_arrive(&P.carry_free[c]);
    }
  }
}

template <typename Fp, int PM, int CPL, int PPB, bool EXACT>
void launch(const void* A, const void* B, const void* Q, const void* Rinv, const void* C, void* J, int Bsz, int N,
            int n, int m, int t_min, double jitter, cudaStream_t stream) {
  lft_select_generic_kernel<Fp, PM, CPL, PPB, EXACT><<<(Bsz + PPB - 1) / PPB, PPB * ROLES * WARP, 0, stream>>>(
      (const Fp*)A, (const Fp*)B, (const Fp*)Q, (const Fp*)Rinv, (const Fp*)C, (Fp*)J, Bsz, N, n, m, t_min, jitter);
}

template <typename Fp>
int select_generic(const void* A, const void* B, const void* Q, const void* Rinv, const void* C, void* J, int Bsz,
                   int N, int n, int m, int t_min, double jitter, void* stream) {
  if (n < 1 || n > NMAX || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (Bsz > 0 && N > 0) {
    // the chain's size rule (lft_chain.cuh); two problems a block at one
    // column a lane, one at two
    with_size(n + 1, [&](auto z) {
      using Z = decltype(z);
      launch<Fp, Z::PM, Z::CPL, Z::CPL == 1 ? 2 : 1, Z::EXACT>(A, B, Q, Rinv, C, J, Bsz, N, n, m, t_min, jitter,
                                                               (cudaStream_t)stream);
    });
  }
  return (int)cudaGetLastError();
}

}  // namespace

// float64 blocks and J
extern "C" int lft_select_generic(const void* A, const void* B, const void* Q, const void* Rinv,
                                  const void* C, void* J, int Bsz, int N, int n, int m, int t_min,
                                  double jitter, void* stream) {
  return select_generic<double>(A, B, Q, Rinv, C, J, Bsz, N, n, m, t_min, jitter, stream);
}

// float32 blocks and J (float64 arithmetic)
extern "C" int lft_select_generic_f32(const void* A, const void* B, const void* Q, const void* Rinv,
                                      const void* C, void* J, int Bsz, int N, int n, int m, int t_min,
                                      double jitter, void* stream) {
  return select_generic<float>(A, B, Q, Rinv, C, J, Bsz, N, n, m, t_min, jitter, stream);
}
