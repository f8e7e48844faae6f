// Every prefix of the LFT scan (the propagator's elements and their
// sequential composition) in float64 for Hopper.
//
// Replaces the TPU kernel timeopt_tpu/ops/pallas_lft.py lft_scan_lanes
// (body _lft_scan_kernel), which computes in the lanes layout (N, p, p, B);
// here the layout is the port's (B, N, p, p) and the arithmetic native
// float64. The path that reaches it is the unfused propagator select
// (solver/horizon.py::propagator_select): consistency_check, the solve
// with terminal_mode="inverse" and parallel/mesh.py's sharded select.
//
// Two entries, one template on the inputs' storage type: lft_scan (float64
// blocks) and lft_scan_f32 (float32 blocks, as the TPU kernel takes them).
// The float32 instantiation stages its inputs as they are (4-byte cp.async)
// and converts each to double where it is read; everything after, the
// prefixes it writes included, is double, so a float32 problem's scan and
// query stay one float64 recursion rounded once, in J (lft_query.cu).
//
// Per problem and per step k, with p = n + 1 and eps the ladder's rung:
//   element  E = (sym(Q_aug,k) + eps I)^-1,  F = E A',  G = sym(A F + BRB)
//   compose  onto the prefix carry (Ebar, Fbar, Gbar), k > 0, with
//            W = (sym(E_k + Gbar) + eps I)^-1:
//            Ebar -= Fbar W Fbar',  Fbar = Fbar W F_k,  Gbar = G_k - F_k' W F_k
//   output   the prefix (Ebar, Fbar, Gbar) of step k, written to E, F, G.
// BRB = B_aug R^-1 B_aug' comes in assembled (the JAX wrapper forms it
// outside the Pallas kernel too).
//
// Two choices differ from the TPU kernel, which forms explicit inverses
// (_inv_lanes) of Q and of E_k + Gbar: the element takes F = Q^-1 A' and
// E = Q^-1 from one Gauss-Jordan sweep of [Q | A' | I], and the compose
// never forms W for the products: one sweep of [E_k + Gbar | Fbar' | F_k]
// gives W Fbar' and W F_k. The eliminations are pivot-free, as in the plain
// version and the JAX reference. The element and the compose are those of
// lft_select_generic.cu (which takes B R^-1 B' apart and has no ladder), so
// the scan + query chain equals that kernel bit for bit.
//
// The jitter ladder of ops/linalg.py::psd_inv (levels 1 or 2): the plain
// version keeps, per matrix, the rung-1 inverse (eps = jitter) unless it has
// a non-finite entry, and then takes rung 2 (eps = 1e4 jitter). Here rung 2
// is a recompute of that one sweep, taken exactly when a warp vote finds a
// non-finite entry in the rung-1 inverse: E (part of the element sweep) for
// the element, and for the compose W itself, from p identity columns that
// join the sweep when levels = 2 (W is formed only for that test). A
// Gauss-Jordan column's bits depend only on that column and the pivot
// column, so these columns change no other column's bits.
//
// What bounds it on the H100: the recursion is sequential in k, each step
// two dependent p x p eliminations, and the kernel writes every prefix:
// 3p^2 doubles a step (665 MB at quadrotor B=1024, N=160, p=13, the 0.4 ms
// that bounds it by bytes). The first design ran each problem on one block
// of 128 threads mapped over matrix entries, crossing about 60 block-wide
// barriers a step with a few shared-memory multiply-adds between them, read
// each step's inputs at its head and ran element and compose in series.
//
// The design takes the chain apart, as lft_select_generic.cu does. Each
// problem has two warps, two problems a block:
// - the element warp loads step k+1's Q_aug, A_aug and BRB with cp.async
//   (8-byte copies: a step's three matrices are 1,352 B at p = 13, and a
//   step starts on an 8-byte boundary only; 4-byte copies at float32)
//   while it builds step k's element (it does not depend on the carry)
//   into a ring of two slots. It also
//   streams the prefixes out (coalesced, evict-first stores): at step k the
//   carry of step k - 2, complete once the compose of step k - 2 has freed
//   its element slot, so the compose warp never waits on device memory;
// - the compose warp alone is on the chain: it sweeps
//   [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I)] by Gauss-Jordan in
//   registers (csrc/warpmat.cuh: lane j holds column j at p = 3 and 5, two
//   columns a lane otherwise; the pivot column broadcast by __shfl_sync, no
//   barrier per pivot), puts W Fbar' and W F_k in shared memory and forms
//   the three p x p products entry by entry over all 32 lanes (the loop over
//   the summation index outside, so each index feeds a lane's independent
//   sums) into a ring of two carry slots.
// Warps hand element slots over with mbarriers ("full" and "free"); the
// carry ring needs none, since the compose of step k overwrites the carry of
// step k - 2 only after element k, which the element warp builds after
// storing that carry. No block-wide barrier runs inside the step loops. At
// p = 13 a block holds 48,736 B of shared memory and __launch_bounds__
// holds registers to 128, so four blocks, eight problems, fit an SM and the
// 1,024 quadrotor problems are resident in one wave.
//
// Every entry keeps the arithmetic and the operation order of the first
// design (each division by the pivot, each M - col * row update, each inner
// sum in index order, each symmetrization with its operands in the same
// order), so every prefix equals it bit for bit; the additions that join two
// sums are written __dadd_rn / __dsub_rn, since with compile-time sizes the
// compiler could otherwise fuse a product into them, which the first design
// (run-time sizes) never did. Three things the sweeps' speed turned on
// (PERF.md section 6): a float64 division of zero leaves the division's fast
// path, so a zero entry takes x * pv instead (warpmat.cuh quot, the same
// bits); a shuffle in code that the compiler cannot prove the whole warp
// reaches (a branch on the thread index, a loop whose exit hangs on a vote
// or on a barrier's spin) is compiled for a diverged warp at several
// instructions, so the roles branch on a shuffled warp index, a __syncwarp
// follows each barrier wait and the ladder's second rung is written out;
// each pivot still waits on a shuffle and a float64 division.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warpmat.cuh"

namespace {

using namespace warpmat;

constexpr int PMAX = 13;
constexpr int PPB = 2;                   // problems a block
constexpr int THREADS = 2 * PPB * WARP;  // an element and a compose warp each
constexpr int RE = 2;                    // element ring
constexpr int RC = 2;                    // carry ring

// raw inputs of one step in the storage type Fp (double, or float on the
// float32 path, converted to double where they are read)
template <typename Fp, int PM>
struct Stage {
  Fp Q[PM * PM], A[PM * PM], BRB[PM * PM];
};
template <int PM>
struct Mats {  // an element (E, F, G) or a prefix carry (Ebar, Fbar, Gbar)
  double E[PM * PM], F[PM * PM], G[PM * PM];
};
template <typename Fp, int PM>
struct Problem {
  uint64_t elem_full[RE], elem_free[RE];
  Stage<Fp, PM> stage[2];
  Mats<PM> elem[RE], carry[RC];
};

template <typename Fp, int PM>
__device__ __forceinline__ void load_stage(Stage<Fp, PM>& st, const Fp* Ag, const Fp* BRBg, const Fp* Qg, size_t bk,
                                           int pp, int lane) {
  for (int i = lane; i < pp; i += WARP) {
    cp_async_el(&st.Q[i], Qg + bk * pp + i);
    cp_async_el(&st.A[i], Ag + bk * pp + i);
    cp_async_el(&st.BRB[i], BRBg + bk * pp + i);
  }
  cp_async_commit();
}

// True for the whole warp iff every entry of the columns [c0, c0 + p) held
// in registers is finite.
template <int PM, int CPL>
__device__ __forceinline__ bool cols_finite(const double (&M)[CPL][PM], int p, int c0, int lane) {
  bool bad = false;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= c0 && col < c0 + p) {
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p && !isfinite(M[s][i])) bad = true;
    }
  }
  return !__any_sync(FULL, bad);
}

// M (p x p, row-major, shared memory) <- sym(M): each entry (i, j) becomes
// 0.5 (M[i][j] + M[j][i]), operands in that order as in the first design
// (a NaN's sign may depend on it), every read before any write. The warp
// must have written M and synchronized.
template <int PM>
__device__ __forceinline__ void sym_entries(double* M, int p, int lane) {
  constexpr int NE = (PM * PM + WARP - 1) / WARP;
  const int pp = p * p;
  double v[NE];
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t;
    if (idx < pp) {
      const int i = idx / p, j = idx - (idx / p) * p;
      v[t] = 0.5 * (M[idx] + M[j * p + i]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t;
    if (idx < pp) M[idx] = v[t];
  }
}

// [sym(Q) + eps I | A' | I] into registers, lane = column (CPL a lane). A
// lane's column range is decided once, outside the loop over rows, so each
// branch's loads go out together.
template <typename Fp, int PM, int CPL>
__device__ __forceinline__ void fill_element(double (&M)[CPL][PM], const Stage<Fp, PM>& st, int p, double eps,
                                             int lane) {
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col < p) {
#pragma unroll
      for (int i = 0; i < PM; ++i)
        M[s][i] = i < p ? 0.5 * ((double)st.Q[i * p + col] + (double)st.Q[col * p + i]) + (i == col ? eps : 0.0)
                        : 0.0;
    } else if (col < 2 * p) {
      const Fp* a = st.A + (col - p) * p;
#pragma unroll
      for (int i = 0; i < PM; ++i) M[s][i] = i < p ? a[i] : 0.0;
    } else {
#pragma unroll
      for (int i = 0; i < PM; ++i) M[s][i] = (i < p && i == col - 2 * p) ? 1.0 : 0.0;
    }
  }
}

// ---- element warp: step k's element from its staged inputs. The ladder's
// second rung is written out rather than looped: a shuffle inside a loop
// whose exit hangs on a vote is compiled for a diverged warp, and costs
// several instructions.
template <typename Fp, int PM, int CPL, bool EXACT>
__device__ __forceinline__ void build_element(const Stage<Fp, PM>& st, Mats<PM>& el, int p_arg, int levels,
                                              double jitter, int lane) {
  const int p = EXACT ? PM : p_arg;
  const int pp = p * p;
  // [sym(Q) + eps I | A' | I] -> [I | Q^-1 A' | Q^-1] = [I | F | E]
  double M[CPL][PM];
  fill_element<Fp, PM, CPL>(M, st, p, jitter, lane);
  gj_sweep<PM, CPL, true>(M, p, lane);
  if (levels > 1 && !cols_finite<PM, CPL>(M, p, 2 * p, lane)) {
    fill_element<Fp, PM, CPL>(M, st, p, jitter * 1e4, lane);
    gj_sweep<PM, CPL, true>(M, p, lane);
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= p && col < 3 * p) {
      double* dst = col < 2 * p ? el.F + (col - p) : el.E + (col - 2 * p);
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) dst[i * p] = M[s][i];
    }
  }
  __syncwarp();
  // A F + BRB, entry by entry over the lanes (each sum over l in order, the
  // loop over l outside, so each l feeds NE independent sums), then G = its
  // symmetric part
  constexpr int NE = (PM * PM + WARP - 1) / WARP;
  int ii[NE], jj[NE];
  double g[NE];
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t < pp ? lane + WARP * t : 0;  // a lane past the end computes entry 0
    ii[t] = idx / p;
    jj[t] = idx - ii[t] * p;
    g[t] = 0.0;
  }
  for (int l = 0; l < p; ++l) {
#pragma unroll
    for (int t = 0; t < NE; ++t) g[t] += st.A[ii[t] * p + l] * el.F[l * p + jj[t]];
  }
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t;
    if (idx < pp) el.G[idx] = __dadd_rn(g[t], st.BRB[idx]);
  }
  __syncwarp();
  sym_entries<PM>(el.G, p, lane);
}

// [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I, lc = 4p)] into registers, as
// fill_element.
template <int PM, int CPL>
__device__ __forceinline__ void fill_compose(double (&M)[CPL][PM], const Mats<PM>& el, const Mats<PM>& pc, int p,
                                             int lc, double eps, int lane) {
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col < p) {
#pragma unroll
      for (int i = 0; i < PM; ++i)
        M[s][i] = i < p ? 0.5 * ((el.E[i * p + col] + pc.G[i * p + col]) + (el.E[col * p + i] + pc.G[col * p + i])) +
                              (i == col ? eps : 0.0)
                        : 0.0;
    } else if (col < 3 * p) {  // row col - p of Fbar, or column col - 2p of F_k
      const bool fb = col < 2 * p;
      const double* src = fb ? pc.F + (col - p) * p : el.F + (col - 2 * p);
      const int stride = fb ? 1 : p;
#pragma unroll
      for (int i = 0; i < PM; ++i) M[s][i] = i < p ? src[i * stride] : 0.0;
    } else {
#pragma unroll
      for (int i = 0; i < PM; ++i) M[s][i] = (i < p && col < lc && i == col - 3 * p) ? 1.0 : 0.0;
    }
  }
}

// ---- compose warp: carry nc = carry pc o element el (k > 0). el.E is
// scratch once the sweep's last rung is taken, nc.G until the products are
// formed.
template <int PM, int CPL, bool EXACT>
__device__ __forceinline__ void compose(Mats<PM>& el, const Mats<PM>& pc, Mats<PM>& nc, int p_arg, int levels,
                                     double jitter, int lane) {
  const int p = EXACT ? PM : p_arg;
  const int pp = p * p;
  const int lc = levels > 1 ? 4 * p : 3 * p;
  // [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I)] -> [I | W Fbar' | W F_k (| W)]
  double M[CPL][PM];
  fill_compose<PM, CPL>(M, el, pc, p, lc, jitter, lane);
  gj_sweep<PM, CPL, true>(M, p, lane);
  if (levels > 1 && !cols_finite<PM, CPL>(M, p, 3 * p, lane)) {
    fill_compose<PM, CPL>(M, el, pc, p, lc, jitter * 1e4, lane);
    gj_sweep<PM, CPL, true>(M, p, lane);
  }
  // W Fbar' -> el.E, W F_k -> nc.G
  __syncwarp();  // every lane has read el.E
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= p && col < 3 * p) {
      double* dst = col < 2 * p ? el.E + (col - p) : nc.G + (col - 2 * p);
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) dst[i * p] = M[s][i];
    }
  }
  __syncwarp();
  // Ebar - Fbar (W Fbar'), Fbar (W F_k), G_k - F_k' (W F_k), entry by entry
  // over the lanes, each sum over l in order (the loop over l outside);
  // every read before any write
  constexpr int NE = (PM * PM + WARP - 1) / WARP;
  int ii[NE], jj[NE];
  double ra[NE], rf[NE], rg[NE];
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t < pp ? lane + WARP * t : 0;  // a lane past the end computes entry 0
    ii[t] = idx / p;
    jj[t] = idx - ii[t] * p;
    ra[t] = rf[t] = rg[t] = 0.0;
  }
  for (int l = 0; l < p; ++l) {
#pragma unroll
    for (int t = 0; t < NE; ++t) {
      const double fb = pc.F[ii[t] * p + l], wk = nc.G[l * p + jj[t]];
      ra[t] += fb * el.E[l * p + jj[t]];
      rf[t] += fb * wk;
      rg[t] += el.F[l * p + ii[t]] * wk;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t;
    if (idx < pp) {
      nc.E[idx] = __dsub_rn(pc.E[idx], ra[t]);
      nc.F[idx] = rf[t];
      nc.G[idx] = __dsub_rn(el.G[idx], rg[t]);
    }
  }
  __syncwarp();
  sym_entries<PM>(nc.E, p, lane);
  sym_entries<PM>(nc.G, p, lane);
}

// The element and the compose as calls at two columns a lane (inlined into
// the kernel, their registers would spill), inlined at one.
template <typename Fp, int PM, int CPL, bool EXACT>
__device__ __noinline__ void build_element_call(const Stage<Fp, PM>& st, Mats<PM>& el, int p, int levels,
                                                double jitter, int lane) {
  build_element<Fp, PM, CPL, EXACT>(st, el, p, levels, jitter, lane);
}
template <int PM, int CPL, bool EXACT>
__device__ __noinline__ void compose_call(Mats<PM>& el, const Mats<PM>& pc, Mats<PM>& nc, int p, int levels,
                                          double jitter, int lane) {
  compose<PM, CPL, EXACT>(el, pc, nc, p, levels, jitter, lane);
}

// Carry slot cc, the prefix of step k of problem b, to E, F, G.
template <int PM>
__device__ __forceinline__ void store_carry(const Mats<PM>& cc, double* Eo, double* Fo, double* Go, size_t off,
                                            int pp, int lane) {
  for (int idx = lane; idx < pp; idx += WARP) {
    __stcs(Eo + off + idx, cc.E[idx]);
    __stcs(Fo + off + idx, cc.F[idx]);
    __stcs(Go + off + idx, cc.G[idx]);
  }
}

// PPB problems a block: warp w < PPB is problem w's element warp, warp
// PPB + w its compose warp. The element warp also stores each prefix: at
// step k, once the compose of step k - RE has freed its element slot, the
// carry of step k - RE is complete, and the compose overwrites that carry
// slot only after element k, built after the store, is handed over.
// EXACT: p = PM, known to the compiler. Fp: the storage type of the inputs
// (double, or float on the float32 path); the prefixes are written in
// double either way, and every operation is double.
template <typename Fp, int PM, int CPL, bool EXACT>
__global__ void __launch_bounds__(THREADS, 4)
lft_scan_kernel(const Fp* __restrict__ Ag, const Fp* __restrict__ BRBg, const Fp* __restrict__ Qg,
                double* __restrict__ Eo, double* __restrict__ Fo, double* __restrict__ Go, int Bsz, int N, int p_arg,
                int levels, double jitter) {
  static_assert(RC >= RE, "the carry of step k - RE is stored before the compose of step k may reuse its slot");
  const int p = EXACT ? PM : p_arg;
  const int pp = p * p;
  __shared__ Problem<Fp, PM> S[PPB];
  // the warp's index through a shuffle, which the compiler knows every lane
  // shares: a branch on the thread index (the roles below) would have it
  // compile every shuffle in the branch for a diverged warp, at several
  // instructions each
  const int tid = threadIdx.x, lane = tid % WARP, warp = __shfl_sync(FULL, tid / WARP, 0);
  const int sl = warp % PPB, b = blockIdx.x * PPB + sl;

  if (tid == 0) {
    for (int q = 0; q < PPB; ++q) {
      for (int s = 0; s < RE; ++s) {
        mbar_init(&S[q].elem_full[s], WARP);  // the element warp
        mbar_init(&S[q].elem_free[s], WARP);  // the compose warp
      }
    }
  }
  __syncthreads();  // the only block-wide barrier, before the step loops
  if (b >= Bsz) return;
  Problem<Fp, PM>& P = S[sl];

  if (warp < PPB) {  // element warp: step k+1's inputs in flight while step k is built
    load_stage<Fp, PM>(P.stage[0], Ag, BRBg, Qg, (size_t)b * N, pp, lane);
    for (int k = 0; k < N; ++k) {
      if (k + 1 < N) {
        load_stage<Fp, PM>(P.stage[(k + 1) & 1], Ag, BRBg, Qg, (size_t)b * N + k + 1, pp, lane);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncwarp();
      const int e = k % RE;
      if (k >= RE) {
        mbar_wait(&P.elem_free[e], prev_parity(k, RE));
        __syncwarp();
        store_carry<PM>(P.carry[(k - RE) % RC], Eo, Fo, Go, ((size_t)b * N + k - RE) * pp, pp, lane);
      }
      if constexpr (CPL > 1)
        build_element_call<Fp, PM, CPL, EXACT>(P.stage[k & 1], P.elem[e], p, levels, jitter, lane);
      else build_element<Fp, PM, CPL, EXACT>(P.stage[k & 1], P.elem[e], p, levels, jitter, lane);
      __syncwarp();
      mbar_arrive(&P.elem_full[e]);
    }
    for (int k = N > RE ? N - RE : 0; k < N; ++k) {  // the last prefixes
      mbar_wait(&P.elem_free[k % RE], use_parity(k, RE));
      __syncwarp();
      store_carry<PM>(P.carry[k % RC], Eo, Fo, Go, ((size_t)b * N + k) * pp, pp, lane);
    }
  } else {  // compose warp: the carry's chain
    for (int k = 0; k < N; ++k) {
      const int e = k % RE;
      mbar_wait(&P.elem_full[e], use_parity(k, RE));
      __syncwarp();
      Mats<PM>& el = P.elem[e];
      Mats<PM>& nc = P.carry[k % RC];
      if (k == 0) {  // the first element is the carry itself: no compose
        for (int idx = lane; idx < pp; idx += WARP) {
          nc.E[idx] = el.E[idx];
          nc.F[idx] = el.F[idx];
          nc.G[idx] = el.G[idx];
        }
      } else {
        if constexpr (CPL > 1) compose_call<PM, CPL, EXACT>(el, P.carry[(k - 1) % RC], nc, p, levels, jitter, lane);
        else compose<PM, CPL, EXACT>(el, P.carry[(k - 1) % RC], nc, p, levels, jitter, lane);
      }
      __syncwarp();
      mbar_arrive(&P.elem_free[e]);
    }
  }
}

template <typename Fp, int PM, int CPL, bool EXACT>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lft_scan_kernel<Fp, PM, CPL, EXACT>, THREADS, 0);
  return n;
}

template <typename Fp, int PM, int CPL, bool EXACT>
void launch(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G, int Bsz, int N, int p,
            int levels, double jitter, cudaStream_t stream) {
  lft_scan_kernel<Fp, PM, CPL, EXACT><<<(Bsz + PPB - 1) / PPB, THREADS, 0, stream>>>(
      (const Fp*)A, (const Fp*)BRB, (const Fp*)Q, (double*)E, (double*)F, (double*)G, Bsz, N, p, levels, jitter);
}

template <typename Fp>
int scan_blocks_per_sm(int p) {
  if (p < 2 || p > PMAX) return -1;
  if (p == 3) return blocks_per_sm<Fp, 3, 1, true>();
  if (p == 5) return blocks_per_sm<Fp, 5, 1, true>();
  if (p == 13) return blocks_per_sm<Fp, 13, 2, true>();
  return blocks_per_sm<Fp, PMAX, 2, false>();
}

template <typename Fp>
int scan(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G, int Bsz, int N, int p, int levels,
         double jitter, void* stream) {
  if (p < 2 || p > PMAX || levels < 1 || levels > 2) return (int)cudaErrorInvalidValue;
  if (Bsz > 0 && N > 0) {
    // the registry's p = 3 (double integrator), 5 (cart-pole, segway,
    // ballbot, PointMass) and 13 (quadrotor) as compile-time sizes, one
    // column a lane at p <= 5 (4p <= 32) and two at p = 13; any other
    // p <= 13 at run time, two columns a lane
    cudaStream_t s = (cudaStream_t)stream;
    if (p == 3) launch<Fp, 3, 1, true>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, s);
    else if (p == 5) launch<Fp, 5, 1, true>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, s);
    else if (p == 13) launch<Fp, 13, 2, true>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, s);
    else launch<Fp, PMAX, 2, false>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Blocks (of two problems) an SM holds at once at this p, as the launch
// below takes it; -1 for a p it refuses. The float32 instantiation stages
// half the bytes.
extern "C" int lft_scan_blocks_per_sm(int p) { return scan_blocks_per_sm<double>(p); }
extern "C" int lft_scan_blocks_per_sm_f32(int p) { return scan_blocks_per_sm<float>(p); }

// float64 blocks, float64 prefixes
extern "C" int lft_scan(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G,
                        int Bsz, int N, int p, int levels, double jitter, void* stream) {
  return scan<double>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, stream);
}

// float32 blocks, float64 prefixes (float64 arithmetic)
extern "C" int lft_scan_f32(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G,
                            int Bsz, int N, int p, int levels, double jitter, void* stream) {
  return scan<float>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, stream);
}
