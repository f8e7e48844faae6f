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
// Per problem and per step k, with p = n + 1, the element and the compose
// of lft_chain.cuh (BRB = B_aug R^-1 B_aug' staged as it comes in, the
// sweeps' divisions by warpmat::quot, the jitter ladder of
// ops/linalg.py::psd_inv at levels 1 or 2), and the prefix (Ebar, Fbar,
// Gbar) of step k written to E, F, G. The JAX wrapper forms BRB outside the
// Pallas kernel too. Where the TPU kernel forms explicit inverses
// (_inv_lanes) of Q and of E_k + Gbar, the chain eliminates: one sweep of
// [Q | A' | I] gives F = Q^-1 A' and E = Q^-1, one of
// [E_k + Gbar | Fbar' | F_k] gives W Fbar' and W F_k. The generic select
// (lft_select_generic.cu) runs the same chain, so the scan + query chain
// equals that kernel bit for bit.
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
// - the compose warp alone is on the chain: it composes the element onto
//   the carry into a ring of two carry slots.
// Warps hand element slots over with mbarriers ("full" and "free"); the
// carry ring needs none, since the compose of step k overwrites the carry of
// step k - 2 only after element k, which the element warp builds after
// storing that carry. No block-wide barrier runs inside the step loops. At
// p = 13 a block holds 48,736 B of shared memory, so four blocks, eight
// problems, fit an SM and the 1,024 quadrotor problems are resident in one
// wave.
//
// A shuffle in code that the compiler cannot prove the whole warp reaches
// (a branch on the thread index, a loop whose exit hangs on a barrier's
// spin) is compiled for a diverged warp at several instructions (PERF.md
// section 6), so the roles branch on a shuffled warp index and a
// __syncwarp follows each barrier wait.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lft_chain.cuh"

namespace {

using namespace lft_chain;

constexpr int PPB = 2;                   // problems a block
constexpr int THREADS = 2 * PPB * WARP;  // an element and a compose warp each
constexpr int RE = 2;                    // element ring
constexpr int RC = 2;                    // carry ring

template <typename Fp, int PM>
using StageBRB = Stage<Fp, PM, PM * PM>;  // Q_aug, A_aug and BRB
template <typename Fp, int PM>
struct Problem {
  uint64_t elem_full[RE], elem_free[RE];
  StageBRB<Fp, PM> stage[2];
  Mats<PM> elem[RE], carry[RC];
};

template <typename Fp, int PM>
__device__ __forceinline__ void load_stage(StageBRB<Fp, PM>& st, const Fp* Ag, const Fp* BRBg, const Fp* Qg,
                                           size_t bk, int pp, int lane) {
  for (int i = lane; i < pp; i += WARP) {
    cp_async_el(&st.Q[i], Qg + bk * pp + i);
    cp_async_el(&st.A[i], Ag + bk * pp + i);
    cp_async_el(&st.B[i], BRBg + bk * pp + i);
  }
  cp_async_commit();
}

// ---- element warp: step k's element from its staged inputs
template <typename Fp, int PM, int CPL, bool EXACT>
__device__ __noinline__ void build_element(const StageBRB<Fp, PM>& st, Mats<PM>& el, int p, int levels,
                                           double jitter, int lane) {
  using Z = Size<PM, CPL, EXACT>;
  element<Z, true, true>(st, el, p, levels, jitter, lane, BRBStaged<Z, Fp>{st.B, p});
}

// ---- compose warp: carry nc = carry pc o element el (k > 0)
template <int PM, int CPL, bool EXACT>
__device__ __noinline__ void compose(const Mats<PM>& el, const Mats<PM>& pc, Mats<PM>& nc, int p, int levels,
                                     double jitter, int lane) {
  lft_chain::compose<Size<PM, CPL, EXACT>, true, true, true>(el, pc, nc, p, levels, jitter, lane);
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
      build_element<Fp, PM, CPL, EXACT>(P.stage[k & 1], P.elem[e], p, levels, jitter, lane);
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
        compose<PM, CPL, EXACT>(el, P.carry[(k - 1) % RC], nc, p, levels, jitter, lane);
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
  return with_size(p, [](auto z) {
    using Z = decltype(z);
    return blocks_per_sm<Fp, Z::PM, Z::CPL, Z::EXACT>();
  });
}

template <typename Fp>
int scan(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G, int Bsz, int N, int p, int levels,
         double jitter, void* stream) {
  if (p < 2 || p > PMAX || levels < 1 || levels > 2) return (int)cudaErrorInvalidValue;
  if (Bsz > 0 && N > 0) {
    with_size(p, [&](auto z) {  // the chain's size rule (lft_chain.cuh)
      using Z = decltype(z);
      launch<Fp, Z::PM, Z::CPL, Z::EXACT>(A, BRB, Q, E, F, G, Bsz, N, p, levels, jitter, (cudaStream_t)stream);
    });
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
