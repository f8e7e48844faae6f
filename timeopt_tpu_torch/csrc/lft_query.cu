// The factored terminal queries of the propagator in float64 for Hopper.
//
// Two entries, one template on C's and J's storage type: lft_query (float64)
// and lft_query_f32 (float32 C and J, the float32 path; the prefixes of
// lft_scan.cu stay float64 on both). The float32 instantiation stages C as
// it is (4-byte cp.async), converts it to double where it is read, and
// rounds J to float32 once, on its store.
//
// Replaces the TPU kernel timeopt_tpu/ops/pallas_lft.py lft_query_lanes
// (body _query_kernel), which computes in the lanes layout (N, p, p, B) and
// forms explicit inverses (_inv_lanes); here the layout is the port's
// (B, N, p, p) and the arithmetic native float64. The path that reaches it
// is the unfused propagator select with terminal_mode="factored"
// (solver/horizon.py::propagator_select), run by consistency_check.
//
// Per problem b and horizon t, on the prefix (E, F, G) and the terminal
// factor C (n x p, p = n + 1), with the order of the plain version
// (solver/horizon.py::propagator_J_curve_factored):
//   S  = sym(I + C G C')                      (n x n, solved with jitter 0)
//   Y  = S^-1 (F C')'                          one sweep of [S | C F']
//   X0 = sym(E - (F C') Y)
//   y  = (X0 + eps I)^-1 e_{p-1},  J = 0.5 y[p-1]
// J is unscaled (the caller multiplies by s_0^2) and written for every t.
// The jitter ladder of ops/linalg.py::psd_solve (levels 1 or 2): y takes
// rung 2 (eps = 1e4 jitter), a recompute of that one elimination, exactly
// when the rung-1 solve has a non-finite entry; the S solve has jitter 0, so
// its two rungs are one matrix and it runs once. The eliminations are
// pivot-free, as in the plain version and the JAX reference.
//
// What bounds it on the H100: the B*N queries are independent (163,840 at
// quadrotor B=1024, N=160), each reading 3p^2 + np doubles (5.3 KB at
// p = 13) and writing one, with a few kFLOP between: 869 MB of reads at
// B=1024, 0.26 ms at the card's 3.35 TB/s. The first design ran one
// 32-thread block a query with ~12 KB of shared memory (18 of an SM's 64
// warp slots), loaded a query's inputs before computing on them, crossed
// ~58 block barriers a query and read shared memory in every multiply-add.
//
// The design: persistent warps, one query at a time each, no block
// barrier. A grid of as many one-warp blocks as fit the card at once gives
// each warp its own stride of (b, t) pairs and its own ring of two input
// slots in shared memory: while it computes query q, cp.async brings in
// query q + stride's E, F, G and C (16 warps an SM at p = 13, ~85 KB of
// loads in flight an SM). A query runs the C form of lft_select_generic.cu's
// query warps: C G, F C' and C G C' entry by entry over the 32 lanes (the
// loop over the summation index outside); the sweep of [sym(I + C G C') |
// C F'] in registers (csrc/warpmat.cuh: n x (n + p) <= 12 x 25, lane j holds
// column j, the pivot column broadcast by __shfl_sync); X0 entry by entry;
// and the sweep of [X0 + eps I | e_{p-1}] in registers, J read off its last
// column. That sweep runs in full, back substitution included: the ladder's
// warp vote needs every entry of y, which a forward-only sweep (whose last
// pivot gives J alone, lft_select_generic.cu) does not form. Every entry
// keeps the arithmetic and the operation order of the first design (each
// inner sum in index order, each division by the pivot, each M - col * row
// update, each symmetrization with its operands in the same order), so J
// equals it bit for bit; the additions that join a sum to another value are
// written __dadd_rn / __dsub_rn, as in lft_scan.cu. What holds it back now
// (PERF.md section 6): each query's own instruction stream, led by the two
// sweeps' 25 pivots, each a chain of shuffles and a float64 division;
// more queries in flight do not help (one input slot and 24 warps an SM
// ran 3% faster).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "warpmat.cuh"

namespace {

using namespace warpmat;

constexpr int NMAX = 12;

// one query's inputs: the prefix in double, C in the storage type Fp
// (double, or float on the float32 path, converted to double where it is
// read)
template <typename Fp, int NM>
struct Slot {
  static constexpr int PM = NM + 1;
  double E[PM * PM], F[PM * PM], G[PM * PM];
  Fp C[NM * PM];
};
template <typename Fp, int NM>
struct WarpRegion {  // one warp's input ring and products
  static constexpr int PM = NM + 1;
  Slot<Fp, NM> slot[2];
  double CG[NM * PM], FC[PM * NM];
};

template <typename Fp, int NM>
__device__ __forceinline__ void load_slot(Slot<Fp, NM>& sl, const double* Eg, const double* Fg, const double* Gg,
                                          const Fp* Cg, size_t q, int pp, int np, int lane) {
  for (int i = lane; i < pp; i += WARP) {
    cp_async8(&sl.E[i], Eg + q * pp + i);
    cp_async8(&sl.F[i], Fg + q * pp + i);
    cp_async8(&sl.G[i], Gg + q * pp + i);
  }
  for (int i = lane; i < np; i += WARP) cp_async_el(&sl.C[i], Cg + q * np + i);
  cp_async_commit();
}

// out(idx, sum_l a(i, l) b(l, j)) for every entry idx = i * cols + j of a
// rows x cols product (at most MAXE entries), entry by entry over the
// lanes: each sum over l in order, the loop over l outside, so each l feeds
// the lane's independent sums.
template <int MAXE, typename FA, typename FB, typename FO>
__device__ __forceinline__ void entrywise(int rows, int cols, int inner, int lane, FA a, FB b, FO out) {
  constexpr int NE = (MAXE + WARP - 1) / WARP;
  int ii[NE], jj[NE];
  double acc[NE];
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t < rows * cols ? lane + WARP * t : 0;  // past the end: entry 0
    ii[t] = idx / cols;
    jj[t] = idx - ii[t] * cols;
    acc[t] = 0.0;
  }
  for (int l = 0; l < inner; ++l) {
#pragma unroll
    for (int t = 0; t < NE; ++t) acc[t] += a(ii[t], l) * b(l, jj[t]);
  }
#pragma unroll
  for (int t = 0; t < NE; ++t)
    if (lane + WARP * t < rows * cols) out(lane + WARP * t, acc[t]);
}

// [sym(X0) + eps I | e_{p-1}] into registers, lane j holding column j; X0
// (p x p, unsymmetrized) in shared memory.
template <int PM>
__device__ __forceinline__ void fill_x(double (&X)[1][PM], const double* X0, int p, double eps, int j) {
  if (j < p) {
#pragma unroll
    for (int i = 0; i < PM; ++i)
      X[0][i] = i < p ? __dadd_rn(0.5 * (X0[i * p + j] + X0[j * p + i]), i == j ? eps : 0.0) : 0.0;
  } else {
#pragma unroll
    for (int i = 0; i < PM; ++i) X[0][i] = (j == p && i == p - 1) ? 1.0 : 0.0;
  }
}

// J of one query. The slot's G holds C G C' once C G is formed, its F the
// unsymmetrized X0 once F C' is formed, and the warp's CG holds Y.
template <typename Fp, int NM, bool EXACT>
__device__ __noinline__ double query(WarpRegion<Fp, NM>& R, Slot<Fp, NM>& in, int n_arg, int levels, double jitter,
                                     int lane) {
  constexpr int PM = NM + 1;
  const int n = EXACT ? NM : n_arg;
  const int p = n + 1;
  // C G (n x p) and F C' (p x n)
  entrywise<NM * PM>(n, p, p, lane, [&](int i, int l) { return (double)in.C[i * p + l]; },
                     [&](int l, int j) { return in.G[l * p + j]; }, [&](int idx, double v) { R.CG[idx] = v; });
  entrywise<PM * NM>(p, n, p, lane, [&](int i, int l) { return in.F[i * p + l]; },
                     [&](int l, int j) { return (double)in.C[j * p + l]; },
                     [&](int idx, double v) { R.FC[idx] = v; });
  __syncwarp();
  // C G C' (n x n) -> in.G
  entrywise<NM * NM>(n, n, p, lane, [&](int i, int l) { return R.CG[i * p + l]; },
                     [&](int l, int j) { return (double)in.C[j * p + l]; },
                     [&](int idx, double v) { in.G[idx] = v; });
  __syncwarp();
  // [sym(I + C G C') | C F'] -> [I | Y], lane j holding column j (n + p <= 25)
  const int j = lane;
  double M[1][NM];
  if (j < n) {
#pragma unroll
    for (int i = 0; i < NM; ++i) {
      const double d = (i == j) ? 1.0 : 0.0;
      M[0][i] = i < n ? 0.5 * __dadd_rn(__dadd_rn(d, in.G[i * n + j]), __dadd_rn(d, in.G[j * n + i])) : 0.0;
    }
  } else {
    const double* src = R.FC + (j < n + p ? j - n : 0) * n;
#pragma unroll
    for (int i = 0; i < NM; ++i) M[0][i] = (i < n && j < n + p) ? src[i] : 0.0;
  }
  gj_sweep<NM, 1, true>(M, n, lane);
  // Y -> R.CG (C G is spent), then E - (F C') Y -> in.F (F is spent)
  if (j >= n && j < n + p) {
#pragma unroll
    for (int i = 0; i < NM; ++i)
      if (i < n) R.CG[i * p + (j - n)] = M[0][i];
  }
  __syncwarp();
  entrywise<PM * PM>(p, p, n, lane, [&](int i, int l) { return R.FC[i * n + l]; },
                     [&](int l, int jj) { return R.CG[l * p + jj]; },
                     [&](int idx, double v) { in.F[idx] = __dsub_rn(in.E[idx], v); });
  __syncwarp();
  // [sym(X0) + eps I | e_{p-1}] -> [I | y], lane j holding column j
  // (p + 1 <= 14); the second rung written out, as in lft_scan.cu
  double X[1][PM];
  fill_x<PM>(X, in.F, p, jitter, j);
  gj_sweep<PM, 1, true>(X, p, lane);
  if (levels > 1) {
    bool bad = false;
    if (j == p) {
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p && !isfinite(X[0][i])) bad = true;
    }
    if (__any_sync(FULL, bad)) {
      fill_x<PM>(X, in.F, p, jitter * 1e4, j);
      gj_sweep<PM, 1, true>(X, p, lane);
    }
  }
  __syncwarp();
  double y = 0.0;
#pragma unroll
  for (int i = 0; i < PM; ++i)
    if (i == p - 1) y = X[0][i];
  return 0.5 * __shfl_sync(FULL, y, p);
}

// One warp a block. The warp takes the pairs q = w, w + W, ... (w its
// block's index, W the grid's blocks), with query q + W's inputs in flight
// while it computes query q. The loop runs on the block index, which the
// compiler knows every lane shares: a loop whose exit hangs on the thread
// index would have it compile every shuffle for a diverged warp, at several
// instructions each. EXACT: n = NM, known to the compiler. Fp: the storage
// type of C and J (double, or float on the float32 path: J one rounding of
// the double result); the prefixes are double either way.
template <typename Fp, int NM, bool EXACT>
__global__ void __launch_bounds__(WARP, NM >= 12 ? 16 : 32)
lft_query_kernel(const double* __restrict__ Eg, const double* __restrict__ Fg, const double* __restrict__ Gg,
                 const Fp* __restrict__ Cg, Fp* __restrict__ J, long long pairs, int n_arg, int levels,
                 double jitter) {
  const int n = EXACT ? NM : n_arg;
  const int p = n + 1, pp = p * p, np = n * p;
  __shared__ WarpRegion<Fp, NM> R;
  const int lane = threadIdx.x;
  const long long stride = gridDim.x;
  long long q = blockIdx.x;
  if (q < pairs) load_slot<Fp, NM>(R.slot[0], Eg, Fg, Gg, Cg, (size_t)q, pp, np, lane);
  for (int it = 0; q < pairs; q += stride, ++it) {
    if (q + stride < pairs) {
      load_slot<Fp, NM>(R.slot[(it + 1) & 1], Eg, Fg, Gg, Cg, (size_t)(q + stride), pp, np, lane);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const double jv = query<Fp, NM, EXACT>(R, R.slot[it & 1], n, levels, jitter, lane);
    if (lane == 0) J[q] = (Fp)jv;
    __syncwarp();  // every lane is done with the slot before it is refilled
  }
}

template <typename Fp, int NM, bool EXACT>
int blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, lft_query_kernel<Fp, NM, EXACT>, WARP, 0);
  return n;
}

template <typename Fp, int NM, bool EXACT>
int launch(const void* E, const void* F, const void* G, const void* C, void* J, long long pairs, int n, int levels,
           double jitter, cudaStream_t stream) {
  static int resident = 0;  // blocks the card holds at once
  if (resident == 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int per_sm = blocks_per_sm<Fp, NM, EXACT>();
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  const int grid = (int)(pairs < resident ? pairs : resident);
  lft_query_kernel<Fp, NM, EXACT><<<grid, WARP, 0, stream>>>(
      (const double*)E, (const double*)F, (const double*)G, (const Fp*)C, (Fp*)J, pairs, n, levels, jitter);
  return (int)cudaGetLastError();
}

template <typename Fp>
int query_blocks_per_sm(int n) {
  if (n < 1 || n > NMAX) return -1;
  if (n == 2) return blocks_per_sm<Fp, 2, true>();
  if (n == 4) return blocks_per_sm<Fp, 4, true>();
  if (n == 12) return blocks_per_sm<Fp, 12, true>();
  return blocks_per_sm<Fp, NMAX, false>();
}

template <typename Fp>
int query_all(const void* E, const void* F, const void* G, const void* C, void* J, int Bsz, int N, int n, int levels,
              double jitter, void* stream) {
  if (n < 1 || n > NMAX || levels < 1 || levels > 2) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)Bsz * N;
  if (pairs <= 0) return (int)cudaGetLastError();
  // the registry's n = 2 (double integrator), 4 (cart-pole, segway, ballbot,
  // PointMass) and 12 (quadrotor) as compile-time sizes; any other n <= 12
  // at run time
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 2) return launch<Fp, 2, true>(E, F, G, C, J, pairs, n, levels, jitter, s);
  if (n == 4) return launch<Fp, 4, true>(E, F, G, C, J, pairs, n, levels, jitter, s);
  if (n == 12) return launch<Fp, 12, true>(E, F, G, C, J, pairs, n, levels, jitter, s);
  return launch<Fp, NMAX, false>(E, F, G, C, J, pairs, n, levels, jitter, s);
}

}  // namespace

// Blocks (one warp each) an SM holds at once at this n, as the launch below
// takes it; -1 for an n it refuses. The float32 instantiation stages C in
// half the bytes.
extern "C" int lft_query_blocks_per_sm(int n) { return query_blocks_per_sm<double>(n); }
extern "C" int lft_query_blocks_per_sm_f32(int n) { return query_blocks_per_sm<float>(n); }

// float64 prefixes, C and J
extern "C" int lft_query(const void* E, const void* F, const void* G, const void* C, void* J,
                         int Bsz, int N, int n, int levels, double jitter, void* stream) {
  return query_all<double>(E, F, G, C, J, Bsz, N, n, levels, jitter, stream);
}

// float64 prefixes, float32 C and J (float64 arithmetic, J rounded once)
extern "C" int lft_query_f32(const void* E, const void* F, const void* G, const void* C, void* J,
                             int Bsz, int N, int n, int levels, double jitter, void* stream) {
  return query_all<float>(E, F, G, C, J, Bsz, N, n, levels, jitter, stream);
}
