// Warp-level float64 helpers for tiny matrices, shared by the fused and
// the generic select (lft_select.cu, lft_select_generic.cu), the prefix
// scan and the query (lft_scan.cu, lft_query.cu) and the backward pass
// (backward.cu).
//
// A matrix under elimination lives in registers: lane j holds column j
// (and, with two columns a lane, column j + 32), one row per array entry.
// Every shuffle and vote names the full warp, and every lane of the warp
// reaches every call, also a lane whose column is past the matrix's edge
// (it computes on zeros and nothing reads its result): a mask that names
// only some lanes makes the groups of a warp take turns. Step inputs move
// from device memory to shared memory by cp.async; warps hand shared
// buffers to each other through mbarriers in shared memory.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace warpmat {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

// ---- PTX: cp.async copies and mbarriers

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Every thread of a producing warp arrives (release); a consuming warp
// waits for the phase of its use of the buffer (acquire).
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  uint64_t state;
  asm volatile("mbarrier.arrive.shared.b64 %0, [%1];" : "=l"(state) : "r"(smem_addr(bar)) : "memory");
  (void)state;
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile("{ .reg .pred p; mbarrier.try_wait.parity.shared.b64 p, [%1], %2; selp.u32 %0, 1, 0, p; }"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void cp_async8(double* dst, const double* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src) : "memory");
}
// one element of either storage type (the float32 path keeps its inputs
// float32 in shared memory and converts them to float64 as it reads them)
__device__ __forceinline__ void cp_async_el(double* dst, const double* src) { cp_async8(dst, src); }
__device__ __forceinline__ void cp_async_el(float* dst, const float* src) { cp_async4(dst, src); }
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
// wait until at most K of this thread's committed groups are in flight
template <int K>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(K) : "memory");
}

// ---- end PTX

// A ring of R buffers, each used by step k for the (k / R)-th time. The u-th
// completion of a buffer's barrier has parity u & 1: step k waits for the
// "full" phase of its own use and, from k >= R on, for the "free" phase of
// the use before.
__device__ __forceinline__ unsigned use_parity(int k, int R) { return (unsigned)(k / R) & 1u; }
__device__ __forceinline__ unsigned prev_parity(int k, int R) { return (unsigned)(k / R - 1) & 1u; }

// x / pv, as IEEE division gives it; with a zero x and a finite, non-zero
// pv the signed zero comes from x * pv, which has the same value and sign,
// without the division: a zero quotient falls outside the range of the
// float64 division's fast path, and its slow path costs the whole warp.
__device__ __forceinline__ double quot(double x, double pv) {
  return (x == 0.0 && isfinite(pv) && pv != 0.0) ? x * pv : x / pv;
}

// Pivot-free Gauss-Jordan elimination of the r x c system held in
// registers, CPL columns a lane: M[s][i] is row i of column lane + 32 s.
// The left block is r x r (r <= R <= 32, its column i in lane i); after
// the sweep each right-block column holds left^-1 * that column. Entry by
// entry the same arithmetic as a sweep in shared memory: per pivot i the
// row is divided by the pivot, then every other row q takes
// M[q] - M[q][i] * row, the column entry M[q][i] broadcast by shuffle
// before row q is updated. Returns the pivot of row `lane` (1.0 for a lane
// >= r), for a vote on the pivots. ZQ: the row's divisions by quot (the
// same bits; zero entries and the columns past the matrix's edge skip the
// division).
template <int R, int CPL, bool ZQ = false>
__device__ __forceinline__ double gj_sweep(double (&M)[CPL][R], int r, int lane) {
  double mine = 1.0;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (i < r) {
      const double pv = __shfl_sync(FULL, M[0][i], i);
      if (lane == i) mine = pv;
      double row[CPL];
#pragma unroll
      for (int s = 0; s < CPL; ++s) row[s] = ZQ ? quot(M[s][i], pv) : M[s][i] / pv;
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (q < r) {
          const double c = __shfl_sync(FULL, M[0][q], i);
#pragma unroll
          for (int s = 0; s < CPL; ++s) M[s][q] = (q == i) ? row[s] : M[s][q] - c * row[s];
        }
      }
    }
  }
  return mine;
}

// The last pivot of a pivot-free elimination of the r x r matrix whose
// column j lane j holds (r <= R): forward elimination only, which gives
// every entry the last pivot depends on the same updates as a full
// Gauss-Jordan sweep, hence the same bits. Every lane gets the value.
// ZQ: the row's divisions by quot, as in gj_sweep.
template <int R, bool ZQ = false>
__device__ __forceinline__ double last_pivot(double (&X)[R], int r) {
#pragma unroll
  for (int i = 0; i < R - 1; ++i) {
    if (i < r - 1) {
      const double pv = __shfl_sync(FULL, X[i], i);
      const double row = ZQ ? quot(X[i], pv) : X[i] / pv;
#pragma unroll
      for (int q = i + 1; q < R; ++q) {
        if (q < r) {
          const double c = __shfl_sync(FULL, X[q], i);
          X[q] = X[q] - c * row;
        }
      }
    }
  }
  double last = 0.0;
#pragma unroll
  for (int q = 0; q < R; ++q)
    if (q == r - 1) last = X[q];
  return __shfl_sync(FULL, last, r - 1);
}

// M (p x p, row-major, shared memory) <- sym(M) = 0.5 (M + M'), in place:
// one lane per pair i <= j. The warp must have written M and synchronized.
__device__ __forceinline__ void sym_inplace(double* M, int p, int lane) {
  for (int idx = lane; idx < p * p; idx += WARP) {
    const int i = idx / p, j = idx - (idx / p) * p;
    if (i > j) continue;
    const double s = 0.5 * (M[idx] + M[j * p + i]);
    M[idx] = s;
    M[j * p + i] = s;
  }
}

}  // namespace warpmat
