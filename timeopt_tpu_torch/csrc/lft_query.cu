// The factored terminal queries of the propagator in float64 for Hopper.
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
// What bounds it on the H100: the B*N queries are independent (20,480 at
// quadrotor B=128, 163,840 at B=1024), each a short chain of dependent
// eliminations on at most 13 x 25 doubles, reading 3p^2 + np doubles (5.3 KB
// at p = 13) and writing one. So the pairs map to warps, not a block per
// problem: one 32-thread block per (b, t), its matrices in shared memory
// (~12 KB at p = 13, so ~18 blocks in flight per SM), lanes over matrix
// entries, and the grid of B*N blocks fills the card many times over.
#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace {

constexpr int NMAX = 12;
constexpr int PMAX = NMAX + 1;
constexpr int THREADS = 32;

__global__ void __launch_bounds__(THREADS)
lft_query_kernel(const double* __restrict__ Eg, const double* __restrict__ Fg,
                 const double* __restrict__ Gg, const double* __restrict__ Cg,
                 double* __restrict__ J, int n, int levels, double jitter) {
  const size_t q = blockIdx.x;  // pair index b * N + t
  const int p = n + 1;
  const int pp = p * p;
  const int tid = threadIdx.x, nt = blockDim.x;

  __shared__ double E[PMAX * PMAX], F[PMAX * PMAX], G[PMAX * PMAX], X0[PMAX * PMAX];
  __shared__ double C[NMAX * PMAX], CG[NMAX * PMAX], FC[PMAX * NMAX];
  __shared__ double Mx[PMAX * (NMAX + PMAX)];
  __shared__ double rowbuf[NMAX + PMAX], colbuf[PMAX], piv[PMAX];

  for (int i = tid; i < pp; i += nt) {
    E[i] = Eg[q * pp + i];
    F[i] = Fg[q * pp + i];
    G[i] = Gg[q * pp + i];
  }
  for (int i = tid; i < n * p; i += nt) C[i] = Cg[q * n * p + i];
  __syncthreads();
  smm<false, false>(CG, p, C, p, G, p, n, p, p, 1.0, false);  // C G   (n x p)
  smm<false, true>(FC, n, F, p, C, p, p, n, p, 1.0, false);   // F C'  (p x n)

  // [sym(I + C G C') | C F'] -> [I | Y]
  const int lq = n + p;
  for (int idx = tid; idx < n * lq; idx += nt) {
    const int i = idx / lq, j = idx - (idx / lq) * lq;
    double x;
    if (j < n) {
      double sij = 0.0, sji = 0.0;
      for (int l = 0; l < p; ++l) {
        sij += CG[i * p + l] * C[j * p + l];
        sji += CG[j * p + l] * C[i * p + l];
      }
      const double d = (i == j) ? 1.0 : 0.0;
      x = 0.5 * ((d + sij) + (d + sji));
    } else {
      x = FC[(j - n) * n + i];
    }
    Mx[idx] = x;
  }
  __syncthreads();
  gj_eliminate(Mx, lq, n, lq, piv, rowbuf, colbuf);

  // X0 = sym(E - (F C') Y); G is free from here on
  for (int idx = tid; idx < pp; idx += nt) {
    const int i = idx / p, j = idx - (idx / p) * p;
    double s = 0.0;
    for (int l = 0; l < n; ++l) s += FC[i * n + l] * Mx[l * lq + n + j];
    G[idx] = E[idx] - s;
  }
  __syncthreads();
  for (int idx = tid; idx < pp; idx += nt) {
    const int i = idx / p, j = idx - (idx / p) * p;
    X0[idx] = 0.5 * (G[idx] + G[j * p + i]);
  }
  __syncthreads();

  // [X0 + eps I | e_{p-1}] -> [I | y]
  const int lx = p + 1;
  for (int lv = 0; lv < levels; ++lv) {
    const double eps = lv == 0 ? jitter : jitter * 1e4;
    for (int idx = tid; idx < p * lx; idx += nt) {
      const int i = idx / lx, j = idx - (idx / lx) * lx;
      Mx[idx] = j < p ? X0[i * p + j] + (i == j ? eps : 0.0) : (i == p - 1 ? 1.0 : 0.0);
    }
    __syncthreads();
    gj_eliminate(Mx, lx, p, lx, piv, rowbuf, colbuf);
    if (lv + 1 == levels) break;
    int bad = 0;
    for (int i = tid; i < p; i += nt)
      if (!isfinite(Mx[i * lx + p])) bad = 1;
    if (__syncthreads_or(bad) == 0) break;
  }
  if (tid == 0) J[q] = 0.5 * Mx[(p - 1) * lx + p];
}

}  // namespace

extern "C" int lft_query(const void* E, const void* F, const void* G, const void* C, void* J,
                         int Bsz, int N, int n, int levels, double jitter, void* stream) {
  if (n < 1 || n > NMAX || levels < 1 || levels > 2) return (int)cudaErrorInvalidValue;
  const long long pairs = (long long)Bsz * N;
  if (pairs > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (pairs > 0) {
    lft_query_kernel<<<(unsigned)pairs, THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)E, (const double*)F, (const double*)G, (const double*)C, (double*)J, n,
        levels, jitter);
  }
  return (int)cudaGetLastError();
}
