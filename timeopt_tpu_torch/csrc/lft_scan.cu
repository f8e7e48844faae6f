// Every prefix of the LFT scan (the propagator's elements and their
// sequential composition) in float64 for Hopper.
//
// Replaces the TPU kernel timeopt_tpu/ops/pallas_lft.py lft_scan_lanes
// (body _lft_scan_kernel), which computes in the lanes layout (N, p, p, B);
// here the layout is the port's (B, N, p, p) and the arithmetic native
// float64. The path that reaches it is the unfused propagator select
// (solver/horizon.py::propagator_select): consistency_check and the solve
// with terminal_mode="inverse".
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
// (_inv_lanes) of Q and of E_k + Gbar:
// - the element takes F = Q^-1 A' and E = Q^-1 from one Gauss-Jordan sweep
//   of [Q | A' | I], and the compose never forms W: one sweep of
//   [E_k + Gbar | Fbar' | F_k] gives W Fbar' and W F_k. The eliminations
//   are pivot-free, as in the plain version and the JAX reference.
// - the element and compose are copied from lft_select_generic.cu rather
//   than shared through a header, so the select kernels' compiled code and
//   numerics stay as they are.
//
// The jitter ladder of ops/linalg.py::psd_inv (levels 1 or 2): the plain
// version keeps, per matrix, the rung-1 inverse (eps = jitter) unless it has
// a non-finite entry, and then takes rung 2 (eps = 1e4 jitter). Here rung 2
// is a recompute of that one elimination, taken exactly when the rung-1
// inverse is not finite: E (part of the element sweep) for the element, and
// for the compose W itself, from identity columns appended to the sweep
// when levels = 2 (W is formed only for that test).
//
// What bounds it on the H100: the recursion is sequential in k and each step
// is two dependent p x p eliminations, so a problem is bound by the latency
// of its block barriers, not by bytes or FLOPs. Unlike the select kernels it
// writes every prefix: 3p^2 doubles per step (4 KB at p = 13, 665 MB at
// quadrotor B=1024, N=160), one coalesced store per step, far below the
// card's bandwidth. One 128-thread block per problem runs the time loop with
// the carry and scratch in shared memory (~18 KB at p = 13); threads map
// over matrix entries, and the batch fills the card.
#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace {

constexpr int PMAX = 13;
constexpr int THREADS = 128;

// True, for the whole block, iff the r x c block of M (leading dimension ld)
// that starts at column c0 is finite. A barrier.
__device__ inline bool block_finite(const double* M, int ld, int r, int c0, int c) {
  int bad = 0;
  for (int idx = threadIdx.x; idx < r * c; idx += blockDim.x) {
    const int i = idx / c, j = idx - (idx / c) * c;
    if (!isfinite(M[i * ld + c0 + j])) bad = 1;
  }
  return __syncthreads_or(bad) == 0;
}

__global__ void __launch_bounds__(THREADS)
lft_scan_kernel(const double* __restrict__ Ag, const double* __restrict__ BRBg,
                const double* __restrict__ Qg, double* __restrict__ Eo, double* __restrict__ Fo,
                double* __restrict__ Go, int N, int p, int levels, double jitter) {
  const int b = blockIdx.x;
  const int pp = p * p;
  const int tid = threadIdx.x, nt = blockDim.x;

  __shared__ double cE[PMAX * PMAX], cF[PMAX * PMAX], cG[PMAX * PMAX];
  __shared__ double E[PMAX * PMAX], F[PMAX * PMAX], G[PMAX * PMAX];
  __shared__ double Aa[PMAX * PMAX], Bb[PMAX * PMAX], T1[PMAX * PMAX];
  __shared__ double Mx[PMAX * 4 * PMAX];
  __shared__ double rowbuf[4 * PMAX], colbuf[PMAX], piv[PMAX];

  for (int k = 0; k < N; ++k) {
    const size_t off = ((size_t)b * N + k) * pp;
    const double* Ak = Ag + off;
    const double* Qk = Qg + off;
    for (int i = tid; i < pp; i += nt) {
      Aa[i] = Ak[i];
      Bb[i] = BRBg[off + i];
    }

    // ---- element: [sym(Q) + eps I | A' | I] -> [I | Q^-1 A' | Q^-1] = [I | F | E]
    const int ld = 3 * p;
    for (int lv = 0; lv < levels; ++lv) {
      const double eps = lv == 0 ? jitter : jitter * 1e4;
      for (int idx = tid; idx < p * ld; idx += nt) {
        const int i = idx / ld, j = idx - (idx / ld) * ld;
        double x;
        if (j < p) x = 0.5 * (Qk[i * p + j] + Qk[j * p + i]) + (i == j ? eps : 0.0);
        else if (j < 2 * p) x = Ak[(j - p) * p + i];
        else x = (i == j - 2 * p) ? 1.0 : 0.0;
        Mx[idx] = x;
      }
      __syncthreads();
      gj_eliminate(Mx, ld, p, ld, piv, rowbuf, colbuf);
      if (lv + 1 == levels || block_finite(Mx, ld, p, 2 * p, p)) break;
    }
    // G = sym(A F + BRB)
    for (int idx = tid; idx < pp; idx += nt) {
      const int i = idx / p, j = idx - (idx / p) * p;
      F[idx] = Mx[i * ld + p + j];
      E[idx] = Mx[i * ld + 2 * p + j];
      double g = 0.0;
      for (int l = 0; l < p; ++l) g += Aa[i * p + l] * Mx[l * ld + p + j];
      T1[idx] = g + Bb[idx];
    }
    __syncthreads();
    for (int idx = tid; idx < pp; idx += nt) {
      const int i = idx / p, j = idx - (idx / p) * p;
      G[idx] = 0.5 * (T1[idx] + T1[j * p + i]);
    }
    __syncthreads();

    if (k == 0) {
      // the first element is the carry itself: no compose
      for (int idx = tid; idx < pp; idx += nt) {
        cE[idx] = E[idx];
        cF[idx] = F[idx];
        cG[idx] = G[idx];
      }
      __syncthreads();
    } else {
      // ---- compose: [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I)] -> [I | W Fbar' | W F_k (| W)]
      const int lc = levels > 1 ? 4 * p : 3 * p;
      for (int lv = 0; lv < levels; ++lv) {
        const double eps = lv == 0 ? jitter : jitter * 1e4;
        for (int idx = tid; idx < p * lc; idx += nt) {
          const int i = idx / lc, j = idx - (idx / lc) * lc;
          double x;
          if (j < p)
            x = 0.5 * ((E[i * p + j] + cG[i * p + j]) + (E[j * p + i] + cG[j * p + i])) +
                (i == j ? eps : 0.0);
          else if (j < 2 * p) x = cF[(j - p) * p + i];
          else if (j < 3 * p) x = F[i * p + (j - 2 * p)];
          else x = (i == j - 3 * p) ? 1.0 : 0.0;
          Mx[idx] = x;
        }
        __syncthreads();
        gj_eliminate(Mx, lc, p, lc, piv, rowbuf, colbuf);
        if (lv + 1 == levels || block_finite(Mx, lc, p, 3 * p, p)) break;
      }
      // Ebar - Fbar (W Fbar') -> E;  Fbar (W F_k) -> Aa;  G_k - F_k' (W F_k) -> T1
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        double a = 0.0, f = 0.0, g = 0.0;
        for (int l = 0; l < p; ++l) {
          a += cF[i * p + l] * Mx[l * lc + p + j];
          f += cF[i * p + l] * Mx[l * lc + 2 * p + j];
          g += F[l * p + i] * Mx[l * lc + 2 * p + j];
        }
        E[idx] = cE[idx] - a;
        Aa[idx] = f;
        T1[idx] = G[idx] - g;
      }
      __syncthreads();
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        cE[idx] = 0.5 * (E[idx] + E[j * p + i]);
        cF[idx] = Aa[idx];
        cG[idx] = 0.5 * (T1[idx] + T1[j * p + i]);
      }
      __syncthreads();
    }

    for (int idx = tid; idx < pp; idx += nt) {
      Eo[off + idx] = cE[idx];
      Fo[off + idx] = cF[idx];
      Go[off + idx] = cG[idx];
    }
    // the next step's loads into Aa/Bb and sweeps are ordered after these
    // reads of the carry by the barriers inside the element
  }
}

}  // namespace

extern "C" int lft_scan(const void* A, const void* BRB, const void* Q, void* E, void* F, void* G,
                        int Bsz, int N, int p, int levels, double jitter, void* stream) {
  if (p < 2 || p > PMAX || levels < 1 || levels > 2) return (int)cudaErrorInvalidValue;
  if (Bsz > 0 && N > 0) {
    lft_scan_kernel<<<Bsz, THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (const double*)BRB, (const double*)Q, (double*)E, (double*)F,
        (double*)G, N, p, levels, jitter);
  }
  return (int)cudaGetLastError();
}
