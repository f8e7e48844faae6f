// Generic propagator select (HOP-DDP horizon selection on assembled,
// step-dependent blocks) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_lft.py
// propagator_select_lanes_df and propagator_select_dense_df (body
// _df_select_kernel -> _df_select_step + _df_compose_query). The lanes,
// dense and trisym variants are TPU layouts of one function and become this
// one kernel; the df32 (double-single) arithmetic becomes native float64.
// The path that reaches it is a system with an extra stage cost (PointMass),
// whose Hessian makes Q_aug vary with k, so the k-constant arrow element and
// W0 query of the fused kernel (lft_select.cu) do not apply.
//
// Per problem and per step k, with p = n + 1:
//   element  E = (sym(Q_aug,k) + jitter I)^-1,  F = E A',  G = sym(A F + B R^-1 B')
//   compose  onto the prefix carry (Ebar, Fbar, Gbar) with
//            W = (sym(E_k + Gbar) + jitter I)^-1 never formed
//   query    (k+1 >= T_min) S = sym(I + C Gbar C'),  Y = S^-1 C Fbar',
//            X0 = sym(Ebar - Fbar C' Y),  J = 0.5 ((X0 + jitter I)^-1)[p-1, p-1]
//            read off the last pivot of the elimination; +inf below T_min.
// J is unscaled (the caller multiplies by s_0^2). No elimination pivots, as
// in the plain version (solver/horizon.py::select_generic_plain) and the JAX
// reference: Q_aug may be indefinite near an obstacle, and the result must
// be the same function, not a better-conditioned one.
//
// What bounds it on the H100: as for lft_select.cu, the recursion is
// sequential in k and each step is a chain of dependent p x p eliminations
// (three per step: element, compose, query, plus the n x n query solve), so
// a problem is bound by the latency of its block barriers, not by bytes or
// FLOPs (a step reads (3p^2 + pm + np) doubles, 1.5 KB at p = 5, m = 2). The
// time loop runs inside one thread block per problem with every carry and
// scratch matrix in shared memory (~20 KB at the p = 13 maximum); threads map
// over matrix entries, and the batch fills the card. The element takes F
// and E from one Gauss-Jordan sweep of [Q | A' | I], the compose W Fbar' and
// W F_k from one sweep of [E_k + Gbar | Fbar' | F_k]; that compose is a copy
// of lft_select.cu's rather than a shared header, so the fused kernel's
// compiled code, and its agreement with its plain version, stay as they
// are. At p = 5 a 128-thread block leaves most threads idle in every sweep;
// packing several problems into a block is left for later work.
#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace {

constexpr int NMAX = 12;
constexpr int PMAX = NMAX + 1;
constexpr int MMAX = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
lft_select_generic_kernel(const double* __restrict__ Ag, const double* __restrict__ Bg,
                          const double* __restrict__ Qg, const double* __restrict__ Rinv,
                          const double* __restrict__ Cg, double* __restrict__ J, int N, int n,
                          int m, int t_min, double jitter) {
  const int b = blockIdx.x;
  const int p = n + 1;
  const int pp = p * p;
  const int tid = threadIdx.x, nt = blockDim.x;

  __shared__ double cE[PMAX * PMAX], cF[PMAX * PMAX], cG[PMAX * PMAX];
  __shared__ double E[PMAX * PMAX], F[PMAX * PMAX], G[PMAX * PMAX];
  __shared__ double Aa[PMAX * PMAX], T1[PMAX * PMAX];
  __shared__ double Ri[MMAX * MMAX], Bk[PMAX * MMAX], BR[PMAX * MMAX];
  __shared__ double Ck[NMAX * PMAX], CG[NMAX * PMAX], FC[PMAX * NMAX];
  __shared__ double Mx[PMAX * 3 * PMAX];
  __shared__ double rowbuf[3 * PMAX], colbuf[PMAX], piv[PMAX];

  for (int i = tid; i < m * m; i += nt) Ri[i] = Rinv[(size_t)b * m * m + i];

  for (int k = 0; k < N; ++k) {
    const size_t bk = (size_t)b * N + k;
    const double* Ak = Ag + bk * pp;
    const double* Qk = Qg + bk * pp;

    // ---- element: [sym(Q) + jitter I | A' | I] -> [I | Q^-1 A' | Q^-1] = [I | F | E]
    const int ld = 3 * p;
    for (int idx = tid; idx < p * ld; idx += nt) {
      const int i = idx / ld, j = idx - (idx / ld) * ld;
      double x;
      if (j < p) x = 0.5 * (Qk[i * p + j] + Qk[j * p + i]) + (i == j ? jitter : 0.0);
      else if (j < 2 * p) x = Ak[(j - p) * p + i];
      else x = (i == j - 2 * p) ? 1.0 : 0.0;
      Mx[idx] = x;
    }
    for (int i = tid; i < pp; i += nt) Aa[i] = Ak[i];
    for (int i = tid; i < p * m; i += nt) Bk[i] = Bg[bk * p * m + i];
    for (int i = tid; i < n * p; i += nt) Ck[i] = Cg[bk * n * p + i];
    __syncthreads();
    smm<false, false>(BR, m, Bk, m, Ri, m, p, m, m, 1.0, false);  // B R^-1
    gj_eliminate(Mx, ld, p, ld, piv, rowbuf, colbuf);
    // G = sym(A F + B R^-1 B')
    for (int idx = tid; idx < pp; idx += nt) {
      const int i = idx / p, j = idx - (idx / p) * p;
      F[idx] = Mx[i * ld + p + j];
      E[idx] = Mx[i * ld + 2 * p + j];
      double g = 0.0;
      for (int l = 0; l < p; ++l) g += Aa[i * p + l] * Mx[l * ld + p + j];
      double brb = 0.0;
      for (int l = 0; l < m; ++l) brb += BR[i * m + l] * Bk[j * m + l];
      T1[idx] = g + brb;
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
      // ---- compose: [sym(E_k + Gbar) + jitter I | Fbar' | F_k] -> [I | W Fbar' | W F_k]
      for (int idx = tid; idx < p * ld; idx += nt) {
        const int i = idx / ld, j = idx - (idx / ld) * ld;
        double x;
        if (j < p)
          x = 0.5 * ((E[i * p + j] + cG[i * p + j]) + (E[j * p + i] + cG[j * p + i])) +
              (i == j ? jitter : 0.0);
        else if (j < 2 * p) x = cF[(j - p) * p + i];
        else x = F[i * p + (j - 2 * p)];
        Mx[idx] = x;
      }
      __syncthreads();
      gj_eliminate(Mx, ld, p, ld, piv, rowbuf, colbuf);
      // Ebar - Fbar (W Fbar') -> E;  Fbar (W F_k) -> Aa;  G_k - F_k' (W F_k) -> T1
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        double a = 0.0, f = 0.0, g = 0.0;
        for (int l = 0; l < p; ++l) {
          a += cF[i * p + l] * Mx[l * ld + p + j];
          f += cF[i * p + l] * Mx[l * ld + 2 * p + j];
          g += F[l * p + i] * Mx[l * ld + 2 * p + j];
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

    if (k + 1 < t_min) {
      if (tid == 0) J[bk] = INFINITY;
      continue;
    }

    // ---- C-form terminal query
    smm<false, false>(CG, p, Ck, p, cG, p, n, p, p, 1.0, false);  // C Gbar   (n x p)
    smm<false, true>(FC, n, cF, p, Ck, p, p, n, p, 1.0, false);   // Fbar C'  (p x n)
    {
      // [sym(I + C Gbar C') | C Fbar'] -> [I | Y]
      const int lq = n + p;
      for (int idx = tid; idx < n * lq; idx += nt) {
        const int i = idx / lq, j = idx - (idx / lq) * lq;
        double x;
        if (j < n) {
          double sij = 0.0, sji = 0.0;
          for (int l = 0; l < p; ++l) {
            sij += CG[i * p + l] * Ck[j * p + l];
            sji += CG[j * p + l] * Ck[i * p + l];
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
      // X0 = Ebar - (Fbar C') Y
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += FC[i * n + l] * Mx[l * lq + n + j];
        T1[idx] = cE[idx] - s;
      }
      __syncthreads();
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        E[idx] = 0.5 * (T1[idx] + T1[j * p + i]) + (i == j ? jitter : 0.0);
      }
      __syncthreads();
      gj_eliminate(E, p, p, p, piv, rowbuf, colbuf);
      if (tid == 0) J[bk] = 0.5 / piv[p - 1];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int lft_select_generic(const void* A, const void* B, const void* Q, const void* Rinv,
                                  const void* C, void* J, int Bsz, int N, int n, int m, int t_min,
                                  double jitter, void* stream) {
  if (n < 1 || n > NMAX || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (Bsz > 0 && N > 0) {
    lft_select_generic_kernel<<<Bsz, THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (const double*)B, (const double*)Q, (const double*)Rinv,
        (const double*)C, (double*)J, N, n, m, t_min, jitter);
  }
  return (int)cudaGetLastError();
}
