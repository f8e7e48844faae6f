// Fused propagator select (HOP-DDP horizon selection) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_lft.py
// propagator_select_lanes_df_fused and propagator_select_dense_df_fused
// (body _df_select_fused_kernel -> _df_compose_query_w0). The lanes, dense
// and trisym variants are TPU layouts of one function and become this one
// kernel; the df32 (double-single) arithmetic becomes native float64.
//
// Per problem and per step k: assemble A_aug and B R^-1 B' from the raw
// step inputs, build the arrow-form LFT element (E, F, G), compose it onto
// the prefix carry (Ebar, Fbar, Gbar), and for k+1 >= T_min run the
// W0-form terminal query J = 0.5 ((X0 + jitter I)^-1)[p-1, p-1]. Below
// T_min the output is +inf. J is unscaled (the caller multiplies by s_0^2).
//
// What bounds it on the H100: the recursion is sequential in k and every
// step is a chain of dependent 13 x 13 eliminations, so a problem is bound
// by latency (barriers between elimination steps), not by bytes or FLOPs:
// a step reads ~1.8 KB of inputs and does ~40k FLOPs. The TPU's sequential
// grid axis (time) becomes a loop inside the block: one thread block per
// problem keeps the three 13 x 13 carries and all scratch in shared memory
// (~21 KB), threads map over matrix entries, and the batch fills the card
// (B = 1024 gives ~8 resident blocks per SM, which hide each other's
// barrier latency). The compose never forms W = (E_k + Gbar)^-1: one
// Gauss-Jordan sweep over [E_k + Gbar + jitter I | Fbar' | F_k] yields
// W Fbar' and W F_k together.
#include <cuda_runtime.h>
#include <math.h>

#include "smallmat.cuh"

namespace {

constexpr int NMAX = 12;
constexpr int PMAX = NMAX + 1;
constexpr int MMAX = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
lft_select_kernel(const double* __restrict__ A, const double* __restrict__ Bm,
                  const double* __restrict__ vecs, const double* __restrict__ scal,
                  const double* __restrict__ iQq, const double* __restrict__ Rinv,
                  const double* __restrict__ W0g, double* __restrict__ J, int N,
                  int n, int m, int t_min, double jitter) {
  const int b = blockIdx.x;
  const int p = n + 1;
  const int pp = p * p;
  const int tid = threadIdx.x, nt = blockDim.x;

  __shared__ double cE[PMAX * PMAX], cF[PMAX * PMAX], cG[PMAX * PMAX];
  __shared__ double E[PMAX * PMAX], F[PMAX * PMAX], G[PMAX * PMAX];
  __shared__ double Aa[PMAX * PMAX], T1[PMAX * PMAX];
  __shared__ double iQ[NMAX * NMAX], W0[NMAX * NMAX], Ri[MMAX * MMAX];
  __shared__ double Bk[NMAX * MMAX], BR[NMAX * MMAX];
  __shared__ double DAt[NMAX * PMAX];
  __shared__ double Mx[PMAX * 3 * PMAX];
  __shared__ double q[NMAX], u[PMAX], v[PMAX], et[NMAX];
  __shared__ double rowbuf[3 * PMAX + NMAX], colbuf[PMAX], piv[PMAX];
  __shared__ double inv_s;

  for (int i = tid; i < n * n; i += nt) {
    iQ[i] = iQq[(size_t)b * n * n + i];
    W0[i] = W0g[(size_t)b * n * n + i];
  }
  for (int i = tid; i < m * m; i += nt) Ri[i] = Rinv[(size_t)b * m * m + i];
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    const size_t bk = (size_t)b * N + k;
    const double* Ak = A + bk * n * n;
    const double* vk = vecs + bk * 4 * n;  // rows e_k, e_{k+1}, atil_k, Q e_k
    const double* sk = scal + bk * 4;      // corner_k, 1/s_k, s_{k+1}, 1/s_{k+1}
    const double corner = sk[0], inv_sk = sk[1], s_kp1 = sk[2], inv_skp1 = sk[3];

    // ---- A_aug = [[A, atil/s_k], [0, s_{k+1}/s_k]], B_k, q = Qe/s_k, e~
    for (int idx = tid; idx < pp; idx += nt) {
      const int i = idx / p, j = idx - (idx / p) * p;
      double a;
      if (i < n) a = (j < n) ? Ak[i * n + j] : vk[2 * n + i] * inv_sk;
      else a = (j < n) ? 0.0 : s_kp1 * inv_sk;
      Aa[idx] = a;
    }
    for (int i = tid; i < n * m; i += nt) Bk[i] = Bm[bk * n * m + i];
    for (int i = tid; i < n; i += nt) {
      q[i] = vk[3 * n + i] * inv_sk;
      et[i] = vk[n + i] * inv_skp1;
    }
    __syncthreads();
    smm<false, false>(BR, m, Bk, m, Ri, m, n, m, m, 1.0, false);  // B R^-1

    // ---- arrow element: w = iQq q, s = (c + jitter) - q'w, u = [w; -1]
    for (int i = tid; i < n; i += nt) {
      double s = 0.0;
      for (int l = 0; l < n; ++l) s += iQ[i * n + l] * q[l];
      u[i] = s;
    }
    if (tid == 0) u[n] = -1.0;
    __syncthreads();
    if (tid == 0) {
      double qtw = 0.0;
      for (int l = 0; l < n; ++l) qtw += q[l] * u[l];
      inv_s = 1.0 / ((corner * inv_sk * inv_sk + jitter) - qtw);
    }
    // v = A_aug u;  DAt = iQq A_left' (n x p)
    for (int i = tid; i < p; i += nt) {
      double s = 0.0;
      for (int l = 0; l < p; ++l) s += Aa[i * p + l] * u[l];
      v[i] = s;
    }
    smm<false, true>(DAt, p, iQ, n, Aa, p, n, p, n, 1.0, false);

    // E = blkdiag(iQq, 0) + (1/s) u u';  F = [DAt; 0] + (1/s) u v';
    // G = A_left DAt + (1/s) v v' + [[B R^-1 B', 0], [0, 0]]  (then sym)
    for (int idx = tid; idx < pp; idx += nt) {
      const int i = idx / p, j = idx - (idx / p) * p;
      const double ui = u[i] * inv_s;
      E[idx] = ((i < n && j < n) ? iQ[i * n + j] : 0.0) + ui * u[j];
      F[idx] = ((i < n) ? DAt[i * p + j] : 0.0) + ui * v[j];
      double g = 0.0;
      for (int l = 0; l < n; ++l) g += Aa[i * p + l] * DAt[l * p + j];
      double brb = 0.0;
      if (i < n && j < n)
        for (int l = 0; l < m; ++l) brb += BR[i * m + l] * Bk[j * m + l];
      T1[idx] = (g + (v[i] * inv_s) * v[j]) + brb;
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
      const int ld = 3 * p;
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

    // ---- W0-form terminal query. With e~ = e_{k+1}/s_{k+1}:
    // K = W0 + G11 + e~ g' + g e~' + g22 e~ e~',  FEt = Fbar[:, :n] + Fbar[:, n] e~'
    // X0 = Ebar - FEt K^-1 FEt';  J = 0.5 / (last pivot of sym(X0) + jitter I)
    {
      const int ld = n + p;
      for (int idx = tid; idx < n * ld; idx += nt) {
        const int i = idx / ld, j = idx - (idx / ld) * ld;
        double x;
        if (j < n) {
          const double eg = et[i] * cG[j * p + n];
          const double ge = cG[i * p + n] * et[j];
          x = W0[i * n + j] + (((cG[i * p + j] + eg) + ge) + (et[i] * cG[n * p + n]) * et[j]);
        } else {
          const int r = j - n;  // FEt'[i][r] = FEt[r][i]
          x = cF[r * p + i] + cF[r * p + n] * et[i];
        }
        Mx[idx] = x;
      }
      __syncthreads();
      gj_eliminate(Mx, ld, n, ld, piv, rowbuf, colbuf);  // right block: K^-1 FEt'
      for (int idx = tid; idx < pp; idx += nt) {
        const int i = idx / p, j = idx - (idx / p) * p;
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += (cF[i * p + l] + cF[i * p + n] * et[l]) * Mx[l * ld + n + j];
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

extern "C" int lft_select_fused(const void* A, const void* Bm, const void* vecs,
                                const void* scal, const void* iQq, const void* Rinv,
                                const void* W0, void* J, int B, int N, int n, int m,
                                int t_min, double jitter, void* stream) {
  if (n < 1 || n > NMAX || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (B > 0 && N > 0) {
    lft_select_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (const double*)Bm, (const double*)vecs, (const double*)scal,
        (const double*)iQq, (const double*)Rinv, (const double*)W0, (double*)J, N, n, m,
        t_min, jitter);
  }
  return (int)cudaGetLastError();
}
