// Truncated iLQR backward pass (reverse Riccati sweep) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_backward.py
// backward_lanes_df and backward_dense_df (body _backward_kernel ->
// _backward_step_body); one kernel here, native float64 instead of df32.
// Contract of timeopt_tpu/solver/backward.py::_backward_arrays per problem:
// ok starts as T* > 0; at t+1 == T* the terminal expansion (Vx = QfeT_t,
// Vxx = Qf) is injected and ok &= eT_ok_t; each active step t < T* forms
// the Q-expansion, eliminates [sym(Quu) + lambda I | Qu | Qux] by
// pivot-free Gauss-Jordan (the pivots are the PD test), sets
// kappa = -Quu_reg^-1 Qu, K = -Quu_reg^-1 Qux, updates the value with the
// UNREGULARIZED Quu in the full K'Quu K form, and ANDs ok with
// pd & step_ok_t & finite(Vx_new, Vxx_new). Steps t >= T* get zero gains.
//
// What bounds it on the H100: a chain of T* dependent 12 x 12 steps per
// problem (latency, not bytes: a step reads ~1.7 KB and does ~10k FLOPs).
// One thread block per problem keeps (Vx, Vxx) and the step's scratch in
// shared memory (~12 KB) and maps threads over matrix entries. The TPU
// skipped dead steps only per 128-problem tile (by the tile's max T*);
// here each block starts its reverse loop at its own T* - 1 and only
// writes zeros above it.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smallmat.cuh"

namespace {

constexpr int NMAX = 12;
constexpr int MMAX = 8;
constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
backward_kernel(const double* __restrict__ A, const double* __restrict__ Bm,
                const double* __restrict__ lx, const double* __restrict__ lu,
                const double* __restrict__ Qs, const double* __restrict__ QfeT,
                const double* __restrict__ eT_ok, const double* __restrict__ step_ok,
                const double* __restrict__ Qf, const double* __restrict__ R,
                const int64_t* __restrict__ T_star, const double* __restrict__ lm,
                double* __restrict__ kappa, double* __restrict__ Kout,
                bool* __restrict__ ok_out, int N, int n, int m) {
  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int64_t T = T_star[b];
  const int t_hi = (int)(T < 0 ? 0 : (T > N ? N : T));  // active steps: t < t_hi
  const double lam = lm[b];

  __shared__ double Vx[NMAX], Vxx[NMAX * NMAX];
  __shared__ double At[NMAX * NMAX], Bt[NMAX * MMAX];
  __shared__ double VA[NMAX * NMAX], VB[NMAX * MMAX];
  __shared__ double Qx[NMAX], Qxx[NMAX * NMAX], Quu[MMAX * MMAX], Qux[MMAX * NMAX];
  __shared__ double Mx[MMAX * (MMAX + 1 + NMAX)];
  __shared__ double QuuK[MMAX * (1 + NMAX)];
  __shared__ double Vraw[NMAX * NMAX], Vxn[MMAX + NMAX];  // [Qu | Vx_new]
  __shared__ double rowbuf[MMAX + 1 + NMAX], colbuf[MMAX], piv[MMAX];
  __shared__ int finite_flag;
  __shared__ bool ok;

  // zero gains on the inactive steps t >= T*
  const int gsz = m + m * n;
  for (int idx = tid; idx < (N - t_hi) * gsz; idx += nt) {
    const int t = t_hi + idx / gsz, r = idx - (idx / gsz) * gsz;
    const size_t bt = (size_t)b * N + t;
    if (r < m) kappa[bt * m + r] = 0.0;
    else Kout[bt * m * n + (r - m)] = 0.0;
  }
  for (int i = tid; i < n; i += nt) Vx[i] = 0.0;
  for (int i = tid; i < n * n; i += nt) Vxx[i] = 0.0;
  if (tid == 0) ok = T > 0;
  __syncthreads();

  const int w = m + 1 + n;  // [Quu_reg | Qu | Qux]
  for (int t = t_hi - 1; t >= 0; --t) {
    const size_t bt = (size_t)b * N + t;
    if (t + 1 == T) {  // terminal injection
      for (int i = tid; i < n; i += nt) Vx[i] = QfeT[bt * n + i];
      for (int i = tid; i < n * n; i += nt) Vxx[i] = Qf[(size_t)b * n * n + i];
      if (tid == 0) ok = ok && (eT_ok[bt] > 0.5);
    }
    for (int i = tid; i < n * n; i += nt) At[i] = A[bt * n * n + i];
    for (int i = tid; i < n * m; i += nt) Bt[i] = Bm[bt * n * m + i];
    if (tid == 0) finite_flag = 1;
    __syncthreads();

    smm<false, false>(VA, n, Vxx, n, At, n, n, n, n, 1.0, false);  // Vxx A
    smm<false, false>(VB, m, Vxx, n, Bt, m, n, m, n, 1.0, false);  // Vxx B
    // Qx = lx + A'Vx;  Qxx = Qs + A'(Vxx A);  Quu = R + B'(Vxx B);  Qux = B'(Vxx A)
    for (int i = tid; i < n; i += nt) {
      double s = 0.0;
      for (int l = 0; l < n; ++l) s += At[l * n + i] * Vx[l];
      Qx[i] = lx[bt * n + i] + s;
    }
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      double s = 0.0;
      for (int l = 0; l < n; ++l) s += At[l * n + i] * VA[l * n + j];
      Qxx[idx] = Qs[bt * n * n + idx] + s;
    }
    for (int idx = tid; idx < m * m; idx += nt) {
      const int i = idx / m, j = idx - (idx / m) * m;
      double s = 0.0;
      for (int l = 0; l < n; ++l) s += Bt[l * m + i] * VB[l * m + j];
      Quu[idx] = R[(size_t)b * m * m + idx] + s;
    }
    for (int idx = tid; idx < m * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      double s = 0.0;
      for (int l = 0; l < n; ++l) s += Bt[l * m + i] * VA[l * n + j];
      Qux[idx] = s;
    }
    __syncthreads();
    for (int idx = tid; idx < m * w; idx += nt) {
      const int i = idx / w, j = idx - (idx / w) * w;
      double x;
      if (j < m) {
        x = 0.5 * (Quu[i * m + j] + Quu[j * m + i]) + (i == j ? lam : 0.0);
        if (!isfinite(x)) finite_flag = 0;
      } else if (j == m) {  // Qu = lu + B'Vx
        double s = 0.0;
        for (int l = 0; l < n; ++l) s += Bt[l * m + i] * Vx[l];
        x = lu[bt * m + i] + s;
      } else {
        x = Qux[i * n + (j - m - 1)];
      }
      Mx[idx] = x;
    }
    __syncthreads();
    // the elimination overwrites Qu in Mx: keep a copy in Vxn[0..m)
    for (int i = tid; i < m; i += nt) Vxn[i] = Mx[i * w + m];
    __syncthreads();
    gj_eliminate(Mx, w, m, w, piv, rowbuf, colbuf);

    // kappa = -X[:, m], K = -X[:, m+1:]; QuuK = Quu [kappa | K]
    for (int idx = tid; idx < m * (1 + n); idx += nt) {
      const int i = idx / (1 + n), j = idx - (idx / (1 + n)) * (1 + n);
      double s = 0.0;
      for (int l = 0; l < m; ++l) s += Quu[i * m + l] * (-Mx[l * w + m + j]);
      QuuK[idx] = s;
    }
    __syncthreads();
    // Vx_new = Qx + K'Qu + Qux'kappa + K'(Quu kappa)
    for (int i = tid; i < n; i += nt) {
      double a = 0.0, c = 0.0, d = 0.0;
      for (int l = 0; l < m; ++l) {
        const double Kli = -Mx[l * w + m + 1 + i];
        a += Kli * Vxn[l];
        c += Qux[l * n + i] * (-Mx[l * w + m]);
        d += Kli * QuuK[l * (1 + n)];
      }
      Vxn[m + i] = ((Qx[i] + a) + c) + d;
    }
    // Vxx_new = sym(Qxx + K'Qux + Qux'K + K'(Quu K))
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      double a = 0.0, c = 0.0, d = 0.0;
      for (int l = 0; l < m; ++l) {
        const double Kli = -Mx[l * w + m + 1 + i];
        a += Kli * Qux[l * n + j];
        c += Qux[l * n + i] * (-Mx[l * w + m + 1 + j]);
        d += Kli * QuuK[l * (1 + n) + 1 + j];
      }
      Vraw[idx] = ((Qxx[idx] + a) + c) + d;
    }
    __syncthreads();
    for (int idx = tid; idx < n * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      const double x = 0.5 * (Vraw[idx] + Vraw[j * n + i]);
      if (!isfinite(x)) finite_flag = 0;
      Vxx[idx] = x;
    }
    for (int i = tid; i < n; i += nt) {
      const double x = Vxn[m + i];
      if (!isfinite(x)) finite_flag = 0;
      Vx[i] = x;
    }
    for (int i = tid; i < m; i += nt) kappa[bt * m + i] = -Mx[i * w + m];
    for (int idx = tid; idx < m * n; idx += nt) {
      const int i = idx / n, j = idx - (idx / n) * n;
      Kout[bt * m * n + idx] = -Mx[i * w + m + 1 + j];
    }
    __syncthreads();
    if (tid == 0) {
      bool pd = true;
      for (int i = 0; i < m; ++i) pd = pd && (piv[i] > 0.0) && isfinite(piv[i]);
      ok = ok && pd && (finite_flag != 0) && (step_ok[bt] > 0.5);
    }
    __syncthreads();
  }
  if (tid == 0) ok_out[b] = ok;
}

}  // namespace

extern "C" int backward_truncated(const void* A, const void* Bm, const void* lx,
                                  const void* lu, const void* Qs, const void* QfeT,
                                  const void* eT_ok, const void* step_ok, const void* Qf,
                                  const void* R, const void* T_star, const void* lm,
                                  void* kappa, void* K, void* ok, int B, int N, int n,
                                  int m, void* stream) {
  if (n < 1 || n > NMAX || m < 1 || m > MMAX) return (int)cudaErrorInvalidValue;
  if (B > 0) {
    backward_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
        (const double*)A, (const double*)Bm, (const double*)lx, (const double*)lu,
        (const double*)Qs, (const double*)QfeT, (const double*)eT_ok,
        (const double*)step_ok, (const double*)Qf, (const double*)R,
        (const int64_t*)T_star, (const double*)lm, (double*)kappa, (double*)K, (bool*)ok,
        N, n, m);
  }
  return (int)cudaGetLastError();
}
