// Block-cooperative float64 helpers for tiny row-major matrices held in
// shared memory. Every thread of the block calls each helper with the same
// arguments; each helper ends with __syncthreads(), so its result is visible
// to the whole block when it returns. Outputs must not alias inputs.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// C (r x c) = s * op(A) op(B) (+ C if acc), inner dimension `inner`.
// op(A)[i][l] = TA ? A[l*lda + i] : A[i*lda + l]; likewise for B.
template <bool TA, bool TB>
__device__ inline void smm(double* C, int ldc, const double* A, int lda,
                           const double* B, int ldb, int r, int c, int inner,
                           double s, bool acc) {
  for (int idx = threadIdx.x; idx < r * c; idx += blockDim.x) {
    const int i = idx / c, j = idx - (idx / c) * c;
    double sum = 0.0;
    for (int l = 0; l < inner; ++l) {
      const double a = TA ? A[l * lda + i] : A[i * lda + l];
      const double b = TB ? B[j * ldb + l] : B[l * ldb + j];
      sum += a * b;
    }
    C[i * ldc + j] = acc ? C[i * ldc + j] + s * sum : s * sum;
  }
  __syncthreads();
}

// Pivot-free Gauss-Jordan elimination of the augmented r x c system M
// (leading dimension ld, left block r x r): afterwards the right block holds
// left^-1 * right. The pivots (Schur-complement diagonals) go to piv[0..r).
// Same elimination order as ops/linalg.py::_gj_eliminate. rowbuf holds c
// doubles, colbuf r.
__device__ inline void gj_eliminate(double* M, int ld, int r, int c, double* piv,
                                   double* rowbuf, double* colbuf) {
  for (int i = 0; i < r; ++i) {
    const double p = M[i * ld + i];
    for (int j = threadIdx.x; j < c; j += blockDim.x) rowbuf[j] = M[i * ld + j] / p;
    for (int q = threadIdx.x; q < r; q += blockDim.x) colbuf[q] = M[q * ld + i];
    if (threadIdx.x == 0) piv[i] = p;
    __syncthreads();
    for (int idx = threadIdx.x; idx < r * c; idx += blockDim.x) {
      const int q = idx / c, j = idx - (idx / c) * c;
      M[q * ld + j] = (q == i) ? rowbuf[j] : M[q * ld + j] - colbuf[q] * rowbuf[j];
    }
    __syncthreads();
  }
}

// Floored modulo into (-pi, pi], the same value as torch.remainder /
// jnp.remainder: fmod truncates toward zero, so a negative remainder is
// shifted by one period (plain fmod alone differs for negative angles).
__device__ inline double angle_normalize(double a) {
  const double two_pi = 6.283185307179586;
  double r = fmod(a + 3.141592653589793, two_pi);
  if (r != 0.0 && r < 0.0) r += two_pi;
  return r - 3.141592653589793;
}
