// Scalar float64 helpers of the line-search kernel (linesearch.cu).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

// Floored modulo into (-pi, pi], the same value as torch.remainder /
// jnp.remainder: fmod truncates toward zero, so a negative remainder is
// shifted by one period (plain fmod alone differs for negative angles).
__device__ inline double angle_normalize(double a) {
  const double two_pi = 6.283185307179586;
  double r = fmod(a + 3.141592653589793, two_pi);
  if (r != 0.0 && r < 0.0) r += two_pi;
  return r - 3.141592653589793;
}
