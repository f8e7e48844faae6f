// A forward-mode dual number in double: a value and one tangent. Evaluating
// a system's xdot (csrc/systems.cuh, a template on its scalar) on duals
// seeded at input j gives xdot and its derivative along input j together:
// one column of the Jacobian (csrc/linearize.cu).
//
// The tangent rules are those of torch's forward AD, so that the Jacobian
// keeps the AD path's pattern of non-finite entries: a product carries both
// terms (0 * NaN is NaN, as in a vmap'd jacfwd, whose tangents are dense), a
// constant is a double and never a dual with a zero tangent (KV * v takes
// KV * v.d, no 0 * v), sin, cos and tan take the derivative at the value.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// the double overloads beside the dual ones, so that a template's
// unqualified sin(x) finds both whichever header came first
using ::cos;
using ::exp;
using ::sin;
using ::sqrt;
using ::tan;

struct Dual {
  double v, d;
};

__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.d}; }

__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator+(Dual a, double c) { return {a.v + c, a.d}; }
__device__ __forceinline__ Dual operator+(double c, Dual a) { return {c + a.v, a.d}; }

__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, double c) { return {a.v - c, a.d}; }
__device__ __forceinline__ Dual operator-(double c, Dual a) { return {c - a.v, -a.d}; }

__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, double c) { return {a.v * c, a.d * c}; }
__device__ __forceinline__ Dual operator*(double c, Dual a) { return {c * a.v, c * a.d}; }

// (a / b)' = (a' - b' q) / b with q = a / b
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const double q = a.v / b.v;
  return {q, (a.d - b.d * q) / b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, double c) { return {a.v / c, a.d / c}; }
// (c / b)' = -b' q / b with q = c / b
__device__ __forceinline__ Dual operator/(double c, Dual b) {
  const double q = c / b.v;
  return {q, -b.d * q / b.v};
}

__device__ __forceinline__ Dual sin(Dual a) {
  double s, c;
  sincos(a.v, &s, &c);
  return {s, a.d * c};
}
__device__ __forceinline__ Dual cos(Dual a) {
  double s, c;
  sincos(a.v, &s, &c);
  return {c, -a.d * s};
}
__device__ __forceinline__ Dual tan(Dual a) {
  const double t = tan(a.v);
  return {t, a.d * (1.0 + t * t)};
}
__device__ __forceinline__ Dual sqrt(Dual a) {
  const double r = sqrt(a.v);
  return {r, a.d / (2.0 * r)};
}
__device__ __forceinline__ Dual exp(Dual a) {
  const double e = exp(a.v);
  return {e, a.d * e};
}

}  // namespace
