// The line-search kernel (csrc/linesearch_kernel.cuh) on the hand-written
// dynamics of the seven systems of the model registry (csrc/systems.cuh,
// System.device_id 0..6), the quadrotor's trigonometry shared across the
// lanes of a rollout, and the four entries linesearch_rollout[_from][_f32]
// dispatching on system_id. A System without a device_id gets a struct
// generated from its own Python functions instead (ops/dyngen.py), in the
// same kernel template.
#include "linesearch_kernel.cuh"
#include "systems.cuh"

namespace {

// The quadrotor: lanes 6, 7 and 8 own phi, theta and psi; each takes the
// sine and cosine of its own angle (lane 7 the tangent too) and the group
// reads them by shuffle. The formulas are Quadrotor::xdot's and ::guard's.
template <>
__device__ __forceinline__ double xdot_lane<Quadrotor>(int i, double xi, const double* x, const double* u,
                                                       bool& bad) {
  using S = Quadrotor;
  constexpr int G = group_width(S::n);
  double sv = 0.0, cv = 0.0, tv = 0.0;
  if (i >= 6 && i <= 8) {
    sv = sin(xi);
    cv = cos(xi);
  }
  if (i == 7) tv = tan(xi);
  const double sph = group_read<G>(sv, 6), cph = group_read<G>(cv, 6);
  const double sth = group_read<G>(sv, 7), cth = group_read<G>(cv, 7);
  const double tth = group_read<G>(tv, 7);
  const double sps = group_read<G>(sv, 8), cps = group_read<G>(cv, 8);

  bool g = false;
  double ss = 0.0;
#pragma unroll
  for (int q = 0; q < S::n; ++q) {
    g = g || !isfinite(x[q]);
    ss += x[q] * x[q];
  }
#pragma unroll
  for (int j = 0; j < S::m; ++j) g = g || !isfinite(u[j]);
  g = g || (sqrt(ss) > 1e6) || (fabs(cth) < 1e-3);
#pragma unroll
  for (int q = 9; q < 12; ++q) g = g || (fabs(x[q]) > 1e3);
  bad = g;

  // every lane evaluates the whole xdot from the shared trigonometry (no
  // divergence between the lanes) and keeps its own entry
  const double vx = x[3], vy = x[4], vz = x[5];
  const double wx = x[9], wy = x[10], wz = x[11];
  const double tm = u[0] / S::MASS;
  double xd[S::n];
  xd[0] = vx;
  xd[1] = vy;
  xd[2] = vz;
  xd[3] = tm * (cps * sth * cph + sps * sph) - 0.0 - S::KV * vx;
  xd[4] = tm * (sps * sth * cph - cps * sph) - 0.0 - S::KV * vy;
  xd[5] = tm * (cth * cph) - S::G - S::KV * vz;
  const double sec = 1.0 / cth;
  xd[6] = wx + sph * tth * wy + cph * tth * wz;
  xd[7] = 0.0 * wx + cph * wy + (-sph) * wz;
  xd[8] = 0.0 * wx + sph * sec * wy + cph * sec * wz;
  const double jx = S::IX * wx, jy = S::IY * wy, jz = S::IZ * wz;
  const double cx = wy * jz - wz * jy;
  const double cy = wz * jx - wx * jz;
  const double cz = wx * jy - wy * jx;
  xd[9] = (u[1] - cx) * S::INV_IX - S::KW * wx;
  xd[10] = (u[2] - cy) * S::INV_IY - S::KW * wy;
  xd[11] = (u[3] - cz) * S::INV_IZ - S::KW * wz;
  double r = 0.0;
#pragma unroll
  for (int q = 0; q < S::n; ++q)
    if (q == i) r = xd[q];
  return r;
}

// The registry's struct of system_id (systems.cuh::with_system); the lander
// takes the lane group of 16, as the quadrotor. Each rollout of problem b
// starts at x0 + b * x0_stride.
template <typename Fp>
int rollout_from(const void* X, const void* U, const void* K, const void* kap, const void* T_star, const void* xg,
                 const void* u_ref, const void* Q, const void* R, const void* Qf, const void* w,
                 const void* wrap_mask, const void* alphas, void* Xs, void* Us, void* Js, const void* x0, int B,
                 int N, int n, int m, int A, int system_id, double dt, int state_wrap_bits, long long x0_stride,
                 void* stream) {
  return with_system(system_id, [&](auto sys) {
    return launch<decltype(sys), Fp>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us, Js, x0,
                                     x0_stride, B, N, n, m, A, dt, state_wrap_bits, (cudaStream_t)stream);
  });
}

}  // namespace

// float64 data: from start states
extern "C" int linesearch_rollout_from(const void* X, const void* U, const void* K,
                                       const void* kap, const void* T_star, const void* xg,
                                       const void* u_ref, const void* Q, const void* R,
                                       const void* Qf, const void* w, const void* wrap_mask,
                                       const void* alphas, void* Xs, void* Us, void* Js,
                                       const void* x0, int B, int N, int n, int m, int A,
                                       int system_id, double dt, int state_wrap_bits,
                                       long long x0_stride, void* stream) {
  return rollout_from<double>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us, Js, x0, B,
                              N, n, m, A, system_id, dt, state_wrap_bits, x0_stride, stream);
}

// The ordinary line search: every rollout starts at its own X[0].
extern "C" int linesearch_rollout(const void* X, const void* U, const void* K, const void* kap,
                                  const void* T_star, const void* xg, const void* u_ref,
                                  const void* Q, const void* R, const void* Qf, const void* w,
                                  const void* wrap_mask, const void* alphas, void* Xs, void* Us,
                                  void* Js, int B, int N, int n, int m, int A, int system_id,
                                  double dt, int state_wrap_bits, void* stream) {
  return linesearch_rollout_from(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas,
                                 Xs, Us, Js, X, B, N, n, m, A, system_id, dt, state_wrap_bits,
                                 (long long)(N + 1) * n, stream);
}

// float32 data (float64 arithmetic and state): the two entries above
extern "C" int linesearch_rollout_from_f32(const void* X, const void* U, const void* K,
                                           const void* kap, const void* T_star, const void* xg,
                                           const void* u_ref, const void* Q, const void* R,
                                           const void* Qf, const void* w, const void* wrap_mask,
                                           const void* alphas, void* Xs, void* Us, void* Js,
                                           const void* x0, int B, int N, int n, int m, int A,
                                           int system_id, double dt, int state_wrap_bits,
                                           long long x0_stride, void* stream) {
  return rollout_from<float>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us, Js, x0, B,
                             N, n, m, A, system_id, dt, state_wrap_bits, x0_stride, stream);
}

extern "C" int linesearch_rollout_f32(const void* X, const void* U, const void* K, const void* kap,
                                      const void* T_star, const void* xg, const void* u_ref,
                                      const void* Q, const void* R, const void* Qf, const void* w,
                                      const void* wrap_mask, const void* alphas, void* Xs, void* Us,
                                      void* Js, int B, int N, int n, int m, int A, int system_id,
                                      double dt, int state_wrap_bits, void* stream) {
  return linesearch_rollout_from_f32(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas,
                                     Xs, Us, Js, X, B, N, n, m, A, system_id, dt, state_wrap_bits,
                                     (long long)(N + 1) * n, stream);
}
