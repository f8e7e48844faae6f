// The hand-written dynamics of the line-search kernel
// (csrc/linesearch_kernel.cuh): the six systems of the model registry,
// System.device_id 0..5, each with the formulas of timeopt_tpu_torch/models,
// the quadrotor's trigonometry shared across the lanes of a rollout, and the
// four entries linesearch_rollout[_from][_f32] with a system_id switch.
// A System without a device_id gets a struct generated from its own Python
// functions instead (ops/dyngen.py), in the same kernel template.
#include "linesearch_kernel.cuh"

namespace {

// ---- device-side dynamics; the same formulas as timeopt_tpu_torch/models

struct DoubleIntegrator : NoExtras {
  static constexpr int n = 2, m = 1;
  __device__ static void xdot(const double* x, const double* u, double* xd) {
    xd[0] = x[1];
    xd[1] = u[0];
  }
};

struct Quadrotor : NoExtras {
  static constexpr int n = 12, m = 4;
  static constexpr double MASS = 1.0, G = 9.81;
  static constexpr double IX = 0.02, IY = 0.02, IZ = 0.04;
  static constexpr double INV_IX = 1.0 / 0.02, INV_IY = 1.0 / 0.02, INV_IZ = 1.0 / 0.04;
  static constexpr double KV = 0.05, KW = 0.01;

  __device__ static void xdot(const double* x, const double* u, double* xd) {
    const double vx = x[3], vy = x[4], vz = x[5];
    const double phi = x[6], th = x[7], psi = x[8];
    const double wx = x[9], wy = x[10], wz = x[11];
    const double sph = sin(phi), cph = cos(phi);
    const double sth = sin(th), cth = cos(th);
    const double sps = sin(psi), cps = cos(psi);
    const double tm = u[0] / MASS;
    xd[0] = vx;
    xd[1] = vy;
    xd[2] = vz;
    xd[3] = tm * (cps * sth * cph + sps * sph) - 0.0 - KV * vx;
    xd[4] = tm * (sps * sth * cph - cps * sph) - 0.0 - KV * vy;
    xd[5] = tm * (cth * cph) - G - KV * vz;
    const double tth = tan(th);
    const double sec = 1.0 / cos(th);
    xd[6] = wx + sph * tth * wy + cph * tth * wz;
    xd[7] = 0.0 * wx + cph * wy + (-sph) * wz;
    xd[8] = 0.0 * wx + sph * sec * wy + cph * sec * wz;
    const double jx = IX * wx, jy = IY * wy, jz = IZ * wz;
    const double cx = wy * jz - wz * jy;
    const double cy = wz * jx - wx * jz;
    const double cz = wx * jy - wy * jx;
    xd[9] = (u[1] - cx) * INV_IX - KW * wx;
    xd[10] = (u[2] - cy) * INV_IY - KW * wy;
    xd[11] = (u[3] - cz) * INV_IZ - KW * wz;
  }

  // Euler singularity, spin-up, divergence or non-finite input
  __device__ static bool guard(const double* x, const double* u) {
    bool bad = false;
    double ss = 0.0;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      bad = bad || !isfinite(x[i]);
      ss += x[i] * x[i];
    }
#pragma unroll
    for (int j = 0; j < m; ++j) bad = bad || !isfinite(u[j]);
    bad = bad || (sqrt(ss) > 1e6) || (fabs(cos(x[7])) < 1e-3);
#pragma unroll
    for (int i = 9; i < 12; ++i) bad = bad || (fabs(x[i]) > 1e3);
    return bad;
  }
};

struct Cartpole : NoExtras {
  static constexpr int n = 4, m = 1;
  static constexpr double G = 9.81, M_POLE = 0.1, LENGTH = 0.5;
  static constexpr double POLEMASS_LENGTH = M_POLE * LENGTH;
  static constexpr double INV_TOTAL_MASS = 1.0 / (1.0 + M_POLE);

  __device__ static void xdot(const double* x, const double* u, double* xd) {
    const double th_dot = x[3];
    const double th_u = x[2] - 3.141592653589793;
    const double costh = cos(th_u), sinth = sin(th_u);
    const double temp = (u[0] + POLEMASS_LENGTH * th_dot * th_dot * sinth) * INV_TOTAL_MASS;
    const double denom = LENGTH * (4.0 / 3.0 - M_POLE * costh * costh * INV_TOTAL_MASS);
    const double th_acc = (G * sinth - costh * temp) / denom;
    xd[0] = x[1];
    xd[1] = temp - POLEMASS_LENGTH * th_acc * costh * INV_TOTAL_MASS;
    xd[2] = th_dot;
    xd[3] = th_acc;
  }
};

struct Segway : NoExtras {
  static constexpr int n = 4, m = 1;
  static constexpr double G = 9.81, R_WHEEL = 0.15, M_BASE = 1.0, M_PEND = 2.0, L_PEND = 0.5;
  static constexpr double I_PEND = (1.0 / 3.0) * M_PEND * L_PEND * L_PEND;
  static constexpr double A1 = M_BASE + M_PEND, A2 = M_PEND * L_PEND;
  static constexpr double A3 = I_PEND + M_PEND * L_PEND * L_PEND;
  static constexpr double DEN = A1 * A3 - A2 * A2;
  static constexpr double A_TAU = A3 / (R_WHEEL * DEN) - A2 / DEN;
  static constexpr double A_TH = -(A2 * M_PEND * G * L_PEND) / DEN;
  static constexpr double B_TAU = -A2 / (R_WHEEL * DEN) + A1 / DEN;
  static constexpr double B_TH = (A1 * M_PEND * G * L_PEND) / DEN;

  __device__ static void xdot(const double* x, const double* u, double* xd) {
    xd[0] = x[1];
    xd[1] = A_TAU * u[0] + A_TH * x[2];
    xd[2] = x[3];
    xd[3] = B_TAU * u[0] + B_TH * x[2];
  }
};

struct Ballbot : NoExtras {
  static constexpr int n = 4, m = 1;
  static constexpr double G = 9.81, R_BALL = 0.12, M_BALL = 1.2, M_BODY = 2.0, L_BODY = 0.55;
  static constexpr double I_BALL = (2.0 / 5.0) * M_BALL * R_BALL * R_BALL;
  static constexpr double M_EFF = M_BALL + I_BALL / (R_BALL * R_BALL);
  static constexpr double POLEMASS_LENGTH = M_BODY * L_BODY;
  static constexpr double INV_TOTAL_MASS = 1.0 / (M_EFF + M_BODY);
  static constexpr double INV_R_BALL = 1.0 / R_BALL;

  __device__ static void xdot(const double* x, const double* u, double* xd) {
    const double th_dot = x[3];
    const double force = u[0] * INV_R_BALL;
    const double s = sin(x[2]), c = cos(x[2]);
    const double temp = (force + POLEMASS_LENGTH * th_dot * th_dot * s) * INV_TOTAL_MASS;
    const double th_acc =
        (G * s - c * temp) / (L_BODY * (4.0 / 3.0 - M_BODY * c * c * INV_TOTAL_MASS));
    xd[0] = x[1];
    xd[1] = temp - POLEMASS_LENGTH * th_acc * c * INV_TOTAL_MASS;
    xd[2] = th_dot;
    xd[3] = th_acc;
  }
};

struct PointMass : NoExtras {
  static constexpr int n = 4, m = 2;

  __device__ static void xdot(const double* x, const double* u, double* xd) {
    xd[0] = x[2];
    xd[1] = x[3];
    xd[2] = u[0];
    xd[3] = u[1];
  }

  // soft obstacle penalty sum_i w_i exp(-||p - o_i||^2 / (2 r_i^2)),
  // (cx, cy, r, w) as models/pointmass.py::OBSTACLES
  __device__ static double extra_cost(const double* x, const double*) {
    const double obs[3][4] = {{-1.0, -0.5, 0.65, 6.0}, {0.0, 0.2, 0.70, 6.0}, {1.0, 1.0, 0.65, 6.0}};
    double c = 0.0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const double dx = x[0] - obs[i][0], dy = x[1] - obs[i][1];
      const double r = obs[i][2];
      c += obs[i][3] * exp(-(dx * dx + dy * dy) / (2.0 * r * r));
    }
    return c;
  }
};

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

// system_id (System.device_id): 0 = DoubleIntegrator, 1 = Quadrotor,
// 2 = Cartpole, 3 = Segway, 4 = Ballbot, 5 = PointMass. Each rollout of
// problem b starts at x0 + b * x0_stride.
template <typename Fp>
int rollout_from(const void* X, const void* U, const void* K, const void* kap, const void* T_star, const void* xg,
                 const void* u_ref, const void* Q, const void* R, const void* Qf, const void* w,
                 const void* wrap_mask, const void* alphas, void* Xs, void* Us, void* Js, const void* x0, int B,
                 int N, int n, int m, int A, int system_id, double dt, int state_wrap_bits, long long x0_stride,
                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define LS_LAUNCH(SYS)                                                                          \
  return launch<SYS, Fp>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs, Us, Js, \
                     x0, x0_stride, B, N, n, m, A, dt, state_wrap_bits, s)
  switch (system_id) {
    case 0:
      LS_LAUNCH(DoubleIntegrator);
    case 1:
      LS_LAUNCH(Quadrotor);
    case 2:
      LS_LAUNCH(Cartpole);
    case 3:
      LS_LAUNCH(Segway);
    case 4:
      LS_LAUNCH(Ballbot);
    case 5:
      LS_LAUNCH(PointMass);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LS_LAUNCH
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
