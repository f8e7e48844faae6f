// All-alphas forward line search (closed-loop rollouts + truncated true
// cost) in float64 for Hopper.
//
// Replaces the TPU kernels timeopt_tpu/ops/pallas_forward.py
// linesearch_lanes_df and linesearch_dense_df (body _fwd_kernel); one kernel
// here, native float64 instead of the compensated df32 rollout. The
// first-improving-alpha selection stays outside the kernel, in torch, as
// _select_first_improving stayed outside the TPU kernel.
//
// Per (problem, alpha): N Euler steps from X[0] with
//   u_k = U_k + [k < T*] (K_k wrap(x - X_k) + alpha kappa_k),
//   x+  = x + dt xdot(x, u) (+ NaN where the system's guard holds on (x, u)),
// the raw step of the system (no norm poisoning), and the cost of
// solver/cost.py::cost_true accumulated inline: stage costs for k < T*
// (with the system's extra stage cost), the terminal cost at X[T*]. J is +inf unless X is finite on rows <= T*, U on
// the active steps, T* > 0, the total is finite and the whole trajectory
// is finite on [0, N].
//
// What bounds it on the H100: each rollout is a chain of N dependent steps
// of ~300 FLOPs (the quadrotor's trigonometry included) and the outputs
// are the only large traffic (B*A*(N+1)*(n+m) doubles, 100 MB at B=1024).
// One thread per (problem, alpha) keeps the state in registers (the system
// is a template parameter, so n and m are compile-time and the loops
// unroll); B*A = 5120 threads at B=1024 is ~40 blocks, well under one wave
// of the card, so the kernel is latency bound on the step chain.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "smallmat.cuh"

namespace {

// ---- device-side dynamics; the same formulas as timeopt_tpu_torch/models

// Each system gives xdot, its guard (true where the step is poisoned) and
// its extra stage cost (0 for all but PointMass). NoExtras supplies the
// defaults.
struct NoExtras {
  __device__ static bool guard(const double*, const double*) { return false; }
  __device__ static double extra_cost(const double*, const double*) { return 0.0; }
};

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

template <class S>
__global__ void linesearch_kernel(const double* __restrict__ X, const double* __restrict__ U,
                                  const double* __restrict__ K, const double* __restrict__ kap,
                                  const int64_t* __restrict__ T_star,
                                  const double* __restrict__ xg, const double* __restrict__ u_ref,
                                  const double* __restrict__ Q, const double* __restrict__ R,
                                  const double* __restrict__ Qf, const double* __restrict__ w,
                                  const bool* __restrict__ wrap_mask,
                                  const double* __restrict__ alphas, double* __restrict__ Xs,
                                  double* __restrict__ Us, double* __restrict__ Js, int B, int N,
                                  int A, double dt, int state_wrap_bits) {
  constexpr int n = S::n, m = S::m;
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= B * A) return;
  const int b = gid / A, a = gid - (gid / A) * A;
  const double alpha = alphas[a];
  const int64_t T = T_star[b];
  const int64_t T_term = T > N ? N : T;  // cost_true clips the terminal row
  const double* xgb = xg + (size_t)b * n;
  const double* urb = u_ref + (size_t)b * m;
  const double* Qb = Q + (size_t)b * n * n;
  const double* Rb = R + (size_t)b * m * m;
  const double* Qfb = Qf + (size_t)b * n * n;
  const double wb = w[b];

  bool wm[n];
  double x[n], xn[n], xd[n], e[n], u[m];
#pragma unroll
  for (int i = 0; i < n; ++i) {
    wm[i] = wrap_mask[(size_t)b * n + i];
    x[i] = X[(size_t)b * (N + 1) * n + i];
  }
  double* Xo = Xs + ((size_t)b * A + a) * (N + 1) * n;
  double* Uo = Us + ((size_t)b * A + a) * N * m;
  bool fa = true;
#pragma unroll
  for (int i = 0; i < n; ++i) {
    Xo[i] = x[i];
    fa = fa && isfinite(x[i]);
  }
  bool ft = fa, fu = true;
  double run = 0.0, jt = 0.0;

  for (int k = 0; k < N; ++k) {
    const bool active = k < T;
    const size_t bk = (size_t)b * N + k;
    const double* Xk = X + ((size_t)b * (N + 1) + k) * n;
    const double* Kk = K + bk * m * n;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      const double d = x[i] - Xk[i];
      e[i] = wm[i] ? angle_normalize(d) : d;
    }
#pragma unroll
    for (int j = 0; j < m; ++j) {
      double s = 0.0;
#pragma unroll
      for (int i = 0; i < n; ++i) s += Kk[j * n + i] * e[i];
      const double du = s + alpha * kap[bk * m + j];
      u[j] = U[bk * m + j] + (active ? du : 0.0);
    }

    if (active) {  // stage cost on the current state
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const double d = x[i] - xgb[i];
        e[i] = wm[i] ? angle_normalize(d) : d;
      }
      double qe = 0.0, rd = 0.0;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < n; ++j) s += Qb[i * n + j] * e[j];
        qe += e[i] * s;
      }
#pragma unroll
      for (int i = 0; i < m; ++i) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < m; ++j) s += Rb[i * m + j] * (u[j] - urb[j]);
        rd += (u[i] - urb[i]) * s;
      }
      run += ((0.5 * qe + 0.5 * rd) + wb) + S::extra_cost(x, u);
    }

    S::xdot(x, u, xd);
    const bool bad = S::guard(x, u);
#pragma unroll
    for (int i = 0; i < n; ++i) {
      double v = x[i] + dt * xd[i];
      if ((state_wrap_bits >> i) & 1) v = angle_normalize(v);
      xn[i] = bad ? v + NAN : v;
    }

    if (k + 1 == T_term) {  // terminal cost at X[T*]
#pragma unroll
      for (int i = 0; i < n; ++i) {
        const double d = xn[i] - xgb[i];
        e[i] = wm[i] ? angle_normalize(d) : d;
      }
      double qe = 0.0;
#pragma unroll
      for (int i = 0; i < n; ++i) {
        double s = 0.0;
#pragma unroll
        for (int j = 0; j < n; ++j) s += Qfb[i * n + j] * e[j];
        qe += e[i] * s;
      }
      jt = run + 0.5 * qe;
    }

    bool nfin = true;
#pragma unroll
    for (int i = 0; i < n; ++i) {
      nfin = nfin && isfinite(xn[i]);
      Xo[(size_t)(k + 1) * n + i] = xn[i];
      x[i] = xn[i];
    }
    bool ufin = true;
#pragma unroll
    for (int j = 0; j < m; ++j) {
      ufin = ufin && isfinite(u[j]);
      Uo[(size_t)k * m + j] = u[j];
    }
    fa = fa && nfin;
    if (k + 1 <= T) ft = ft && nfin;
    if (active) fu = fu && ufin;
  }
  const bool ok = ft && fu && (T > 0) && isfinite(jt) && fa;
  Js[(size_t)b * A + a] = ok ? jt : INFINITY;
}

template <class S>
int launch(const void* X, const void* U, const void* K, const void* kap, const void* T_star,
           const void* xg, const void* u_ref, const void* Q, const void* R, const void* Qf,
           const void* w, const void* wrap_mask, const void* alphas, void* Xs, void* Us,
           void* Js, int B, int N, int n, int m, int A, double dt, int state_wrap_bits,
           cudaStream_t stream) {
  if (n != S::n || m != S::m) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const int blocks = (B * A + threads - 1) / threads;
  if (blocks > 0) {
    linesearch_kernel<S><<<blocks, threads, 0, stream>>>(
        (const double*)X, (const double*)U, (const double*)K, (const double*)kap,
        (const int64_t*)T_star, (const double*)xg, (const double*)u_ref, (const double*)Q,
        (const double*)R, (const double*)Qf, (const double*)w, (const bool*)wrap_mask,
        (const double*)alphas, (double*)Xs, (double*)Us, (double*)Js, B, N, A, dt,
        state_wrap_bits);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// system_id (System.device_id): 0 = DoubleIntegrator, 1 = Quadrotor,
// 2 = Cartpole, 3 = Segway, 4 = Ballbot, 5 = PointMass.
extern "C" int linesearch_rollout(const void* X, const void* U, const void* K, const void* kap,
                                  const void* T_star, const void* xg, const void* u_ref,
                                  const void* Q, const void* R, const void* Qf, const void* w,
                                  const void* wrap_mask, const void* alphas, void* Xs, void* Us,
                                  void* Js, int B, int N, int n, int m, int A, int system_id,
                                  double dt, int state_wrap_bits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (system_id) {
    case 0:
      return launch<DoubleIntegrator>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask,
                                      alphas, Xs, Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    case 1:
      return launch<Quadrotor>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas,
                               Xs, Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    case 2:
      return launch<Cartpole>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas,
                              Xs, Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    case 3:
      return launch<Segway>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs,
                            Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    case 4:
      return launch<Ballbot>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas, Xs,
                             Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    case 5:
      return launch<PointMass>(X, U, K, kap, T_star, xg, u_ref, Q, R, Qf, w, wrap_mask, alphas,
                               Xs, Us, Js, B, N, n, m, A, dt, state_wrap_bits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
