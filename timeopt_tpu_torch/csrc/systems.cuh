// The device dynamics of the seven systems of the model registry
// (System.device_id 0..6), each with the formulas of timeopt_tpu_torch/models:
// n, m, xdot(x, u, xd), guard(x, u) and extra_cost(x, u). Two kernels run
// them: the line search (csrc/linesearch.cu) integrates xdot in double, and
// the Jacobian kernel (csrc/linearize.cu) differentiates the very same
// formulas by evaluating xdot on dual numbers (csrc/dual.cuh). Hence xdot is
// a template on its scalar T; its double instance is the code the line
// search always ran. The guard and the extra stage cost are double only:
// neither enters the Jacobian (the guard's NaN payload is additive and
// constant).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

// Each system gives xdot, its guard (true where the step is poisoned) and
// its extra stage cost (0 for all but PointMass). NoExtras supplies the
// defaults.
struct NoExtras {
  __device__ static bool guard(const double*, const double*) { return false; }
  __device__ static double extra_cost(const double*, const double*) { return 0.0; }
};

struct DoubleIntegrator : NoExtras {
  static constexpr int n = 2, m = 1;
  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
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

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
    const T vx = x[3], vy = x[4], vz = x[5];
    const T phi = x[6], th = x[7], psi = x[8];
    const T wx = x[9], wy = x[10], wz = x[11];
    const T sph = sin(phi), cph = cos(phi);
    const T sth = sin(th), cth = cos(th);
    const T sps = sin(psi), cps = cos(psi);
    const T tm = u[0] / MASS;
    xd[0] = vx;
    xd[1] = vy;
    xd[2] = vz;
    xd[3] = tm * (cps * sth * cph + sps * sph) - 0.0 - KV * vx;
    xd[4] = tm * (sps * sth * cph - cps * sph) - 0.0 - KV * vy;
    xd[5] = tm * (cth * cph) - G - KV * vz;
    const T tth = tan(th);
    const T sec = 1.0 / cos(th);
    xd[6] = wx + sph * tth * wy + cph * tth * wz;
    xd[7] = 0.0 * wx + cph * wy + (-sph) * wz;
    xd[8] = 0.0 * wx + sph * sec * wy + cph * sec * wz;
    const T jx = IX * wx, jy = IY * wy, jz = IZ * wz;
    const T cx = wy * jz - wz * jy;
    const T cy = wz * jx - wx * jz;
    const T cz = wx * jy - wy * jx;
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

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
    const T th_dot = x[3];
    const T th_u = x[2] - 3.141592653589793;
    const T costh = cos(th_u), sinth = sin(th_u);
    const T temp = (u[0] + POLEMASS_LENGTH * th_dot * th_dot * sinth) * INV_TOTAL_MASS;
    const T denom = LENGTH * (4.0 / 3.0 - M_POLE * costh * costh * INV_TOTAL_MASS);
    const T th_acc = (G * sinth - costh * temp) / denom;
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

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
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

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
    const T th_dot = x[3];
    const T force = u[0] * INV_R_BALL;
    const T s = sin(x[2]), c = cos(x[2]);
    const T temp = (force + POLEMASS_LENGTH * th_dot * th_dot * s) * INV_TOTAL_MASS;
    const T th_acc =
        (G * s - c * temp) / (L_BODY * (4.0 / 3.0 - M_BODY * c * c * INV_TOTAL_MASS));
    xd[0] = x[1];
    xd[1] = temp - POLEMASS_LENGTH * th_acc * c * INV_TOTAL_MASS;
    xd[2] = th_dot;
    xd[3] = th_acc;
  }
};

struct PointMass : NoExtras {
  static constexpr int n = 4, m = 2;

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
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

// The 6-DoF powered-descent lander (models/rocket6dof.py): x = [m, r_I (3),
// v_I (3), q_B/I (4, scalar first), omega_B (3)], u = T_B, the thrust in the
// body frame; the formulas in the model's order, the constants' terms in
// product form (RY * tz) as there.
struct Rocket6DoF : NoExtras {
  static constexpr int n = 14, m = 3;
  static constexpr double M_DRY = 1.0, G = 1.0, ALPHA_M = 0.01;
  static constexpr double JX = 0.01, JY = 0.01, JZ = 0.01;
  static constexpr double INV_JX = 1.0 / 0.01, INV_JY = 1.0 / 0.01, INV_JZ = 1.0 / 0.01;
  static constexpr double RX = -0.01, RY = 0.0, RZ = 0.0;
  static constexpr double THRUST_EPS = 1e-6;

  template <typename T>
  __device__ static void xdot(const T* x, const T* u, T* xd) {
    const T mass = x[0];
    const T q0 = x[7], q1 = x[8], q2 = x[9], q3 = x[10];
    const T wx = x[11], wy = x[12], wz = x[13];
    const T tx = u[0], ty = u[1], tz = u[2];
    const T tn = sqrt(tx * tx + ty * ty + tz * tz);
    xd[0] = -ALPHA_M * tn;
    xd[1] = x[4];
    xd[2] = x[5];
    xd[3] = x[6];
    // C_I/B(q) T_B / m + g_I
    const T ax = (1.0 - 2.0 * (q2 * q2 + q3 * q3)) * tx + 2.0 * (q1 * q2 - q0 * q3) * ty +
                 2.0 * (q1 * q3 + q0 * q2) * tz;
    const T ay = 2.0 * (q1 * q2 + q0 * q3) * tx + (1.0 - 2.0 * (q1 * q1 + q3 * q3)) * ty +
                 2.0 * (q2 * q3 - q0 * q1) * tz;
    const T az = 2.0 * (q1 * q3 - q0 * q2) * tx + 2.0 * (q2 * q3 + q0 * q1) * ty +
                 (1.0 - 2.0 * (q1 * q1 + q2 * q2)) * tz;
    xd[4] = ax / mass - G;
    xd[5] = ay / mass;
    xd[6] = az / mass;
    // 0.5 Omega(omega) q
    xd[7] = 0.5 * (-wx * q1 - wy * q2 - wz * q3);
    xd[8] = 0.5 * (wx * q0 + wz * q2 - wy * q3);
    xd[9] = 0.5 * (wy * q0 - wz * q1 + wx * q3);
    xd[10] = 0.5 * (wz * q0 + wy * q1 - wx * q2);
    // J^-1 (r_T x T - omega x (J omega))
    const T mx = RY * tz - RZ * ty;
    const T my = RZ * tx - RX * tz;
    const T mz = RX * ty - RY * tx;
    const T jx = JX * wx, jy = JY * wy, jz = JZ * wz;
    const T cx = wy * jz - wz * jy;
    const T cy = wz * jx - wx * jz;
    const T cz = wx * jy - wy * jx;
    xd[11] = (mx - cx) * INV_JX;
    xd[12] = (my - cy) * INV_JY;
    xd[13] = (mz - cz) * INV_JZ;
  }

  // a non-finite input, the mass below the dry mass, or a thrust whose
  // norm (and so its derivative) is not defined
  __device__ static bool guard(const double* x, const double* u) {
    bool bad = false;
#pragma unroll
    for (int i = 0; i < n; ++i) bad = bad || !isfinite(x[i]);
#pragma unroll
    for (int j = 0; j < m; ++j) bad = bad || !isfinite(u[j]);
    const double tn = sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    return bad || (x[0] < M_DRY) || (tn < THRUST_EPS);
  }
};

#ifdef __CUDACC__  // the kernels' dispatch (the structs above also build on the host)

// f(S{}) for the struct S of system_id (System.device_id):
// 0 = DoubleIntegrator, 1 = Quadrotor, 2 = Cartpole, 3 = Segway,
// 4 = Ballbot, 5 = PointMass, 6 = Rocket6DoF; cudaErrorInvalidValue for any
// other id. A system on the device is one struct above and one case here.
template <class F>
int with_system(int system_id, F&& f) {
  switch (system_id) {
    case 0: return f(DoubleIntegrator{});
    case 1: return f(Quadrotor{});
    case 2: return f(Cartpole{});
    case 3: return f(Segway{});
    case 4: return f(Ballbot{});
    case 5: return f(PointMass{});
    case 6: return f(Rocket6DoF{});
    default: return (int)cudaErrorInvalidValue;
  }
}

#endif  // __CUDACC__

}  // namespace
