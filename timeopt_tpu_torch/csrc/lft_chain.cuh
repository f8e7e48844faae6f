// The LFT chain of the propagator select in float64, one definition for the
// generic select (lft_select_generic.cu) and the prefix scan (lft_scan.cu):
// the element of a step, its compose onto the prefix carry, and the size
// rule both kernels compile by. Each kernel keeps its own schedule (roles,
// rings, staging, stores, queries); since both run this code, the scan +
// query chain equals the generic select bit for bit by construction.
//
// Per step k, with p = n + 1 and eps = jitter (or the ladder's rung 2):
//   element  E = (sym(Q_aug,k) + eps I)^-1,  F = E A',  G = sym(A F + BRB)
//   compose  onto the carry (Ebar, Fbar, Gbar), k > 0, with
//            W = (sym(E_k + Gbar) + eps I)^-1 never formed for the products:
//            Ebar -= Fbar W Fbar',  Fbar = Fbar W F_k,  Gbar = G_k - F_k' W F_k
// Each is one warp: a pivot-free Gauss-Jordan sweep in registers
// (warpmat.cuh: lane j holds column j, CPL columns a lane), then the lanes
// of the right blocks form the products a column a lane. No elimination
// pivots, as in the plain versions and the JAX reference: Q_aug may be
// indefinite, and the result must be the same function. Each kernel keeps
// the arithmetic and the operation order of its first design (each
// division by the pivot, each M - col * row update, each inner sum in index
// order, each symmetrization with its operands in the same order), so its
// outputs equal that design's bit for bit; only the schedules differ. The
// additions that join two sums are __dadd_rn / __dsub_rn, since with
// compile-time sizes the compiler could otherwise fuse a one-term sum's
// product into them, which the first designs (run-time sizes) never did.
//
// The two kernels differ in four ways, each a template parameter:
// - BRB = B R^-1 B': a functor giving its column j. The generic select
//   forms it from B R^-1 and B (BRBFromFactors), the scan reads it as
//   staged (BRBStaged);
// - ZQ: the sweeps divide by warpmat::quot (the scan) or plainly (the
//   generic select); the same bits;
// - LADDER: the jitter ladder of ops/linalg.py::psd_inv (the scan). The
//   plain version keeps, per matrix, the rung-1 inverse unless it has a
//   non-finite entry, and then takes rung 2 (eps = 1e4 jitter). Here rung 2
//   is a recompute of that one sweep, taken exactly when a warp vote finds
//   a non-finite entry in the rung-1 inverse: E for the element, and for
//   the compose W itself, from p identity columns that join the sweep when
//   levels = 2. A Gauss-Jordan column's bits depend only on that column and
//   the pivot column, so these columns change no other column's bits. Rung
//   2 is written out rather than looped: a shuffle inside a loop whose exit
//   hangs on a vote is compiled for a diverged warp, at several
//   instructions each;
// - BY_ENTRY: the compose's three products a column a lane (the generic
//   select: with one column a lane the left block's lanes, idle after the
//   sweep, take G_k - F_k' (W F_k)) or entry by entry over all 32 lanes
//   from W Fbar' and W F_k staged in shared memory (the scan: a column a
//   lane took it 11-26% longer at the quadrotor's B = 1024, PERF.md
//   section 6). The same sums in the same order either way.
#pragma once

#include "warpmat.cuh"

namespace lft_chain {

using namespace warpmat;

constexpr int PMAX = 13;

// A compiled size: PM rows, CPL columns a lane, and p = PM known to the
// compiler (EXACT) or p <= PM at run time. Each function below takes p as
// EXACT ? PM : p_arg itself, so that p is a constant from the first: the
// compiler simplifies each function before it inlines it, and what it
// folds there depends on whether p is known.
template <int PM_, int CPL_, bool EXACT_>
struct Size {
  static constexpr int PM = PM_, CPL = CPL_;
  static constexpr bool EXACT = EXACT_;
};

// The size rule of the chain, f(Size<...>{}) for p in [2, PMAX] (the caller
// checks the range): p = 3 (double integrator), 5 (cart-pole, segway,
// ballbot, PointMass) and 13 (quadrotor) compile exactly, any other p at
// run time. One column a lane while the widest chain matrix, the compose's
// [. | Fbar' | F_k | I], fits a warp (4p <= 32), else two.
template <class F>
auto with_size(int p, F&& f) {
  if (p == 3) return f(Size<3, 1, true>{});
  if (p == 5) return f(Size<5, 1, true>{});
  if (p == 13) return f(Size<13, 2, true>{});
  return f(Size<PMAX, 2, false>{});
}

// Raw inputs of one step in the storage type Fp (double, or float on the
// float32 path, converted to double where they are read). B is B_aug
// (p x m) for the generic select, BRB (p x p) for the scan.
template <typename Fp, int PM, int NB>
struct Stage {
  Fp Q[PM * PM], A[PM * PM], B[NB];
};
template <int PM>
struct Mats {  // an element (E, F, G) or a prefix carry (Ebar, Fbar, Gbar)
  double E[PM * PM], F[PM * PM], G[PM * PM];
};

// Column j of B R^-1 B' added into b: B (p x m) staged, BR = B R^-1 formed
// at the element's head by the caller.
template <class Z, typename Fp>
struct BRBFromFactors {
  const Fp* B;
  const double* BR;
  int p_arg, m;
  __device__ __forceinline__ void operator()(double (&b)[Z::PM], int j) const {
    constexpr int PM = Z::PM;
    const int p = Z::EXACT ? PM : p_arg;
    for (int l = 0; l < m; ++l) {
      const double bj = B[j * m + l];
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) b[i] += BR[i * m + l] * bj;
    }
  }
};
// Column j of B R^-1 B' as staged (p x p, row-major).
template <class Z, typename Fp>
struct BRBStaged {
  const Fp* BRB;
  int p_arg;
  __device__ __forceinline__ void operator()(double (&b)[Z::PM], int j) const {
    constexpr int PM = Z::PM;
    const int p = Z::EXACT ? PM : p_arg;
#pragma unroll
    for (int i = 0; i < PM; ++i)
      if (i < p) b[i] = BRB[i * p + j];
  }
};

// True for the whole warp iff every entry of the columns [c0, c0 + p) held
// in registers is finite.
template <int PM, int CPL>
__device__ __forceinline__ bool cols_finite(const double (&M)[CPL][PM], int p, int c0, int lane) {
  bool bad = false;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= c0 && col < c0 + p) {
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p && !isfinite(M[s][i])) bad = true;
    }
  }
  return !__any_sync(FULL, bad);
}

// [sym(Q) + eps I | A' | I] into registers, lane = column (CPL a lane).
template <class Z, typename Fp, int NB>
__device__ __forceinline__ void fill_element(double (&M)[Z::CPL][Z::PM], const Stage<Fp, Z::PM, NB>& st, int p_arg,
                                             double eps, int lane) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      double x = 0.0;
      if (i < p && col < 3 * p) {
        if (col < p) x = 0.5 * ((double)st.Q[i * p + col] + (double)st.Q[col * p + i]) + (i == col ? eps : 0.0);
        else if (col < 2 * p) x = st.A[(col - p) * p + i];
        else x = (i == col - 2 * p) ? 1.0 : 0.0;
      }
      M[s][i] = x;
    }
  }
}

// Step k's element from its staged inputs into el:
// [sym(Q) + eps I | A' | I] -> [I | Q^-1 A' | Q^-1] = [I | F | E]; the lane
// of F's column j then forms column j of A F + BRB (G before its
// symmetrization).
template <class Z, bool ZQ, bool LADDER, typename Fp, int NB, class BRB>
__device__ __forceinline__ void element(const Stage<Fp, Z::PM, NB>& st, Mats<Z::PM>& el, int p_arg, int levels,
                                        double jitter, int lane, BRB brb) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
  double M[CPL][PM];
  fill_element<Z>(M, st, p, jitter, lane);
  gj_sweep<PM, CPL, ZQ>(M, p, lane);
  if constexpr (LADDER) {
    if (levels > 1 && !cols_finite<PM, CPL>(M, p, 2 * p, lane)) {
      fill_element<Z>(M, st, p, jitter * 1e4, lane);
      gj_sweep<PM, CPL, ZQ>(M, p, lane);
    }
  }
  __syncwarp();  // what brb reads (B R^-1)
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= p && col < 2 * p) {
      const int j = col - p;
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) el.F[i * p + j] = M[s][i];
      double g[PM], b[PM];
#pragma unroll
      for (int i = 0; i < PM; ++i) g[i] = b[i] = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l) {
        if (l < p) {
          const double f = M[s][l];
#pragma unroll
          for (int i = 0; i < PM; ++i)
            if (i < p) g[i] += st.A[i * p + l] * f;
        }
      }
      brb(b, j);
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) el.G[i * p + j] = __dadd_rn(g[i], b[i]);
    } else if (col >= 2 * p && col < 3 * p) {
      const int j = col - 2 * p;
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) el.E[i * p + j] = M[s][i];
    }
  }
  __syncwarp();
  sym_inplace(el.G, p, lane);
}

// [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I with the ladder at levels 2)]
// into registers, as fill_element.
template <class Z, bool LADDER>
__device__ __forceinline__ void fill_compose(double (&M)[Z::CPL][Z::PM], const Mats<Z::PM>& el, const Mats<Z::PM>& pc,
                                             int p_arg, int levels, double eps, int lane) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
  const int lc = LADDER && levels > 1 ? 4 * p : 3 * p;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
#pragma unroll
    for (int i = 0; i < PM; ++i) {
      double x = 0.0;
      if (i < p && col < lc) {
        if (col < p)
          x = 0.5 * ((el.E[i * p + col] + pc.G[i * p + col]) + (el.E[col * p + i] + pc.G[col * p + i])) +
              (i == col ? eps : 0.0);
        else if (col < 2 * p) x = pc.F[(col - p) * p + i];
        else if (!LADDER || col < 3 * p) x = el.F[i * p + (col - 2 * p)];
        else x = (i == col - 3 * p) ? 1.0 : 0.0;
      }
      M[s][i] = x;
    }
  }
}

// The three products of the compose from its swept [I | W Fbar' | W F_k]
// in M, a column a lane: Ebar - Fbar (W Fbar') -> nc.E,  Fbar (W F_k) ->
// nc.F,  G_k - F_k' (W F_k) -> nc.G.
template <class Z>
__device__ __forceinline__ void products_by_column(const double (&M)[Z::CPL][Z::PM], const Mats<Z::PM>& el,
                                                   const Mats<Z::PM>& pc, Mats<Z::PM>& nc, int p_arg, int lane) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
  // with one column a lane, lane j < p takes a copy of column j of W F_k
  double Y[PM];
  if constexpr (CPL == 1) {
    const int src = lane < p ? lane + 2 * p : lane;
#pragma unroll
    for (int l = 0; l < PM; ++l) Y[l] = __shfl_sync(FULL, M[0][l], src);
  }
  // Every sum runs over l in order; the loop over l is outside, so each l
  // feeds p independent sums.
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= p && col < 2 * p) {
      const int j = col - p;
      double a[PM];
#pragma unroll
      for (int i = 0; i < PM; ++i) a[i] = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l) {
        if (l < p) {
          const double x = M[s][l];
#pragma unroll
          for (int i = 0; i < PM; ++i)
            if (i < p) a[i] += pc.F[i * p + l] * x;
        }
      }
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) nc.E[i * p + j] = __dsub_rn(pc.E[i * p + j], a[i]);
    } else if (col >= 2 * p && col < 3 * p) {
      const int j = col - 2 * p;
      double f[PM], g[PM];
#pragma unroll
      for (int i = 0; i < PM; ++i) f[i] = g[i] = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l) {
        if (l < p) {
          const double x = M[s][l];
#pragma unroll
          for (int i = 0; i < PM; ++i) {
            if (i < p) {
              f[i] += pc.F[i * p + l] * x;
              if constexpr (CPL > 1) g[i] += el.F[l * p + i] * x;
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < PM; ++i) {
        if (i < p) {
          nc.F[i * p + j] = f[i];
          if constexpr (CPL > 1) nc.G[i * p + j] = __dsub_rn(el.G[i * p + j], g[i]);
        }
      }
    }
  }
  if constexpr (CPL == 1) {
    if (lane < p) {
      const int j = lane;
      double g[PM];
#pragma unroll
      for (int i = 0; i < PM; ++i) g[i] = 0.0;
#pragma unroll
      for (int l = 0; l < PM; ++l) {
        if (l < p) {
          const double y = Y[l];
#pragma unroll
          for (int i = 0; i < PM; ++i)
            if (i < p) g[i] += el.F[l * p + i] * y;
        }
      }
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) nc.G[i * p + j] = __dsub_rn(el.G[i * p + j], g[i]);
    }
  }
}

// The same products entry by entry over the lanes; nc.E and nc.G hold
// W Fbar' and W F_k until the products are formed.
template <class Z>
__device__ __forceinline__ void products_by_entry(const double (&M)[Z::CPL][Z::PM], const Mats<Z::PM>& el,
                                                  const Mats<Z::PM>& pc, Mats<Z::PM>& nc, int p_arg, int lane) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
#pragma unroll
  for (int s = 0; s < CPL; ++s) {
    const int col = lane + WARP * s;
    if (col >= p && col < 3 * p) {
      double* dst = col < 2 * p ? nc.E + (col - p) : nc.G + (col - 2 * p);
#pragma unroll
      for (int i = 0; i < PM; ++i)
        if (i < p) dst[i * p] = M[s][i];
    }
  }
  __syncwarp();
  // every sum over l in order (the loop over l outside); every read
  // before any write
  constexpr int NE = (PM * PM + WARP - 1) / WARP;
  int ii[NE], jj[NE];
  double ra[NE], rf[NE], rg[NE];
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t < p * p ? lane + WARP * t : 0;  // a lane past the end computes entry 0
    ii[t] = idx / p;
    jj[t] = idx - ii[t] * p;
    ra[t] = rf[t] = rg[t] = 0.0;
  }
  for (int l = 0; l < p; ++l) {
#pragma unroll
    for (int t = 0; t < NE; ++t) {
      const double fb = pc.F[ii[t] * p + l], wk = nc.G[l * p + jj[t]];
      ra[t] += fb * nc.E[l * p + jj[t]];
      rf[t] += fb * wk;
      rg[t] += el.F[l * p + ii[t]] * wk;
    }
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < NE; ++t) {
    const int idx = lane + WARP * t;
    if (idx < p * p) {
      nc.E[idx] = __dsub_rn(pc.E[idx], ra[t]);
      nc.F[idx] = rf[t];
      nc.G[idx] = __dsub_rn(el.G[idx], rg[t]);
    }
  }
}

// The carry nc = the carry pc composed with the element el (k > 0).
template <class Z, bool ZQ, bool LADDER, bool BY_ENTRY>
__device__ __forceinline__ void compose(const Mats<Z::PM>& el, const Mats<Z::PM>& pc, Mats<Z::PM>& nc, int p_arg,
                                        int levels, double jitter, int lane) {
  constexpr int PM = Z::PM, CPL = Z::CPL;
  const int p = Z::EXACT ? PM : p_arg;
  // [sym(E_k + Gbar) + eps I | Fbar' | F_k (| I)] -> [I | W Fbar' | W F_k (| W)]
  double M[CPL][PM];
  fill_compose<Z, LADDER>(M, el, pc, p, levels, jitter, lane);
  gj_sweep<PM, CPL, ZQ>(M, p, lane);
  if constexpr (LADDER) {
    if (levels > 1 && !cols_finite<PM, CPL>(M, p, 3 * p, lane)) {
      fill_compose<Z, LADDER>(M, el, pc, p, levels, jitter * 1e4, lane);
      gj_sweep<PM, CPL, ZQ>(M, p, lane);
    }
  }
  if constexpr (BY_ENTRY) products_by_entry<Z>(M, el, pc, nc, p, lane);
  else products_by_column<Z>(M, el, pc, nc, p, lane);
  __syncwarp();
  sym_inplace(nc.E, p, lane);
  sym_inplace(nc.G, p, lane);
}

}  // namespace lft_chain
