// K4: general stage 1 of one azimuthal mode (phase moments).
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:427 (_stage1_kernel, the
// general branch :449-615), reached through fused_homogeneous_thermal
// (:618) when nmom > 0.  The mode m lives in the tables (the phase tables
// and Lam_l^m at the nodes, kernels.general_tables), in lam0 = Lam_l^m(mu0)
// and in the argument `mode`, which sets the parity of l - m that splits
// the phase tables (their nonzero rows start at l = m mod 2 and at the
// other parity) and the beam source's prefactor kappa = (2 - delta_m0) /
// 4 pi.  For m >= 1 Lam_l^m vanishes at l < m, so the zero table entries
// drop those moments; the radiance path runs one launch per mode.
//
// For every (layer, column) element, independently, in the operation order
// of its plain version (solver.homogeneous_solution with the kernel's sweep
// count, thermal_particular and the beam particular of _beam_from_q):
//  1. Se, So: the even/odd phase tables contracted with g_0 = 1 and the
//     layer's delta-M scaled moments g_1..g_nmom; the other parity's
//     entries are structural zeros and are skipped, as are l >= nstr;
//  2. Uhat, Vhat = M^-1/2 (I - ssa W^1/2 S W^1/2) M^-1/2, the Cholesky
//     Uhat = Lc Lc^T (pivots floored at 1e-12), K = Lc^T Vhat Lc;
//  3. cyclic Jacobi on K, the JAX package's rotation formulas and (p, q)
//     order, 3/4/8 sweeps for N <= 2/4/8, so the mode order is the plain
//     version's;
//  4. D = M^-1/2 W^-1/2 Lc Y, S = -(V D) / (mu lam), gp/gm = (S +- D)/2
//     normalised per mode, expd = exp(-lam dtau);
//  5. thermal: U h = (1 - ssa) 1, V y0d = 2 mu slope h by two pivoted LUs;
//  6. beam: q+- = kappa sum_l (2l+1) parity_l g_l Lam_l(+-mu_i) Lam_l(mu0), the
//     source expanded in S = gp + gm by one more LU, divided by the
//     resonance-clamped lam^2 - 1/mur^2 (floor 1e-4 (lam^2 + 1/mur^2)),
//     zd = -mur M^-1 (U zs - qs).
//
// Bound on the H100: operations.  Per element it reads (4 + nmom)*4 bytes
// (+ 8 + 4*nstr with the beam) and writes (2N^2 + 7N)*4 (760 bytes at
// N = 8), against ~28 * 8 * (6N + 30) ~ 5e4 flops of Jacobi alone at N = 8,
// plus the contraction (~N^2 nstr), the Cholesky, the products and three
// N x N LUs (~N^3 each) -- some 100 flops per byte, well above the f32
// ridge of ~20.  Built with --fmad=false, so each multiply-add issues as
// two instructions: the issue-rate floor is about twice the operation bound.
//
// Design: one thread per element, the live set cut to fit 128 registers,
// so an SM holds 16 warps (at 255 registers it would hold 8).  The time
// is latency: 224 rotations per element at N = 8, each a dependent chain
// of three divisions and two square roots, and long dependent sums around
// them, so it is set by how many elements an SM holds at once (this source
// at 3 and 2 blocks of 128 threads per SM ran 1.2x and 1.6x as long;
// PERF.md).
//  - The Jacobi matrix is kept packed (its lower triangle: 36 floats at
//    N = 8, not 64), exactly, since every rotation writes both halves
//    with the same value.
//  - Neither the moments nor Lc stay live across the sweeps: the moments
//    are loaded again and the Cholesky is recomputed, bit for bit.
// A team of N lanes per element (each lane one row, the rotation's scalars
// formed in every lane from shuffled entries) is bit-equal too but
// issue-bound: a warp issues the rotation's scalar chain for four elements
// instead of 32, and it took 3x as long at N = 8 (PERF.md).
// Every output element keeps the plain version's operation order (and
// --fmad=false), so the kernel is bit-equal to stage1_general_plain.
// chip_smoke.py phase 1 prints the registers and spills of every build.

#include "common.cuh"

namespace {

// Offsets into the static table buffer (kernels.general_tables), G2 = nstr
// rows of the phase expansion.
template <int N>
struct Tab {
  static constexpr int G2 = 2 * N;
  static constexpr int kEven = 0;                      // (G2, N, N)
  static constexpr int kOdd = kEven + G2 * N * N;      // (G2, N, N)
  static constexpr int kLam = kOdd + G2 * N * N;       // (G2, N) Lam_l(mu_i)
  static constexpr int kLamSigned = kLam + G2 * N;     // (G2, N) parity-signed
  static constexpr int kC2p = kLamSigned + G2 * N;     // (G2,) (2l+1) parity
  static constexpr int kMu = kC2p + G2;                // (N,) each below
  static constexpr int kW = kMu + N;
  static constexpr int kSqw = kW + N;
  static constexpr int kSqm = kSqw + N;
  static constexpr int kSqmSqw = kSqm + N;
};

constexpr int kThreads = 128;
// Resident blocks per SM the register allocation must allow: 4, so at most
// 128 registers a thread.
constexpr int kMinBlocks = 4;

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// sum over l = l0, l0 + 2, ... <= lmax (the rows of one parity of l - m) of
// g_l * tab[l][i][j], g_0 = 1, accumulated in l order; 0 with no term.
template <int N>
__device__ __forceinline__ float contract(const float* __restrict__ tab,
                                          const float (&g)[2 * N], int l0,
                                          int lmax, int i, int j) {
  float acc = 0.0f;
  bool first = true;
#pragma unroll
  for (int l = l0; l < 2 * N; l += 2) {
    if (l <= lmax) {
      const float t = tab[(l * N + i) * N + j];
      if (t != 0.0f) {
        const float term = (l == 0) ? t : g[l] * t;
        acc = first ? term : acc + term;
        first = false;
      }
    }
  }
  return acc;
}

// Index of (i, j) in a packed symmetric matrix (lower triangle, by rows).
__device__ __forceinline__ constexpr int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// A load the compiler cannot merge with an earlier one of the same address.
__device__ __forceinline__ float reload(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}

// One Jacobi rotation zeroing A[P][Q], as jacobi._rotate, on the packed A.
template <int N, int P, int Q>
__device__ __forceinline__ void rotate(float (&A)[N * (N + 1) / 2],
                                       float (&V)[N][N]) {
  const float apq = A[sym(P, Q)];
  const float app = A[sym(P, P)];
  const float aqq = A[sym(Q, Q)];
  const bool small = fabsf(apq) <= 1.17549435e-35f;   // float32 tiny * 1e3
  const float denom = small ? 1.0f : 2.0f * apq;
  const float tau = (aqq - app) / denom;
  const float root = sqrtf(1.0f + tau * tau);
  // torch.sign: -1, 0 or 1, NaN for NaN
  const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau * 0.0f);
  float t = sg / (fabsf(tau) + root);
  t = (sg == 0.0f) ? 1.0f / (tau + root) : t;
  t = small ? 0.0f : t;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  const float new_pp = c * c * app - 2.0f * s * c * apq + s * s * aqq;
  const float new_qq = s * s * app + 2.0f * s * c * apq + c * c * aqq;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    if (r == P || r == Q) continue;
    const float arp = A[sym(r, P)];
    const float arq = A[sym(r, Q)];
    A[sym(r, P)] = c * arp - s * arq;
    A[sym(r, Q)] = s * arp + c * arq;
  }
  A[sym(P, P)] = new_pp;
  A[sym(Q, Q)] = new_qq;
  A[sym(P, Q)] = 0.0f;
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const float vrp = V[r][P];
    const float vrq = V[r][Q];
    V[r][P] = c * vrp - s * vrq;
    V[r][Q] = s * vrp + c * vrq;
  }
}

// One cyclic sweep: (p, q) = (0, 1), (0, 2), ..., (N-2, N-1).
template <int N, int P = 0, int Q = 1>
__device__ __forceinline__ void sweep(float (&A)[N * (N + 1) / 2],
                                      float (&V)[N][N]) {
  if constexpr (P < N - 1) {
    rotate<N, P, Q>(A, V);
    if constexpr (Q + 1 < N) {
      sweep<N, P, Q + 1>(A, V);
    } else {
      sweep<N, P + 1, P + 2>(A, V);
    }
  }
}

// The moments g_0 = 1, g_1..g_lmax of one element (0 above lmax).
template <int N>
__device__ __forceinline__ void load_moments(const float* pmom, int64_t layer,
                                             int64_t b, int64_t B, int nmom,
                                             int lmax, float (&g)[2 * N]) {
  g[0] = 1.0f;
#pragma unroll
  for (int l = 1; l < 2 * N; ++l) {
    g[l] = l <= lmax ? reload(pmom + (layer * nmom + (l - 1)) * B + b) : 0.0f;
  }
}

// The Cholesky factor of Uhat (pivots floored at 1e-12), upper part zero.
template <int N>
__device__ __forceinline__ void cholesky_uhat(const float* tab,
                                              const float (&g)[2 * N],
                                              float ssa, int lmax, int p0,
                                              float (&Lc)[N][N]) {
  using T = Tab<N>;
  const float* even = tab + T::kEven;
  const float* sqw = tab + T::kSqw;
  const float* sqm = tab + T::kSqm;
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float d;
    {
      const float se = contract<N>(even, g, p0, lmax, j, j);
      d = (1.0f - ssa * ((sqw[j] * se) * sqw[j])) / (sqm[j] * sqm[j]);
    }
#pragma unroll
    for (int k = 0; k < j; ++k) d = d - Lc[j][k] * Lc[j][k];
    d = sqrtf(clamp_min_nan(d, 1e-12f));
    Lc[j][j] = d;
    const float inv = 1.0f / d;
#pragma unroll
    for (int i = j + 1; i < N; ++i) {
      const float se = contract<N>(even, g, p0, lmax, i, j);
      float v = (0.0f - ssa * ((sqw[i] * se) * sqw[j])) / (sqm[i] * sqm[j]);
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - Lc[i][k] * Lc[j][k];
      Lc[i][j] = v * inv;
    }
#pragma unroll
    for (int i = 0; i < j; ++i) Lc[i][j] = 0.0f;
  }
}

// P0 = m mod 2: the first row of the even parity of l - m in the phase
// tables (the odd parity starts at 1 - P0), a template parameter so that
// each mode's table offsets are constants.
template <int N, int P0>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage1_general_kernel(const float* __restrict__ ssa_in,
                      const float* __restrict__ pmom,
                      const float* __restrict__ dtau_in,
                      const float* __restrict__ btop_in,
                      const float* __restrict__ slope_in,
                      const float* __restrict__ fbeam_in,
                      const float* __restrict__ mur_in,
                      const float* __restrict__ lam0_in,
                      float* __restrict__ gp_out, float* __restrict__ gm_out,
                      float* __restrict__ lam_out, float* __restrict__ expd_out,
                      float* __restrict__ y0p_out, float* __restrict__ y0m_out,
                      float* __restrict__ y1_out, float* __restrict__ zp_out,
                      float* __restrict__ zm_out, int nmom, int sweeps,
                      int mode, int thermal, int beam, int64_t L,
                      int64_t B, const float* __restrict__ tab) {
  using T = Tab<N>;
  const int64_t lb = L * B;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= lb) return;
  const int64_t layer = e / B;
  const int64_t b = e - layer * B;
  const int lmax = nmom < 2 * N - 1 ? nmom : 2 * N - 1;
  constexpr int p0 = P0;
  constexpr int p1 = 1 - P0;
  const float* odd = tab + T::kOdd;
  const float* mu = tab + T::kMu;
  const float* w = tab + T::kW;
  const float* sqw = tab + T::kSqw;
  const float* sqm = tab + T::kSqm;
  const float ssa = ssa_in[e];

  // K = Lc^T (Vhat Lc), symmetrised, packed (lower triangle)
  float A[N * (N + 1) / 2];
  {
    float g[2 * N];
    load_moments<N>(pmom, layer, b, B, nmom, lmax, g);
    float Lc[N][N];
    cholesky_uhat<N>(tab, g, ssa, lmax, p0, Lc);
    float VL[N][N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      float vh[N];
#pragma unroll
      for (int m = 0; m < N; ++m) {
        const float so = contract<N>(odd, g, p1, lmax, k, m);
        vh[m] = ((k == m ? 1.0f : 0.0f) - ssa * ((sqw[k] * so) * sqw[m]))
                / (sqm[k] * sqm[m]);
      }
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = vh[j] * Lc[j][j];
#pragma unroll
        for (int m = j + 1; m < N; ++m) acc = acc + vh[m] * Lc[m][j];
        VL[k][j] = acc;
      }
    }
    float K[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float acc = Lc[i][i] * VL[i][j];
#pragma unroll
        for (int k = i + 1; k < N; ++k) acc = acc + Lc[k][i] * VL[k][j];
        K[i][j] = acc;
      }
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j <= i; ++j) A[sym(i, j)] = 0.5f * (K[i][j] + K[j][i]);
    }
  }

  float Y[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) Y[i][j] = (i == j) ? 1.0f : 0.0f;
  }
  if constexpr (N > 1) {
#pragma unroll 1
    for (int it = 0; it < sweeps; ++it) sweep<N>(A, Y);
  }
  float lam[N];
#pragma unroll
  for (int k = 0; k < N; ++k) lam[k] = sqrtf(clamp_min_nan(A[sym(k, k)], 1e-12f));

  // the moments and Lc again (reloaded, not kept live across the sweeps)
  float g[2 * N];
  load_moments<N>(pmom, layer, b, B, nmom, lmax, g);
  float D[N][N];
  {
    float Lc[N][N];
    cholesky_uhat<N>(tab, g, ssa, lmax, p0, Lc);
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float acc = Lc[i][0] * Y[0][k];
#pragma unroll
        for (int j = 1; j <= i; ++j) acc = acc + Lc[i][j] * Y[j][k];
        D[i][k] = acc / tab[T::kSqmSqw + i];
      }
    }
  }

  float Vf[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < N; ++j) {
      Vf[i][j] = (i == j ? 1.0f : 0.0f)
                 - ssa * (contract<N>(odd, g, p1, lmax, i, j) * w[j]);
    }
  }
  float Sg[N][N];
  const float dtau = dtau_in[e];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float gpk[N];
    float gmk[N];
    float mxp = 0.0f;
    float mxm = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = Vf[i][0] * D[0][k];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + Vf[i][j] * D[j][k];
      const float s = -acc / (mu[i] * lam[k]);
      gpk[i] = 0.5f * (s + D[i][k]);
      gmk[i] = 0.5f * (s - D[i][k]);
      mxp = (i == 0) ? fabsf(gpk[0]) : nan_max(mxp, fabsf(gpk[i]));
      mxm = (i == 0) ? fabsf(gmk[0]) : nan_max(mxm, fabsf(gmk[i]));
    }
    const float scale = clamp_min_nan(nan_max(mxp, mxm), 1e-30f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float gpn = gpk[i] / scale;
      const float gmn = gmk[i] / scale;
      gp_out[static_cast<int64_t>(i * N + k) * lb + e] = gpn;
      gm_out[static_cast<int64_t>(i * N + k) * lb + e] = gmn;
      Sg[i][k] = gpn + gmn;
    }
    lam_out[k * lb + e] = lam[k];
    expd_out[k * lb + e] = expf(-lam[k] * dtau);
  }

  float Uf[N][N];
  if (thermal || beam) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        Uf[i][j] = (i == j ? 1.0f : 0.0f)
                   - ssa * (contract<N>(tab + T::kEven, g, p0, lmax, i, j) * w[j]);
      }
    }
  }

  if (thermal) {
    float M[N][N];
    float rhs[N][1];
    float h[N][1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int j = 0; j < N; ++j) M[i][j] = Uf[i][j];
      rhs[i][0] = (1.0f - ssa) * 1.0f;
    }
    lu_solve<N, 1>(M, rhs, h);
    const float slope = slope_in[e];
    const float btop = btop_in[e];
    float y1[N];
    float y0d[N][1];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y1[i] = slope * h[i][0];
      rhs[i][0] = (2.0f * mu[i]) * y1[i];
#pragma unroll
      for (int j = 0; j < N; ++j) M[i][j] = Vf[i][j];
    }
    lu_solve<N, 1>(M, rhs, y0d);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      y1_out[i * lb + e] = y1[i];
      y0p_out[i * lb + e] = btop * h[i][0] + 0.5f * y0d[i][0];
      y0m_out[i * lb + e] = btop * h[i][0] - 0.5f * y0d[i][0];
    }
  }

  if (beam) {
    // (2 - delta_m0) / 4 pi, rounded to float as the plain version's scale
    const float kappa = mode > 0
        ? static_cast<float>(2.0 / (4.0 * 3.141592653589793))
        : static_cast<float>(1.0 / (4.0 * 3.141592653589793));
    float accp[N];
    float accm[N];
    bool first[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      accp[i] = 0.0f;
      accm[i] = 0.0f;
      first[i] = true;
    }
#pragma unroll
    for (int l = 0; l < 2 * N; ++l) {
      if (l <= lmax) {
        const float coef = (g[l] * tab[T::kC2p + l]) * lam0_in[l * B + b];
#pragma unroll
        for (int i = 0; i < N; ++i) {
          const float t = tab[T::kLam + l * N + i];
          if (t != 0.0f) {
            const float tp = coef * t;
            const float tm = coef * tab[T::kLamSigned + l * N + i];
            accp[i] = first[i] ? tp : accp[i] + tp;
            accm[i] = first[i] ? tm : accm[i] + tm;
            first[i] = false;
          }
        }
      }
    }
    const float amp = ssa * fbeam_in[b];
    const float mur = mur_in[e];
    float qs[N];
    float rhs[N][1];
    float qsmu[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float qp = (kappa * accp[i]) * amp;
      const float qm = (kappa * accm[i]) * amp;
      qs[i] = qp + qm;
      rhs[i][0] = qp - qm;
      qsmu[i] = qs[i] / mu[i];
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = Vf[i][0] * qsmu[0];
#pragma unroll
      for (int j = 1; j < N; ++j) acc = acc + Vf[i][j] * qsmu[j];
      rhs[i][0] = acc / mu[i] - rhs[i][0] / (mu[i] * mur);
    }
    float M[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) M[i][k] = Sg[i][k];
    }
    float c[N][1];
    lu_solve<N, 1>(M, rhs, c);
    const float inv = 1.0f / (mur * mur);
    float scaled[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float lam2 = lam[k] * lam[k];
      float den = lam2 - inv;
      const float floor = 1e-4f * (lam2 + inv);
      den = fabsf(den) < floor ? (den < 0.0f ? -floor : floor) : den;
      scaled[k] = c[k][0] / den;
    }
    float zs[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = Sg[i][0] * scaled[0];
#pragma unroll
      for (int k = 1; k < N; ++k) acc = acc + Sg[i][k] * scaled[k];
      zs[i] = acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float uz = Uf[i][0] * zs[0];
#pragma unroll
      for (int j = 1; j < N; ++j) uz = uz + Uf[i][j] * zs[j];
      const float zd = -mur * (uz - qs[i]) / mu[i];
      zp_out[i * lb + e] = 0.5f * (zs[i] + zd);
      zm_out[i * lb + e] = 0.5f * (zs[i] - zd);
    }
  }
}

template <int N>
int launch(int thermal, int beam, const float* ssa, const float* pmom,
           const float* dtau, const float* btop, const float* slope,
           const float* fbeam, const float* mur, const float* lam0, float* gp,
           float* gm, float* lam, float* expd, float* y0p, float* y0m,
           float* y1, float* zp, float* zm, int nmom, int sweeps, int mode,
           int64_t L, int64_t B, const float* tab, cudaStream_t stream) {
  const int64_t lb = L * B;
  if (lb == 0) return 0;
  const int64_t blocks = (lb + kThreads - 1) / kThreads;
  auto kernel = (mode & 1) ? stage1_general_kernel<N, 1>
                           : stage1_general_kernel<N, 0>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      ssa, pmom, dtau, btop, slope, fbeam, mur, lam0, gp, gm, lam, expd, y0p,
      y0m, y1, zp, zm, nmom, sweeps, mode, thermal, beam, L, B, tab);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: ssa, dtau, btop, slope, mur (L,B); pmom (L,nmom,B), delta-M
// scaled; fbeam (B); lam0 (G,B), Lam_l^m(mu0), rows l < nstr read; gp, gm
// (N,N,L,B); lam, expd, y0p, y0m, y1, zp, zm (N,L,B).  tab: the device
// buffer of kernels.general_tables for the mode m = `mode`, which also sets
// the parity split of the tables and the beam prefactor (1/(4 pi) at m = 0,
// 2/(4 pi) above).  With beam == 0, fbeam,
// mur, lam0, zp and zm are not touched (may be null); with thermal == 0,
// btop, slope, y0p, y0m and y1 are not touched (may be null): the thermal
// particular is zero and the wrapper returns it without a store.
PYHARP_API int pyharp_stage1_general(
    int n, int thermal, int beam, const float* ssa, const float* pmom,
    const float* dtau, const float* btop, const float* slope,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* y0p, float* y0m, float* y1,
    float* zp, float* zm, int nmom, int sweeps, int mode, long long L,
    long long B, const float* tab, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define PYHARP_CASE(NN)                                                       \
    case NN:                                                                  \
      return launch<NN>(thermal, beam, ssa, pmom, dtau, btop, slope,   \
                        fbeam, mur, lam0, gp, gm, lam, expd, y0p, y0m, y1,    \
                        zp, zm, nmom, sweeps, mode, L, B, tab, s);
    PYHARP_CASE(1)
    PYHARP_CASE(2)
    PYHARP_CASE(3)
    PYHARP_CASE(4)
    PYHARP_CASE(5)
    PYHARP_CASE(6)
    PYHARP_CASE(7)
    PYHARP_CASE(8)
#undef PYHARP_CASE
    default: return PYHARP_UNSUPPORTED_N;
  }
}

