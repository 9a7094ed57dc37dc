// K1: isotropic stage 1 of the m = 0 solve, thermal and beam variants.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:223 (_stage1_isotropic),
// reached through fused_homogeneous_thermal (:618) when nmom == 0 and
// m == 0: the thermal variant, and with fbeam/mur given the beam variant
// (:395-424), a second instantiation (BEAM) so the thermal-only launch
// keeps its cost.
//
// For every (layer, column) element, independently: the N eigenvalues of
// the isotropic secular equation
//     f(x) = 1 - ssa * sum_i c_i / (d_i - x),  d_i = 1/mu_i^2, c_i = w_i/mu_i^2
// one per pole bracket, by a fixed schedule of bisections on the sign of
// the division-free factored polynomial (10 for N <= 4, 12 above) and two
// safeguarded Newton steps that keep the last finite iterate (when ssa ~ 0
// the step lands exactly on a pole and f/f' turns NaN); then the closed-form
// factored eigenvectors gp/gm normalised per mode, expd = exp(-lam*dtau),
// and the closed-form thermal particular y1 = slope, y0+- = btop +- mu*slope.
// The beam variant adds the isotropic beam particular Z+-: only the l = 0
// moment scatters, so q+ = q- = ssa fbeam / (4 pi), V = I and
// U = I - ssa 1 w^T; the beam source is expanded in S = gp + gm by one
// N x N pivoted LU (lu_solve of common.cuh) and divided by the
// resonance-clamped lam^2 - 1/mur^2, lam^2 being the secular root x_k
// itself (clamped at 1e-12), with the float32 floor 1e-4 (lam^2 + 1/mur^2).
//
// Bound on the H100: expected near the f32 ridge.  Per element the thermal
// variant reads 16 bytes and writes (2N^2 + 5N)*4 bytes (208 at N = 4),
// against roughly N*(10*5N + 2*5N) flops plus N*(N + 2) exact divisions
// (~1000 operations at N = 4), with each bisection step depending on the
// one before; the beam variant reads 8 bytes more and writes 8N more, and
// adds an N x N LU (~N^3 flops).  The design gives each thread one element
// so loads and stores coalesce along B and keeps every intermediate in
// registers; the thermal variant writes each mode's eigenvector column as
// soon as it is normalised, so register use grows with N, not N^2, while
// the beam variant keeps S = gp + gm (N^2 floats) for its solve.
// Built with nvcc -O3 for sm_90a without --use_fast_math (the NaN test
// and exact division are part of the algorithm) and with --fmad=false, so
// every operation rounds as in the plain version: at ssa -> 1 the sign
// polynomial cancels to ~1e-6 of its terms and one contracted multiply-add
// would move the root by ~1e-4.
// ptxas (nvcc 12.9, sm_90a, -O3 --fmad=false), registers per thread of the
// thermal variant for N = 1/2/4/8: 24/32/60/120, no spills.  chip_smoke.py
// phase 1 prints the counts of every build, the beam variant's included.

#include "common.cuh"

namespace {

template <int N>
struct SecularTables {
  float d[N];      // 1/mu_i^2 in node order (mu ascending, so d descending)
  float c[N];      // w_i / mu_i^2
  float ds[N];     // the poles sorted ascending
  float cs[N];     // residues in sorted-pole order
  float lo[N];     // bracket k is (lo[k], hi[k]): (0, ds[0]), (ds[0], ds[1]), ...
  float hi[N];
  float invmu[N];  // 1/mu_i
  float mu[N];
  float w[N];      // quadrature weights (beam variant)
};

// sign(f(x)) > 0 on bracket k, from the factored polynomial
// P(x) = prod_j t_j + ssa sum_i cs_i prod_{j != i} t_j,  t_j = x - ds_j,
// which shares the sign of (-1)^(N-k) f on that bracket.
template <int N>
__device__ __forceinline__ bool secular_sign_pos(float x, float ssa, int k,
                                                 const SecularTables<N>& t) {
  float tt[N];
#pragma unroll
  for (int j = 0; j < N; ++j) tt[j] = x - t.ds[j];
  float pre[N + 1];
  float suf[N + 1];
  pre[1] = tt[0];
#pragma unroll
  for (int j = 1; j < N; ++j) pre[j + 1] = pre[j] * tt[j];
  suf[N - 1] = tt[N - 1];
#pragma unroll
  for (int j = N - 2; j >= 0; --j) suf[j] = tt[j] * suf[j + 1];
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float part;
    if (N == 1) {
      part = t.cs[0];
    } else if (i == 0) {
      part = t.cs[0] * suf[1];
    } else if (i == N - 1) {
      part = t.cs[i] * pre[i];
    } else {
      part = t.cs[i] * (pre[i] * suf[i + 1]);
    }
    acc = (i == 0) ? part : acc + part;
  }
  const float p = pre[N] + ssa * acc;
  const float sgn = ((N - k) % 2 == 0) ? 1.0f : -1.0f;
  return sgn * p > 0.0f;
}

// 2 kappa = 2 / (4 pi), rounded as the plain version rounds 2.0 * kappa
constexpr double kTwoKappa = 2.0 * (1.0 / (4.0 * 3.141592653589793));

template <int N, bool BEAM>
__global__ void __launch_bounds__(256)
stage1_isotropic_kernel(const float* __restrict__ ssa_in,
                        const float* __restrict__ dtau_in,
                        const float* __restrict__ btop_in,
                        const float* __restrict__ slope_in,
                        const float* __restrict__ fbeam_in,
                        const float* __restrict__ mur_in,
                        float* __restrict__ gp, float* __restrict__ gm,
                        float* __restrict__ lam, float* __restrict__ expd,
                        float* __restrict__ y0p, float* __restrict__ y0m,
                        float* __restrict__ y1, float* __restrict__ zp,
                        float* __restrict__ zm, int64_t lb, int64_t B,
                        const __grid_constant__ SecularTables<N> t) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= lb) return;
  constexpr int kBisect = N <= 4 ? 10 : 12;
  constexpr int kNewton = 2;
  const float ssa = ssa_in[e];

  float x[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float lo = t.lo[k];
    float hi = t.hi[k];
    for (int it = 0; it < kBisect; ++it) {
      const float m = 0.5f * (lo + hi);
      const bool pos = secular_sign_pos<N>(m, ssa, k, t);  // root above m
      lo = pos ? m : lo;
      hi = pos ? hi : m;
    }
    float xk = 0.5f * (lo + hi);
    for (int it = 0; it < kNewton; ++it) {
      float fs = 0.0f;
      float fps = 0.0f;
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float u = 1.0f / (xk - t.d[i]);
        const float cu = t.c[i] * u;
        fs = (i == 0) ? cu : fs + cu;
        fps = (i == 0) ? cu * u : fps + cu * u;
      }
      const float f = 1.0f + ssa * fs;
      const float fp = -ssa * fps;
      const float fp_safe = fp < -1e-30f ? fp : -1e-30f;
      float xn = xk - f / fp_safe;
      // clip as jnp.clip does: a NaN stays NaN and is rejected below
      xn = xn < lo ? lo : xn;
      xn = xn > hi ? hi : xn;
      xk = isfinite(xn) ? xn : xk;
    }
    x[k] = xk;
  }

  const float dtau = dtau_in[e];
  float S[BEAM ? N : 1][BEAM ? N : 1];  // gp + gm, normalised (beam only)
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float xc = fmaxf(x[k], 1e-12f);
    const float lamk = sqrtf(xc);
    const float invlam = rsqrtf(xc);
    float dk[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float prod = 1.0f;
      bool first = true;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        if (j == i) continue;
        const float tj = t.d[j] - x[k];
        prod = first ? tj : prod * tj;
        first = false;
      }
      dk[i] = t.invmu[i] * prod;
    }
    float gpk[N];
    float gmk[N];
    float mx = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float s = -dk[i] * t.invmu[i] * invlam;
      gpk[i] = 0.5f * (s + dk[i]);
      gmk[i] = 0.5f * (s - dk[i]);
      mx = (i == 0) ? fabsf(gpk[0]) : mx;
      mx = fmaxf(mx, fabsf(gpk[i]));
      mx = fmaxf(mx, fabsf(gmk[i]));
    }
    const float inv = 1.0f / fmaxf(mx, 1e-30f);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float gpn = gpk[i] * inv;
      const float gmn = gmk[i] * inv;
      gp[static_cast<int64_t>(i * N + k) * lb + e] = gpn;
      gm[static_cast<int64_t>(i * N + k) * lb + e] = gmn;
      if constexpr (BEAM) S[i][k] = gpn + gmn;
    }
    lam[k * lb + e] = lamk;
    expd[k * lb + e] = expf(-lamk * dtau);
  }

  const float slope = slope_in[e];
  const float btop = btop_in[e];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    y1[i * lb + e] = slope;
    y0p[i * lb + e] = btop + t.mu[i] * slope;
    y0m[i * lb + e] = btop - t.mu[i] * slope;
  }

  if constexpr (BEAM) {
    const float mur = mur_in[e];
    const float qs = static_cast<float>(kTwoKappa) * (ssa * fbeam_in[e % B]);
    float rhs[N][1];
    float cc[N][1];
#pragma unroll
    for (int i = 0; i < N; ++i) rhs[i][0] = qs * t.d[i];
    float Sc[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
      for (int k = 0; k < N; ++k) Sc[i][k] = S[i][k];
    }
    lu_solve<N, 1>(Sc, rhs, cc);
    const float inv_mur2 = 1.0f / (mur * mur);
    float scaled[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      const float lam2k = clamp_min_nan(x[k], 1e-12f);
      float den = lam2k - inv_mur2;
      const float floor = 1e-4f * (lam2k + inv_mur2);
      den = fabsf(den) < floor ? (den < 0.0f ? -floor : floor) : den;
      scaled[k] = cc[k][0] / den;
    }
    float zs[N];
    float wz = 0.0f;
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = S[i][0] * scaled[0];
#pragma unroll
      for (int k = 1; k < N; ++k) acc = acc + S[i][k] * scaled[k];
      zs[i] = acc;
      wz = (i == 0) ? t.w[0] * acc : wz + t.w[i] * acc;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float uz = zs[i] - ssa * wz;          // (I - ssa 1 w^T) zs
      const float zd = -mur * (uz - qs) * t.invmu[i];
      zp[i * lb + e] = 0.5f * (zs[i] + zd);
      zm[i * lb + e] = 0.5f * (zs[i] - zd);
    }
  }
}

template <int N>
int launch(int beam, const float* ssa, const float* dtau, const float* btop,
           const float* slope, const float* fbeam, const float* mur,
           float* gp, float* gm, float* lam, float* expd, float* y0p,
           float* y0m, float* y1, float* zp, float* zm, int64_t lb, int64_t B,
           const float* tables, cudaStream_t stream) {
  SecularTables<N> t;
  for (int i = 0; i < N; ++i) {
    t.d[i] = tables[0 * N + i];
    t.c[i] = tables[1 * N + i];
    t.ds[i] = tables[2 * N + i];
    t.cs[i] = tables[3 * N + i];
    t.lo[i] = tables[4 * N + i];
    t.hi[i] = tables[5 * N + i];
    t.invmu[i] = tables[6 * N + i];
    t.mu[i] = tables[7 * N + i];
    t.w[i] = tables[8 * N + i];
  }
  if (lb == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (lb + kThreads - 1) / kThreads;
  const auto grid = static_cast<unsigned>(blocks);
  if (beam) {
    stage1_isotropic_kernel<N, true><<<grid, kThreads, 0, stream>>>(
        ssa, dtau, btop, slope, fbeam, mur, gp, gm, lam, expd, y0p, y0m, y1,
        zp, zm, lb, B, t);
  } else {
    stage1_isotropic_kernel<N, false><<<grid, kThreads, 0, stream>>>(
        ssa, dtau, btop, slope, fbeam, mur, gp, gm, lam, expd, y0p, y0m, y1,
        zp, zm, lb, B, t);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// tables: host float32[9*n] = d, c, ds, cs, lo, hi, invmu, mu, w (each n
// long).  Shapes: ssa, dtau, btop, slope, mur (L,B); fbeam (B); gp, gm
// (N,N,L,B); lam, expd, y0p, y0m, y1, zp, zm (N,L,B); lb = L*B.  With
// beam == 0, fbeam, mur, zp and zm are not touched (may be null).
PYHARP_API int pyharp_stage1_isotropic(int n, int beam, const float* ssa,
                                       const float* dtau, const float* btop,
                                       const float* slope, const float* fbeam,
                                       const float* mur, float* gp, float* gm,
                                       float* lam, float* expd, float* y0p,
                                       float* y0m, float* y1, float* zp,
                                       float* zm, long long lb, long long B,
                                       const float* tables, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
#define PYHARP_CASE(NN)                                                      \
    case NN:                                                                 \
      return launch<NN>(beam, ssa, dtau, btop, slope, fbeam, mur, gp, gm,    \
                        lam, expd, y0p, y0m, y1, zp, zm, lb, B, tables, s);
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
