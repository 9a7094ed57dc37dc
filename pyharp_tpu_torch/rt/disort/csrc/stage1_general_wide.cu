// K4 at N = 9..16 (nstr 18..32): general stage 1 of one azimuthal mode
// (phase moments).
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:427 (_stage1_kernel, the
// general branch :449-615) at the N that stage1_general.cu does not
// instantiate; the mode m enters as there (the tables of
// kernels.general_tables, lam0 and `mode`).  It computes, for every (layer,
// column) element, what stage1_general.cu computes, step for step and in
// the operation order of the plain version (solver.homogeneous_solution
// with kernels.kernel_sweeps(N) = 8 Jacobi sweeps in the JAX package's
// rotation formulas and cyclic (p, q) order, thermal_particular and the
// beam particular of _beam_from_q): the contracted phase tables, the
// Cholesky of Uhat, K = Lc^T Vhat Lc, the Jacobi eigensolve, the
// eigenvectors, then two N x N LUs (thermal) and one more (beam).  Built
// with --fmad=false, so it is bit-equal to stage1_general_plain.
//
// Bound on the H100: operations.  Per element it reads (4 + nmom)*4 bytes
// (+ 8 + 4*nstr with the beam) and writes (2N^2 + 7N)*4 (2,496 bytes at
// N = 16), against ~8 * 120 rotations * (6N + 30) ~ 1.2e5 flops of Jacobi
// alone at N = 16 plus three N x N LUs and the products (~N^3 each).
//
// Design: one body for every N = 9..16 (wide.cuh), one thread per element,
// loads and stores coalesced along L*B.  At N = 16 the element's packed
// Jacobi matrix (136 floats), Lc, the eigenvectors, V, U and S (256 each)
// cannot live in registers, and the rotation's (p, q) is a run-time index,
// so they live in the thread's local memory (its stack, cached in L1 and
// L2): the 960 rotations at N = 16 (8 sweeps of 120) stream the packed
// matrix and the eigenvectors through the caches.  This is the simple
// design; PERF.md records its time against the bound.  The Jacobi set in
// shared memory instead (laid out across the block, two blocks of 64
// threads per SM) took 1.2x as long on the aerosol shape at nstr 32.  A
// team of N lanes per element holding a row each is the lead for a faster
// one.  chip_smoke.py phase 1 prints registers, stack and spills.

#include "wide.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSym = kNMax * (kNMax + 1) / 2;

// Offsets into kernels.general_tables for n (G2 = 2n rows).
struct GenTab {
  int even, odd, lam, lam_signed, c2p, mu, w, sqw, sqm, sqmsqw;
  __device__ explicit GenTab(int n)
      : even(0), odd(2 * n * n * n), lam(odd + 2 * n * n * n),
        lam_signed(lam + 2 * n * n), c2p(lam_signed + 2 * n * n),
        mu(c2p + 2 * n), w(mu + n), sqw(w + n), sqm(sqw + n),
        sqmsqw(sqm + n) {}
};

__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// sum over l = l0, l0 + 2, ... <= lmax of g_l * tab[l][i][j], g_0 = 1,
// skipping the structural zeros, in l order; 0 with no term.
__device__ __forceinline__ float contract(const float* __restrict__ tab,
                                          const float* g, int n, int l0,
                                          int lmax, int i, int j) {
  float acc = 0.0f;
  bool first = true;
  for (int l = l0; l < 2 * n && l <= lmax; l += 2) {
    const float t = tab[(l * n + i) * n + j];
    if (t != 0.0f) {
      const float term = (l == 0) ? t : g[l] * t;
      acc = first ? term : acc + term;
      first = false;
    }
  }
  return acc;
}

// Index of (i, j) in a packed symmetric matrix (lower triangle, by rows).
__device__ __forceinline__ int sym(int i, int j) {
  return i >= j ? i * (i + 1) / 2 + j : j * (j + 1) / 2 + i;
}

// One Jacobi rotation zeroing A[p][q], as jacobi._rotate, on the packed A.
__device__ __forceinline__ void rotate(float* A, float (*V)[kNMax], int p,
                                       int q, int n) {
  const float apq = A[sym(p, q)];
  const float app = A[sym(p, p)];
  const float aqq = A[sym(q, q)];
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
  for (int r = 0; r < n; ++r) {
    if (r == p || r == q) continue;
    const float arp = A[sym(r, p)];
    const float arq = A[sym(r, q)];
    A[sym(r, p)] = c * arp - s * arq;
    A[sym(r, q)] = s * arp + c * arq;
  }
  A[sym(p, p)] = new_pp;
  A[sym(q, q)] = new_qq;
  A[sym(p, q)] = 0.0f;
  for (int r = 0; r < n; ++r) {
    const float vrp = V[r][p];
    const float vrq = V[r][q];
    V[r][p] = c * vrp - s * vrq;
    V[r][q] = s * vrp + c * vrq;
  }
}

__global__ void __launch_bounds__(kThreads)
stage1_general_wide_kernel(const float* __restrict__ ssa_in,
                           const float* __restrict__ pmom,
                           const float* __restrict__ dtau_in,
                           const float* __restrict__ btop_in,
                           const float* __restrict__ slope_in,
                           const float* __restrict__ fbeam_in,
                           const float* __restrict__ mur_in,
                           const float* __restrict__ lam0_in,
                           float* __restrict__ gp_out,
                           float* __restrict__ gm_out,
                           float* __restrict__ lam_out,
                           float* __restrict__ expd_out,
                           float* __restrict__ y0p_out,
                           float* __restrict__ y0m_out,
                           float* __restrict__ y1_out,
                           float* __restrict__ zp_out,
                           float* __restrict__ zm_out, int n, int nmom,
                           int sweeps, int mode, int thermal, int beam,
                           int64_t L, int64_t B,
                           const float* __restrict__ tab) {
  const int64_t lb = L * B;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= lb) return;
  const GenTab T(n);
  const int64_t layer = e / B;
  const int64_t b = e - layer * B;
  const int lmax = nmom < 2 * n - 1 ? nmom : 2 * n - 1;
  const int p0 = mode & 1;          // first row of the even parity of l - m
  const int p1 = 1 - p0;
  const float* even = tab + T.even;
  const float* odd = tab + T.odd;
  const float* mu = tab + T.mu;
  const float* w = tab + T.w;
  const float* sqw = tab + T.sqw;
  const float* sqm = tab + T.sqm;
  const float ssa = ssa_in[e];

  // the moments g_0 = 1, g_1..g_lmax (0 above lmax)
  float g[2 * kNMax];
  g[0] = 1.0f;
  for (int l = 1; l < 2 * n; ++l) {
    g[l] = l <= lmax ? pmom[(layer * nmom + (l - 1)) * B + b] : 0.0f;
  }

  // the Cholesky factor of Uhat (pivots floored at 1e-12), upper part zero
  float Lc[kNMax][kNMax];
  for (int j = 0; j < n; ++j) {
    float d;
    {
      const float se = contract(even, g, n, p0, lmax, j, j);
      d = (1.0f - ssa * ((sqw[j] * se) * sqw[j])) / (sqm[j] * sqm[j]);
    }
    for (int k = 0; k < j; ++k) d = d - Lc[j][k] * Lc[j][k];
    d = sqrtf(clamp_min_nan(d, 1e-12f));
    Lc[j][j] = d;
    const float inv = 1.0f / d;
    for (int i = j + 1; i < n; ++i) {
      const float se = contract(even, g, n, p0, lmax, i, j);
      float v = (0.0f - ssa * ((sqw[i] * se) * sqw[j])) / (sqm[i] * sqm[j]);
      for (int k = 0; k < j; ++k) v = v - Lc[i][k] * Lc[j][k];
      Lc[i][j] = v * inv;
    }
    for (int i = 0; i < j; ++i) Lc[i][j] = 0.0f;
  }

  // K = Lc^T (Vhat Lc), symmetrised, packed (lower triangle)
  float A[kSym];
  {
    float VL[kNMax][kNMax];
    for (int k = 0; k < n; ++k) {
      float vh[kNMax];
      for (int m = 0; m < n; ++m) {
        const float so = contract(odd, g, n, p1, lmax, k, m);
        vh[m] = ((k == m ? 1.0f : 0.0f) - ssa * ((sqw[k] * so) * sqw[m]))
                / (sqm[k] * sqm[m]);
      }
      for (int j = 0; j < n; ++j) {
        float acc = vh[j] * Lc[j][j];
        for (int m = j + 1; m < n; ++m) acc = acc + vh[m] * Lc[m][j];
        VL[k][j] = acc;
      }
    }
    float K[kNMax][kNMax];
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        float acc = Lc[i][i] * VL[i][j];
        for (int k = i + 1; k < n; ++k) acc = acc + Lc[k][i] * VL[k][j];
        K[i][j] = acc;
      }
    }
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j <= i; ++j) A[sym(i, j)] = 0.5f * (K[i][j] + K[j][i]);
    }
  }

  float Y[kNMax][kNMax];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) Y[i][j] = (i == j) ? 1.0f : 0.0f;
  }
  for (int it = 0; it < sweeps; ++it) {
    for (int p = 0; p < n - 1; ++p) {
      for (int q = p + 1; q < n; ++q) rotate(A, Y, p, q, n);
    }
  }
  float lam[kNMax];
  for (int k = 0; k < n; ++k) lam[k] = sqrtf(clamp_min_nan(A[sym(k, k)], 1e-12f));

  float D[kNMax][kNMax];
  for (int i = 0; i < n; ++i) {
    for (int k = 0; k < n; ++k) {
      float acc = Lc[i][0] * Y[0][k];
      for (int j = 1; j <= i; ++j) acc = acc + Lc[i][j] * Y[j][k];
      D[i][k] = acc / tab[T.sqmsqw + i];
    }
  }

  float Vf[kNMax][kNMax];
  for (int i = 0; i < n; ++i) {
    for (int j = 0; j < n; ++j) {
      Vf[i][j] = (i == j ? 1.0f : 0.0f)
                 - ssa * (contract(odd, g, n, p1, lmax, i, j) * w[j]);
    }
  }
  float Sg[kNMax][kNMax];
  const float dtau = dtau_in[e];
  for (int k = 0; k < n; ++k) {
    float gpk[kNMax];
    float gmk[kNMax];
    float mxp = 0.0f;
    float mxm = 0.0f;
    for (int i = 0; i < n; ++i) {
      float acc = Vf[i][0] * D[0][k];
      for (int j = 1; j < n; ++j) acc = acc + Vf[i][j] * D[j][k];
      const float s = -acc / (mu[i] * lam[k]);
      gpk[i] = 0.5f * (s + D[i][k]);
      gmk[i] = 0.5f * (s - D[i][k]);
      mxp = (i == 0) ? fabsf(gpk[0]) : nan_max(mxp, fabsf(gpk[i]));
      mxm = (i == 0) ? fabsf(gmk[0]) : nan_max(mxm, fabsf(gmk[i]));
    }
    const float scale = clamp_min_nan(nan_max(mxp, mxm), 1e-30f);
    for (int i = 0; i < n; ++i) {
      const float gpn = gpk[i] / scale;
      const float gmn = gmk[i] / scale;
      gp_out[static_cast<int64_t>(i * n + k) * lb + e] = gpn;
      gm_out[static_cast<int64_t>(i * n + k) * lb + e] = gmn;
      Sg[i][k] = gpn + gmn;
    }
    lam_out[k * lb + e] = lam[k];
    expd_out[k * lb + e] = expf(-lam[k] * dtau);
  }

  float Uf[kNMax][kNMax];
  if (thermal || beam) {
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) {
        Uf[i][j] = (i == j ? 1.0f : 0.0f)
                   - ssa * (contract(even, g, n, p0, lmax, i, j) * w[j]);
      }
    }
  }

  float M[kNMax][kNMax];
  if (thermal) {
    float rhs[kNMax];
    float h[kNMax];
    for (int i = 0; i < n; ++i) {
      for (int j = 0; j < n; ++j) M[i][j] = Uf[i][j];
      rhs[i] = (1.0f - ssa) * 1.0f;
    }
    lu_solve_rt(M, rhs, h, n);
    const float slope = slope_in[e];
    const float btop = btop_in[e];
    float y0d[kNMax];
    for (int i = 0; i < n; ++i) {
      const float y1 = slope * h[i];
      y1_out[i * lb + e] = y1;
      rhs[i] = (2.0f * mu[i]) * y1;
      for (int j = 0; j < n; ++j) M[i][j] = Vf[i][j];
    }
    lu_solve_rt(M, rhs, y0d, n);
    for (int i = 0; i < n; ++i) {
      y0p_out[i * lb + e] = btop * h[i] + 0.5f * y0d[i];
      y0m_out[i * lb + e] = btop * h[i] - 0.5f * y0d[i];
    }
  }

  if (beam) {
    // (2 - delta_m0) / 4 pi, rounded to float as the plain version's scale
    const float kappa = mode > 0
        ? static_cast<float>(2.0 / (4.0 * 3.141592653589793))
        : static_cast<float>(1.0 / (4.0 * 3.141592653589793));
    float accp[kNMax];
    float accm[kNMax];
    bool first[kNMax];
    for (int i = 0; i < n; ++i) {
      accp[i] = 0.0f;
      accm[i] = 0.0f;
      first[i] = true;
    }
    for (int l = 0; l < 2 * n && l <= lmax; ++l) {
      const float coef = (g[l] * tab[T.c2p + l]) * lam0_in[l * B + b];
      for (int i = 0; i < n; ++i) {
        const float t = tab[T.lam + l * n + i];
        if (t != 0.0f) {
          const float tp = coef * t;
          const float tm = coef * tab[T.lam_signed + l * n + i];
          accp[i] = first[i] ? tp : accp[i] + tp;
          accm[i] = first[i] ? tm : accm[i] + tm;
          first[i] = false;
        }
      }
    }
    const float amp = ssa * fbeam_in[b];
    const float mur = mur_in[e];
    float qs[kNMax];
    float rhs[kNMax];
    float qsmu[kNMax];
    for (int i = 0; i < n; ++i) {
      const float qp = (kappa * accp[i]) * amp;
      const float qm = (kappa * accm[i]) * amp;
      qs[i] = qp + qm;
      rhs[i] = qp - qm;
      qsmu[i] = qs[i] / mu[i];
    }
    for (int i = 0; i < n; ++i) {
      float acc = Vf[i][0] * qsmu[0];
      for (int j = 1; j < n; ++j) acc = acc + Vf[i][j] * qsmu[j];
      rhs[i] = acc / mu[i] - rhs[i] / (mu[i] * mur);
    }
    for (int i = 0; i < n; ++i) {
      for (int k = 0; k < n; ++k) M[i][k] = Sg[i][k];
    }
    float c[kNMax];
    lu_solve_rt(M, rhs, c, n);
    const float inv = 1.0f / (mur * mur);
    float scaled[kNMax];
    for (int k = 0; k < n; ++k) {
      const float lam2 = lam[k] * lam[k];
      float den = lam2 - inv;
      const float floor = 1e-4f * (lam2 + inv);
      den = fabsf(den) < floor ? (den < 0.0f ? -floor : floor) : den;
      scaled[k] = c[k] / den;
    }
    float zs[kNMax];
    for (int i = 0; i < n; ++i) {
      float acc = Sg[i][0] * scaled[0];
      for (int k = 1; k < n; ++k) acc = acc + Sg[i][k] * scaled[k];
      zs[i] = acc;
    }
    for (int i = 0; i < n; ++i) {
      float uz = Uf[i][0] * zs[0];
      for (int j = 1; j < n; ++j) uz = uz + Uf[i][j] * zs[j];
      const float zd = -mur * (uz - qs[i]) / mu[i];
      zp_out[i * lb + e] = 0.5f * (zs[i] + zd);
      zm_out[i * lb + e] = 0.5f * (zs[i] - zd);
    }
  }
}

}  // namespace

// As pyharp_stage1_general (stage1_general.cu), for n = 9..16.
PYHARP_API int pyharp_stage1_general_wide(
    int n, int thermal, int beam, const float* ssa, const float* pmom,
    const float* dtau, const float* btop, const float* slope,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* y0p, float* y0m, float* y1,
    float* zp, float* zm, int nmom, int sweeps, int mode, long long L,
    long long B, const float* tab, void* stream) {
  if (n < kWideMinN || n > kNMax) return PYHARP_UNSUPPORTED_N;
  const int64_t lb = static_cast<int64_t>(L) * B;
  if (lb == 0) return 0;
  const auto grid = static_cast<unsigned>((lb + kThreads - 1) / kThreads);
  stage1_general_wide_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      ssa, pmom, dtau, btop, slope, fbeam, mur, lam0, gp, gm, lam, expd, y0p,
      y0m, y1, zp, zm, n, nmom, sweeps, mode, thermal, beam, L, B, tab);
  return static_cast<int>(cudaGetLastError());
}
