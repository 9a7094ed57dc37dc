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
// Design: a team of kTeam = 4 lanes per element (8 lanes ran slower,
// PERF.md), one body for every N = 9..16 (wide.cuh).  Lane t
// of a team owns rows s*kTeam + t (slots s < 16/kTeam) of every matrix.
//  - The sweeps: the full symmetric Jacobi matrix A lives in registers,
//    16/kTeam rows of 16 floats a lane, its diagonal in every lane, the
//    eigenvectors Y by rows in shared memory.  Every sweep is unrolled
//    over the 120 (p, q) pairs of N = 16 (team_sweep), each behind a test
//    of q < N that every lane takes alike, so every register index is a
//    constant; for N < 16 the order is the cyclic one without the skipped
//    pairs.  A rotation: the owner of row q shuffles its copy of a_pq,
//    every lane forms c, s and the new diagonal as jacobi._rotate does
//    and updates columns p and q of its other rows of A and of its rows of
//    Y by the plain formulas, and the owner of row q gathers its new row
//    from column q, a shuffle an entry.  Row p's copy is gathered once
//    after all the rotations of p, which do not read it.  Row r's copy of
//    A[r][p] and row p's copy of A[p][r] are one value, since the plain
//    version writes both halves with it.
//  - The rest runs row by row over the team, its matrices in shared
//    memory (two of 16 x 17 an element, the eigenvalues and a vector in
//    their 17th columns, the moments, a second vector: 596 floats, so
//    that three blocks of 128 threads fit an SM): the contractions, the
//    left-looking Cholesky (the owner of row j forms the pivot, every lane
//    its rows below it), VL = Vhat Lc and K = Lc^T VL, D = Lc Y, gp and gm
//    (each mode's scale a max over the team, exact in any order), Sg = gp
//    + gm, and the three N x N LUs, each column eliminated by rows over the
//    team (the bubble's swaps and the back substitution on its first
//    lane).
//  - At most 168 registers (kMinBlocks = 3): one rotation is a dependent
//    chain of three divisions and two square roots (~1,100 cycles on an
//    NVIDIA H100 80GB HBM3 at 700 W, PERF.md), so the sweeps are
//    latency-bound and the elements an SM holds set their time.
//  - Stores: a warp writes 32/kTeam consecutive elements of each output
//    plane, whole 32-byte sectors at kTeam = 4.
// The design that came before (one thread per element, its matrices in
// local memory) streamed every rotation through the caches and took 2.4x
// as long on the same card; PERF.md records both, the team sizes and the
// variants tried.
// chip_smoke.py phase 1 prints registers, stack and spills.

#include "wide.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTeam = 4;
constexpr int kRows = kNMax / kTeam;       // rows of each matrix a lane owns
constexpr int kElems = kThreads / kTeam;   // elements of a block
constexpr unsigned kFull = 0xffffffffu;
// An element's shared memory: two matrices of 16 rows at stride kLd (the
// eigenvalues in the first one's 17th column, a vector in the second's),
// the moments g_0..g_31 and a second vector of 16.
constexpr int kLd = kNMax + 1;
constexpr int kMat = kNMax * kLd;
constexpr int kOffG = 2 * kMat;
constexpr int kOffVb = kOffG + 2 * kNMax;
constexpr int kUsed = kOffVb + kNMax;
// the element stride, 4 times an odd number (mod 32): the 8 elements of
// a warp, 4 rows each at stride kLd, meet 32 distinct banks (596 floats:
// three blocks fit an SM's 228 KB)
constexpr int kStride = kUsed + 4;
static_assert(kStride % 8 == 4, "4 times an odd number of floats");
constexpr int kSmemBytes = kElems * kStride * static_cast<int>(sizeof(float));
// blocks an SM must hold: 3 (168 registers a thread)
constexpr int kMinBlocks = 3;
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

// sum over l = ls, ls + 2, ... <= lmax of g_l * tab[l][i][j], g_0 = 1, in
// l order, 0 with no term: ls = m for the even table, m + 1 for the odd
// one (the table is zero below l = m).  The plain version skips each zero
// entry; adding g_l * 0 instead changes at most the sign of a zero sum
// (finite moments), which no use can see: every contraction enters as
// c - ssa x w with c = 0 or 1.
__device__ __forceinline__ float contract(const float* __restrict__ tab,
                                          const float* g, int n, int ls,
                                          int lmax, int i, int j) {
  const int lend = lmax < 2 * n - 1 ? lmax : 2 * n - 1;
  if (ls > lend) return 0.0f;
  const float t0 = __ldg(tab + (ls * n + i) * n + j);
  float acc = (ls == 0) ? t0 : g[ls] * t0;
#pragma unroll 4
  for (int l = ls + 2; l <= lend; l += 2) {
    acc = acc + g[l] * __ldg(tab + (l * n + i) * n + j);
  }
  return acc;
}

// lu_solve_rt of wide.cuh on a matrix in shared memory (row stride kLd)
// over the team, the solution written over b: the bubble's row swaps and
// the back substitution on the team's first lane, each column's
// elimination by rows (row r on lane r % kTeam).  Every lane calls it.
// b is read at stride BS.
template <int BS>
__device__ void lu_solve_team(float* A, float* bv, int n, int t) {
  auto b = [&](int r) -> float& { return bv[r * BS]; };
  for (int col = 0; col < n; ++col) {
    if (t == 0) {
      for (int r = col + 1; r < n; ++r) {
        if (fabsf(A[r * kLd + col]) > fabsf(A[col * kLd + col])) {
          for (int j = col; j < n; ++j) {
            const float x = A[r * kLd + j];
            A[r * kLd + j] = A[col * kLd + j];
            A[col * kLd + j] = x;
          }
          const float x = b(r);
          b(r) = b(col);
          b(col) = x;
        }
      }
    }
    __syncwarp();
    const float inv = 1.0f / A[col * kLd + col];
    const int first = col + 1 + (t - (col + 1) % kTeam + kTeam) % kTeam;
    for (int r = first; r < n; r += kTeam) {
      const float f = A[r * kLd + col] * inv;
      for (int j = col + 1; j < n; ++j) {
        A[r * kLd + j] = A[r * kLd + j] - f * A[col * kLd + j];
      }
      b(r) = b(r) - f * b(col);
    }
    __syncwarp();
  }
  if (t == 0) {
    for (int row = n - 1; row >= 0; --row) {
      float acc = b(row);
      for (int c = row + 1; c < n; ++c) acc = acc - A[row * kLd + c] * b(c);
      b(row) = acc / A[row * kLd + row];
    }
  }
  __syncwarp();
}

using Rows = float[kRows][kNMax];

// c, s and the new diagonal of jacobi._rotate zeroing a_pq.
__device__ __forceinline__ void rotation(float app, float apq, float aqq,
                                         float& c, float& s, float& new_pp,
                                         float& new_qq) {
  const bool small = fabsf(apq) <= 1.17549435e-35f;   // float32 tiny * 1e3
  const float denom = small ? 1.0f : 2.0f * apq;
  const float tau = (aqq - app) / denom;
  const float root = sqrtf(1.0f + tau * tau);
  // torch.sign: -1, 0 or 1, NaN for NaN; where it is 0, tau is +-0 and the
  // plain version's 1 / (tau + root) is 1 / 1
  const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau * 0.0f);
  float tr = sg / (fabsf(tau) + root);
  tr = (sg == 0.0f) ? 1.0f : tr;
  tr = small ? 0.0f : tr;
  c = 1.0f / sqrtf(1.0f + tr * tr);
  s = tr * c;
  new_pp = c * c * app - 2.0f * s * c * apq + s * s * aqq;
  new_qq = s * s * app + 2.0f * s * c * apq + c * c * aqq;
}

// One rotation zeroing A[P][Q], as jacobi._rotate, on the team: lane t
// holds rows s*kTeam + t of A in A[s] and of Y in shared memory (Ys, row
// stride kLd); every lane holds the diagonal of A in diag, the rows'
// copies of it are not kept.  Row P's copy is not kept during the
// rotations of P either (none of them reads it): team_row_refresh gathers
// it after them.
template <int P, int Q>
__device__ __forceinline__ void team_rotate(Rows& A, float* Ys,
                                            float (&diag)[kNMax], int t) {
  constexpr int op = P % kTeam, sp = P / kTeam;   // owner and slot of row P
  constexpr int oq = Q % kTeam, sq = Q / kTeam;
  const bool isp = t == op;
  const bool isq = t == oq;
  // a_pq from row Q's copy, current since the last update of column P
  const float apq = __shfl_sync(kFull, A[sq][P], oq, kTeam);
  float c, s, new_pp, new_qq;
  rotation(diag[P], apq, diag[Q], c, s, new_pp, new_qq);
  // columns P and Q of the lane's rows other than P and Q, and of Y
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const bool own = (k == sp && isp) || (k == sq && isq);
    const float arp = A[k][P];
    const float arq = A[k][Q];
    const float nrp = c * arp - s * arq;
    const float nrq = s * arp + c * arq;
    A[k][P] = own ? arp : nrp;
    A[k][Q] = own ? arq : nrq;
    float* y = Ys + (k * kTeam + t) * kLd;
    const float vrp = y[P];
    const float vrq = y[Q];
    y[P] = c * vrp - s * vrq;
    y[Q] = s * vrp + c * vrq;
  }
  // row Q: A[Q][r] = A[r][Q] from r's owner
#pragma unroll
  for (int r = 0; r < kNMax; ++r) {
    if (r == P || r == Q) continue;
    const float rq = __shfl_sync(kFull, A[r / kTeam][Q], r % kTeam, kTeam);
    A[sq][r] = isq ? rq : A[sq][r];
  }
  diag[P] = new_pp;
  diag[Q] = new_qq;
  A[sq][P] = isq ? 0.0f : A[sq][P];
}

// Row P's copy after the rotations of P: A[P][r] = A[r][P] from r's owner.
template <int P>
__device__ __forceinline__ void team_row_refresh(Rows& A, int t) {
  constexpr int op = P % kTeam, sp = P / kTeam;
  const bool isp = t == op;
#pragma unroll
  for (int r = 0; r < kNMax; ++r) {
    if (r == P) continue;
    const float rp = __shfl_sync(kFull, A[r / kTeam][P], r % kTeam, kTeam);
    A[sp][r] = isp ? rp : A[sp][r];
  }
}

// The rotations (P, Q), (P, Q + 1), ... of one cyclic sweep, those with
// Q >= n skipped: the cyclic order of n.
template <int P, int Q>
__device__ __forceinline__ void team_sweep(Rows& A, float* Ys,
                                           float (&diag)[kNMax], int t,
                                           int n) {
  if constexpr (P < kNMax - 1) {
    if (Q < n) team_rotate<P, Q>(A, Ys, diag, t);
    if constexpr (Q + 1 < kNMax) {
      team_sweep<P, Q + 1>(A, Ys, diag, t, n);
    } else {
      if (P + 1 < n) team_row_refresh<P>(A, t);
      team_sweep<P + 1, P + 2>(A, Ys, diag, t, n);
    }
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
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
  extern __shared__ __align__(16) float smem[];
  const int64_t lb = L * B;
  const int t = static_cast<int>(threadIdx.x) % kTeam;
  const int el = static_cast<int>(threadIdx.x) / kTeam;
  const int64_t e = static_cast<int64_t>(blockIdx.x) * kElems + el;
  // a team past the end computes the last element and stores nothing, so
  // that every lane of the warp takes part in the shuffles
  const bool store = e < lb;
  const int64_t ec = store ? e : lb - 1;
  const int64_t layer = ec / B;
  const int64_t b = ec - layer * B;
  float* Lm = smem + el * kStride;     // Lc, then D, then copies to factor
  float* Wm = Lm + kMat;               // VL, K, Y, Sg, then Vf
  float* gs = Lm + kOffG;
  float* lams = Lm + kNMax;            // the eigenvalues, stride kLd
  float* va = Wm + kNMax;              // a vector, stride kLd
  float* vb = Lm + kOffVb;
  const GenTab T(n);
  const int lmax = nmom < 2 * n - 1 ? nmom : 2 * n - 1;
  const int p0 = mode;              // first nonzero rows: l = m (even l - m)
  const int p1 = mode + 1;          // and l = m + 1 (odd)
  const float* even = tab + T.even;
  const float* odd = tab + T.odd;
  const float* mu = tab + T.mu;
  const float* w = tab + T.w;
  const float* sqw = tab + T.sqw;
  const float* sqm = tab + T.sqm;
  const float ssa = ssa_in[ec];

  // the moments g_0 = 1, g_1..g_lmax (0 above lmax)
  for (int l = t; l < 2 * kNMax; l += kTeam) {
    gs[l] = l == 0 ? 1.0f
          : (l < 2 * n && l <= lmax ? pmom[(layer * nmom + (l - 1)) * B + b]
                                    : 0.0f);
  }
  __syncwarp();

  // the Cholesky factor of Uhat (pivots floored at 1e-12), left-looking:
  // the owner of row j forms the pivot, then every lane its rows below
  for (int j = 0; j < n; ++j) {
    if (t == j % kTeam) {
      const float se = contract(even, gs, n, p0, lmax, j, j);
      float d = (1.0f - ssa * ((sqw[j] * se) * sqw[j])) / (sqm[j] * sqm[j]);
      for (int k = 0; k < j; ++k) d = d - Lm[j * kLd + k] * Lm[j * kLd + k];
      Lm[j * kLd + j] = sqrtf(clamp_min_nan(d, 1e-12f));
    }
    __syncwarp();
    const float inv = 1.0f / Lm[j * kLd + j];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i > j && i < n) {
        const float se = contract(even, gs, n, p0, lmax, i, j);
        float v = (0.0f - ssa * ((sqw[i] * se) * sqw[j])) / (sqm[i] * sqm[j]);
        for (int k = 0; k < j; ++k) v = v - Lm[i * kLd + k] * Lm[j * kLd + k];
        Lm[i * kLd + j] = v * inv;
      }
    }
  }
  __syncwarp();

  // VL = Vhat Lc by rows into W
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int k = s * kTeam + t;
    if (k < n) {
      float vh[kNMax];
#pragma unroll
      for (int m = 0; m < kNMax; ++m) {
        if (m < n) {
          const float so = contract(odd, gs, n, p1, lmax, k, m);
          vh[m] = ((k == m ? 1.0f : 0.0f) - ssa * ((sqw[k] * so) * sqw[m]))
                  / (sqm[k] * sqm[m]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNMax; ++j) {
        if (j < n) {
          float acc = vh[j] * Lm[j * kLd + j];
#pragma unroll
          for (int m = j + 1; m < kNMax; ++m) {
            if (m < n) acc = acc + vh[m] * Lm[m * kLd + j];
          }
          Wm[k * kLd + j] = acc;
        }
      }
    }
  }
  __syncwarp();

  // K = Lc^T VL by rows into A's registers, then over VL; the Jacobi
  // matrix (K + K^T) / 2 in full rows (zero outside n x n), its diagonal
  // in every lane, then Y = I over K in W
  float A[kRows][kNMax];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) {
      float acc = 0.0f;
      if (i < n && j < n) {
        acc = Lm[i * kLd + i] * Wm[i * kLd + j];
        for (int k = i + 1; k < n; ++k) acc = acc + Lm[k * kLd + i] * Wm[k * kLd + j];
      }
      A[s][j] = acc;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) {
      if (i < n && j < n) Wm[i * kLd + j] = A[s][j];
    }
  }
  __syncwarp();
  float diag[kNMax];
#pragma unroll
  for (int j = 0; j < kNMax; ++j) {
    diag[j] = j < n ? 0.5f * (Wm[j * kLd + j] + Wm[j * kLd + j]) : 0.0f;
  }
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) {
      A[s][j] = (i < n && j < n) ? 0.5f * (A[s][j] + Wm[j * kLd + i]) : 0.0f;
    }
  }
  __syncwarp();
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) Wm[i * kLd + j] = i == j ? 1.0f : 0.0f;
  }
  __syncwarp();

  for (int it = 0; it < sweeps; ++it) team_sweep<0, 1>(A, Wm, diag, t, n);

  // the eigenvalues; Y is in W
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
    float dg = 0.0f;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) dg = (j == i) ? diag[j] : dg;
    if (i < n) lams[i * kLd] = sqrtf(clamp_min_nan(dg, 1e-12f));
  }
  __syncwarp();

  // D = Lc Y / sqrt(mu w) by rows, each over its row of Lc
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
    if (i < n) {
      float d[kNMax];
      const float den = tab[T.sqmsqw + i];
#pragma unroll
      for (int k = 0; k < kNMax; ++k) {
        float acc = Lm[i * kLd] * Wm[k];
        for (int j = 1; j <= i; ++j) acc = acc + Lm[i * kLd + j] * Wm[j * kLd + k];
        d[k] = acc / den;
      }
#pragma unroll
      for (int k = 0; k < kNMax; ++k) {
        if (k < n) Lm[i * kLd + k] = d[k];
      }
    }
  }
  __syncwarp();

  // Vf by rows (registers); S = -(Vf D) / (mu lam), gp and gm normalised
  // per mode, Sg = gp + gm into W
  float vf[kRows][kNMax];
#pragma unroll
  for (int s = 0; s < kRows; ++s) {
    const int i = s * kTeam + t;
#pragma unroll
    for (int j = 0; j < kNMax; ++j) {
      vf[s][j] = 0.0f;
      if (i < n && j < n) {
        vf[s][j] = (i == j ? 1.0f : 0.0f)
                   - ssa * (contract(odd, gs, n, p1, lmax, i, j) * w[j]);
      }
    }
  }
  const float dtau = dtau_in[ec];
  for (int k = 0; k < n; ++k) {
    const float lk = lams[k * kLd];
    float gpk[kRows];
    float gmk[kRows];
    float mx = -1.0f;
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      gpk[s] = 0.0f;
      gmk[s] = 0.0f;
      if (i < n) {
        float acc = vf[s][0] * Lm[k];
#pragma unroll
        for (int j = 1; j < kNMax; ++j) {
          if (j < n) acc = acc + vf[s][j] * Lm[j * kLd + k];
        }
        const float sv = -acc / (mu[i] * lk);
        const float dik = Lm[i * kLd + k];
        gpk[s] = 0.5f * (sv + dik);
        gmk[s] = 0.5f * (sv - dik);
        mx = nan_max(nan_max(mx, fabsf(gpk[s])), fabsf(gmk[s]));
      }
    }
#pragma unroll
    for (int off = kTeam / 2; off > 0; off /= 2) {
      mx = nan_max(mx, __shfl_xor_sync(kFull, mx, off, kTeam));
    }
    const float scale = clamp_min_nan(mx, 1e-30f);
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) {
        const float gpn = gpk[s] / scale;
        const float gmn = gmk[s] / scale;
        if (store) {
          gp_out[static_cast<int64_t>(i * n + k) * lb + e] = gpn;
          gm_out[static_cast<int64_t>(i * n + k) * lb + e] = gmn;
        }
        Wm[i * kLd + k] = gpn + gmn;
      }
    }
    if (store && t == k % kTeam) {
      lam_out[k * lb + e] = lk;
      expd_out[k * lb + e] = expf(-lk * dtau);
    }
  }
  __syncwarp();

  // Uf[i][j] = (i == j) - ssa Se[i][j] w_j, formed where it is used
  auto uf = [&](int i, int j) {
    return (i == j ? 1.0f : 0.0f)
           - ssa * (contract(even, gs, n, p0, lmax, i, j) * w[j]);
  };

  if (beam) {
    // (2 - delta_m0) / 4 pi, rounded to float as the plain version's scale
    const float kappa = mode > 0
        ? static_cast<float>(2.0 / (4.0 * 3.141592653589793))
        : static_cast<float>(1.0 / (4.0 * 3.141592653589793));
    const float amp = ssa * fbeam_in[b];
    const float mur = mur_in[ec];
    // q+- of the lane's rows, each summed in l order
    float accp[kRows];
    float accm[kRows];
    bool first[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      accp[s] = 0.0f;
      accm[s] = 0.0f;
      first[s] = true;
    }
    for (int l = 0; l < 2 * n && l <= lmax; ++l) {
      const float coef = (gs[l] * tab[T.c2p + l]) * lam0_in[l * B + b];
#pragma unroll
      for (int s = 0; s < kRows; ++s) {
        const int i = s * kTeam + t;
        const float tl = i < n ? tab[T.lam + l * n + i] : 0.0f;
        if (tl != 0.0f) {
          const float tp = coef * tl;
          const float tm = coef * tab[T.lam_signed + l * n + i];
          accp[s] = first[s] ? tp : accp[s] + tp;
          accm[s] = first[s] ? tm : accm[s] + tm;
          first[s] = false;
        }
      }
    }
    float qs[kRows];
    float qd[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      const float qp = (kappa * accp[s]) * amp;
      const float qm = (kappa * accm[s]) * amp;
      qs[s] = qp + qm;
      qd[s] = qp - qm;
      if (i < n) va[i * kLd] = qs[s] / mu[i];
    }
    __syncwarp();
    // the right-hand side M^-1 V qs / mu - (q+ - q-) / (mu mur) into vb,
    // a copy of Sg into L for the LU
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) {
        float acc = vf[s][0] * va[0 * kLd];
#pragma unroll
        for (int j = 1; j < kNMax; ++j) {
          if (j < n) acc = acc + vf[s][j] * va[j * kLd];
        }
        vb[i] = acc / mu[i] - qd[s] / (mu[i] * mur);
        for (int k = 0; k < n; ++k) Lm[i * kLd + k] = Wm[i * kLd + k];
      }
    }
    __syncwarp();
    lu_solve_team<1>(Lm, vb, n, t);
    __syncwarp();
    const float inv = 1.0f / (mur * mur);
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int k = s * kTeam + t;
      if (k < n) {
        const float lam2 = lams[k * kLd] * lams[k * kLd];
        float den = lam2 - inv;
        const float floor = 1e-4f * (lam2 + inv);
        den = fabsf(den) < floor ? (den < 0.0f ? -floor : floor) : den;
        va[k * kLd] = vb[k] / den;
      }
    }
    __syncwarp();
    float zs[kRows];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      zs[s] = 0.0f;
      if (i < n) {
        float acc = Wm[i * kLd] * va[0 * kLd];
        for (int k = 1; k < n; ++k) acc = acc + Wm[i * kLd + k] * va[k * kLd];
        zs[s] = acc;
      }
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) vb[i] = zs[s];
    }
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) {
        float uz = uf(i, 0) * vb[0];
        for (int j = 1; j < n; ++j) uz = uz + uf(i, j) * vb[j];
        const float zd = -mur * (uz - qs[s]) / mu[i];
        if (store) {
          zp_out[i * lb + e] = 0.5f * (zs[s] + zd);
          zm_out[i * lb + e] = 0.5f * (zs[s] - zd);
        }
      }
    }
    __syncwarp();
  }

  if (thermal) {
    // U h = (1 - ssa) 1 with Uf in L, then V y0d = 2 mu slope h with Vf
    // in W
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) {
        for (int j = 0; j < n; ++j) Lm[i * kLd + j] = uf(i, j);
#pragma unroll
        for (int j = 0; j < kNMax; ++j) {
          if (j < n) Wm[i * kLd + j] = vf[s][j];
        }
        va[i * kLd] = (1.0f - ssa) * 1.0f;
      }
    }
    __syncwarp();
    lu_solve_team<kLd>(Lm, va, n, t);
    __syncwarp();
    const float slope = slope_in[ec];
    const float btop = btop_in[ec];
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n) {
        const float y1 = slope * va[i * kLd];
        if (store) y1_out[i * lb + e] = y1;
        vb[i] = (2.0f * mu[i]) * y1;
      }
    }
    __syncwarp();
    lu_solve_team<1>(Wm, vb, n, t);
    __syncwarp();
#pragma unroll
    for (int s = 0; s < kRows; ++s) {
      const int i = s * kTeam + t;
      if (i < n && store) {
        y0p_out[i * lb + e] = btop * va[i * kLd] + 0.5f * vb[i];
        y0m_out[i * lb + e] = btop * va[i * kLd] - 0.5f * vb[i];
      }
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
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      stage1_general_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grid = static_cast<unsigned>((lb + kElems - 1) / kElems);
  stage1_general_wide_kernel<<<grid, kThreads, kSmemBytes,
                               static_cast<cudaStream_t>(stream)>>>(
      ssa, pmom, dtau, btop, slope, fbeam, mur, lam0, gp, gm, lam, expd, y0p,
      y0m, y1, zp, zm, n, nmom, sweeps, mode, thermal, beam, L, B, tab);
  return static_cast<int>(cudaGetLastError());
}
