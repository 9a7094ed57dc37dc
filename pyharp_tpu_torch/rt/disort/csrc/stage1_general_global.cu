// K4 at N > 64 (nstr > 128): general stage 1 of one azimuthal mode (phase
// moments).
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:427 (_stage1_kernel, the
// general branch :449-615) at the N that stage1_general_huge.cu does not
// take; the mode m enters as there (the tables of kernels.general_tables,
// lam0 and `mode`).  For every (layer, column) element it computes what
// stage1_general_huge.cu computes, step for step and in the operation
// order of the plain version (solver.homogeneous_solution with
// kernels.kernel_sweeps(N) = 8 Jacobi sweeps in the JAX package's rotation
// formulas and cyclic (p, q) order, thermal_particular and the beam
// particular of _beam_from_q).  Built with --fmad=false, so it is
// bit-equal to stage1_general_plain.
//
// Bound on the H100: operations.  Per element it reads (4 + nmom)*4 bytes
// (+ 8 + 4*nstr with the beam) and writes (2N^2 + 7N)*4 (134,656 bytes at
// N = 128), against ~8 * 8,128 rotations * (6N + 30) ~ 5.2e7 flops of
// Jacobi alone at N = 128, plus three N x N LUs and the products (~N^3
// each).
//
// Design: stage1_general_huge.cu's body with lane t on the rows t + 32 j
// for any number of row sets: a warp per element, one body for every
// N > 64 with N a run-time argument and no bound on it, 2 elements a block
// of 64 threads, the warps walking the elements in a grid-stride loop.  An
// element's X and Y (N x (N + 1): Uhat, Lc^T, the Jacobi matrix, Vf, the
// LUs, Uf; Vhat, VL, the eigenvectors, D, Sg), its moments, eigenvalues
// and pivots, the values the huge body carries in registers for its two
// rows a lane (a_rp, y_rp and the new a_rr through a sweep's q loop; gp
// and gm of a mode; the beam's q+-, zs; the thermal h) and the pivot
// records live in a slab of global scratch per resident warp (133 KB at
// N = 128), where the huge body keeps 34.3 KB of shared memory an element.
// A lane reads and writes only its own rows' carried values, a_pq coming
// from row q's lane by a shuffle of what that lane read of its own row, so
// the huge body's one __syncwarp a rotation still orders the sweeps; up
// to N = 256 (8 row sets) the carried values stay in registers, the body
// compiled for each set count, and the sweeps are the huge body's
// (general_huge.cuh's sweeps_rows<R>: the rotation's chain straight
// through, the slots of the next rotation loaded right after the barrier,
// the row updates as selects; above 8 sets sweeps_global, every rotation
// in turn).  The radiances' modes m >= 1 come in one launch
// (pyharp_stage1_general_global_modes: at nstr 256 a mode has 16 elements
// of 1 x 4 x 4, and the 255 modes keep every resident warp busy).  The
// rotation's quotients and square roots take the fast paths behind the
// same two range checks (general.cuh's rotation_checked); the LUs are
// global.cuh's warp LU.
// chip_smoke.py phase 23 prints registers, stack and spills;
// tests/test_torch_global_k4.py models the body on the CPU.

#include "general_huge.cuh"
#include "global.cuh"

namespace {

constexpr int kElems = 2;                  // elements (warps) a block
constexpr int kThreads = 32 * kElems;

// An element's slab for n: X and Y (n rows of n + 1), the moments
// g_0..g_{2n-1}, the eigenvalues, the Cholesky pivots, three vectors of
// per-row carried values (n each) and the records (row_sets(n) words).
struct GlobalK4Geom {
  int ld;
  int64_t y, gs, lams, piv, c0, c1, c2, bits, floats;
  __host__ __device__ explicit GlobalK4Geom(int n)
      : ld(n + 1), y(static_cast<int64_t>(n) * ld), gs(2 * y),
        lams(gs + 2 * n), piv(lams + n), c0(piv + n), c1(c0 + n),
        c2(c1 + n), bits(c2 + n), floats(bits + row_sets(n)) {}
};

// The sweeps of an element on its warp, rotation by rotation in the
// cyclic order of n, lane t on rows t + 32 j.  Entry (r, c) of A at
// X[max][min]; at a fixed p row r's a_rp, y_rp and new a_rr are carried in
// arp[r], yrp[r] and dq[r] (lane t's own entries) through the q loop and
// stored when it ends; a_pq comes from row q's lane by a shuffle, a_qq
// from the diagonal as the loop began, a_pp from the previous rotation's
// new_pp.  The copy of a_rq a lane reads was written at least one rotation
// before (by its own other row or another lane), so one __syncwarp a
// rotation orders it.
__device__ __forceinline__ void sweeps_global(float* X, float* Y, int ld,
                                              int n, int sweeps, int t,
                                              float* arp, float* yrp,
                                              float* dq) {
  for (int it = 0; it < sweeps; ++it) {
    for (int p = 0; p + 1 < n; ++p) {
      float app = X[p * ld + p];
      for (int r = t; r < n; r += 32) {
        arp[r] = r == p ? 0.0f : (r > p ? X[r * ld + p] : X[p * ld + r]);
        yrp[r] = Y[r * ld + p];
        dq[r] = 0.0f;
      }
      for (int q = p + 1; q < n; ++q) {
        const int rq = t + (q & ~31);      // the lane's row in q's set
        const float own = rq < n ? arp[rq] : 0.0f;
        const float apq = __shfl_sync(kBigFull, own, q & 31);
        const float aqq = X[q * ld + q];
        float c, s, new_pp, new_qq;
        rotation_checked(app, apq, aqq, c, s, new_pp, new_qq);
        for (int r = t; r < n; r += 32) {
          if (r != p && r != q) {
            float* aq = X + (r > q ? r * ld + q : q * ld + r);
            const float arq = *aq;
            const float a = arp[r];
            const float nrp = c * a - s * arq;
            *aq = s * a + c * arq;
            arp[r] = nrp;
          } else if (r == q) {
            arp[r] = 0.0f;
            dq[r] = new_qq;
          }
          const float vrq = Y[r * ld + q];
          const float y = yrp[r];
          Y[r * ld + q] = s * y + c * vrq;
          yrp[r] = c * y - s * vrq;
        }
        app = new_pp;
        __syncwarp();
      }
      for (int r = t; r < n; r += 32) {
        if (r == p) {
          X[p * ld + p] = app;
        } else {
          X[r > p ? r * ld + p : p * ld + r] = arp[r];
        }
        if (r > p) X[r * ld + r] = dq[r];
        Y[r * ld + p] = yrp[r];
      }
      __syncwarp();
    }
  }
}

// The sweeps with the rows' carried values in registers (general_huge.cuh's
// sweeps_rows<R>), for R row sets known at compile time (N up to 32 R).
constexpr int kRegSetsMin = 3;             // row_sets(65)
constexpr int kRegSetsMax = 8;             // N up to 256

// The sweeps: in registers up to kRegSetsMax row sets, else in scratch.
template <int R = kRegSetsMin>
__device__ __forceinline__ void sweeps_any(float* X, float* Y, int ld, int n,
                                           int sweeps, int t, float* arp,
                                           float* yrp, float* dq) {
  if constexpr (R > kRegSetsMax) {
    sweeps_global(X, Y, ld, n, sweeps, t, arp, yrp, dq);
  } else if (row_sets(n) == R) {
    sweeps_rows<R, false>(X, Y, ld, n, sweeps, t);
  } else {
    sweeps_any<R + 1>(X, Y, ld, n, sweeps, t, arp, yrp, dq);
  }
}

__global__ void __launch_bounds__(kThreads)
stage1_general_global_kernel(const float* __restrict__ ssa_in,
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
                             int sweeps, int mode0, int thermal, int beam,
                             int64_t L, int64_t B,
                             const float* __restrict__ tab0, K4Modes modes,
                             float* scratch) {
  const GlobalK4Geom G(n);
  const int64_t lb = L * B;
  const int t = static_cast<int>(threadIdx.x) & 31;   // rows t + 32 j
  const int64_t warp = static_cast<int64_t>(blockIdx.x) * kElems +
                       (static_cast<int>(threadIdx.x) >> 5);
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kElems;
  float* X = scratch + warp * G.floats;  // Uhat, Lc^T; A; Vf;
  float* Y = X + G.y;                  // Vhat, VL; Y; D, Sg;   LU; Uf; Vf
  float* gs = X + G.gs;
  float* lams = X + G.lams;
  float* piv = X + G.piv;              // Lc's diagonal (pending pivots)
  float* c0 = X + G.c0;                // the rows' carried values
  float* c1 = X + G.c1;
  float* c2 = X + G.c2;
  unsigned* bits = reinterpret_cast<unsigned*>(X + G.bits);
  const int ld = G.ld;
  // the beam's two vectors, in the columns n of Y and X that its steps
  // leave free
  float* va = Y + n;
  float* vb = X + n;
  const GenTab T(n);
  const int lmax = nmom < 2 * n - 1 ? nmom : 2 * n - 1;
  // Lc[i][j], j <= i: the pivot vector, else X's upper triangle
  auto lc = [&](int i, int j) { return i == j ? piv[i] : X[j * ld + i]; };

  for (int64_t ef = warp; ef < modes.nm * lb; ef += warps) {
    const K4Element E(ef, lb, B, modes, tab0, mode0, lam0_in);
    const int64_t e = E.e;             // the inputs' (layer, column)
    const int64_t layer = E.layer;
    const int64_t b = E.b;
    const int64_t o = E.o;             // the outputs' element and stride
    const int64_t os = E.os;
    const int mode = E.mode;
    const float* tab = E.tab;
    const float* lam0 = E.lam0;
    const int p0 = mode;            // first nonzero rows: l = m (even l - m)
    const int p1 = mode + 1;        // and l = m + 1 (odd)
    const float* even = tab + T.even;
    const float* odd = tab + T.odd;
    const float* mu = tab + T.mu;
    const float* w = tab + T.w;
    const float* sqw = tab + T.sqw;
    const float* sqm = tab + T.sqm;
    const float ssa = ssa_in[e];

    // the moments g_0 = 1, g_1..g_lmax (0 above lmax)
    for (int l = t; l < 2 * n; l += 32) {
      gs[l] = l == 0 ? 1.0f
            : (l <= lmax ? pmom[(layer * nmom + (l - 1)) * B + b] : 0.0f);
    }
    __syncwarp();

    // Uhat's lower triangle by columns, the lane's columns j: the entries
    // below the diagonal, (i, j) into X[j][i], the pending pivot into
    // piv[j]
    for (int j = t; j < n; j += 32) {
      const float sqwj = sqw[j];
      const float sqmj = sqm[j];
      for (int i0 = 0; i0 < n; i0 += kHalf) {
        if (i0 + kHalf <= j) continue;     // rows above the diagonal
        float c[kHalf];
        contract_col(even, gs, n, p0, lmax, j, i0, c);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const int r = i0 + i;
          if (r >= j && r < n) {
            const float u = ((r == j ? 1.0f : 0.0f)
                             - ssa * ((sqw[r] * c[i]) * sqwj))
                            / (sqm[r] * sqmj);
            if (r == j) {
              piv[j] = u;
            } else {
              X[j * ld + r] = u;
            }
          }
        }
      }
    }
    __syncwarp();
    // the Cholesky, right-looking: column j's pivot on its row's lane, its
    // entries on the lanes of the rows below, then each of those rows'
    // pending entries of the later columns and its pending pivot less this
    // column's term
    for (int j = 0; j < n; ++j) {
      if (t == (j & 31)) piv[j] = sqrtf(clamp_min_nan(piv[j], 1e-12f));
      __syncwarp();
      const float inv = 1.0f / piv[j];
      for (int r = t; r < n; r += 32) {
        if (r > j) X[j * ld + r] = X[j * ld + r] * inv;
      }
      __syncwarp();
      for (int r = t; r < n; r += 32) {
        if (r <= j) continue;
        const float ltj = X[j * ld + r];
        for (int k = j + 1; k < r; ++k) {
          X[k * ld + r] = X[k * ld + r] - ltj * X[j * ld + k];
        }
        piv[r] = piv[r] - ltj * ltj;
      }
    }
    __syncwarp();

    // Vhat by columns into Y (the lane's columns), then VL = Vhat Lc in
    // place, the lane's rows
    for (int j = t; j < n; j += 32) {
      const float sqwj = sqw[j];
      const float sqmj = sqm[j];
      for (int i0 = 0; i0 < n; i0 += kHalf) {
        float c[kHalf];
        contract_col(odd, gs, n, p1, lmax, j, i0, c);
#pragma unroll
        for (int i = 0; i < kHalf; ++i) {
          const int r = i0 + i;
          if (r < n) {
            Y[r * ld + j] = ((r == j ? 1.0f : 0.0f)
                             - ssa * ((sqw[r] * c[i]) * sqwj))
                            / (sqm[r] * sqmj);
          }
        }
      }
    }
    __syncwarp();
    for (int r = t; r < n; r += 32) {
      for (int j = 0; j < n; ++j) {
        float acc = Y[r * ld + j] * piv[j];
        for (int m = j + 1; m < n; ++m) acc = acc + Y[r * ld + m] * lc(m, j);
        Y[r * ld + j] = acc;
      }
    }
    __syncwarp();
    // K = Lc^T VL; the lane forms K[r][j] and K[j][r] for j <= r of its
    // rows and writes the Jacobi matrix (K + K^T) / 2 into X's lower
    // triangle
    for (int r = t; r < n; r += 32) {
      for (int j = 0; j <= r; ++j) {
        float krj = piv[r] * Y[r * ld + j];
        for (int k = r + 1; k < n; ++k) krj = krj + lc(k, r) * Y[k * ld + j];
        float kjr = piv[j] * Y[j * ld + r];
        for (int k = j + 1; k < n; ++k) kjr = kjr + lc(k, j) * Y[k * ld + r];
        X[r * ld + j] = 0.5f * (krj + kjr);
      }
    }
    __syncwarp();
    for (int r = t; r < n; r += 32) {
      for (int j = 0; j < n; ++j) Y[r * ld + j] = r == j ? 1.0f : 0.0f;
    }
    __syncwarp();

    sweeps_any(X, Y, ld, n, sweeps, t, c0, c1, c2);

    // the eigenvalues; D = Lc Y / sqrt(mu w) in place over Y, a column at
    // a time, each row's sum held in c0 until every lane has read the
    // column
    for (int r = t; r < n; r += 32) {
      lams[r] = sqrtf(clamp_min_nan(X[r * ld + r], 1e-12f));
    }
    for (int k = 0; k < n; ++k) {
      for (int r = t; r < n; r += 32) {
        float acc = lc(r, 0) * Y[k];
        for (int j = 1; j <= r; ++j) acc = acc + lc(r, j) * Y[j * ld + k];
        c0[r] = acc;
      }
      __syncwarp();
      for (int r = t; r < n; r += 32) {
        Y[r * ld + k] = c0[r] / tab[T.sqmsqw + r];
      }
    }
    __syncwarp();

    // Vf by columns into X; S = -(Vf D) / (mu lam), gp and gm normalised
    // per mode (held in c0, c1 until the mode's max is known), Sg = gp + gm
    // in place over D
    for (int j = t; j < n; j += 32) {
      form_iw(X, ld, odd, gs, n, p1, lmax, ssa, w[j], j);
    }
    __syncwarp();
    const float dtau = dtau_in[e];
    for (int k = 0; k < n; ++k) {
      const float lk = lams[k];
      float mx = -1.0f;
      for (int r = t; r < n; r += 32) {
        float acc = X[r * ld] * Y[k];
        for (int j = 1; j < n; ++j) acc = acc + X[r * ld + j] * Y[j * ld + k];
        const float sv = -acc / (mu[r] * lk);
        const float dik = Y[r * ld + k];
        const float gpk = 0.5f * (sv + dik);
        const float gmk = 0.5f * (sv - dik);
        c0[r] = gpk;
        c1[r] = gmk;
        mx = max_nan(max_nan(mx, fabsf(gpk)), fabsf(gmk));
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        mx = max_nan(mx, __shfl_xor_sync(kBigFull, mx, off));
      }
      const float scale = clamp_min_nan(mx, 1e-30f);
      for (int r = t; r < n; r += 32) {
        const float gpn = c0[r] / scale;
        const float gmn = c1[r] / scale;
        gp_out[static_cast<int64_t>(r * n + k) * os + o] = gpn;
        gm_out[static_cast<int64_t>(r * n + k) * os + o] = gmn;
        Y[r * ld + k] = gpn + gmn;
      }
      if (t == (k & 31)) {
        lam_out[k * os + o] = lk;
        expd_out[k * os + o] = expf(-lk * dtau);
      }
    }
    __syncwarp();

    bool have_uf = false;
    if (beam) {
      // (2 - delta_m0) / 4 pi, rounded to float as the plain version's
      // scale
      const float kappa = mode > 0
          ? static_cast<float>(2.0 / (4.0 * 3.141592653589793))
          : static_cast<float>(1.0 / (4.0 * 3.141592653589793));
      const float amp = ssa * fbeam_in[b];
      const float mur = mur_in[e];
      // q+- of the lane's rows, each summed in l order: qs in c0, qd in c1
      for (int r = t; r < n; r += 32) {
        float accp = 0.0f;
        float accm = 0.0f;
        bool first = true;
        for (int l = 0; l < 2 * n && l <= lmax; ++l) {
          const float tl = tab[T.lam + l * n + r];
          if (tl != 0.0f) {
            const float coef = (gs[l] * tab[T.c2p + l]) * lam0[l * B + b];
            const float tp = coef * tl;
            const float tm = coef * tab[T.lam_signed + l * n + r];
            accp = first ? tp : accp + tp;
            accm = first ? tm : accm + tm;
            first = false;
          }
        }
        const float qp = (kappa * accp) * amp;
        const float qm = (kappa * accm) * amp;
        c0[r] = qp + qm;
        c1[r] = qp - qm;
        va[r * ld] = c0[r] / mu[r];
      }
      __syncwarp();
      // the right-hand side M^-1 V qs / mu - (q+ - q-) / (mu mur) from Vf
      // in X, then a copy of Sg with it in column n over X
      for (int r = t; r < n; r += 32) {
        float acc = X[r * ld] * va[0];
        for (int j = 1; j < n; ++j) acc = acc + X[r * ld + j] * va[j * ld];
        const float rhs = acc / mu[r] - c1[r] / (mu[r] * mur);
        for (int k = 0; k < n; ++k) X[r * ld + k] = Y[r * ld + k];
        X[r * ld + n] = rhs;
      }
      __syncwarp();
      warp_lu_solve_global(X, ld, n, 1, t, bits);
      const float inv = 1.0f / (mur * mur);
      for (int r = t; r < n; r += 32) {
        const float lam2 = lams[r] * lams[r];
        float dn = lam2 - inv;
        const float floor = 1e-4f * (lam2 + inv);
        dn = fabsf(dn) < floor ? (dn < 0.0f ? -floor : floor) : dn;
        va[r * ld] = X[r * ld + n] / dn;
      }
      __syncwarp();
      // zs of the lane's rows, in c2 and over X's column n
      for (int r = t; r < n; r += 32) {
        float zs = Y[r * ld] * va[0];
        for (int k = 1; k < n; ++k) zs = zs + Y[r * ld + k] * va[k * ld];
        c2[r] = zs;
        vb[r * ld] = zs;
      }
      // Uf by columns over X, once for uz and the thermal LU
      for (int j = t; j < n; j += 32) {
        form_iw(X, ld, even, gs, n, p0, lmax, ssa, w[j], j);
      }
      have_uf = true;
      __syncwarp();
      for (int r = t; r < n; r += 32) {
        float uz = X[r * ld] * vb[0];
        for (int j = 1; j < n; ++j) uz = uz + X[r * ld + j] * vb[j * ld];
        const float zd = -mur * (uz - c0[r]) / mu[r];
        zp_out[r * os + o] = 0.5f * (c2[r] + zd);
        zm_out[r * os + o] = 0.5f * (c2[r] - zd);
      }
      __syncwarp();
    }

    if (thermal) {
      // U h = (1 - ssa) 1 with Uf in X, then V y0d = 2 mu slope h with Vf
      // formed again into Y (the right-hand sides in column n); h in c0
      if (!have_uf) {
        for (int j = t; j < n; j += 32) {
          form_iw(X, ld, even, gs, n, p0, lmax, ssa, w[j], j);
        }
      }
      for (int r = t; r < n; r += 32) X[r * ld + n] = (1.0f - ssa) * 1.0f;
      __syncwarp();
      warp_lu_solve_global(X, ld, n, 1, t, bits);
      const float slope = slope_in[e];
      const float btop = btop_in[e];
      for (int r = t; r < n; r += 32) {
        const float hv = X[r * ld + n];
        c0[r] = hv;
        const float y1 = slope * hv;
        y1_out[r * os + o] = y1;
        Y[r * ld + n] = (2.0f * mu[r]) * y1;
      }
      for (int j = t; j < n; j += 32) {
        form_iw(Y, ld, odd, gs, n, p1, lmax, ssa, w[j], j);
      }
      __syncwarp();
      warp_lu_solve_global(Y, ld, n, 1, t, bits);
      for (int r = t; r < n; r += 32) {
        const float y0d = Y[r * ld + n];
        y0p_out[r * os + o] = btop * c0[r] + 0.5f * y0d;
        y0m_out[r * os + o] = btop * c0[r] - 0.5f * y0d;
      }
    }
    __syncwarp();                    // the slab is free for the next element
  }
}

// Elements resident on an SM; -1 on an error.
int per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, stage1_general_global_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks * kElems;
}

// Blocks of the launch over lb elements, a warp an element up to the warps
// resident on the card; -1 on an error.
int64_t grid_of(int64_t lb) {
  const int elems = per_sm();
  if (elems < 0) return -1;
  const int64_t warps = resident_units(elems, lb);
  return warps < 0 ? -1 : (warps + kElems - 1) / kElems;
}

// The launch over modes.nm modes of L B elements each.
int launch(int n, int thermal, int beam, const float* ssa, const float* pmom,
           const float* dtau, const float* btop, const float* slope,
           const float* fbeam, const float* mur, const float* lam0, float* gp,
           float* gm, float* lam, float* expd, float* y0p, float* y0m,
           float* y1, float* zp, float* zm, int nmom, int sweeps, int mode,
           int64_t L, int64_t B, const float* tab, K4Modes modes,
           float* scratch, void* stream) {
  if (n < kGlobalMinN) return PYHARP_UNSUPPORTED_N;
  const int64_t elems = modes.nm * L * B;
  if (elems == 0) return 0;
  const int64_t grid = grid_of(elems);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  stage1_general_global_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      ssa, pmom, dtau, btop, slope, fbeam, mur, lam0, gp, gm, lam, expd, y0p,
      y0m, y1, zp, zm, n, nmom, sweeps, mode, thermal, beam, L, B, tab,
      modes, scratch);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of global scratch a launch over `elems` elements needs (L B, or
// nm L B over nm modes), a slab a resident warp; -1 on an error.
PYHARP_API long long pyharp_stage1_general_global_scratch(int n,
                                                          long long elems) {
  if (n < kGlobalMinN) return -1;
  if (elems == 0) return 0;
  const int64_t grid = grid_of(elems);
  return grid < 0 ? -1 : grid * kElems * GlobalK4Geom(n).floats;
}

// As pyharp_stage1_general (stage1_general.cu), for n > 64; scratch holds
// pyharp_stage1_general_global_scratch(n, L B) floats.
PYHARP_API int pyharp_stage1_general_global(
    int n, int thermal, int beam, const float* ssa, const float* pmom,
    const float* dtau, const float* btop, const float* slope,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* y0p, float* y0m, float* y1,
    float* zp, float* zm, int nmom, int sweeps, int mode, long long L,
    long long B, const float* tab, float* scratch, void* stream) {
  return launch(n, thermal, beam, ssa, pmom, dtau, btop, slope, fbeam, mur,
                lam0, gp, gm, lam, expd, y0p, y0m, y1, zp, zm, nmom, sweeps,
                mode, L, B, tab, K4Modes{1, 0, nullptr}, scratch, stream);
}

// As pyharp_stage1_general_huge_modes (stage1_general_huge.cu), for n > 64;
// scratch holds pyharp_stage1_general_global_scratch(n, nm L B) floats.
PYHARP_API int pyharp_stage1_general_global_modes(
    int n, const float* ssa, const float* pmom, const float* dtau,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* zp, float* zm, int nmom,
    int sweeps, long long nm, long long G, long long L, long long B,
    const long long* tabs, float* scratch, void* stream) {
  return launch(n, 0, 1, ssa, pmom, dtau, nullptr, nullptr, fbeam, mur, lam0,
                gp, gm, lam, expd, nullptr, nullptr, nullptr, zp, zm, nmom,
                sweeps, 0, L, B, nullptr, K4Modes{nm, G, tabs}, scratch,
                stream);
}

// Elements resident on an SM, by the occupancy calculator.
PYHARP_API int pyharp_stage1_general_global_occupancy() { return per_sm(); }
