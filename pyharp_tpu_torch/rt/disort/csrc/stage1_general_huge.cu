// K4 at N = 33..64 (nstr 66..128): general stage 1 of one azimuthal mode
// (phase moments).
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:427 (_stage1_kernel, the
// general branch :449-615) at the N that stage1_general_big.cu does not
// take; the mode m enters as there (the tables of kernels.general_tables,
// lam0 and `mode`).  For every (layer, column) element it computes what
// stage1_general_big.cu computes, step for step and in the operation order
// of the plain version (solver.homogeneous_solution with
// kernels.kernel_sweeps(N) = 8 Jacobi sweeps in the JAX package's rotation
// formulas and cyclic (p, q) order, thermal_particular and the beam
// particular of _beam_from_q).  Built with --fmad=false, so it is bit-equal
// to stage1_general_plain.
//
// Bound on the H100: operations.  Per element it reads (4 + nmom)*4 bytes
// (+ 8 + 4*nstr with the beam) and writes (2N^2 + 7N)*4 (34,560 bytes at
// N = 64), against ~8 * 2,016 rotations * (6N + 30) ~ 6.7e6 flops of
// Jacobi alone at N = 64, plus three N x N LUs and the products (~N^3
// each).
//
// Design: stage1_general_big.cu's body with two rows a lane: a warp per
// element, lane t owning rows t and t + 32 (and columns t and t + 32 where
// a step goes by columns), one body for every N = 33..64 with N a run-time
// argument, 2 elements a block of 64 threads.  An element keeps X and Y
// (N x (N + 1) at an odd stride) in shared memory, 34.3 KB at N = 64, so
// six elements an SM: an element's time is its latency, so a launch must
// bring many of them.  The radiances' modes m >= 1 come in one launch
// (pyharp_stage1_general_huge_modes, general_huge.cuh's K4Modes: at nstr
// 128 a mode has 128 elements of 1 x 16 x 8, 64 of the 132 SMs, and the
// 127 modes fill the card some 20 times over).  Every step of the big body
// runs over the lane's rows in turn; the Cholesky keeps each row's pending
// pivot in the pivot vector instead of a register.  The sweeps
// (general_huge.cuh's sweeps_rows<2>) keep to the chain of a rotation: a
// lane carries a_rp, y_rp and the diagonal of both its rows through the q
// loop, a_pq and a_qq come by shuffles, the rotation runs straight through
// on the fast paths of its quotients and square roots (the range checks'
// other path in a branch beside it), row q + 1's a_rp is shuffled before
// the row work, the slots of the next rotation are loaded right after the
// barrier, and the row updates are selects.  chip_smoke.py phase 1 prints
// registers, stack and spills; tests/test_torch_huge_k4.py models the body
// on the CPU; tools/wide_ab.py's part huge_cycles reads its cycles by phase
// (-DPYHARP_BIG_PROFILE).

#include "general_huge.cuh"
#include "huge.cuh"

namespace {

constexpr int kElems = 2;                  // elements (warps) a block
constexpr int kThreads = 32 * kElems;
constexpr int kMinBlocks = 3;              // blocks an SM holds at N = 64
constexpr int kRowsALane = 2;              // rows t and t + 32

__global__ void __launch_bounds__(kThreads, kMinBlocks)
stage1_general_huge_kernel(const float* __restrict__ ssa_in,
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
                           const float* __restrict__ tab0, K4Modes modes) {
  extern __shared__ __align__(16) float smem[];
  BIG_PROF_START();
  const K4Geom G(n);
  const int64_t lb = L * B;
  const int t = static_cast<int>(threadIdx.x) & 31;   // rows t, t + 32
  const int el = static_cast<int>(threadIdx.x) >> 5;
  const int64_t ef = static_cast<int64_t>(blockIdx.x) * kElems + el;
  if (ef >= modes.nm * lb) return;     // a whole warp
  const K4Element E(ef, lb, B, modes, tab0, mode0, lam0_in);
  const int64_t e = E.e;               // the inputs' (layer, column)
  const int64_t layer = E.layer;
  const int64_t b = E.b;
  const int64_t o = E.o;               // the outputs' element and stride
  const int64_t os = E.os;
  const int mode = E.mode;
  const float* tab = E.tab;
  lam0_in = E.lam0;
  float* X = smem + el * G.floats;     // Uhat, Lc^T; A; Vf; LU; Uf
  float* Y = X + G.y;                  // Vhat, VL; Y; D, Sg; Vf
  float* gs = X + G.gs;
  float* lams = X + G.lams;
  float* piv = X + G.piv;              // Lc's diagonal (pending pivots)
  const int ld = G.ld;
  // the beam's two vectors, in the columns n of Y and X that its steps
  // leave free
  float* va = Y + n;
  float* vb = X + n;
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
  const float ssa = ssa_in[e];
  // Lc[i][j], j <= i: the pivot vector, else X's upper triangle
  auto lc = [&](int i, int j) { return i == j ? piv[i] : X[j * ld + i]; };

  // the moments g_0 = 1, g_1..g_lmax (0 above lmax)
  for (int l = t; l < 2 * n; l += 32) {
    gs[l] = l == 0 ? 1.0f
          : (l <= lmax ? pmom[(layer * nmom + (l - 1)) * B + b] : 0.0f);
  }
  __syncwarp();

  // Uhat's lower triangle by columns, the lane's columns j: the entries
  // below the diagonal, (i, j) into X[j][i], the pending pivot into piv[j]
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
    float ltj[kRowsALane];
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      ltj[h] = 0.0f;
      if (r > j && r < n) {
        ltj[h] = X[j * ld + r] * inv;
        X[j * ld + r] = ltj[h];
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r > j && r < n) {
        for (int k = j + 1; k < r; ++k) {
          X[k * ld + r] = X[k * ld + r] - ltj[h] * X[j * ld + k];
        }
        piv[r] = piv[r] - ltj[h] * ltj[h];
      }
    }
  }
  __syncwarp();
  BIG_PROF_MARK(0);

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
                           - ssa * ((sqw[r] * c[i]) * sqwj)) / (sqm[r] * sqmj);
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
  // K = Lc^T VL; the lane forms K[r][j] and K[j][r] for j <= r of its rows
  // and writes the Jacobi matrix (K + K^T) / 2 into X's lower triangle
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

  BIG_PROF_MARK(1);
  sweeps_rows<kRowsALane, true>(X, Y, ld, n, sweeps, t);

  // the eigenvalues; D = Lc Y / sqrt(mu w) in place over Y, a column at a
  // time
  for (int r = t; r < n; r += 32) {
    lams[r] = sqrtf(clamp_min_nan(X[r * ld + r], 1e-12f));
  }
  for (int k = 0; k < n; ++k) {
    float acc[kRowsALane];
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      acc[h] = 0.0f;
      if (r < n) {
        acc[h] = lc(r, 0) * Y[k];
        for (int j = 1; j <= r; ++j) acc[h] = acc[h] + lc(r, j) * Y[j * ld + k];
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r < n) Y[r * ld + k] = acc[h] / tab[T.sqmsqw + r];
    }
  }
  __syncwarp();
  BIG_PROF_MARK(4);

  // Vf by columns into X; S = -(Vf D) / (mu lam), gp and gm normalised per
  // mode, Sg = gp + gm in place over D
  for (int j = t; j < n; j += 32) {
    form_iw(X, ld, odd, gs, n, p1, lmax, ssa, w[j], j);
  }
  __syncwarp();
  const float dtau = dtau_in[e];
  for (int k = 0; k < n; ++k) {
    const float lk = lams[k];
    float gpk[kRowsALane];
    float gmk[kRowsALane];
    float mx = -1.0f;
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      gpk[h] = 0.0f;
      gmk[h] = 0.0f;
      if (r < n) {
        float acc = X[r * ld] * Y[k];
        for (int j = 1; j < n; ++j) acc = acc + X[r * ld + j] * Y[j * ld + k];
        const float sv = -acc / (mu[r] * lk);
        const float dik = Y[r * ld + k];
        gpk[h] = 0.5f * (sv + dik);
        gmk[h] = 0.5f * (sv - dik);
        mx = max_nan(max_nan(mx, fabsf(gpk[h])), fabsf(gmk[h]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      mx = max_nan(mx, __shfl_xor_sync(kBigFull, mx, off));
    }
    const float scale = clamp_min_nan(mx, 1e-30f);
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r < n) {
        const float gpn = gpk[h] / scale;
        const float gmn = gmk[h] / scale;
        gp_out[static_cast<int64_t>(r * n + k) * os + o] = gpn;
        gm_out[static_cast<int64_t>(r * n + k) * os + o] = gmn;
        Y[r * ld + k] = gpn + gmn;
      }
    }
    if (t == (k & 31)) {
      lam_out[k * os + o] = lk;
      expd_out[k * os + o] = expf(-lk * dtau);
    }
  }
  __syncwarp();
  BIG_PROF_MARK(5);

  bool have_uf = false;
  if (beam) {
    // (2 - delta_m0) / 4 pi, rounded to float as the plain version's scale
    const float kappa = mode > 0
        ? static_cast<float>(2.0 / (4.0 * 3.141592653589793))
        : static_cast<float>(1.0 / (4.0 * 3.141592653589793));
    const float amp = ssa * fbeam_in[b];
    const float mur = mur_in[e];
    // q+- of the lane's rows, each summed in l order
    float qs[kRowsALane];
    float qd[kRowsALane];
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      float accp = 0.0f;
      float accm = 0.0f;
      bool first = true;
      for (int l = 0; l < 2 * n && l <= lmax; ++l) {
        const float coef = (gs[l] * tab[T.c2p + l]) * lam0_in[l * B + b];
        const float tl = r < n ? tab[T.lam + l * n + r] : 0.0f;
        if (tl != 0.0f) {
          const float tp = coef * tl;
          const float tm = coef * tab[T.lam_signed + l * n + r];
          accp = first ? tp : accp + tp;
          accm = first ? tm : accm + tm;
          first = false;
        }
      }
      const float qp = (kappa * accp) * amp;
      const float qm = (kappa * accm) * amp;
      qs[h] = qp + qm;
      qd[h] = qp - qm;
      if (r < n) va[r * ld] = qs[h] / mu[r];
    }
    __syncwarp();
    // the right-hand side M^-1 V qs / mu - (q+ - q-) / (mu mur) from Vf in
    // X, then a copy of Sg with it in column n over X
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r < n) {
        float acc = X[r * ld] * va[0];
        for (int j = 1; j < n; ++j) acc = acc + X[r * ld + j] * va[j * ld];
        const float rhs = acc / mu[r] - qd[h] / (mu[r] * mur);
        for (int k = 0; k < n; ++k) X[r * ld + k] = Y[r * ld + k];
        X[r * ld + n] = rhs;
      }
    }
    __syncwarp();
    warp_lu_solve(X, ld, n, 1, t);
    const float inv = 1.0f / (mur * mur);
    for (int r = t; r < n; r += 32) {
      const float lam2 = lams[r] * lams[r];
      float dn = lam2 - inv;
      const float floor = 1e-4f * (lam2 + inv);
      dn = fabsf(dn) < floor ? (dn < 0.0f ? -floor : floor) : dn;
      va[r * ld] = X[r * ld + n] / dn;
    }
    __syncwarp();
    float zs[kRowsALane];
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      zs[h] = 0.0f;
      if (r < n) {
        zs[h] = Y[r * ld] * va[0];
        for (int k = 1; k < n; ++k) zs[h] = zs[h] + Y[r * ld + k] * va[k * ld];
        vb[r * ld] = zs[h];
      }
    }
    // Uf by columns over X, once for uz and the thermal LU
    for (int j = t; j < n; j += 32) {
      form_iw(X, ld, even, gs, n, p0, lmax, ssa, w[j], j);
    }
    have_uf = true;
    __syncwarp();
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r < n) {
        float uz = X[r * ld] * vb[0];
        for (int j = 1; j < n; ++j) uz = uz + X[r * ld + j] * vb[j * ld];
        const float zd = -mur * (uz - qs[h]) / mu[r];
        zp_out[r * os + o] = 0.5f * (zs[h] + zd);
        zm_out[r * os + o] = 0.5f * (zs[h] - zd);
      }
    }
    __syncwarp();
  }
  BIG_PROF_MARK(6);

  if (thermal) {
    // U h = (1 - ssa) 1 with Uf in X, then V y0d = 2 mu slope h with Vf
    // formed again into Y (the right-hand sides in column n)
    if (!have_uf) {
      for (int j = t; j < n; j += 32) {
        form_iw(X, ld, even, gs, n, p0, lmax, ssa, w[j], j);
      }
    }
    for (int r = t; r < n; r += 32) X[r * ld + n] = (1.0f - ssa) * 1.0f;
    __syncwarp();
    warp_lu_solve(X, ld, n, 1, t);
    const float slope = slope_in[e];
    const float btop = btop_in[e];
    float hv[kRowsALane];
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      hv[h] = 0.0f;
      if (r < n) {
        hv[h] = X[r * ld + n];
        const float y1 = slope * hv[h];
        y1_out[r * os + o] = y1;
        Y[r * ld + n] = (2.0f * mu[r]) * y1;
      }
    }
    for (int j = t; j < n; j += 32) {
      form_iw(Y, ld, odd, gs, n, p1, lmax, ssa, w[j], j);
    }
    __syncwarp();
    warp_lu_solve(Y, ld, n, 1, t);
#pragma unroll
    for (int h = 0; h < kRowsALane; ++h) {
      const int r = t + 32 * h;
      if (r < n) {
        const float y0d = Y[r * ld + n];
        y0p_out[r * os + o] = btop * hv[h] + 0.5f * y0d;
        y0m_out[r * os + o] = btop * hv[h] - 0.5f * y0d;
      }
    }
  }
  BIG_PROF_MARK(7);
  BIG_PROF_FLUSH();
}

int smem_bytes(int n) {
  return kElems * K4Geom(n).floats * static_cast<int>(sizeof(float));
}

// The attribute belongs to the current device: set it on every launch (and
// every occupancy query).
cudaError_t allow_smem(int n) {
  return cudaFuncSetAttribute(stage1_general_huge_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(n));
}

// The launch over modes.nm modes of L B elements each.
int launch(int n, int thermal, int beam, const float* ssa, const float* pmom,
           const float* dtau, const float* btop, const float* slope,
           const float* fbeam, const float* mur, const float* lam0, float* gp,
           float* gm, float* lam, float* expd, float* y0p, float* y0m,
           float* y1, float* zp, float* zm, int nmom, int sweeps, int mode,
           int64_t L, int64_t B, const float* tab, K4Modes modes,
           void* stream) {
  if (n < kHugeMinN || n > kHugeMaxN) return PYHARP_UNSUPPORTED_N;
  const int64_t elems = modes.nm * L * B;
  if (elems == 0) return 0;
  const cudaError_t err = allow_smem(n);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grid = static_cast<unsigned>((elems + kElems - 1) / kElems);
  stage1_general_huge_kernel<<<grid, kThreads, smem_bytes(n),
                               static_cast<cudaStream_t>(stream)>>>(
      ssa, pmom, dtau, btop, slope, fbeam, mur, lam0, gp, gm, lam, expd, y0p,
      y0m, y1, zp, zm, n, nmom, sweeps, mode, thermal, beam, L, B, tab,
      modes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// As pyharp_stage1_general (stage1_general.cu), for n = 33..64.
PYHARP_API int pyharp_stage1_general_huge(
    int n, int thermal, int beam, const float* ssa, const float* pmom,
    const float* dtau, const float* btop, const float* slope,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* y0p, float* y0m, float* y1,
    float* zp, float* zm, int nmom, int sweeps, int mode, long long L,
    long long B, const float* tab, void* stream) {
  return launch(n, thermal, beam, ssa, pmom, dtau, btop, slope, fbeam, mur,
                lam0, gp, gm, lam, expd, y0p, y0m, y1, zp, zm, nmom, sweeps,
                mode, L, B, tab, K4Modes{1, 0, nullptr}, stream);
}

// K4 at the nm modes of a radiance solve in one launch, n = 33..64: no
// thermal source, a beam; `tabs` the modes' table pointers and m (K4Modes),
// lam0 (nm, G, B); gp, gm (n, n, L, nm, B), lam, expd, zp, zm (n, L, nm, B).
PYHARP_API int pyharp_stage1_general_huge_modes(
    int n, const float* ssa, const float* pmom, const float* dtau,
    const float* fbeam, const float* mur, const float* lam0, float* gp,
    float* gm, float* lam, float* expd, float* zp, float* zm, int nmom,
    int sweeps, long long nm, long long G, long long L, long long B,
    const long long* tabs, void* stream) {
  return launch(n, 0, 1, ssa, pmom, dtau, nullptr, nullptr, fbeam, mur, lam0,
                gp, gm, lam, expd, nullptr, nullptr, nullptr, zp, zm, nmom,
                sweeps, 0, L, B, nullptr, K4Modes{nm, G, tabs}, stream);
}

// Elements resident on an SM at n, by the occupancy calculator.
PYHARP_API int pyharp_stage1_general_huge_occupancy(int n) {
  if (allow_smem(n) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, stage1_general_huge_kernel, kThreads, smem_bytes(n)) !=
      cudaSuccess)
    return -1;
  return blocks * kElems;
}

BIG_PROF_READER(stage1_general_huge)
