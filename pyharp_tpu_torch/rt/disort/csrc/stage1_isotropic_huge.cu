// K1 at N = 33..64 (nstr 66..128): isotropic stage 1 of the m = 0 solve,
// thermal and beam variants, with the secular roots taken relative to
// their nearer pole.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:223 (_stage1_isotropic,
// beam :395-424) at the N that stage1_isotropic_big.cu does not take.  It
// computes what stage1_isotropic_big.cu computes, root for root
// (kernels._stage1_isotropic_wide is the plain version of both): each root
// k from the nearer end of its bracket, a = |tau| bisected on the bits of
// its float (`bisect` steps) on the sign of s f = s - ssa sum_i c_i v_i,
// two Newton steps, the eigenvector (-1)^k sign(s) v_i / mu_i normalised
// per mode; expd, the thermal particular and, in the beam variant, the beam
// particular by one N x N pivoted LU of S = gp + gm and the resonance-
// clamped denominators.  Built with --fmad=false, every quotient correctly
// rounded and every sum in the plain version's order, so the two are
// bit-equal.
//
// Bound on the H100.  Bytes: per element it reads 16 bytes (24 with the
// beam) and writes (2N^2 + 5N)*4 (34,048 bytes at N = 64; 34,560 with the
// beam).  Instruction issue: ~290,000 correctly rounded divisions an
// element at N = 64 (N roots of 1 + 32 + 2 sums of 64 padded terms and
// the eigenvector's two passes), far above the byte bound.
//
// Design: a warp per element, lane k finding roots k and k + 32 in turn,
// one body for every N = 33..64 with N a run-time argument, every sum
// padded to kM = 64 terms (the padded terms add zeros).  At 64 terms a
// root's c and row of delta would take 128 registers, so the lanes read
// them from the block's staged table (delta at an odd stride: the lanes,
// each on its own row, meet distinct banks; c the same word for every
// lane).  The quotients are stage1_isotropic_big.cu's: `quotient`, with s
// (tau in Newton's sums) checked against [2^-60, 2^60] once a sum and the
// sum taken again with `/`, the pole's select and the test on N where it
// leaves the range.  Lane k stores column k of gp and gm straight to
// device memory (a simple body: the 2 x 64 x 65 floats of an element's
// staging would leave room for too few elements an SM).
//  - Thermal: 8 elements a block, the table alone in shared memory.
//  - Beam: 6 elements a block; each keeps S = gp + gm and a copy with the
//    right-hand side in column N in shared memory (64 x 65 floats each),
//    and big.cuh's warp LU (the plain operations in their order, `/`
//    throughout) solves the copy; lane k forms the clamped denominator of
//    modes k and k + 32, lane i zs_i = S scaled for rows i and i + 32 from
//    the unfactored S, and every lane w . zs in the plain order.
// chip_smoke.py phase 1 prints registers, stack and spills;
// tests/test_torch_huge_k1.py models the body lane by lane on the CPU.

#include "huge.cuh"

namespace {

constexpr int kM = kHugeMaxN;                // terms of every sum
// The staged table, padded to kM terms: delta's kM + 1 rows at the odd
// stride kLd, the kM + 1 origins, then half, c, 1/mu^2, 1/mu, mu and w, kM
// each.
constexpr int kLd = kM + 1;
static_assert(kLd % 2 == 1, "odd row stride");
constexpr int kOrigin = (kM + 1) * kLd;
constexpr int kHalf = kOrigin + kM + 1;
constexpr int kC = kHalf + kM;
constexpr int kD = kC + kM;
constexpr int kInvmu = kD + kM;
constexpr int kMu = kInvmu + kM;
constexpr int kW = kMu + kM;
constexpr int kTab = (kW + kM + 3) / 4 * 4;
// A beam element's shared memory: S (kM rows at stride kLd), the LU's copy
// with the right-hand side in column n (the same), then the roots x_k, the
// scaled coefficients and zs, kM each.
constexpr int kS = 0;
constexpr int kA = kM * kLd;
constexpr int kXk = 2 * kM * kLd;
constexpr int kSc = kXk + kM;
constexpr int kZs = kSc + kM;
constexpr int kBeamStage = kZs + kM;
constexpr float kPad = 0x1p30f;              // delta past N
constexpr double kTwoKappa = 2.0 * (1.0 / (4.0 * 3.141592653589793));
constexpr int kNewton = 2;

template <bool BEAM>
struct Shape {
  static constexpr int kElems = BEAM ? 6 : 8;  // elements (warps) a block
  static constexpr int kThreads = 32 * kElems;
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float)) *
      (kTab + (BEAM ? kElems * kBeamStage : 0));
};

// The range of the sums' quotients is stage1_isotropic_big.cu's: every
// divisor is dlt_i - tau (or its negative) with tau within half of root
// k's bracket, so it is |tau| on the origin's pole, at least the least of
// h_k and the gaps between poles elsewhere, and 2^30 - tau on the padding;
// each lies in [2^-60, 2^31] wherever |tau| does (the largest pole at
// N = 64 is 8.3e6).  tests/test_torch_huge_k1.py checks the table's
// distances at every N = 33..64.

// sum_i c_i v_i, v_i = s / (dlt_i - tau), 1 on the pole (the origin's).
// FAST: all kM terms by `quotient`; else the plain version's terms i < n
// with `/` and the pole's select.
template <bool FAST>
__device__ __forceinline__ float sf_sum(float tau, float s, const float* dlt,
                                        int pole, int n, const float* c) {
  float acc = 0.0f;
#pragma unroll 16
  for (int i = 0; i < kM; ++i) {
    if (FAST) {
      const float v = quotient(s, dlt[i] - tau);
      acc = (i == 0) ? c[0] * v : acc + c[i] * v;
    } else if (i < n) {
      const float v = (i == pole) ? 1.0f : s / (dlt[i] - tau);
      acc = (i == 0) ? c[0] * v : acc + c[i] * v;
    }
  }
  return acc;
}

// s f from the origin whose differences are dlt: s - ssa sum_i c_i v_i.
__device__ __forceinline__ float s_f(float tau, float s, const float* dlt,
                                     int pole, int n, float ssa,
                                     const float* c) {
  float acc = sf_sum<true>(tau, s, dlt, pole, n, c);
  if (!in_range(s)) acc = sf_sum<false>(tau, s, dlt, pole, n, c);
  return s - ssa * acc;
}

// A Newton step's sums: fs = sum_i c_i u_i, fps = sum_i c_i u_i^2,
// u_i = 1 / (tau - dlt_i).
template <bool FAST>
__device__ __forceinline__ void newton_sums(float tau, const float* dlt,
                                            int n, const float* c, float& fs,
                                            float& fps) {
#pragma unroll 16
  for (int i = 0; i < kM; ++i) {
    if (FAST || i < n) {
      const float b = tau - dlt[i];
      const float u = FAST ? quotient(1.0f, b) : 1.0f / b;
      const float cu = c[i] * u;
      fs = (i == 0) ? cu : fs + cu;
      fps = (i == 0) ? cu * u : fps + cu * u;
    }
  }
}

// Entry i of the columns k of gp and gm before their normalisation.
struct Eig {
  float tau, s, sk, invlam;
  int pole;
  template <bool FAST>
  __device__ __forceinline__ void entry(int i, float dlti, const float* tb,
                                        float& gpi, float& gmi) const {
    const float b = dlti - tau;
    const float v = FAST ? quotient(s, b) : (i == pole ? 1.0f : s / b);
    const float invmu = tb[kInvmu + i];
    const float D = invmu * (sk * v);
    const float si = -D * invmu * invlam;
    gpi = 0.5f * (si + D);
    gmi = 0.5f * (si - D);
  }
};

// The eigenvector's max over i (FAST: all kM terms, the padded ones
// zeros; else i < n).
template <bool FAST>
__device__ __forceinline__ float eig_max(const Eig& g, const float* dlt,
                                         int n, const float* tb) {
  float mx = 0.0f;
#pragma unroll 16
  for (int i = 0; i < kM; ++i) {
    if (FAST || i < n) {
      float gpi, gmi;
      g.entry<FAST>(i, dlt[i], tb, gpi, gmi);
      float m = (i == 0) ? fabsf(gpi) : mx;
      m = max_nan(m, fabsf(gpi));
      mx = max_nan(m, fabsf(gmi));
    }
  }
  return mx;
}

// The normalised column k of gp and gm to device memory (entry (i, k) at
// gp[(i n + k) lb + e]) and, in the beam variant, of S = gp + gm and its
// copy into the element's staging (st, null in the thermal variant).
template <bool FAST>
__device__ __forceinline__ void eig_store(const Eig& g, const float* dlt,
                                          int n, const float* tb, float inv,
                                          int k, int64_t lb, int64_t e,
                                          bool store, float* __restrict__ gp,
                                          float* __restrict__ gm, float* st) {
  for (int i = 0; i < n; ++i) {
    float gpi, gmi;
    g.entry<FAST>(i, dlt[i], tb, gpi, gmi);
    const float gpn = gpi * inv;
    const float gmn = gmi * inv;
    if (store) {
      const int64_t o = static_cast<int64_t>(i * n + k) * lb + e;
      gp[o] = gpn;
      gm[o] = gmn;
    }
    if (st != nullptr) {
      const float sik = gpn + gmn;
      st[kS + i * kLd + k] = sik;
      st[kA + i * kLd + k] = sik;
    }
  }
}

template <bool BEAM>
__global__ void __launch_bounds__(Shape<BEAM>::kThreads)
stage1_isotropic_huge_kernel(const float* __restrict__ ssa_in,
                             const float* __restrict__ dtau_in,
                             const float* __restrict__ btop_in,
                             const float* __restrict__ slope_in,
                             const float* __restrict__ fbeam_in,
                             const float* __restrict__ mur_in,
                             float* __restrict__ gp, float* __restrict__ gm,
                             float* __restrict__ lam,
                             float* __restrict__ expd,
                             float* __restrict__ y0p,
                             float* __restrict__ y0m, float* __restrict__ y1,
                             float* __restrict__ zp, float* __restrict__ zm,
                             int n, int bisect, int64_t lb, int64_t B,
                             const float* __restrict__ tab) {
  constexpr int kElems = Shape<BEAM>::kElems;
  constexpr int kThreads = Shape<BEAM>::kThreads;
  extern __shared__ __align__(16) float smem[];
  float* tb = smem;
  // kernels.wide_isotropic_tables (delta (n + 1, n), origin (n + 1), then
  // half, c, d, invmu, mu, w, n each) into the padded layout
  for (int i = static_cast<int>(threadIdx.x); i < kTab; i += kThreads) {
    int src = -1;
    if (i < kOrigin) {
      const int row = i / kLd;
      const int j = i - row * kLd;
      if (row <= n && j < n) src = row * n + j;
    } else if (i < kHalf) {
      const int j = i - kOrigin;
      if (j <= n) src = (n + 1) * n + j;
    } else {
      const int q = (i - kHalf) / kM;
      const int j = i - kHalf - q * kM;
      if (j < n && q < 6) src = (n + 1) * (n + 1) + q * n + j;
    }
    tb[i] = src >= 0 ? tab[src] : (i < kOrigin ? kPad : 0.0f);
  }
  __syncthreads();

  const int t = static_cast<int>(threadIdx.x) & 31;
  const int el = static_cast<int>(threadIdx.x) >> 5;
  const int64_t e0 = static_cast<int64_t>(blockIdx.x) * kElems;
  // a warp past the end computes the last element and stores nothing
  const bool mine = e0 + el < lb;
  const int64_t e = mine ? e0 + el : lb - 1;
  const float ssa = ssa_in[e];
  const float dtau = dtau_in[e];
  const float slope = slope_in[e];
  const float btop = btop_in[e];
  float* st = BEAM ? smem + kTab + el * kBeamStage : nullptr;
  const float* c = tb + kC;

  for (int k = t; k < n; k += 32) {              // the lane's roots
    const float h = tb[kHalf + k];
    // f at the bracket's midpoint, from the upper pole: root above it?
    const bool up = s_f(-h, h, tb + (k + 1) * kLd, n - 1 - k, n, ssa, c)
                    > 0.0f;
    const float* dlt = tb + (up ? k + 1 : k) * kLd;
    const int pole = up ? n - 1 - k : n - k;      // n: origin 0, no pole
    const bool flip = !up && k > 0;               // s = -tau < 0
    const bool zero = !up && k == 0;              // s = 1
    const float sgn = up ? -1.0f : 1.0f;          // tau = sgn a
    int lo = 0;
    int hi = __float_as_int(h);
    for (int it = 0; it < bisect; ++it) {
      const int m = lo + ((hi - lo) >> 1);
      const float tau = sgn * __int_as_float(m);
      const float s = zero ? 1.0f : -tau;
      const float g = s_f(tau, s, dlt, pole, n, ssa, c);
      const bool pos = flip ? g < 0.0f : g > 0.0f;   // f > 0: root above
      const bool grow = pos != up;                   // root at larger a
      lo = grow ? m : lo;
      hi = grow ? hi : m;
    }
    const float tlo = up ? -__int_as_float(hi) : __int_as_float(lo);
    const float thi = up ? -__int_as_float(lo) : __int_as_float(hi);
    float tau = sgn * __int_as_float(lo + ((hi - lo) >> 1));
    for (int it = 0; it < kNewton; ++it) {
      float fs = 0.0f;
      float fps = 0.0f;
      newton_sums<true>(tau, dlt, n, c, fs, fps);
      if (!in_range(tau)) newton_sums<false>(tau, dlt, n, c, fs, fps);
      const float f = 1.0f + ssa * fs;
      const float fp = -ssa * fps;
      const float fp_safe = fp < -1e-30f ? fp : -1e-30f;
      float tn = tau - f / fp_safe;
      // clip as torch.maximum/minimum do: a NaN stays NaN, rejected below
      tn = tn < tlo ? tlo : tn;
      tn = tn > thi ? thi : tn;
      tau = isfinite(tn) ? tn : tau;
    }
    const float xk = tb[kOrigin + (up ? k + 1 : k)] + tau;
    if (BEAM) st[kXk + k] = xk;
    const float s = zero ? 1.0f : -tau;
    const float sk = (flip ? -1.0f : 1.0f) * ((k & 1) ? -1.0f : 1.0f);
    const float lamk = sqrtf(clamp_min_nan(xk, 1e-12f));
    const Eig g{tau, s, sk, 1.0f / lamk, pole};
    const bool fast = in_range(s);
    const float mx = fast ? eig_max<true>(g, dlt, n, tb)
                          : eig_max<false>(g, dlt, n, tb);
    const float inv = 1.0f / clamp_min_nan(mx, 1e-30f);
    if (fast) {
      eig_store<true>(g, dlt, n, tb, inv, k, lb, e, mine, gp, gm, st);
    } else {
      eig_store<false>(g, dlt, n, tb, inv, k, lb, e, mine, gp, gm, st);
    }
    if (mine) {
      const int64_t o = static_cast<int64_t>(k) * lb + e;
      const float muk = tb[kMu + k];
      lam[o] = lamk;
      expd[o] = expf(-lamk * dtau);
      y1[o] = slope;
      y0p[o] = btop + muk * slope;
      y0m[o] = btop - muk * slope;
    }
  }

  if constexpr (BEAM) {
    const float qs = static_cast<float>(kTwoKappa) * (ssa * fbeam_in[e % B]);
    const float mur = mur_in[e];
    for (int i = t; i < n; i += 32) st[kA + i * kLd + n] = qs * tb[kD + i];
    __syncwarp();
    warp_lu_solve(st + kA, kLd, n, 1, t);
    // lane k: the scaled coefficients of modes k and k + 32
    const float inv_mur2 = 1.0f / (mur * mur);
    for (int k = t; k < n; k += 32) {
      const float lam2k = clamp_min_nan(st[kXk + k], 1e-12f);
      float den = lam2k - inv_mur2;
      const float floor = 1e-4f * (lam2k + inv_mur2);
      den = fabsf(den) < floor ? (den < 0.0f ? -floor : floor) : den;
      st[kSc + k] = st[kA + k * kLd + n] / den;
    }
    __syncwarp();
    // lane i: zs_i = sum_j S[i][j] scaled_j, S unfactored
    for (int i = t; i < n; i += 32) {
      float zs = st[kS + i * kLd] * st[kSc];
      for (int j = 1; j < n; ++j) {
        zs = zs + st[kS + i * kLd + j] * st[kSc + j];
      }
      st[kZs + i] = zs;
    }
    __syncwarp();
    float wz = tb[kW] * st[kZs];
    for (int i = 1; i < n; ++i) wz = wz + tb[kW + i] * st[kZs + i];
    if (mine) {
      for (int i = t; i < n; i += 32) {
        const float zs = st[kZs + i];
        const float uz = zs - ssa * wz;          // (I - ssa 1 w^T) zs
        const float zd = -mur * (uz - qs) * tb[kInvmu + i];
        zp[i * lb + e] = 0.5f * (zs + zd);
        zm[i * lb + e] = 0.5f * (zs - zd);
      }
    }
  }
}

// The attribute belongs to the current device: set it before every launch
// (and every occupancy query).
template <bool BEAM>
cudaError_t allow_smem() {
  return cudaFuncSetAttribute(stage1_isotropic_huge_kernel<BEAM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Shape<BEAM>::kSmemBytes);
}

template <bool BEAM>
int launch(int n, const float* ssa, const float* dtau, const float* btop,
           const float* slope, const float* fbeam, const float* mur,
           float* gp, float* gm, float* lam, float* expd, float* y0p,
           float* y0m, float* y1, float* zp, float* zm, int bisect,
           long long lb, long long B, const float* tab, cudaStream_t s) {
  using S = Shape<BEAM>;
  const cudaError_t err = allow_smem<BEAM>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto grid = static_cast<unsigned>((lb + S::kElems - 1) / S::kElems);
  stage1_isotropic_huge_kernel<BEAM><<<grid, S::kThreads, S::kSmemBytes, s>>>(
      ssa, dtau, btop, slope, fbeam, mur, gp, gm, lam, expd, y0p, y0m, y1,
      zp, zm, n, bisect, lb, B, tab);
  return static_cast<int>(cudaGetLastError());
}

template <bool BEAM>
int occupancy() {
  if (allow_smem<BEAM>() != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, stage1_isotropic_huge_kernel<BEAM>, Shape<BEAM>::kThreads,
          Shape<BEAM>::kSmemBytes) != cudaSuccess)
    return -1;
  return blocks * Shape<BEAM>::kElems;
}

}  // namespace

// As pyharp_stage1_isotropic_big (stage1_isotropic_big.cu), for n =
// 33..64; tab is kernels.wide_isotropic_tables.
PYHARP_API int pyharp_stage1_isotropic_huge(
    int n, int beam, const float* ssa, const float* dtau, const float* btop,
    const float* slope, const float* fbeam, const float* mur, float* gp,
    float* gm, float* lam, float* expd, float* y0p, float* y0m, float* y1,
    float* zp, float* zm, int bisect, long long lb, long long B,
    const float* tab, void* stream) {
  if (n < kHugeMinN || n > kHugeMaxN) return PYHARP_UNSUPPORTED_N;
  if (lb == 0) return 0;
  auto s = static_cast<cudaStream_t>(stream);
  return beam ? launch<true>(n, ssa, dtau, btop, slope, fbeam, mur, gp, gm,
                             lam, expd, y0p, y0m, y1, zp, zm, bisect, lb, B,
                             tab, s)
              : launch<false>(n, ssa, dtau, btop, slope, fbeam, mur, gp, gm,
                              lam, expd, y0p, y0m, y1, zp, zm, bisect, lb, B,
                              tab, s);
}

// Elements resident on an SM by the occupancy calculator, the thermal
// (beam 0) or the beam variant.
PYHARP_API int pyharp_stage1_isotropic_huge_occupancy(int beam) {
  return beam ? occupancy<true>() : occupancy<false>();
}
