// K2 at N = 9..16 (nstr 18..32): forward elimination of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:754 (_bvp_fwd_kernel),
// reached through _bvp_forward (:1180), at the N that bvp_forward.cu does
// not instantiate.  It computes what bvp_forward.cu computes (P_l, g_l of
// every layer, the condensed carry Q = R_l P_l, rg = R_l g_l between
// layers), in the same operation order.
//
// Bound on the H100: latency and instruction rate, as at N = 8.  Per column
// and layer it reads (2N^2 + 3N)*4 bytes and writes (2N^2 + 2N)*4 (4,288
// at N = 16) against ~(2N)^2 (3N + 1) ~ 50,000 flops of elimination at
// N = 16, and the layer loop is serial.
//
// Design: the team body of common.cuh's team_forward_sweep (N = 8), with a
// whole warp per column: one thread would hold the 2N x (3N + 1) system,
// 32 x 49 floats at N = 16.  One body serves N = 9..16 with N a run-time
// argument, so that 2N need not divide 32: the system's rows and columns
// sit at fixed positions, the upper block's at 0..N-1 and the lower
// block's at 16..16+N-1, and lane p owns the block column at position p.
// Loops over positions are unrolled over all 32 and skip the empty ones
// (a test on N, the same in every lane), so every register index is a
// constant and the active positions come in the system's own order: the
// elimination is the unpadded one, step for step.  The layer is compiled
// twice: for N = 16, where no position is empty and no test is left (the
// tests cost 1.6x the time there), and for N taken at run time.  Lane
// p < N also owns unit column p (which selects lower-block row N + p) and
// lane 16 the right-hand side.  The pivot: the plain bubble (strict |a_r| > |a_c|
// swaps over the live suffix) swaps exactly at the rows whose |a_r| beats
// the running max of |a_k|, c <= k < r, NaNs never beating and never
// counted (a NaN pivot stands as +inf); lane c spills its column to shared
// memory, each lane takes its row's entry, and a prefix max over the
// lanes (five shuffles, fmaxf skipping NaNs) and a ballot give every lane
// the swap bits, the same in the whole warp, in place of a 31-step chain
// of compare-selects in every lane.  Every lane applies the swaps to its
// own columns, a group of 8 rows at a time and none where no row of the
// group swaps; multipliers and the upper triangle come by shuffle; Q and
// rg live in shared memory per column, so that a thread needs at most 128
// registers (kMinBlocks = 4: 16 warps an SM; at 167 registers, 12 warps,
// the body took 1.3x as long).  A block of kCols = 4 columns
// stages each layer's gp, gm, E and dblk with cp.async, two stages, while
// the previous layer is solved, and P_l, g_l leave through a shared buffer
// in coalesced stores: 38,144 bytes of shared memory for any N <= 16.
// Registers and spills: chip_smoke.py phase 1 prints them; PERF.md has the
// time of the body that came before (the bubble in every lane, rg in
// registers, 168 registers: 2.3x as long on an NVIDIA H100 80GB HBM3 at
// 700 W) beside this one's.

#include "wide.cuh"

namespace {

struct WideGeom {
  static constexpr int kThreads = 128;
  static constexpr int kCols = kThreads / 32;         // a warp per column
  // blocks an SM must hold: 4 caps a thread at 128 registers
  static constexpr int kMinBlocks = 4;
  static constexpr int kPad = kCols + 1;
  static constexpr int kInMax = 2 * kNMax * kNMax + 3 * kNMax;
  static constexpr int kOutMax = 2 * kNMax * kNMax + 2 * kNMax;
  // per column: Q (n x n), rg and the pivot column
  static constexpr int kColFloats = kNMax * kNMax + kNMax + 32;
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float))
      * ((2 * kInMax + kOutMax) * kPad + kCols * kColFloats);
  static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory over 48 KB");
};

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHalf = 16;   // position of the lower block's first row

// The row (column) of the system at position p, and whether p holds one.
__device__ __forceinline__ int row_at(int p, int n) {
  return p < kHalf ? p : n + p - kHalf;
}
__device__ __forceinline__ bool live(int p, int n) { return (p & 15) < n; }

// One layer on lane p of the column's warp: block column p of
// [ -[gm, gp E] + Q [gp, gm E] ; [gp E, gm] ] (the Lambertian fold on the
// last layer), the lane's right-hand-side column, the elimination, the
// lane's solution column into `out` (P at r*n + p, g at 2n^2 + r), then
// the carry: Q into `q` (row-major, n x n), then rg at q + kNMax^2 (from
// the rhs lane); q + kNMax^2 + kNMax holds the pivot column.
// NF = 16 compiles the layer for n = 16, every position live and no test
// on n left (the main path, nstr 32); NF = 0 takes n at run time.
template <int NF>
__device__ __forceinline__ void wide_forward_layer(
    const float* in, float* out, float* q, int p, int n_arg, bool last,
    float alb, const FloatN<kNMax>& wmu) {
  const int n = NF > 0 ? NF : n_arg;
  constexpr int kPad = WideGeom::kPad;
  auto at = [&](int s) { return in[s * kPad]; };
  const int nn = n * n;
  const bool lo = p < kHalf;
  const int jj = live(p, n) ? (p & 15) : 0;   // idle lanes read column 0
  float* rg = q + kNMax * kNMax;
  float* pc = rg + kNMax;

  float a[32] = {};
  {
    const float ej = at(2 * nn + jj);
    float gpc[kNMax];
    float gmc[kNMax];
#pragma unroll
    for (int k = 0; k < kNMax; ++k) {
      if (k < n) {
        gpc[k] = at(k * n + jj);
        gmc[k] = at(nn + k * n + jj);
      }
    }
#pragma unroll
    for (int i = 0; i < kNMax; ++i) {
      if (i < n) {
        const float ttop = lo ? gmc[i] : gpc[i] * ej;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < kNMax; ++k) {
          if (k < n) {
            const float dkj = lo ? gpc[k] : gmc[k] * ej;
            acc = (k == 0) ? q[i * n] * dkj : acc + q[i * n + k] * dkj;
          }
        }
        a[i] = -ttop + acc;
        a[kHalf + i] = lo ? gpc[i] * ej : gmc[i];
      }
    }
    if (last) {
      // Lambertian reflection: Blow -= 2 albedo sum_r wmu_r Rn[r]
      const float alb2 = 2.0f * alb;
      float refl = 0.0f;
#pragma unroll
      for (int r = 0; r < kNMax; ++r) {
        if (r < n) {
          const float rn = lo ? gmc[r] * ej : gpc[r];
          refl = (r == 0) ? wmu.v[0] * rn : refl + wmu.v[r] * rn;
        }
      }
#pragma unroll
      for (int i = 0; i < kNMax; ++i) {
        if (i < n) a[kHalf + i] = a[kHalf + i] - alb2 * refl;
      }
    }
  }
  // the lane's rhs column: unit column p (p < n) or [d_top - rg ; d_bot]
  const bool rhs = p == kHalf;
  float u[32];
#pragma unroll
  for (int i = 0; i < kNMax; ++i) {
    if (i < n) {
      const float dt = at(2 * nn + n + i);
      const float db = at(2 * nn + 2 * n + i);
      u[i] = rhs ? dt - rg[i] : 0.0f;   // rg read before the carry below
      u[kHalf + i] = rhs ? db : ((p == i) ? 1.0f : 0.0f);
    }
  }

  // LU with the plain version's bubble pivoting, over the live positions
#pragma unroll
  for (int c = 0; c < 32; ++c) {
    if (!live(c, n)) continue;
    // the swap bits: lane c's column, an entry a lane, then the running
    // max of |a_k| over c <= k < r by a prefix max over the lanes
    if (p == c) {
#pragma unroll
      for (int r4 = c / 4; r4 < 8; ++r4) {
        reinterpret_cast<float4*>(pc)[r4] =
            make_float4(a[4 * r4], a[4 * r4 + 1], a[4 * r4 + 2], a[4 * r4 + 3]);
      }
    }
    __syncwarp(kFull);
    const float x = fabsf(pc[p]);
    __syncwarp(kFull);                 // read before the next pivot's store
    const bool cand = p > c && live(p, n);
    float run = p == c ? (x != x ? INFINITY : x) : (cand ? x : -1.0f);
#pragma unroll
    for (int d = 1; d < 32; d *= 2) {
      const float y = __shfl_up_sync(kFull, run, d);
      if (p >= d) run = fmaxf(run, y);
    }
    const float before = __shfl_up_sync(kFull, run, 1);
    const unsigned bits = __ballot_sync(kFull, cand && x > before);
    // the swaps in the bubble's order, rows in groups of 8 skipped whole
    // where none swaps (bits are the same in every lane: no divergence)
#pragma unroll
    for (int g = (c + 1) / 8; g < 4; ++g) {
      if ((bits >> (8 * g)) & 0xffu) {
#pragma unroll
        for (int r = 8 * g; r < 8 * g + 8; ++r) {
          if (r <= c || !live(r, n)) continue;
          if ((bits >> r) & 1u) {
            const float ta = a[c];
            a[c] = a[r];
            a[r] = ta;
            const float tu = u[c];
            u[c] = u[r];
            u[r] = tu;
          }
        }
      }
    }
    const float inv = 1.0f / __shfl_sync(kFull, a[c], c);
#pragma unroll
    for (int r = c + 1; r < 32; ++r) {
      if (!live(r, n)) continue;
      const float f = __shfl_sync(kFull, a[r], c) * inv;
      a[r] = a[r] - f * a[c];
      u[r] = u[r] - f * u[c];
    }
  }
  // back substitution, times the pivot's reciprocal as bvp_forward_layer
  // does; the solution overwrites u
#pragma unroll
  for (int row = 31; row >= 0; --row) {
    if (!live(row, n)) continue;
    const float inv = 1.0f / __shfl_sync(kFull, a[row], row);
    float acc = u[row];
#pragma unroll
    for (int c = row + 1; c < 32; ++c) {
      if (!live(c, n)) continue;
      acc = acc - __shfl_sync(kFull, a[row], c) * u[c];
    }
    u[row] = acc * inv;
  }

  // P_l[r][p] = x_p[r] (p < n), g_l = the rhs lane's x; then the carry
  if (p < n || rhs) {
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      if (!live(s, n)) continue;
      const int r = row_at(s, n);
      out[(rhs ? 2 * nn + r : r * n + p) * kPad] = u[s];
    }
  }
  __syncwarp(kFull);                 // the build's reads of Q are done
#pragma unroll
  for (int i = 0; i < kNMax; ++i) {
    if (i < n) {
      float acc = 0.0f;
#pragma unroll
      for (int s = 0; s < 32; ++s) {
        if (!live(s, n)) continue;
        const float rn = s < kHalf ? at(nn + i * n + s) * at(2 * nn + s)
                                   : at(i * n + s - kHalf);
        acc = (s == 0) ? rn * u[0] : acc + rn * u[s];
      }
      if (p < n) q[i * n + p] = acc;
      if (rhs) rg[i] = acc;
    }
  }
}

__global__ void __launch_bounds__(WideGeom::kThreads, WideGeom::kMinBlocks)
bvp_forward_wide_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ albedo,
                        float* __restrict__ p_out, float* __restrict__ g_out,
                        int n, int L, int64_t B, FloatN<kNMax> wmu) {
  using G = WideGeom;
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = G::kInMax * G::kPad;
  const int nn = n * n;
  const int k_in = 2 * nn + 3 * n;
  const int k_out = 2 * nn + 2 * n;
  float* stage = smem;                               // [2][kInMax][kPad]
  float* outb = stage + 2 * kStage;                  // [kOutMax][kPad]
  const int tid = static_cast<int>(threadIdx.x);
  const int p = tid & 31;
  const int col = tid >> 5;
  float* q = outb + G::kOutMax * G::kPad + col * G::kColFloats;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G::kCols;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const float alb = albedo[b0 + col < B ? b0 + col : B - 1];

  auto prefetch = [&](int l, float* dst) {
    for (int idx = tid; idx < k_in * G::kCols; idx += G::kThreads) {
      const int s = idx / G::kCols;
      const int c = idx - s * G::kCols;
      const int64_t o = static_cast<int64_t>(l) * B
                        + (b0 + c < B ? b0 + c : B - 1);
      const float* src =
          s < nn ? gp_in + s * LB + o
          : s < 2 * nn ? gm_in + (s - nn) * LB + o
          : s < 2 * nn + n ? e_in + (s - 2 * nn) * LB + o
          : d_in + (s - 2 * nn - n) * LB + o;
      cp_async4(dst + s * G::kPad + c, src);
    }
    cp_async_commit();
  };

  for (int k = p; k < nn; k += 32) q[k] = 0.0f;
  if (p < kNMax) q[kNMax * kNMax + p] = 0.0f;     // rg
  prefetch(0, stage);

  for (int l = 0; l < L; ++l) {
    cp_async_wait_all();
    __syncthreads();                 // layer l staged; last outputs stored
    if (l + 1 < L) prefetch(l + 1, stage + ((l + 1) & 1) * kStage);
    if (n == kNMax) {
      wide_forward_layer<kNMax>(stage + (l & 1) * kStage + col, outb + col, q,
                                p, n, l == L - 1, alb, wmu);
    } else {
      wide_forward_layer<0>(stage + (l & 1) * kStage + col, outb + col, q, p,
                            n, l == L - 1, alb, wmu);
    }
    __syncthreads();                 // the layer's outputs are staged
    for (int idx = tid; idx < k_out * G::kCols; idx += G::kThreads) {
      const int s = idx / G::kCols;
      const int c = idx - s * G::kCols;
      if (b0 + c < B) {
        const int64_t o = static_cast<int64_t>(l) * B + b0 + c;
        float* dst = s < 2 * nn ? p_out + s * LB + o
                                : g_out + (s - 2 * nn) * LB + o;
        *dst = outb[s * G::kPad + c];
      }
    }
  }
}

}  // namespace

// As pyharp_bvp_forward (bvp_forward.cu), for n = 9..16.
PYHARP_API int pyharp_bvp_forward_wide(int n, const float* gp, const float* gm,
                                       const float* expd, const float* dblk,
                                       const float* albedo, float* p_out,
                                       float* g_out, int L, long long B,
                                       const float* wmu, void* stream) {
  if (n < kWideMinN || n > kNMax) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  FloatN<kNMax> w{};
  for (int i = 0; i < n; ++i) w.v[i] = wmu[i];
  using G = WideGeom;
  const auto blocks = static_cast<unsigned>((B + G::kCols - 1) / G::kCols);
  bvp_forward_wide_kernel<<<blocks, G::kThreads, G::kSmemBytes,
                            static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, dblk, albedo, p_out, g_out, n, L, B, w);
  return static_cast<int>(cudaGetLastError());
}
