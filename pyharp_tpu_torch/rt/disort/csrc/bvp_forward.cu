// K2: forward elimination of the layer-coupling boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:754 (_bvp_fwd_kernel),
// reached through _bvp_forward (:1180).
//
// Each column b walks the L layers top-down.  A layer builds and solves its
// 2N x 2N diagonal block against N unit columns and the right-hand side
// (the augmented 2N x (3N + 1) system) and writes P_l (2N x N) and g_l
// (2N) for the backward sweep.  The carry between layers is the condensed
// Q = R_l P_l (N x N) and rg = R_l g_l (N), R_l = [gm E, gp]: the same
// products the Pallas kernel forms at the start of the next layer, formed
// while P_l is at hand.
//
// Bound on the H100: latency and instruction rate.  Per column and layer it
// reads (2N^2 + 3N)*4 bytes and writes (2N^2 + 2N)*4 bytes against ~1600
// flops (N = 4) or ~10,000 (N = 8) and a serial chain of pivot selects,
// and the layer loop is serial, so the only parallelism is the B columns.
//
// Three bodies, chosen by N in pyharp_bvp_forward:
//
// N <= 6: one thread per column, common.cuh's bvp_forward_layer (shared
// with K6), the 8 x 13 system (N = 4) and the carry in registers.  It
// reaches 64-78% of its bound at N <= 4 with no spills; the team body
// below, run at N = 2 and 4, took 2.9-3.5x as long on the same paths
// (PERF.md).  At N = 5 and 6 it holds the system in 255 registers (and
// spills 2.5 KB at N = 6) and still took 0.27x and 0.72x the half-warp
// team's time on aerosol_16str_beam's configuration on an H100 (PERF.md).
//
// N = 7 (nstr 14): a team of 16 lanes per column, two columns per warp
// (bvp_forward_half_kernel; one thread spills 5 KB of the 14 x 22 system
// and took ~2.2x as long on an H100, PERF.md; a team of 2N lanes would
// straddle a warp).  The team does at 16 lanes what bvp_forward_wide.cu
// does at 32: the system's rows and block columns sit at fixed positions,
// the upper block's at 0..N-1 and the lower block's at 8..8+N-1; lane p
// owns the block column at position p, lanes p < N also unit column p and
// lane 8 the right-hand side.  Loops run over the 16 positions and skip
// the empty ones, so every register index is a constant and the
// elimination is the unpadded one, step for step.  The swap bits
// of pivot c are the records of the pivot column: lane c puts its column
// in shared memory, lane r takes |a_r|, and row r swaps where |a_r| beats
// the prefix max of |a_k|, c <= k < r (four shuffles, fmaxf skipping NaNs,
// a NaN pivot standing as +inf), then a ballot: the bits of the plain
// bubble and of the plain lu_solve's records.  The swaps are selects, by
// groups of 4 rows skipped where neither column of the warp swaps one.
// Multipliers and the upper triangle come by shuffle within the half warp;
// back substitution reuses the pivots' reciprocals; gm E (formed once by
// the lower block's lanes), Q and rg live in shared memory per column.  A
// block of 16 columns stages each layer's gp, gm, E and dblk with
// cp.async, two stages, while the previous layer is solved, and P_l, g_l
// leave through a shared buffer in coalesced stores; each thread copies
// one run of slots per tensor with stepped pointers (a select of the
// source per copy took 13% more at N = 7 on an H100, PERF.md).  4 blocks
// an SM (64 registers).
//
// N = 8: a team of 2N = 16 lanes per column, two columns per warp (one
// thread would hold the 16 x 25 system in 255 registers, spill ~9 KB and
// run 8 warps per SM; PERF.md): common.cuh's team_forward_sweep, which
// K6 runs as its forward sweep at N = 8.  Lane j owns block column j of
// the system and one right-hand-side column; the pivot lane replays the
// plain bubble and broadcasts the swap bits; layer inputs are staged by
// cp.async, P_l and g_l leave in coalesced stores (the design is written
// out in common.cuh).  Every entry is formed by the same operations as in
// bvp_forward_layer, so the team is bit-equal to the per-thread body.
// Registers and spills: chip_smoke.py phase 1 prints them.

#include "common.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(64)
bvp_forward_kernel(const float* __restrict__ gp_in,
                   const float* __restrict__ gm_in,
                   const float* __restrict__ e_in,
                   const float* __restrict__ d_in,
                   const float* __restrict__ albedo,
                   float* __restrict__ p_out, float* __restrict__ g_out,
                   int L, int64_t B, FloatN<N> wmu) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const float alb = albedo[b];

  float Q[N][N];
  float rg[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    rg[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) Q[i][j] = 0.0f;
  }

  for (int l = 0; l < L; ++l) {
    const int64_t o = static_cast<int64_t>(l) * B + b;
    bvp_forward_layer<N>(gp_in, gm_in, e_in, d_in, LB, o, l == L - 1, alb,
                         wmu, Q, rg, p_out + o, g_out + o, LB);
  }
}

template <int N>
int launch(const float* gp, const float* gm, const float* expd,
           const float* dblk, const float* albedo, float* p_out, float* g_out,
           int L, int64_t B, const FloatN<N>& w, cudaStream_t stream) {
  constexpr int kThreads = 64;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  bvp_forward_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      gp, gm, expd, dblk, albedo, p_out, g_out, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

// ---- the half-warp team (N = 7) -----------------------------------------

constexpr int kHalfLanes = 16;
constexpr int kHalfLow = 8;     // position of the lower block's first row

// Launch geometry and shared memory of the half-warp team's block: two
// stages of a layer's inputs and one of its outputs (slots as TeamGeom's),
// then per column the pivot column (16 floats, 16-byte aligned), the
// pivots' reciprocals (16), the layer's gm E and Q (N rows of kRow floats
// each, read a row at a time in two 16-byte loads) and rg (kRow).
template <int N>
struct HalfGeom {
  static constexpr int kThreads = 256;
  static constexpr int kCols = kThreads / kHalfLanes;
  static constexpr int kPad = kCols + 1;
  static constexpr int kIn = 2 * N * N + 3 * N;
  static constexpr int kOut = 2 * N * N + 2 * N;
  static constexpr int kColBase = ((2 * kIn + kOut) * kPad + 3) / 4 * 4;
  static constexpr int kRow = 8;
  static constexpr int kColFloats = 2 * kHalfLanes + (2 * N + 1) * kRow;
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float))
      * (kColBase + kCols * kColFloats);
  static_assert(N <= kRow, "a block of the system has at most 8 rows");
  static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory over 48 KB");
};

// threadIdx.x read afresh where it is called: what is formed from it is
// not hoisted out of the loop around the call, and so is not held in a
// register through that loop.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Whether position p holds a row (a block column), and which.
template <int N>
__device__ __forceinline__ bool half_live(int p) { return (p & 7) < N; }
template <int N>
__device__ __forceinline__ int half_row_at(int p) {
  return p < kHalfLow ? p : N + p - kHalfLow;
}

// One layer on lane p of a column's half warp: block column p of
// [ -[gm, gp E] + Q [gp, gm E] ; [gp E, gm] ] (the Lambertian fold on the
// last layer), the lane's right-hand-side column, the elimination, the
// lane's solution column into `out` (P at r*N + p, g at 2N^2 + r), then
// the carry: Q into `q` (N rows of kRow), then rg at q + N * kRow (from
// the rhs lane).
// `pc` holds the pivot column, then the pivots' reciprocals (shared with
// back substitution, which divides by the same pivots) and gm E, which
// the lanes of the lower block form in the build and the carry reads.
// Every lane of the warp calls it.
template <int N>
__device__ __forceinline__ void half_forward_layer(
    const float* in, float* out, float* q, float* pc, int p, bool last,
    float alb, const FloatN<N>& wmu) {
  constexpr unsigned kFull = 0xffffffffu;
  constexpr int kPad = HalfGeom<N>::kPad;
  constexpr int kRow = HalfGeom<N>::kRow;
  constexpr int nn = N * N;
  auto at = [&](int s) { return in[s * kPad]; };
  // row i of an N x kRow array in shared memory
  auto row8 = [](const float* m, int i, float (&v)[kRow]) {
    const float4 x = reinterpret_cast<const float4*>(m + i * kRow)[0];
    const float4 y = reinterpret_cast<const float4*>(m + i * kRow)[1];
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  };
  const bool lo = p < kHalfLow;
  const int jj = half_live<N>(p) ? (p & 7) : 0;   // idle lanes read column 0
  const int half = static_cast<int>(threadIdx.x) & kHalfLanes;
  float* pinv = pc + kHalfLanes;
  float* gme = pinv + kHalfLanes;
  float* rg = q + N * kRow;

  float a[kHalfLanes] = {};
  {
    const float ej = at(2 * nn + jj);
    float gpc[N];
    float gmc[N];
#pragma unroll
    for (int k = 0; k < N; ++k) {
      gpc[k] = at(k * N + jj);
      gmc[k] = at(nn + k * N + jj);
    }
    if (!lo && half_live<N>(p)) {
      // gm E by columns, as the carry forms R = [gm E, gp] below
#pragma unroll
      for (int k = 0; k < N; ++k) gme[k * kRow + jj] = gmc[k] * ej;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float ttop = lo ? gmc[i] : gpc[i] * ej;
      float qi[kRow];
      row8(q, i, qi);
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float dkj = lo ? gpc[k] : gmc[k] * ej;
        acc = (k == 0) ? qi[0] * dkj : acc + qi[k] * dkj;
      }
      a[i] = -ttop + acc;
      a[kHalfLow + i] = lo ? gpc[i] * ej : gmc[i];
    }
    if (last) {
      // Lambertian reflection: Blow -= 2 albedo sum_r wmu_r Rn[r]
      const float alb2 = 2.0f * alb;
      float refl = 0.0f;
#pragma unroll
      for (int r = 0; r < N; ++r) {
        const float rn = lo ? gmc[r] * ej : gpc[r];
        refl = (r == 0) ? wmu.v[0] * rn : refl + wmu.v[r] * rn;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) a[kHalfLow + i] = a[kHalfLow + i] - alb2 * refl;
    }
  }
  // the lane's rhs column: unit column p (p < N) or [d_top - rg ; d_bot]
  const bool rhs = p == kHalfLow;
  float u[kHalfLanes];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float dt = at(2 * nn + N + i);
    const float db = at(2 * nn + 2 * N + i);
    u[i] = rhs ? dt - rg[i] : 0.0f;   // rg read before the carry below
    u[kHalfLow + i] = rhs ? db : ((p == i) ? 1.0f : 0.0f);
  }

  // LU with the plain version's bubble pivoting, over the live positions
#pragma unroll
  for (int c = 0; c < kHalfLanes; ++c) {
    if (!half_live<N>(c)) continue;
    // the swap bits: lane c's column, an entry a lane, then the running
    // max of |a_k| over c <= k < r by a prefix max over the lanes
    if (p == c) {
#pragma unroll
      for (int r4 = c / 4; r4 < kHalfLanes / 4; ++r4) {
        reinterpret_cast<float4*>(pc)[r4] =
            make_float4(a[4 * r4], a[4 * r4 + 1], a[4 * r4 + 2], a[4 * r4 + 3]);
      }
    }
    __syncwarp(kFull);
    const float x = fabsf(pc[p]);
    __syncwarp(kFull);                 // read before the next pivot's store
    const bool cand = p > c && half_live<N>(p);
    float run = p == c ? (x != x ? INFINITY : x) : (cand ? x : -1.0f);
#pragma unroll
    for (int d = 1; d < kHalfLanes; d *= 2) {
      const float y = __shfl_up_sync(kFull, run, d, kHalfLanes);
      if (p >= d) run = fmaxf(run, y);
    }
    const float before = __shfl_up_sync(kFull, run, 1, kHalfLanes);
    const unsigned vote = __ballot_sync(kFull, cand && x > before);
    const unsigned bits = vote >> half;
    const unsigned any = vote | (vote >> kHalfLanes);   // either column
    // the swaps in the bubble's order, by selects (the two columns of the
    // warp have their own bits), rows in groups of 4 skipped whole where
    // neither column swaps one (a test the same in the whole warp)
#pragma unroll
    for (int g4 = (c + 1) / 4; g4 < kHalfLanes / 4; ++g4) {
      if ((any >> (4 * g4)) & 0xfu) {
#pragma unroll
        for (int r = 4 * g4; r < 4 * g4 + 4; ++r) {
          if (r <= c || !half_live<N>(r)) continue;
          const bool sw = (bits >> r) & 1u;
          const float ha = sw ? a[r] : a[c];
          const float la = sw ? a[c] : a[r];
          const float hu = sw ? u[r] : u[c];
          const float lu = sw ? u[c] : u[r];
          a[c] = ha;
          a[r] = la;
          u[c] = hu;
          u[r] = lu;
        }
      }
    }
    const float inv = 1.0f / __shfl_sync(kFull, a[c], c, kHalfLanes);
    if (p == c) pinv[c] = inv;
#pragma unroll
    for (int r = c + 1; r < kHalfLanes; ++r) {
      if (!half_live<N>(r)) continue;
      const float f = __shfl_sync(kFull, a[r], c, kHalfLanes) * inv;
      a[r] = a[r] - f * a[c];
      u[r] = u[r] - f * u[c];
    }
  }
  // back substitution, times the pivot's reciprocal as bvp_forward_layer
  // does; the solution overwrites u
  __syncwarp(kFull);                 // the reciprocals are stored
#pragma unroll
  for (int row = kHalfLanes - 1; row >= 0; --row) {
    if (!half_live<N>(row)) continue;
    const float inv = pinv[row];
    float acc = u[row];
#pragma unroll
    for (int c = row + 1; c < kHalfLanes; ++c) {
      if (!half_live<N>(c)) continue;
      acc = acc - __shfl_sync(kFull, a[row], c, kHalfLanes) * u[c];
    }
    u[row] = acc * inv;
  }

  // P_l[r][p] = x_p[r] (p < N), g_l = the rhs lane's x; then the carry
  if (p < N || rhs) {
#pragma unroll
    for (int s = 0; s < kHalfLanes; ++s) {
      if (!half_live<N>(s)) continue;
      const int r = half_row_at<N>(s);
      out[(rhs ? 2 * nn + r : r * N + p) * kPad] = u[s];
    }
  }
  __syncwarp(kFull);                 // the build's reads of Q are done
  // one row of the carry at a time (unrolled, the rows' sums held the
  // registers the body has not got at N = 7)
#pragma unroll 1
  for (int i = 0; i < N; ++i) {
    float ge[kRow];
    row8(gme, i, ge);
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < kHalfLanes; ++s) {
      if (!half_live<N>(s)) continue;
      const float rn = s < kHalfLow ? ge[s] : at(i * N + s - kHalfLow);
      acc = (s == 0) ? rn * u[0] : acc + rn * u[s];
    }
    if (p < N) q[i * kRow + p] = acc;
    if (rhs) rg[i] = acc;
  }
}

template <int N>
__global__ void __launch_bounds__(HalfGeom<N>::kThreads, 4)
bvp_forward_half_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ albedo,
                        float* __restrict__ p_out, float* __restrict__ g_out,
                        int L, int64_t B, FloatN<N> wmu) {
  using G = HalfGeom<N>;
  extern __shared__ __align__(16) float smem[];
  constexpr int kStage = G::kIn * G::kPad;
  float* stage = smem;                               // [2][kIn][kPad]
  float* outb = stage + 2 * kStage;                  // [kOut][kPad]
  const int tid = static_cast<int>(threadIdx.x);
  const int p = tid % kHalfLanes;
  const int col = tid / kHalfLanes;
  float* pc = smem + G::kColBase + col * G::kColFloats;
  float* q = pc + 2 * kHalfLanes + N * G::kRow;
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G::kCols;
  const int64_t LB = static_cast<int64_t>(L) * B;

  // Staging: thread t moves column t % kCols of the slots t / kCols,
  // t / kCols + kStep, ..., one run of slots per tensor, its pointers
  // stepped by kStep rows.  The layer's offset l*B + b0 is the same in the
  // whole block; the thread's part is formed afresh at each use (held
  // through the sweep, its 64-bit offsets were spilled).
  constexpr int kStep = G::kThreads / G::kCols;
  const int cols = static_cast<int>(B - b0 < G::kCols ? B - b0 : G::kCols);
  auto stage_rows = [&](const float* src, int rows, float* dst, int64_t o) {
    const int t = fresh_tid();
    const int c = t % G::kCols;
    const int s0 = t / G::kCols;
    const int cr = c < cols ? c : cols - 1;        // past B: column B - 1
    const float* from = src + o + (cr + s0 * LB);
    float* to = dst + s0 * G::kPad + c;
    for (int s = s0; s < rows; s += kStep) {
      cp_async4(to, from);
      from += kStep * LB;
      to += kStep * G::kPad;
    }
  };
  auto prefetch = [&](int l, float* dst) {
    const int64_t o = static_cast<int64_t>(l) * B + b0;
    stage_rows(gp_in, N * N, dst, o);
    stage_rows(gm_in, N * N, dst + N * N * G::kPad, o);
    stage_rows(e_in, N, dst + 2 * N * N * G::kPad, o);
    stage_rows(d_in, 2 * N, dst + (2 * N * N + N) * G::kPad, o);
    cp_async_commit();
  };
  auto store_rows = [&](const float* src, int rows, float* dst, int64_t o) {
    const int t = fresh_tid();
    const int c = t % G::kCols;
    const int s0 = t / G::kCols;
    if (c >= cols) return;                         // past B
    const float* from = src + s0 * G::kPad + c;
    float* to = dst + o + (c + s0 * LB);
    for (int s = s0; s < rows; s += kStep) {
      *to = *from;
      from += kStep * G::kPad;
      to += kStep * LB;
    }
  };

  for (int k = p; k < (N + 1) * G::kRow; k += kHalfLanes) q[k] = 0.0f;  // Q, rg
  prefetch(0, stage);

  for (int l = 0; l < L; ++l) {
    cp_async_wait_all();
    __syncthreads();                 // layer l staged; last outputs stored
    if (l + 1 < L) prefetch(l + 1, stage + ((l + 1) & 1) * kStage);
    // the albedo is read where it is used, not held through the sweep
    const bool last = l == L - 1;
    const float alb = last ? albedo[b0 + (col < cols ? col : cols - 1)] : 0.0f;
    half_forward_layer<N>(stage + (l & 1) * kStage + col, outb + col, q, pc,
                          p, last, alb, wmu);
    __syncthreads();                 // the layer's outputs are staged
    const int64_t o = static_cast<int64_t>(l) * B + b0;
    store_rows(outb, 2 * N * N, p_out, o);
    store_rows(outb + 2 * N * N * G::kPad, 2 * N, g_out, o);
  }
}

template <int N>
int launch_half(const float* gp, const float* gm, const float* expd,
                const float* dblk, const float* albedo, float* p_out,
                float* g_out, int L, int64_t B, const FloatN<N>& w,
                cudaStream_t stream) {
  using G = HalfGeom<N>;
  const int64_t blocks = (B + G::kCols - 1) / G::kCols;
  bvp_forward_half_kernel<N><<<static_cast<unsigned>(blocks), G::kThreads,
                               G::kSmemBytes, stream>>>(
      gp, gm, expd, dblk, albedo, p_out, g_out, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

// ---- the team kernel (N = 8): common.cuh's team_forward_sweep ----------

template <int N>
__global__ void __launch_bounds__(TeamGeom<N>::kThreads, 3)
bvp_forward_team_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ albedo,
                        float* __restrict__ p_out, float* __restrict__ g_out,
                        int L, int64_t B, FloatN<N> wmu) {
  extern __shared__ float smem[];
  team_forward_sweep<N>(gp_in, gm_in, e_in, d_in, albedo, p_out, g_out, L, B,
                        wmu, smem);
}

template <int N>
int launch_team(const float* gp, const float* gm, const float* expd,
                const float* dblk, const float* albedo, float* p_out,
                float* g_out, int L, int64_t B, const FloatN<N>& w,
                cudaStream_t stream) {
  using G = TeamGeom<N>;
  const int64_t blocks = (B + G::kCols - 1) / G::kCols;
  bvp_forward_team_kernel<N><<<static_cast<unsigned>(blocks), G::kThreads,
                               G::kSmemBytes, stream>>>(
      gp, gm, expd, dblk, albedo, p_out, g_out, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
FloatN<N> host_wmu(const float* wmu) {
  FloatN<N> w;
  for (int i = 0; i < N; ++i) w.v[i] = wmu[i];
  return w;
}

}  // namespace

// Shapes: gp, gm (N,N,L,B); expd (N,L,B); dblk (2N,L,B); albedo (B);
// p_out (2N,N,L,B); g_out (2N,L,B).  wmu: host float32[n].
PYHARP_API int pyharp_bvp_forward(int n, const float* gp, const float* gm,
                                  const float* expd, const float* dblk,
                                  const float* albedo, float* p_out,
                                  float* g_out, int L, long long B,
                                  const float* wmu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B == 0 || L == 0) return n >= 1 && n <= 8 ? 0 : PYHARP_UNSUPPORTED_N;
  switch (n) {
    case 1: return launch<1>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<1>(wmu), s);
    case 2: return launch<2>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<2>(wmu), s);
    case 3: return launch<3>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<3>(wmu), s);
    case 4: return launch<4>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<4>(wmu), s);
    case 5: return launch<5>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<5>(wmu), s);
    case 6: return launch<6>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<6>(wmu), s);
    case 7: return launch_half<7>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<7>(wmu), s);
    case 8: return launch_team<8>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<8>(wmu), s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}

