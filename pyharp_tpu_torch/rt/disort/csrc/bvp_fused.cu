// K6: the whole layer-coupling boundary-value problem in one pass, forward
// elimination then back-substitution.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:964 (_bvp_fused_kernel),
// reached through solve_bvp_fused (:1078).
//
// The forward sweep is K2's, top-down, with the condensed carry (Q, rg).
// The backward sweep, bottom-up, is K5's in the (a, b) mode (x = g + P dx,
// written out; dx = gp a + (gm E) b) and K3's layer-top sums in the flux
// mode (fl (2, L, B)), with the bottom layer's raw (a, b) kept as ab_last
// (2N, B) instead of K3's contracted bottom-level row.  Every column walks
// exactly L layers; the albedo folds into the last layer only.
//
// Where P and g live.  The TPU kernel keeps the P (2N x N) and g (2N) of
// every layer in VMEM for a 128-column tile.  Here a column's are
// (2N^2 + 2N) L floats, 16 KB at N = 4, L = 100: for the tens of thousands
// of columns resident on the card that is hundreds of MB, far above the
// 50 MB L2 and the 132 x 227 KB of shared memory.  Written to device memory
// and read back, they make the same trip as K2's P/g output and K3's or
// K5's read of it, and the backward sweep reads gp, gm and E a second time:
// per column-layer at N = 4, ~170 floats moved against the 54 that the
// function needs (K2 reads 44 and writes 40, K3 reads 84 and writes 2).
//
// N <= 4: a segmented schedule, one thread per column.  The forward sweep
// (common.cuh's bvp_forward_layer) keeps only the carry, N^2 + N floats, at
// every S-th layer boundary, in a checkpoint scratch (ceil(L/S), N^2 + N, B)
// coalesced along B.  The backward sweep walks the segments bottom-up: it
// re-runs bvp_forward_layer over a segment's layers from its checkpoint
// (the same function, so the same bits), holds their P_l and g_l in
// registers (N <= 2) or in shared memory (N = 4, 160 S bytes per thread),
// and back-substitutes them.  Per column-layer at N = 4 that moves
// ~96 + 20/S floats from device memory: the inputs are read twice, the
// third read of gp, gm and E hits the cache right after the segment's
// recompute, and the checkpoints are small; the price is the forward
// arithmetic twice.  kSegment gives S per N, chosen on an NVIDIA H100 80GB
// HBM3 at 700 W among S = 1 (P/g of every layer through a scratch), 2, 3,
// 4 and 8 (PERF.md section 6): at N = 2 the forward is cheap and S = 3
// takes 0.72x the scratch design's time; at N = 4 (167 registers, 6 blocks
// of 64 per SM) the second forward sweep eats most of the saving, S = 2 is
// 0.94x on the bench inputs and 1.02x on amarsw-lbl, the least total over
// the two, and S >= 4 loses (fewer blocks per SM).
//
// N = 8: K2's team (common.cuh's team_forward_sweep: 16 lanes per column,
// 16 columns per block of 256 threads, cp.async staging in two stages),
// P/g to a scratch laid out as K2's output, (2N,N,L,B) and (2N,L,B), in
// coalesced stores; then the backward sweep on the same team: the layer's
// gp, gm, E (and tp, tm) and P_l, g_l staged by cp.async (each thread
// copies one column's slots at a constant stride per tensor: mapping every
// copy's slot to its tensor apart cost the sweep ~0.6 ms of instructions
// on the aerosol inputs, PERF.md section 6), lane r forms
// x_r = g_r + sum_k P[r][k] dx_k with dx from the lanes i < N by shuffle,
// in bvp_layer_coeffs' order; lanes i < N form dx_i in the order of
// bvp_layer_carry ((a, b) mode) or bvp_layer_flux (flux mode); the
// outputs leave through shared memory in coalesced stores.  N = 8 keeps
// the scratch: its forward sweep is bound by latency and instruction
// rate, not bytes (K2 runs at 15% of its byte bound), so recomputing it
// would cost far more than the scratch's round trip.
//
// Bound on the H100: memory.  Counting each input read once and each output
// written once (the scratch is not an input or an output), it reads
// (2N^2 + 3N) L floats and 1 per column, and in the flux mode tp and tm,
// 2N L more; it writes 2 L + 2N (flux mode) or 2N L ((a, b) mode) per
// column, against ~K2's flops plus ~14 N^2 L.  Registers and spills of
// every instantiation: chip_smoke.py phase 1.

#include "common.cuh"

namespace {

// Layers per segment at N <= 4.
template <int N>
constexpr int kSegment = N == 4 ? 2 : 3;

constexpr int kThreads = 64;  // threads per block at N <= 4

// P_l (2N x N) then g_l (2N): the floats of one layer's forward output.
template <int N>
constexpr int kLayerFloats = 2 * N * N + 2 * N;

// P/g of a segment in shared memory (N = 4) rather than registers.
template <int N>
constexpr bool kSegmentShared = N > 2;

// 20 KB at N = 4, so the launch needs no opt-in above 48 KB.
template <int N>
constexpr int segment_smem_bytes() {
  return kSegmentShared<N>
             ? static_cast<int>(sizeof(float)) * kSegment<N> * kLayerFloats<N>
                   * kThreads
             : 0;
}

// One layer of the backward sweep of column b from that layer's P and g
// (base pointers, element stride `stride`): (a, b) to out1/out2, or the
// layer-top sums to out1 and, on the bottom layer, its (a, b) to out2.
template <int N, bool FLUX>
__device__ __forceinline__ void backward_layer(
    const float* __restrict__ gp_in, const float* __restrict__ gm_in,
    const float* __restrict__ e_in, const float* __restrict__ tp_in,
    const float* __restrict__ tm_in, float* __restrict__ out1,
    float* __restrict__ out2, const float* p, const float* g, int64_t stride,
    int l, int L, int64_t B, int64_t b, const FloatN<N>& wmu,
    float (&dx)[N]) {
  constexpr int M = 2 * N;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const int64_t o = static_cast<int64_t>(l) * B + b;
  float x[M];
  bvp_layer_coeffs<N>(p, g, stride, dx, x);
  if (FLUX) {
    if (l == L - 1) {
#pragma unroll
      for (int i = 0; i < M; ++i) out2[i * B + b] = x[i];
    }
    float up_sum, dn_sum, upb_sum, dnb_sum;
    bvp_layer_flux<N, false>(gp_in, gm_in, e_in, tp_in, tm_in, LB, o, x, wmu,
                             false, nullptr, nullptr, B, dx, up_sum, dn_sum,
                             upb_sum, dnb_sum);
    out1[o] = up_sum;
    out1[LB + o] = dn_sum;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      out1[i * LB + o] = x[i];
      out2[i * LB + o] = x[N + i];
    }
    bvp_layer_carry<N>(gp_in, gm_in, e_in, LB, o, x, dx);
  }
}

// ---- N <= 4: one thread per column --------------------------------------

template <int N, bool FLUX>
__global__ void __launch_bounds__(kThreads)
bvp_fused_kernel(const float* __restrict__ gp_in,
                 const float* __restrict__ gm_in,
                 const float* __restrict__ e_in,
                 const float* __restrict__ d_in,
                 const float* __restrict__ albedo,
                 const float* __restrict__ tp_in,
                 const float* __restrict__ tm_in,
                 float* __restrict__ out1, float* __restrict__ out2,
                 float* __restrict__ scratch, int L, int64_t B,
                 FloatN<N> wmu) {
  constexpr int S = kSegment<N>;
  constexpr int P2 = 2 * N * N;             // P's floats; g follows
  constexpr int kLF = kLayerFloats<N>;
  constexpr int C = N * N + N;              // the carry: Q, then rg
  extern __shared__ float seg_smem[];
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const float alb = albedo[b];
  float Q[N][N];
  float rg[N];
  float dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    rg[i] = 0.0f;
    dx[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j) Q[i][j] = 0.0f;
  }
  // K6_FORWARD: layer l's forward step, its P/g to p (element stride
  // `stride`); K6_BACKWARD: layer l's back-substitution from p.  Macros, not
  // lambdas, so the forced inlining of the layer steps is kept.
#define K6_FORWARD(l, p, stride)                                            \
  bvp_forward_layer<N>(gp_in, gm_in, e_in, d_in, LB,                        \
                       static_cast<int64_t>(l) * B + b, (l) == L - 1, alb,   \
                       wmu, Q, rg, (p), (p) + P2 * (stride), (stride))
#define K6_BACKWARD(l, p, stride)                                           \
  backward_layer<N, FLUX>(gp_in, gm_in, e_in, tp_in, tm_in, out1, out2,     \
                          (p), (p) + P2 * (stride), (stride), (l), L, B, b, \
                          wmu, dx)

  // sweep 1: the carry entering every S-th layer to the checkpoints, up to
  // the last segment, whose carry stays in registers
  const int nseg = (L + S - 1) / S;
  float sink[kLF];                  // this sweep's P/g, never read
  for (int l = 0; l < (nseg - 1) * S; ++l) {
    if (l % S == 0) {
      float* ck = scratch + static_cast<int64_t>(l / S) * C * B + b;
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) ck[(i * N + j) * B] = Q[i][j];
        ck[(N * N + i) * B] = rg[i];
      }
    }
    K6_FORWARD(l, sink, 1);
  }
  // sweep 2: each segment bottom-up, recomputed from its checkpoint
  for (int seg = nseg - 1; seg >= 0; --seg) {
    const int l0 = seg * S;
    const int n = min(S, L - l0);
    if (seg < nseg - 1) {
      const float* ck = scratch + static_cast<int64_t>(seg) * C * B + b;
#pragma unroll
      for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j < N; ++j) Q[i][j] = ck[(i * N + j) * B];
        rg[i] = ck[(N * N + i) * B];
      }
    }
    if constexpr (kSegmentShared<N>) {
      // [S][kLF][kThreads]: thread-major, so a warp's accesses are
      // conflict-free
      float* buf = seg_smem + threadIdx.x;
      for (int t = 0; t < n; ++t) {
        K6_FORWARD(l0 + t, buf + t * kLF * kThreads, kThreads);
      }
      for (int t = n - 1; t >= 0; --t) {
        K6_BACKWARD(l0 + t, buf + t * kLF * kThreads, kThreads);
      }
    } else {
      float buf[S][kLF];            // registers: every index is static
#pragma unroll
      for (int t = 0; t < S; ++t) {
        if (t < n) K6_FORWARD(l0 + t, buf[t], 1);
      }
#pragma unroll
      for (int t = S - 1; t >= 0; --t) {
        if (t < n) K6_BACKWARD(l0 + t, buf[t], 1);
      }
    }
  }
#undef K6_FORWARD
#undef K6_BACKWARD
}

// ---- N = 8: the team kernel ----------------------------------------------

// Shared memory of the team's backward sweep: two stages of a layer's
// inputs and one of its outputs, slot-major with kCols columns per slot
// (padded by one).  Input slots: gp (i, k) at i*N + k, gm at N^2 + i*N + k,
// E at 2N^2 + k, in the flux mode tp at kTp + i and tm at kTm + i, then P
// (r, k) at kP + r*N + k and g at kG + r.  Output slots: a then b ((a, b)
// mode), or the up and down sums and, on the bottom layer, ab_last (flux).
template <int N, bool FLUX>
struct TeamBack {
  using G = TeamGeom<N>;
  static constexpr int kE = 2 * N * N;
  static constexpr int kTp = kE + N;
  static constexpr int kTm = kTp + N;
  static constexpr int kP = kE + N + (FLUX ? 2 * N : 0);
  static constexpr int kG = kP + 2 * N * N;
  static constexpr int kIn = kG + 2 * N;
  static constexpr int kOut = FLUX ? 2 + 2 * N : 2 * N;
  static constexpr int kSmemBytes =
      static_cast<int>(sizeof(float)) * (2 * kIn + kOut) * G::kPad;
  static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory over 48 KB");
};

template <int N, bool FLUX>
constexpr int team_smem_bytes() {
  return TeamGeom<N>::kSmemBytes > TeamBack<N, FLUX>::kSmemBytes
             ? TeamGeom<N>::kSmemBytes
             : TeamBack<N, FLUX>::kSmemBytes;
}

// The backward sweep of a block of kCols columns, bottom-up, on the teams
// of the forward sweep.  Every thread of the block must call it.
template <int N, bool FLUX>
__device__ __forceinline__ void team_backward_sweep(
    const float* __restrict__ gp_in, const float* __restrict__ gm_in,
    const float* __restrict__ e_in, const float* __restrict__ tp_in,
    const float* __restrict__ tm_in, const float* p_scr, const float* g_scr,
    float* __restrict__ out1, float* __restrict__ out2, int L, int64_t B,
    const FloatN<N>& wmu, float* smem) {
  using G = TeamGeom<N>;
  using T = TeamBack<N, FLUX>;
  constexpr int M = G::M;
  constexpr int kStage = T::kIn * G::kPad;
  float* stage = smem;                               // [2][kIn][kPad]
  float* outb = stage + 2 * kStage;                  // [kOut][kPad]
  const int tid = static_cast<int>(threadIdx.x);
  const int j = tid % M;            // row j of x; row j of the carry if j < N
  const int i = j % N;              // lanes j >= N mirror lane j - N
  const int col = tid / M;
  const unsigned mask = team_mask<N>();
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G::kCols;
  const int64_t LB = static_cast<int64_t>(L) * B;
  float w = wmu.v[0];               // wmu_i, selected without local memory
#pragma unroll
  for (int r = 1; r < N; ++r) w = (i == r) ? wmu.v[r] : w;

  // Staging: thread tid always copies column c = tid % kCols, slots
  // tid / kCols + kRows k of each tensor, so its addresses are a base and a
  // constant stride (the prefetch makes ~17 copies per thread and layer).
  constexpr int kRows = G::kThreads / G::kCols;
  const int c_st = tid % G::kCols;
  const int r_st = tid / G::kCols;
  const int64_t b_st = b0 + c_st < B ? b0 + c_st : B - 1;
  auto stage_slots = [&](float* dst, int s0, const float* src, int n,
                         int64_t o) {
#pragma unroll
    for (int r = r_st; r < n; r += kRows) {
      cp_async4(dst + (s0 + r) * G::kPad + c_st, src + r * LB + o);
    }
  };
  auto prefetch = [&](int l, float* dst) {
    const int64_t o = static_cast<int64_t>(l) * B + b_st;
    stage_slots(dst, 0, gp_in, N * N, o);
    stage_slots(dst, N * N, gm_in, N * N, o);
    stage_slots(dst, T::kE, e_in, N, o);
    if (FLUX) {
      stage_slots(dst, T::kTp, tp_in, N, o);
      stage_slots(dst, T::kTm, tm_in, N, o);
    }
    stage_slots(dst, T::kP, p_scr, 2 * N * N, o);
    stage_slots(dst, T::kG, g_scr, 2 * N, o);
    cp_async_commit();
  };

  float dx = 0.0f;                  // dx_j on lanes j < N
  prefetch(L - 1, stage);
  for (int l = L - 1; l >= 0; --l) {
    cp_async_wait_all();
    __syncthreads();                 // layer l staged; last outputs stored
    if (l > 0) prefetch(l - 1, stage + ((L - l) & 1) * kStage);
    const float* in = stage + ((L - 1 - l) & 1) * kStage + col;
    auto at = [&](int s) { return in[s * G::kPad]; };

    // x_j = g_j + P_j dx (bvp_layer_coeffs' order)
    float acc = at(T::kP + j * N) * __shfl_sync(mask, dx, 0, M);
#pragma unroll
    for (int k = 1; k < N; ++k) {
      acc = acc + at(T::kP + j * N + k) * __shfl_sync(mask, dx, k, M);
    }
    const float x = at(T::kG + j) + acc;
    float xs[M];
#pragma unroll
    for (int r = 0; r < M; ++r) xs[r] = __shfl_sync(mask, x, r, M);

    if (FLUX) {
      // bvp_layer_flux's order: up = gp a + (gm E) b, dn = gm a + (gp E) b
      float up = at(i * N) * xs[0];
      float dn = at(N * N + i * N) * xs[0];
#pragma unroll
      for (int k = 1; k < N; ++k) {
        up = up + at(i * N + k) * xs[k];
        dn = dn + at(N * N + i * N + k) * xs[k];
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        up = up + at(N * N + i * N + k) * at(T::kE + k) * xs[N + k];
        dn = dn + at(i * N + k) * at(T::kE + k) * xs[N + k];
      }
      const float upt = w * (up + at(T::kTp + i));
      const float dnt = w * (dn + at(T::kTm + i));
      float up_sum = __shfl_sync(mask, upt, 0, M);
      float dn_sum = __shfl_sync(mask, dnt, 0, M);
#pragma unroll
      for (int r = 1; r < N; ++r) {
        up_sum = up_sum + __shfl_sync(mask, upt, r, M);
        dn_sum = dn_sum + __shfl_sync(mask, dnt, r, M);
      }
      dx = up;
      if (j == 0) {
        outb[col] = up_sum;
        outb[G::kPad + col] = dn_sum;
      }
      if (l == L - 1) outb[(2 + j) * G::kPad + col] = x;
    } else {
      // bvp_layer_carry's order: the two sums apart, then added
      float up = at(i * N) * xs[0];
      float dn = (at(N * N + i * N) * at(T::kE)) * xs[N];
#pragma unroll
      for (int k = 1; k < N; ++k) {
        up = up + at(i * N + k) * xs[k];
        dn = dn + (at(N * N + i * N + k) * at(T::kE + k)) * xs[N + k];
      }
      dx = up + dn;
      outb[j * G::kPad + col] = x;
    }

    __syncthreads();                 // the layer's outputs are staged
    const int nout = FLUX ? (l == L - 1 ? T::kOut : 2) : T::kOut;
    for (int idx = tid; idx < nout * G::kCols; idx += G::kThreads) {
      const int s = idx / G::kCols;
      const int c = idx - s * G::kCols;
      if (b0 + c < B) {
        const int64_t o = static_cast<int64_t>(l) * B + b0 + c;
        float* dst = FLUX ? (s < 2 ? out1 + s * LB + o
                                   : out2 + (s - 2) * B + b0 + c)
                          : (s < N ? out1 + s * LB + o
                                   : out2 + (s - N) * LB + o);
        *dst = outb[s * G::kPad + c];
      }
    }
  }
}

template <int N, bool FLUX>
__global__ void __launch_bounds__(TeamGeom<N>::kThreads, 3)
bvp_fused_team_kernel(const float* __restrict__ gp_in,
                      const float* __restrict__ gm_in,
                      const float* __restrict__ e_in,
                      const float* __restrict__ d_in,
                      const float* __restrict__ albedo,
                      const float* __restrict__ tp_in,
                      const float* __restrict__ tm_in,
                      float* __restrict__ out1, float* __restrict__ out2,
                      float* __restrict__ scratch, int L, int64_t B,
                      FloatN<N> wmu) {
  extern __shared__ float smem[];
  const int64_t LB = static_cast<int64_t>(L) * B;
  float* p_scr = scratch;                            // (2N, N, L, B)
  float* g_scr = scratch + 2 * N * N * LB;           // (2N, L, B)
  team_forward_sweep<N>(gp_in, gm_in, e_in, d_in, albedo, p_scr, g_scr, L, B,
                        wmu, smem);
  __syncthreads();                   // the scratch is written; smem is free
  team_backward_sweep<N, FLUX>(gp_in, gm_in, e_in, tp_in, tm_in, p_scr,
                               g_scr, out1, out2, L, B, wmu, smem);
}

// ---- launch ------------------------------------------------------------

template <int N, bool FLUX>
int launch_mode(const float* gp, const float* gm, const float* expd,
                const float* dblk, const float* albedo, const float* ptop_p,
                const float* ptop_m, float* out1, float* out2, float* scratch,
                int L, int64_t B, const FloatN<N>& w, cudaStream_t stream) {
  if constexpr (N == 8) {
    using G = TeamGeom<N>;
    const unsigned blocks = static_cast<unsigned>((B + G::kCols - 1) / G::kCols);
    bvp_fused_team_kernel<N, FLUX><<<blocks, G::kThreads,
                                     team_smem_bytes<N, FLUX>(), stream>>>(
        gp, gm, expd, dblk, albedo, ptop_p, ptop_m, out1, out2, scratch, L, B,
        w);
  } else {
    constexpr int smem = segment_smem_bytes<N>();
    static_assert(smem <= 48 * 1024, "dynamic shared memory over 48 KB");
    auto kernel = bvp_fused_kernel<N, FLUX>;
    if (smem > 0) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const unsigned blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, smem, stream>>>(gp, gm, expd, dblk, albedo,
                                               ptop_p, ptop_m, out1, out2,
                                               scratch, L, B, w);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch(int flux, const float* gp, const float* gm, const float* expd,
           const float* dblk, const float* albedo, const float* ptop_p,
           const float* ptop_m, float* out1, float* out2, float* scratch,
           int L, int64_t B, const float* wmu, cudaStream_t stream) {
  FloatN<N> w;
  for (int i = 0; i < N; ++i) w.v[i] = wmu[i];
  if (B == 0 || L == 0) return 0;
  return flux ? launch_mode<N, true>(gp, gm, expd, dblk, albedo, ptop_p,
                                     ptop_m, out1, out2, scratch, L, B, w,
                                     stream)
              : launch_mode<N, false>(gp, gm, expd, dblk, albedo, ptop_p,
                                      ptop_m, out1, out2, scratch, L, B, w,
                                      stream);
}

template <int N>
long long scratch_floats(int L, long long B) {
  if (N == 8) return static_cast<long long>(L) * kLayerFloats<N> * B;
  const long long nseg = (L + kSegment<N> - 1) / kSegment<N>;
  return nseg * (N * N + N) * B;
}

}  // namespace

// The scratch pyharp_bvp_fused needs, in floats: P/g of every layer (N = 8),
// else the carry checkpoints; -1 for an N with no kernel.
PYHARP_API long long pyharp_bvp_fused_scratch(int n, int L, long long B) {
  switch (n) {
    case 1: return scratch_floats<1>(L, B);
    case 2: return scratch_floats<2>(L, B);
    case 4: return scratch_floats<4>(L, B);
    case 8: return scratch_floats<8>(L, B);
    default: return PYHARP_UNSUPPORTED_N;
  }
}

// Shapes: gp, gm (N,N,L,B); expd, ptop_p, ptop_m (N,L,B); dblk (2N,L,B);
// albedo (B); scratch of pyharp_bvp_fused_scratch(n, L, B) floats.  flux !=
// 0: out1 = fl (2,L,B), out2 = ab_last (2N,B); flux == 0: out1 = a, out2 =
// b, each (N,L,B).  wmu: host float32[n].
PYHARP_API int pyharp_bvp_fused(int n, int flux, const float* gp,
                                const float* gm, const float* expd,
                                const float* dblk, const float* albedo,
                                const float* ptop_p, const float* ptop_m,
                                float* out1, float* out2, float* scratch,
                                int L, long long B, const float* wmu,
                                void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(flux, gp, gm, expd, dblk, albedo, ptop_p, ptop_m, out1, out2, scratch, L, B, wmu, s);
    case 2: return launch<2>(flux, gp, gm, expd, dblk, albedo, ptop_p, ptop_m, out1, out2, scratch, L, B, wmu, s);
    case 4: return launch<4>(flux, gp, gm, expd, dblk, albedo, ptop_p, ptop_m, out1, out2, scratch, L, B, wmu, s);
    case 8: return launch<8>(flux, gp, gm, expd, dblk, albedo, ptop_p, ptop_m, out1, out2, scratch, L, B, wmu, s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}
