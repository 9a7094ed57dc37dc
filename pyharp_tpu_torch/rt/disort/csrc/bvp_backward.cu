// K5: back-substitution of the layer-coupling boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:846 (_bvp_bwd_kernel),
// reached through solve_bvp_pallas (:1233), the JAX package's path for
// N > 4 (disort.py:447).
//
// Each column b walks the layers bottom-up, L-1 to 0, with the carry dx
// (N): x_l = g_l + P_l dx gives the layer's coefficients (a, b) = (x[:N],
// x[N:]), written out, and the next carry is dx = gp a + (gm E) b of this
// layer, in the plain version's order (the two sums formed apart, then
// added).  With no layer chunks there is no padded sublayer to mask.
//
// Bound on the H100: memory.  Per column and layer it reads
// (4N^2 + 3N)*4 bytes (gp, gm, P, g, E: 1120 bytes at N = 8, 4,288 at
// N = 16) and writes 8N, against ~8N^2 flops (~0.4 flop/byte), far below
// the f32 ridge of ~20 flop/byte.
//
// N <= 8: one thread owns a column (bvp_backward_kernel), streams it with
// loads coalesced along B and keeps only dx and x (3N floats) between
// layers; it reaches 77-83% of its bound (PERF.md).
//
// N = 9..16 (nstr 18..32): rows in parallel over a tile of 32 columns
// (bvp_backward_rows_kernel).  One thread per column, the body before
// this one, ran a chain of 3N dependent memory round trips a layer, which
// only other columns hide: it reached 6% of its bound at B = 4,096 and 36%
// at 16,384 on an H100 (PERF.md; the rows kernel 77% and 85% there).
// Here a block of 2N warps owns 32 consecutive columns, lane c column
// b0 + c, so every load of a row of an input is one 128-byte segment.
// Warp w forms x_w = g_w + P_w dx; after a barrier warp i < N forms the
// sum gp_i a and warp N + i the sum (gm_i E) b, which the next layer's
// lanes add (dx_i = up_i + dn_i) as they read them; x, E and the two sums
// pass through shared memory.  Each thread holds one row of P and g, and
// one row of gp or gm (warps w >= N also E_(w-N)), 2N + 2 floats: it loads
// the next layer's as soon as this layer's are used, so a layer's loads
// are in flight for a whole layer and the serial chain per layer is
// arithmetic and two barriers.  Every sum is formed by one thread in the
// order of bvp_layer_coeffs and bvp_layer_carry.  chip_smoke.py phase 1
// prints the registers and spills of every build.

#include "common.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(64)
bvp_backward_kernel(const float* __restrict__ gp_in,
                    const float* __restrict__ gm_in,
                    const float* __restrict__ e_in,
                    const float* __restrict__ p_in,
                    const float* __restrict__ g_in,
                    float* __restrict__ a_out, float* __restrict__ b_out,
                    int L, int64_t B) {
  const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int M = 2 * N;
  const int64_t LB = static_cast<int64_t>(L) * B;

  float dx[N];
#pragma unroll
  for (int i = 0; i < N; ++i) dx[i] = 0.0f;

  for (int l = L - 1; l >= 0; --l) {
    const int64_t o = static_cast<int64_t>(l) * B + b;
    float x[M];
    bvp_layer_coeffs<N>(p_in + o, g_in + o, LB, dx, x);
#pragma unroll
    for (int i = 0; i < N; ++i) {
      a_out[i * LB + o] = x[i];
      b_out[i * LB + o] = x[N + i];
    }
    bvp_layer_carry<N>(gp_in, gm_in, e_in, LB, o, x, dx);
  }
}

// The rows kernel at N = 9..16 (the design is at the head of this file).
// Shared memory: x (2N rows), E, and the sums up = gp a, dn = (gm E) b
// (N rows each), 32 columns a row.
template <int N>
__global__ void __launch_bounds__(64 * N)
bvp_backward_rows_kernel(const float* __restrict__ gp_in,
                         const float* __restrict__ gm_in,
                         const float* __restrict__ e_in,
                         const float* __restrict__ p_in,
                         const float* __restrict__ g_in,
                         float* __restrict__ a_out, float* __restrict__ b_out,
                         int L, int64_t B) {
  constexpr int kTile = 32;
  __shared__ float s_x[2 * N][kTile];
  __shared__ float s_e[N][kTile];
  __shared__ float s_up[N][kTile];
  __shared__ float s_dn[N][kTile];
  const int c = static_cast<int>(threadIdx.x) & 31;
  const int w = static_cast<int>(threadIdx.x) >> 5;   // row of x
  const bool upper = w < N;                            // warp-uniform
  const int i = upper ? w : w - N;                     // row of its sum
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kTile + c;
  const bool in = b < B;
  const int64_t LB = static_cast<int64_t>(L) * B;
  // the column's first element of each row this thread reads and writes;
  // lanes past B read column B - 1 and store nothing
  const int64_t col = in ? b : B - 1;
  const float* p_row = p_in + static_cast<int64_t>(w * N) * LB + col;
  const float* g_row = g_in + static_cast<int64_t>(w) * LB + col;
  const float* c_row = (upper ? gp_in : gm_in)
                       + static_cast<int64_t>(i * N) * LB + col;
  const float* e_row = e_in + static_cast<int64_t>(i) * LB + col;
  float* x_out = (upper ? a_out : b_out) + static_cast<int64_t>(i) * LB + b;

  float pr[N];     // P[w, :] of the layer
  float gw;        // g[w]
  float ev = 0.0f; // E[i] (warps w >= N)
  float cr[N];     // gp[i, :] (w < N) or gm[i, :]
  auto load_x = [&](int l) {
    const int64_t o = static_cast<int64_t>(l) * B;
#pragma unroll
    for (int k = 0; k < N; ++k) pr[k] = p_row[k * LB + o];
    gw = g_row[o];
    if (!upper) ev = e_row[o];
  };
  auto load_sum = [&](int l) {
    const int64_t o = static_cast<int64_t>(l) * B;
#pragma unroll
    for (int k = 0; k < N; ++k) cr[k] = c_row[k * LB + o];
  };

  for (int k = static_cast<int>(threadIdx.x); k < N * kTile;
       k += static_cast<int>(blockDim.x)) {
    (&s_up[0][0])[k] = 0.0f;
    (&s_dn[0][0])[k] = 0.0f;
  }
  load_x(L - 1);
  load_sum(L - 1);
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    // x_w = g_w + P_w dx, dx_k = up_k + dn_k of the layer below
    float acc = pr[0] * (s_up[0][c] + s_dn[0][c]);
#pragma unroll
    for (int k = 1; k < N; ++k) acc = acc + pr[k] * (s_up[k][c] + s_dn[k][c]);
    const float x = gw + acc;
    s_x[w][c] = x;
    if (!upper) s_e[i][c] = ev;
    if (in) x_out[static_cast<int64_t>(l) * B] = x;
    if (l > 0) load_x(l - 1);
    __syncthreads();                 // x and E of the layer are shared
    if (l == 0) break;
    // the carry's two sums: up_i = gp_i a, dn_i = (gm_i E) b
    float sum;
    if (upper) {
      sum = cr[0] * s_x[0][c];
#pragma unroll
      for (int k = 1; k < N; ++k) sum = sum + cr[k] * s_x[k][c];
      s_up[i][c] = sum;
    } else {
      sum = (cr[0] * s_e[0][c]) * s_x[N][c];
#pragma unroll
      for (int k = 1; k < N; ++k) sum = sum + (cr[k] * s_e[k][c]) * s_x[N + k][c];
      s_dn[i][c] = sum;
    }
    if (l > 1) load_sum(l - 1);      // layer 0 forms no carry
    __syncthreads();                 // the sums are shared; x is free
  }
}

template <int N>
int launch(const float* gp, const float* gm, const float* expd,
           const float* p, const float* g, float* a, float* b, int L,
           int64_t B, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  if constexpr (N > kNarrowMaxN) {
    constexpr int kTile = 32;
    const auto blocks = static_cast<unsigned>((B + kTile - 1) / kTile);
    bvp_backward_rows_kernel<N><<<blocks, 64 * N, 0, stream>>>(
        gp, gm, expd, p, g, a, b, L, B);
  } else {
    constexpr int kThreads = 64;
    const auto blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
    bvp_backward_kernel<N><<<blocks, kThreads, 0, stream>>>(
        gp, gm, expd, p, g, a, b, L, B);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: gp, gm (N,N,L,B); expd (N,L,B); p (2N,N,L,B); g (2N,L,B) from
// K2; a, b (N,L,B).
PYHARP_API int pyharp_bvp_backward(int n, const float* gp, const float* gm,
                                   const float* expd, const float* p,
                                   const float* g, float* a, float* b, int L,
                                   long long B, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(gp, gm, expd, p, g, a, b, L, B, s);
    case 2: return launch<2>(gp, gm, expd, p, g, a, b, L, B, s);
    case 3: return launch<3>(gp, gm, expd, p, g, a, b, L, B, s);
    case 4: return launch<4>(gp, gm, expd, p, g, a, b, L, B, s);
    case 5: return launch<5>(gp, gm, expd, p, g, a, b, L, B, s);
    case 6: return launch<6>(gp, gm, expd, p, g, a, b, L, B, s);
    case 7: return launch<7>(gp, gm, expd, p, g, a, b, L, B, s);
    case 8: return launch<8>(gp, gm, expd, p, g, a, b, L, B, s);
    case 9: return launch<9>(gp, gm, expd, p, g, a, b, L, B, s);
    case 10: return launch<10>(gp, gm, expd, p, g, a, b, L, B, s);
    case 11: return launch<11>(gp, gm, expd, p, g, a, b, L, B, s);
    case 12: return launch<12>(gp, gm, expd, p, g, a, b, L, B, s);
    case 13: return launch<13>(gp, gm, expd, p, g, a, b, L, B, s);
    case 14: return launch<14>(gp, gm, expd, p, g, a, b, L, B, s);
    case 15: return launch<15>(gp, gm, expd, p, g, a, b, L, B, s);
    case 16: return launch<16>(gp, gm, expd, p, g, a, b, L, B, s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}

