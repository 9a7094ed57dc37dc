// K5 at N = 17..32 (nstr 34..64): back-substitution of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:846 (_bvp_bwd_kernel),
// reached through solve_bvp_pallas (:1233), at the N that bvp_backward.cu
// does not instantiate.  It computes what bvp_backward.cu computes: each
// column walks the layers bottom-up with the carry dx (N), x_l = g_l + P_l
// dx gives the layer's (a, b) = (x[:N], x[N:]), and the next carry is dx =
// gp a + (gm E) b, the two sums formed apart and then added, every sum in
// the order of bvp_layer_coeffs and bvp_layer_carry (common.cuh).
//
// Bound on the H100: memory.  Per column and layer it reads (4N^2 + 3N)*4
// bytes (16,768 at N = 32) and writes 8N, against ~8N^2 flops.
//
// Design: the rows kernel of bvp_backward.cu with N warps in place of 2N
// (2N warps of 32 lanes are 2,048 threads at N = 32, over a block's 1,024),
// one body for every N = 17..32 with N a run-time argument (16 more
// template instantiations would lengthen the build).  A block owns 32
// consecutive columns, lane c column b0 + c, so every load of a row of an
// input is one 128-byte segment.  Warp w forms x_w and x_(N+w); after a
// barrier it forms up_w = gp_w a and dn_w = (gm_w E) b; x, E and the two
// sums pass through shared memory, (2N + 3N) x 32 floats, 20 KB at N = 32.
// Each thread reads its rows straight from device memory in the loops (at
// 32N threads a block no thread can hold a layer ahead in registers); the
// block's N warps and the blocks an SM holds keep the loads in flight.
// chip_smoke.py phase 1 prints the registers and spills.

#include "big.cuh"

namespace {

constexpr int kTile = 32;

__global__ void __launch_bounds__(32 * kBigMaxN)
bvp_backward_big_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ p_in,
                        const float* __restrict__ g_in,
                        float* __restrict__ a_out, float* __restrict__ b_out,
                        int n, int L, int64_t B) {
  __shared__ float s_x[2 * kBigMaxN][kTile];
  __shared__ float s_e[kBigMaxN][kTile];
  __shared__ float s_up[kBigMaxN][kTile];
  __shared__ float s_dn[kBigMaxN][kTile];
  const int c = static_cast<int>(threadIdx.x) & 31;
  const int w = static_cast<int>(threadIdx.x) >> 5;   // rows w and n + w
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kTile + c;
  const bool in = b < B;
  const int64_t LB = static_cast<int64_t>(L) * B;
  // lanes past B read column B - 1 and store nothing
  const int64_t col = in ? b : B - 1;
  const int64_t nn = n;

  s_up[w][c] = 0.0f;
  s_dn[w][c] = 0.0f;
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int64_t o = static_cast<int64_t>(l) * B + col;
    // x_r = g_r + P_r dx, dx_k = up_k + dn_k of the layer below, r = w and
    // n + w
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = w + h * n;
      const float* pr = p_in + (r * nn) * LB + o;
      float acc = pr[0] * (s_up[0][c] + s_dn[0][c]);
      for (int k = 1; k < n; ++k) {
        acc = acc + pr[k * LB] * (s_up[k][c] + s_dn[k][c]);
      }
      const float x = g_in[r * LB + o] + acc;
      s_x[r][c] = x;
      if (in) (h == 0 ? a_out : b_out)[w * LB + o] = x;
    }
    s_e[w][c] = e_in[w * LB + o];
    __syncthreads();                 // x and E of the layer are shared
    if (l == 0) break;
    // the carry's two sums: up_w = gp_w a, dn_w = (gm_w E) b
    const float* gpr = gp_in + (w * nn) * LB + o;
    const float* gmr = gm_in + (w * nn) * LB + o;
    float up = gpr[0] * s_x[0][c];
    float dn = (gmr[0] * s_e[0][c]) * s_x[n][c];
    for (int k = 1; k < n; ++k) {
      up = up + gpr[k * LB] * s_x[k][c];
      dn = dn + (gmr[k * LB] * s_e[k][c]) * s_x[n + k][c];
    }
    s_up[w][c] = up;
    s_dn[w][c] = dn;
    __syncthreads();                 // the sums are shared; x is free
  }
}

}  // namespace

// Shapes as pyharp_bvp_backward (bvp_backward.cu), for n = 17..32.
PYHARP_API int pyharp_bvp_backward_big(int n, const float* gp, const float* gm,
                                       const float* expd, const float* p,
                                       const float* g, float* a, float* b,
                                       int L, long long B, void* stream) {
  if (n < kBigMinN || n > kBigMaxN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  const auto blocks = static_cast<unsigned>((B + kTile - 1) / kTile);
  bvp_backward_big_kernel<<<blocks, 32 * n, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, p, g, a, b, n, L, B);
  return static_cast<int>(cudaGetLastError());
}
