// K5 at N = 33..64 (nstr 66..128): back-substitution of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:846 (_bvp_bwd_kernel),
// reached through solve_bvp_pallas (:1233), at the N that
// bvp_backward_big.cu does not take.  It computes what bvp_backward_big.cu
// computes: each column walks the layers bottom-up with the carry dx (N),
// x_l = g_l + P_l dx gives the layer's (a, b) = (x[:N], x[N:]), and the
// next carry is dx = gp a + (gm E) b, the two sums formed apart and then
// added, every sum in the order of kernels.bvp_backward_plain.
//
// Bound on the H100: memory.  Per column and layer it reads (4N^2 + 3N)*4
// bytes (66,304 at N = 64) and writes 8N, against ~8N^2 flops.
//
// Design: bvp_backward_big.cu's block with its 32 warps at every N (a
// block holds at most 1,024 threads): warp w forms the rows r = w and
// w + 32 below N (x_r and x_(N+r), then up_r and dn_r), one body for every
// N = 33..64 with N a run-time argument.  A block owns 32 consecutive
// columns, lane c column b0 + c, so every load of a row of an input is one
// 128-byte segment; x, E and the two sums pass through shared memory,
// (2N + 3N) x 32 floats, 40 KB at N = 64.
// chip_smoke.py phase 1 prints the registers and spills.

#include "huge.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kWarps = 32;

__global__ void __launch_bounds__(32 * kWarps)
bvp_backward_huge_kernel(const float* __restrict__ gp_in,
                         const float* __restrict__ gm_in,
                         const float* __restrict__ e_in,
                         const float* __restrict__ p_in,
                         const float* __restrict__ g_in,
                         float* __restrict__ a_out, float* __restrict__ b_out,
                         int n, int L, int64_t B) {
  __shared__ float s_x[2 * kHugeMaxN][kTile];
  __shared__ float s_e[kHugeMaxN][kTile];
  __shared__ float s_up[kHugeMaxN][kTile];
  __shared__ float s_dn[kHugeMaxN][kTile];
  const int c = static_cast<int>(threadIdx.x) & 31;
  const int w = static_cast<int>(threadIdx.x) >> 5;   // rows w and w + 32
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kTile + c;
  const bool in = b < B;
  const int64_t LB = static_cast<int64_t>(L) * B;
  // lanes past B read column B - 1 and store nothing
  const int64_t col = in ? b : B - 1;
  const int64_t nn = n;

  for (int r = w; r < n; r += kWarps) {
    s_up[r][c] = 0.0f;
    s_dn[r][c] = 0.0f;
  }
  __syncthreads();
  for (int l = L - 1; l >= 0; --l) {
    const int64_t o = static_cast<int64_t>(l) * B + col;
    // x_r = g_r + P_r dx, dx_k = up_k + dn_k of the layer below, r = i and
    // n + i for the warp's rows i
    for (int i = w; i < n; i += kWarps) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i + h * n;
        const float* pr = p_in + (r * nn) * LB + o;
        float acc = pr[0] * (s_up[0][c] + s_dn[0][c]);
        for (int k = 1; k < n; ++k) {
          acc = acc + pr[k * LB] * (s_up[k][c] + s_dn[k][c]);
        }
        const float x = g_in[r * LB + o] + acc;
        s_x[r][c] = x;
        if (in) (h == 0 ? a_out : b_out)[i * LB + o] = x;
      }
      s_e[i][c] = e_in[i * LB + o];
    }
    __syncthreads();                 // x and E of the layer are shared
    if (l == 0) break;
    // the carry's two sums: up_i = gp_i a, dn_i = (gm_i E) b
    for (int i = w; i < n; i += kWarps) {
      const float* gpr = gp_in + (i * nn) * LB + o;
      const float* gmr = gm_in + (i * nn) * LB + o;
      float up = gpr[0] * s_x[0][c];
      float dn = (gmr[0] * s_e[0][c]) * s_x[n][c];
      for (int k = 1; k < n; ++k) {
        up = up + gpr[k * LB] * s_x[k][c];
        dn = dn + (gmr[k * LB] * s_e[k][c]) * s_x[n + k][c];
      }
      s_up[i][c] = up;
      s_dn[i][c] = dn;
    }
    __syncthreads();                 // the sums are shared; x is free
  }
}

}  // namespace

// Shapes as pyharp_bvp_backward (bvp_backward.cu), for n = 33..64.
PYHARP_API int pyharp_bvp_backward_huge(int n, const float* gp,
                                        const float* gm, const float* expd,
                                        const float* p, const float* g,
                                        float* a, float* b, int L,
                                        long long B, void* stream) {
  if (n < kHugeMinN || n > kHugeMaxN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  const auto blocks = static_cast<unsigned>((B + kTile - 1) / kTile);
  bvp_backward_huge_kernel<<<blocks, 32 * kWarps, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, p, g, a, b, n, L, B);
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM, by the occupancy calculator.
PYHARP_API int pyharp_bvp_backward_huge_occupancy() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bvp_backward_huge_kernel, 32 * kWarps, 0) != cudaSuccess)
    return -1;
  return blocks * kTile;
}
