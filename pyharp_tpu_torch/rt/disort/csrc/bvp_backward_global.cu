// K5 at N > 64 (nstr > 128): back-substitution of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:846 (_bvp_bwd_kernel),
// reached through solve_bvp_pallas (:1233), at the N that
// bvp_backward_huge.cu does not take.  It computes what
// bvp_backward_huge.cu computes: each column walks the layers bottom-up
// with the carry dx (N), x_l = g_l + P_l dx gives the layer's (a, b) =
// (x[:N], x[N:]), and the next carry is dx = gp a + (gm E) b, the two sums
// formed apart and then added, every sum in the order of
// kernels.bvp_backward_plain.
//
// Bound on the H100: memory.  Per column and layer it reads (4N^2 + 3N)*4
// bytes (263,680 at N = 128) and writes 8N, against ~8N^2 flops.
//
// Design: bvp_backward_huge.cu's block of 32 warps over a tile of 32
// columns, lane c on column c, warp w on the rows w + 32 j below N (x_r and
// x_(N+r), then the carry's entry r), a loop over the row sets with N a
// run-time argument.  The tile's x (2N x 32) and carry (N x 32, up + dn
// stored once added) pass through dynamic shared memory sized from N at
// launch (384 N bytes, 48 KB at N = 128) while that fits a block (N up to
// 591 on the H100); past it they sit in a slab of global scratch per
// resident block, the blocks walking the tiles in a grid-stride loop.  E is
// read where the carry's sum uses it.
// chip_smoke.py phase 23 prints the registers and spills.

#include "global.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kWarps = 32;
constexpr int kThreads = 32 * kWarps;

__host__ __device__ int64_t tile_floats(int n) { return 3LL * n * kTile; }

template <bool SMEM>
__global__ void __launch_bounds__(kThreads)
bvp_backward_global_kernel(const float* __restrict__ gp_in,
                           const float* __restrict__ gm_in,
                           const float* __restrict__ e_in,
                           const float* __restrict__ p_in,
                           const float* __restrict__ g_in,
                           float* __restrict__ a_out,
                           float* __restrict__ b_out, int n, int L,
                           int64_t B, float* scratch) {
  extern __shared__ __align__(16) float smem[];
  float* s_x = SMEM ? smem
                    : scratch + blockIdx.x * tile_floats(n);
  float* s_dx = s_x + 2 * n * kTile;
  const int c = static_cast<int>(threadIdx.x) & 31;
  const int w = static_cast<int>(threadIdx.x) >> 5;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const int64_t nn = n;
  const int64_t tiles = (B + kTile - 1) / kTile;

  for (int64_t tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int64_t b = tile * kTile + c;
    const bool in = b < B;
    // lanes past B read column B - 1 and store nothing
    const int64_t col = in ? b : B - 1;
    for (int r = w; r < n; r += kWarps) s_dx[r * kTile + c] = 0.0f;
    __syncthreads();
    for (int l = L - 1; l >= 0; --l) {
      const int64_t o = static_cast<int64_t>(l) * B + col;
      // x_r = g_r + P_r dx, r = i and n + i for the warp's rows i
      for (int i = w; i < n; i += kWarps) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = i + h * n;
          const float* pr = p_in + (r * nn) * LB + o;
          float acc = pr[0] * s_dx[c];
          for (int k = 1; k < n; ++k) {
            acc = acc + pr[k * LB] * s_dx[k * kTile + c];
          }
          const float x = g_in[r * LB + o] + acc;
          s_x[r * kTile + c] = x;
          if (in) (h == 0 ? a_out : b_out)[i * LB + o] = x;
        }
      }
      __syncthreads();               // x of the layer is shared
      if (l == 0) break;
      // the carry: up_i = gp_i a, dn_i = (gm_i E) b, dx_i = up_i + dn_i
      for (int i = w; i < n; i += kWarps) {
        const float* gpr = gp_in + (i * nn) * LB + o;
        const float* gmr = gm_in + (i * nn) * LB + o;
        const float* er = e_in + o;
        float up = gpr[0] * s_x[c];
        float dn = (gmr[0] * er[0]) * s_x[n * kTile + c];
        for (int k = 1; k < n; ++k) {
          up = up + gpr[k * LB] * s_x[k * kTile + c];
          dn = dn + (gmr[k * LB] * er[k * LB]) * s_x[(n + k) * kTile + c];
        }
        s_dx[i * kTile + c] = up + dn;
      }
      __syncthreads();               // the carry is shared; x is free
    }
  }
}

// The tiles in shared memory where they fit a block of the current device.
bool in_smem(int n) {
  int dev = 0;
  int optin = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return false;
  return tile_floats(n) * static_cast<int64_t>(sizeof(float)) <= optin;
}

// The attribute belongs to the current device: set it before every launch
// (and every occupancy query).
cudaError_t allow_smem(int n) {
  return cudaFuncSetAttribute(
      bvp_backward_global_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tile_floats(n) * static_cast<int64_t>(sizeof(float))));
}

// Columns resident on an SM at n; -1 on an error.
int per_sm(int n) {
  const bool sm = in_smem(n);
  if (sm && allow_smem(n) != cudaSuccess) return -1;
  int blocks = 0;
  const cudaError_t err = sm
      ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, bvp_backward_global_kernel<true>, kThreads,
            static_cast<size_t>(tile_floats(n) * sizeof(float)))
      : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, bvp_backward_global_kernel<false>, kThreads, 0);
  return err == cudaSuccess ? blocks * kTile : -1;
}

// Blocks of the launch: every tile where the tiles sit in shared memory,
// else one a resident block (each with its slab); -1 on an error.
int64_t grid_of(int n, int64_t B) {
  const int64_t tiles = (B + kTile - 1) / kTile;
  if (in_smem(n)) return tiles;
  const int cols = per_sm(n);
  return cols < 0 ? -1 : resident_units(cols / kTile, tiles);
}

}  // namespace

// Floats of global scratch a launch at (n, B) needs: 0 where the tiles sit
// in shared memory; -1 on an error.
PYHARP_API long long pyharp_bvp_backward_global_scratch(int n, long long B) {
  if (n < kGlobalMinN) return -1;
  if (B == 0 || in_smem(n)) return 0;
  const int64_t grid = grid_of(n, B);
  return grid < 0 ? -1 : grid * tile_floats(n);
}

// Shapes as pyharp_bvp_backward (bvp_backward.cu), for n > 64; scratch
// holds pyharp_bvp_backward_global_scratch(n, B) floats.
PYHARP_API int pyharp_bvp_backward_global(int n, const float* gp,
                                          const float* gm, const float* expd,
                                          const float* p, const float* g,
                                          float* a, float* b, int L,
                                          long long B, float* scratch,
                                          void* stream) {
  if (n < kGlobalMinN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  const int64_t grid = grid_of(n, B);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  auto s = static_cast<cudaStream_t>(stream);
  if (in_smem(n)) {
    const cudaError_t err = allow_smem(n);
    if (err != cudaSuccess) return static_cast<int>(err);
    bvp_backward_global_kernel<true>
        <<<static_cast<unsigned>(grid), kThreads,
           static_cast<size_t>(tile_floats(n) * sizeof(float)), s>>>(
            gp, gm, expd, p, g, a, b, n, L, B, nullptr);
  } else {
    bvp_backward_global_kernel<false>
        <<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
            gp, gm, expd, p, g, a, b, n, L, B, scratch);
  }
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM at n, by the occupancy calculator.
PYHARP_API int pyharp_bvp_backward_global_occupancy(int n) {
  return per_sm(n);
}
