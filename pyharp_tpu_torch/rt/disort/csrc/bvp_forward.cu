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
// Two bodies, chosen by N in pyharp_bvp_forward:
//
// N <= 4: one thread per column, common.cuh's bvp_forward_layer (shared
// with K6), the 8 x 13 system (N = 4) and the carry in registers, no
// spills.  It reaches 64-78% of its bound; the team body below, run at
// N = 2 and 4, took 2.9-3.5x as long on the same paths (PERF.md).
//
// N = 8: a team of 2N = 16 lanes per column, two columns per warp (one
// thread would hold the 16 x 25 system in 255 registers, spill ~9 KB and
// run 8 warps per SM; PERF.md).  Lane j owns block column j of the system
// and, for j <= N, one right-hand-side column (the N unit columns, then
// the rhs): 32 floats in registers.  Owning columns rather than rows keeps
// the pivot search local (rows would need a prefix scan for the pivot and
// a shuffle per live entry to move the pivot row): lane c holds the pivot
// column, replays the plain version's bubble (strict |a_r| > |a_c| swaps
// over the live suffix) on it and broadcasts the swap bits in one
// shuffle; every lane applies the same swaps to its columns.  The
// multipliers a_r,c * (1 / a_c,c) come from lane c by shuffle, each lane
// eliminates its own columns, and back substitution runs in the lanes
// that own the right-hand sides with the upper triangle broadcast by
// shuffle.  Every entry is formed by the same operations as in
// bvp_forward_layer (back substitution times the pivot's reciprocal, as
// there), so the kernel is bit-equal to the per-thread body, which K6's
// forward sweep still runs at N = 8 (chip_smoke.py phase 10).  A block of
// 16 columns stages each layer's gp, gm, E and dblk in shared memory with
// cp.async, coalesced along B, while the previous layer is solved (two
// stages), and P_l, g_l leave through a shared buffer in coalesced
// stores.  Q lives in shared memory per column (the lanes that form it
// are not those that read it), rg with the rhs lane.  Registers and
// spills: chip_smoke.py phase 1 prints them.

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

// ---- the team kernel (N = 8) ----------------------------------------------

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Launch geometry and shared memory of a block: two stages of a layer's
// inputs and one of its outputs, slot-major with kCols columns per slot
// (padded by one against bank conflicts), and Q (N x N) per column.
// Input slots: gp (i, k) at i*N + k, gm at N^2 + i*N + k, E at 2N^2 + k,
// dblk at 2N^2 + N + r; output slots: P (r, q) at r*N + q, g at 2N^2 + r.
template <int N>
struct TeamGeom {
  static constexpr int M = 2 * N;                    // lanes per column
  static constexpr int kThreads = 256;
  static constexpr int kCols = kThreads / M;         // columns per block
  static constexpr int kPad = kCols + 1;
  static constexpr int kIn = 2 * N * N + 3 * N;
  static constexpr int kOut = 2 * N * N + 2 * N;
  static constexpr int kSmemBytes = static_cast<int>(sizeof(float))
      * ((2 * kIn + kOut) * kPad + kCols * N * N);
  static_assert(32 % M == 0, "a team must not straddle a warp");
  static_assert(N + 1 <= M, "a lane owns at most one rhs column");
  static_assert(kSmemBytes <= 48 * 1024, "dynamic shared memory over 48 KB");
};

template <int N>
__global__ void __launch_bounds__(TeamGeom<N>::kThreads, 3)
bvp_forward_team_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ albedo,
                        float* __restrict__ p_out, float* __restrict__ g_out,
                        int L, int64_t B, FloatN<N> wmu) {
  using G = TeamGeom<N>;
  constexpr int M = G::M;
  constexpr int kStage = G::kIn * G::kPad;
  extern __shared__ float smem[];
  float* stage = smem;                               // [2][kIn][kPad]
  float* outb = stage + 2 * kStage;                  // [kOut][kPad]
  const int tid = static_cast<int>(threadIdx.x);
  const int j = tid % M;            // block column j; rhs column j if j <= N
  const int col = tid / M;          // the team's column in the block
  const unsigned mask = ((1u << M) - 1u) << ((tid & 31) / M * M);
  float* q = outb + G::kOut * G::kPad + col * N * N;  // Q, row-major
  const int64_t b0 = static_cast<int64_t>(blockIdx.x) * G::kCols;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const float alb = albedo[b0 + col < B ? b0 + col : B - 1];

  auto prefetch = [&](int l, float* dst) {
    for (int idx = tid; idx < G::kIn * G::kCols; idx += G::kThreads) {
      const int s = idx / G::kCols;
      const int c = idx - s * G::kCols;
      const int64_t o = static_cast<int64_t>(l) * B
                        + (b0 + c < B ? b0 + c : B - 1);
      const float* src =
          s < N * N ? gp_in + s * LB + o
          : s < 2 * N * N ? gm_in + (s - N * N) * LB + o
          : s < 2 * N * N + N ? e_in + (s - 2 * N * N) * LB + o
          : d_in + (s - 2 * N * N - N) * LB + o;
      cp_async4(dst + s * G::kPad + c, src);
    }
    cp_async_commit();
  };

  for (int k = j; k < N * N; k += M) q[k] = 0.0f;
  float rg[N];
#pragma unroll
  for (int i = 0; i < N; ++i) rg[i] = 0.0f;
  prefetch(0, stage);

  const bool lo = j < N;
  const int jj = lo ? j : j - N;
  for (int l = 0; l < L; ++l) {
    cp_async_wait_all();
    __syncthreads();                 // layer l staged; last outputs stored
    if (l + 1 < L) prefetch(l + 1, stage + ((l + 1) & 1) * kStage);
    const float* in = stage + (l & 1) * kStage + col;
    auto at = [&](int s) { return in[s * G::kPad]; };

    // block column j: [ -[gm, gp E] + Q [gp, gm E] ; [gp E, gm] ]
    float a[M];
    {
      const float ej = at(2 * N * N + jj);
      float gpc[N];
      float gmc[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        gpc[k] = at(k * N + jj);
        gmc[k] = at(N * N + k * N + jj);
      }
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const float ttop = lo ? gmc[i] : gpc[i] * ej;
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float dkj = lo ? gpc[k] : gmc[k] * ej;
          acc = (k == 0) ? q[i * N] * dkj : acc + q[i * N + k] * dkj;
        }
        a[i] = -ttop + acc;
        a[N + i] = lo ? gpc[i] * ej : gmc[i];
      }
      if (l == L - 1) {
        // Lambertian reflection: Blow -= 2 albedo sum_r wmu_r Rn[r]
        const float alb2 = 2.0f * alb;
        float refl = 0.0f;
#pragma unroll
        for (int r = 0; r < N; ++r) {
          const float rn = lo ? gmc[r] * ej : gpc[r];
          refl = (r == 0) ? wmu.v[0] * rn : refl + wmu.v[r] * rn;
        }
#pragma unroll
        for (int i = 0; i < N; ++i) a[N + i] = a[N + i] - alb2 * refl;
      }
    }
    // the lane's rhs column: unit column j (j < N) or [d_top - rg ; d_bot]
    float u[M];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float dt = at(2 * N * N + N + i);
      const float db = at(2 * N * N + 2 * N + i);
      u[i] = (j == N) ? dt - rg[i] : 0.0f;
      u[N + i] = (j == N) ? db : ((j == i) ? 1.0f : 0.0f);
    }

    // LU with the plain version's bubble pivoting
#pragma unroll
    for (int c = 0; c < M; ++c) {
      float champ = a[c];
      unsigned bits = 0u;
#pragma unroll
      for (int r = c + 1; r < M; ++r) {
        const bool sw = fabsf(a[r]) > fabsf(champ);
        bits |= sw ? (1u << r) : 0u;
        champ = sw ? a[r] : champ;
      }
      bits = __shfl_sync(mask, bits, c, M);
#pragma unroll
      for (int r = c + 1; r < M; ++r) {
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
      const float inv = 1.0f / __shfl_sync(mask, a[c], c, M);
#pragma unroll
      for (int r = c + 1; r < M; ++r) {
        const float f = __shfl_sync(mask, a[r], c, M) * inv;
        a[r] = a[r] - f * a[c];
        u[r] = u[r] - f * u[c];
      }
    }
    // back substitution, times the pivot's reciprocal as bvp_forward_layer
    // does; the solution overwrites u
#pragma unroll
    for (int row = M - 1; row >= 0; --row) {
      const float inv = 1.0f / __shfl_sync(mask, a[row], row, M);
      float acc = u[row];
#pragma unroll
      for (int c = row + 1; c < M; ++c) {
        acc = acc - __shfl_sync(mask, a[row], c, M) * u[c];
      }
      u[row] = acc * inv;
    }

    // P_l[r][j] = x_j[r] (j < N), g_l = x_N; then the condensed carry
    if (j <= N) {
#pragma unroll
      for (int r = 0; r < M; ++r) {
        outb[(lo ? r * N + j : 2 * N * N + r) * G::kPad + col] = u[r];
      }
    }
    __syncwarp(mask);                // the build's reads of Q are done
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float acc = 0.0f;
#pragma unroll
      for (int k = 0; k < M; ++k) {
        const float rn = k < N ? at(N * N + i * N + k) * at(2 * N * N + k)
                               : at(i * N + k - N);
        acc = (k == 0) ? rn * u[0] : acc + rn * u[k];
      }
      if (lo) q[i * N + j] = acc;
      rg[i] = acc;                   // read on the rhs lane only
    }
    __syncthreads();                 // the layer's outputs are staged
    for (int idx = tid; idx < G::kOut * G::kCols; idx += G::kThreads) {
      const int s = idx / G::kCols;
      const int c = idx - s * G::kCols;
      if (b0 + c < B) {
        const int64_t o = static_cast<int64_t>(l) * B + b0 + c;
        float* dst = s < 2 * N * N ? p_out + s * LB + o
                                   : g_out + (s - 2 * N * N) * LB + o;
        *dst = outb[s * G::kPad + c];
      }
    }
  }
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
  if (B == 0 || L == 0) return n == 1 || n == 2 || n == 4 || n == 8
                                   ? 0 : PYHARP_UNSUPPORTED_N;
  switch (n) {
    case 1: return launch<1>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<1>(wmu), s);
    case 2: return launch<2>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<2>(wmu), s);
    case 4: return launch<4>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<4>(wmu), s);
    case 8: return launch_team<8>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<8>(wmu), s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}
