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
// N = 5, 6, 7 (nstr 10, 12, 14) run the same per-thread body: a team of 2N
// lanes would straddle a warp, and one thread spills the 2N x (3N + 1)
// system (chip_smoke.py phase 1 prints how much).
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
    case 7: return launch<7>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<7>(wmu), s);
    case 8: return launch_team<8>(gp, gm, expd, dblk, albedo, p_out, g_out, L, B, host_wmu<8>(wmu), s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}
