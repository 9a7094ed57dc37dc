// K3: back-substitution of the boundary-value problem fused with the
// level-flux contraction.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:885 (_bvp_bwd_flux_kernel),
// reached through solve_bvp_flux_pallas (:1279).
//
// One thread owns one column b and walks the layers bottom-up with the
// carry dx (N):  x_l = g_l + P_l dx  gives the layer's coefficients
// (a, b) = (x[:N], x[N:]); the upward intensity at the layer top,
// up = gp a + (gm E) b, is both the next carry and, with the particular
// part ptop_p, the wmu-weighted up-sum fl[0, l]; the down-sum fl[1, l] adds
// gm a + (gp E) b + ptop_m.  On the bottom layer the bottom-level sums
// fl_bot use the swapped E-ordering, (gp E) a + gm b + pbot_p and
// (gm E) a + gp b + pbot_m.  The a/b coefficients never reach memory.
//
// Bound on the H100: memory.  Per column and layer it reads
// (4N^2 + 5N)*4 bytes (P, g, gp, gm, E, ptop_p, ptop_m: 336 bytes at N = 4)
// and writes 8, against ~14N^2 flops (~0.7 flop/byte), far below the f32
// ridge of ~20 flop/byte; each thread streams its column with coalesced
// loads along B and keeps only dx and x (3N floats) live between layers.
// ptxas (nvcc 12.9, sm_90a, -O3), registers per thread for N = 1/2/4/8:
// 34/32/72/168, no spills.  chip_smoke.py phase 1 prints the counts of
// every build.

#include "common.cuh"

namespace {

template <int N>
__global__ void __launch_bounds__(64)
bvp_backward_flux_kernel(const float* __restrict__ gp_in,
                         const float* __restrict__ gm_in,
                         const float* __restrict__ e_in,
                         const float* __restrict__ p_in,
                         const float* __restrict__ g_in,
                         const float* __restrict__ tp_in,
                         const float* __restrict__ tm_in,
                         const float* __restrict__ pbp_in,
                         const float* __restrict__ pbm_in,
                         float* __restrict__ fl, float* __restrict__ fl_bot,
                         int L, int64_t B, FloatN<N> wmu) {
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
    const bool bottom = l == L - 1;
    float up_sum, dn_sum, upb_sum, dnb_sum;
    bvp_layer_flux<N, true>(gp_in, gm_in, e_in, tp_in, tm_in, LB, o, x, wmu,
                            bottom, pbp_in + b, pbm_in + b, B, dx, up_sum,
                            dn_sum, upb_sum, dnb_sum);
    fl[o] = up_sum;
    fl[LB + o] = dn_sum;
    if (bottom) {
      fl_bot[b] = upb_sum;
      fl_bot[B + b] = dnb_sum;
    }
  }
}

template <int N>
int launch(const float* gp, const float* gm, const float* expd,
           const float* p, const float* g, const float* ptop_p,
           const float* ptop_m, const float* pbot_p, const float* pbot_m,
           float* fl, float* fl_bot, int L, int64_t B, const float* wmu,
           cudaStream_t stream) {
  FloatN<N> w;
  for (int i = 0; i < N; ++i) w.v[i] = wmu[i];
  if (B == 0 || L == 0) return 0;
  constexpr int kThreads = 64;
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  bvp_backward_flux_kernel<N><<<static_cast<unsigned>(blocks), kThreads, 0,
                                stream>>>(gp, gm, expd, p, g, ptop_p, ptop_m,
                                          pbot_p, pbot_m, fl, fl_bot, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes: gp, gm (N,N,L,B); expd (N,L,B); p (2N,N,L,B); g (2N,L,B);
// ptop_p, ptop_m (N,L,B); pbot_p, pbot_m (N,B) at the bottom layer;
// fl (2,L,B); fl_bot (2,B).  wmu: host float32[n].
PYHARP_API int pyharp_bvp_backward_flux(int n, const float* gp,
                                        const float* gm, const float* expd,
                                        const float* p, const float* g,
                                        const float* ptop_p,
                                        const float* ptop_m,
                                        const float* pbot_p,
                                        const float* pbot_m, float* fl,
                                        float* fl_bot, int L, long long B,
                                        const float* wmu, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 1: return launch<1>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 2: return launch<2>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 3: return launch<3>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 4: return launch<4>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 5: return launch<5>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 6: return launch<6>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 7: return launch<7>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    case 8: return launch<8>(gp, gm, expd, p, g, ptop_p, ptop_m, pbot_p, pbot_m, fl, fl_bot, L, B, wmu, s);
    default: return PYHARP_UNSUPPORTED_N;
  }
}
