// K5: back-substitution of the layer-coupling boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:846 (_bvp_bwd_kernel),
// reached through solve_bvp_pallas (:1233), the JAX package's path for
// N > 4 (disort.py:447).
//
// One thread owns one column b and walks the layers bottom-up, L-1 to 0,
// with the carry dx (N) in registers: x_l = g_l + P_l dx gives the layer's
// coefficients (a, b) = (x[:N], x[N:]), written out, and the next carry is
// dx = gp a + (gm E) b of this layer, in the plain version's order (the
// two sums formed apart, then added).  With no layer chunks there is no
// padded sublayer to mask.
//
// Bound on the H100: memory.  Per column and layer it reads
// (4N^2 + 3N)*4 bytes (gp, gm, P, g, E: 1120 bytes at N = 8) and writes
// 8N (64 at N = 8), against ~8N^2 flops (~0.4 flop/byte), far below the
// f32 ridge of ~20 flop/byte; each thread streams its column with loads
// coalesced along B and keeps only dx and x (3N floats) live between
// layers.  N = 9..16 (nstr 18..32) run the same sweep, one template
// instantiation each (bvp_backward_wide_kernel: each row's loads kept
// behind the previous row, so that dx and x, 48 floats at N = 16, are all
// that stays live); its inputs come to 4,288 bytes per column and layer.
// chip_smoke.py phase 1 prints the registers and spills of every build.

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

// An empty asm with a memory clobber: no load or store moves across it.
__device__ __forceinline__ void fence_loads() { asm volatile("" ::: "memory"); }

// The same sweep at N = 9..16, with each row's loads kept behind the
// previous row's use: fully unrolled, the compiler otherwise emits all
// 2N^2 loads of P (and 2N^2 of gp, gm) before the first product and holds
// them, 255 registers and up to 3 KB of spills at N = 16.  The arithmetic
// and its order are bvp_layer_coeffs' and bvp_layer_carry's.  Each row's
// stores of a or b sit between the fences: with the fences alone, inside
// the shared layer steps and the stores after the rows, ptxas still
// hoisted the loads (255 registers and 8 B-3.2 KB of spills at N = 11..16).
template <int N>
__global__ void __launch_bounds__(64)
bvp_backward_wide_kernel(const float* __restrict__ gp_in,
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
#pragma unroll
    for (int i = 0; i < M; ++i) {
      const float* p = p_in + (i * N) * LB + o;
      float acc = p[0] * dx[0];
#pragma unroll
      for (int k = 1; k < N; ++k) acc = acc + p[k * LB] * dx[k];
      x[i] = g_in[i * LB + o] + acc;
      if (i < N) {
        a_out[i * LB + o] = x[i];
      } else {
        b_out[(i - N) * LB + o] = x[i];
      }
      fence_loads();
    }
    float E[N];
#pragma unroll
    for (int k = 0; k < N; ++k) E[k] = e_in[k * LB + o];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      float up = gp_in[(i * N) * LB + o] * x[0];
      float dn = (gm_in[(i * N) * LB + o] * E[0]) * x[N];
#pragma unroll
      for (int k = 1; k < N; ++k) {
        up = up + gp_in[(i * N + k) * LB + o] * x[k];
        dn = dn + (gm_in[(i * N + k) * LB + o] * E[k]) * x[N + k];
      }
      dx[i] = up + dn;
      fence_loads();
    }
  }
}

template <int N>
int launch(const float* gp, const float* gm, const float* expd,
           const float* p, const float* g, float* a, float* b, int L,
           int64_t B, cudaStream_t stream) {
  if (B == 0 || L == 0) return 0;
  constexpr int kThreads = 64;
  const auto blocks = static_cast<unsigned>((B + kThreads - 1) / kThreads);
  if constexpr (N > kNarrowMaxN) {
    bvp_backward_wide_kernel<N><<<blocks, kThreads, 0, stream>>>(
        gp, gm, expd, p, g, a, b, L, B);
  } else {
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
