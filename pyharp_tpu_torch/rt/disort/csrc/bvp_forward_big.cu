// K2 at N = 17..32 (nstr 34..64): forward elimination of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:754 (_bvp_fwd_kernel),
// reached through _bvp_forward (:1180), at the N that bvp_forward.cu and
// bvp_forward_wide.cu do not take.  Per column, layer by layer top-down, it
// builds the 2N x 2N diagonal block
//     [ -[gm, gp E] + Q [gp, gm E] ;  [gp E, gm] ]
// (the Lambertian fold -2 albedo sum_r wmu_r [gm E, gp]_r on the last
// layer's lower rows), solves it against N unit columns selecting the lower
// block and the right-hand side [d_top - rg ; d_bot] with the plain
// version's pivoted LU, writes P_l (2N x N) and g_l (2N), and forms the
// carry Q = R_l P_l, rg = R_l g_l, R_l = [gm E, gp], for the next layer:
// kernels._bvp_forward_step, every sum in its order.
//
// Bound on the H100: latency and instruction rate.  Per column and layer it
// reads (2N^2 + 3N)*4 bytes and writes (2N^2 + 2N)*4 (16,640 at N = 32)
// against ~(2N)^2 (3N + 1) ~ 400,000 flops of elimination at N = 32, and
// the layer loop is serial.
//
// Design: a warp per column, the system in shared memory, one body for
// every N = 17..32 with N a run-time argument.  The wide body's layout (a
// block column a lane, the lower block at lane position 16) needs 2N <= 32
// positions and holds Q in 45 KB for 4 columns; here the 2N rows are more
// than a warp's lanes, so lane t owns rows t and t + 32.
//  - The layer's gp, gm (N x N at an odd row stride) and E are staged in
//    shared memory; lane t < N builds block columns t and N + t (both
//    from gp's and gm's column t) and the lanes build the unit columns and
//    the right-hand side by rows.
//  - big.cuh's warp_lu_solve: the swap bits from a prefix max over the
//    rows of both halves and two ballots (record_bits), the swaps by lanes
//    over columns, the elimination by rows, back substitution by
//    right-hand side.
//  - The carry by rows of Q (lane t row t), P and g from shared memory.
// Shared memory per column: the 2N x (3N + 1) system, gp, gm, Q (N x N
// each) and E, rg: 37.8 KB at N = 32, sized at launch for the run-time N;
// kCols columns a block.  Stores of P and g go out a lane an entry.
// chip_smoke.py phase 1 prints registers, stack and spills.

#include "big.cuh"

namespace {

constexpr int kCols = 2;                 // columns (warps) a block

// Shared-memory layout of one column for n.
// The system (2n rows of 3n + 1 at stride ld) first, then gp, gm and Q
// (n rows at stride lds), E and rg.
struct BigGeom {
  int m, ld, lds, gp, gm, q, e, rg, floats;
  __host__ __device__ explicit BigGeom(int n)
      : m(2 * n), ld(odd_stride(3 * n + 1)), lds(odd_stride(n)), gp(m * ld),
        gm(gp + n * lds), q(gm + n * lds), e(q + n * lds), rg(e + n),
        floats(rg + n) {}
};

__global__ void __launch_bounds__(32 * kCols)
bvp_forward_big_kernel(const float* __restrict__ gp_in,
                       const float* __restrict__ gm_in,
                       const float* __restrict__ e_in,
                       const float* __restrict__ d_in,
                       const float* __restrict__ alb_in,
                       float* __restrict__ p_out, float* __restrict__ g_out,
                       int n, int L, int64_t B, FloatN<kBigMaxN> wmu) {
  extern __shared__ __align__(16) float smem[];
  const BigGeom G(n);
  const int t = static_cast<int>(threadIdx.x) & 31;
  const int wi = static_cast<int>(threadIdx.x) >> 5;
  const int64_t b = static_cast<int64_t>(blockIdx.x) * kCols + wi;
  if (b >= B) return;                    // a whole warp: no shuffle partner
  const int64_t LB = static_cast<int64_t>(L) * B;
  float* A = smem + wi * G.floats;
  float* sgp = A + G.gp;
  float* sgm = A + G.gm;
  float* sq = A + G.q;
  float* se = A + G.e;
  float* srg = A + G.rg;
  const int m = G.m, ld = G.ld, lds = G.lds;
  const float alb2 = 2.0f * alb_in[b];

  // the carry above the first layer: zeros
  for (int k = t; k < n * lds; k += 32) sq[k] = 0.0f;
  for (int k = t; k < n; k += 32) srg[k] = 0.0f;

  for (int l = 0; l < L; ++l) {
    const int64_t o = static_cast<int64_t>(l) * B + b;
    for (int k = t; k < n * n; k += 32) {
      const int i = k / n;
      const int j = k - i * n;
      sgp[i * lds + j] = gp_in[k * LB + o];
      sgm[i * lds + j] = gm_in[k * LB + o];
    }
    for (int k = t; k < n; k += 32) se[k] = e_in[k * LB + o];
    __syncwarp();

    // block columns t and n + t
    if (t < n) {
      const float ej = se[t];
      float refl_lo = 0.0f;
      float refl_hi = 0.0f;
      if (l == L - 1) {
        // sum_r wmu_r Rn[r][j], Rn = [gm E, gp]
        for (int r = 0; r < n; ++r) {
          const float rlo = sgm[r * lds + t] * ej;
          const float rhi = sgp[r * lds + t];
          refl_lo = (r == 0) ? wmu.v[0] * rlo : refl_lo + wmu.v[r] * rlo;
          refl_hi = (r == 0) ? wmu.v[0] * rhi : refl_hi + wmu.v[r] * rhi;
        }
      }
      for (int i = 0; i < n; ++i) {
        // upper: -Ttop + Q Dn, Ttop = [gm, gp E], Dn = [gp, gm E]
        float acc_lo = sq[i * lds] * sgp[t];
        float acc_hi = sq[i * lds] * (sgm[t] * ej);
        for (int k = 1; k < n; ++k) {
          const float qik = sq[i * lds + k];
          acc_lo = acc_lo + qik * sgp[k * lds + t];
          acc_hi = acc_hi + qik * (sgm[k * lds + t] * ej);
        }
        A[i * ld + t] = -sgm[i * lds + t] + acc_lo;
        A[i * ld + n + t] = -(sgp[i * lds + t] * ej) + acc_hi;
        // lower: Blow = [gp E, gm]
        float blo = sgp[i * lds + t] * ej;
        float bhi = sgm[i * lds + t];
        if (l == L - 1) {
          blo = blo - alb2 * refl_lo;
          bhi = bhi - alb2 * refl_hi;
        }
        A[(n + i) * ld + t] = blo;
        A[(n + i) * ld + n + t] = bhi;
      }
    }
    // the unit columns and the right-hand side, by rows
    for (int r = t; r < m; r += 32) {
      for (int q = 0; q < n; ++q) A[r * ld + m + q] = (r == n + q) ? 1.0f : 0.0f;
      const float d = d_in[r * LB + o];
      A[r * ld + m + n] = r < n ? d - srg[r] : d;
    }
    __syncwarp();

    warp_lu_solve(A, ld, m, n + 1, t);

    // P_l[r][q] = x_q[r], g_l = x_n
    for (int k = t; k < m * n; k += 32) {
      const int r = k / n;
      const int q = k - r * n;
      p_out[k * LB + o] = A[r * ld + m + q];
    }
    for (int r = t; r < m; r += 32) g_out[r * LB + o] = A[r * ld + m + n];
    if (l + 1 == L) break;
    // the carry: Q[t][j] = sum_k Rn[t][k] P[k][j], rg[t] = sum_k Rn[t][k]
    // g[k], Rn = [gm E, gp]
    if (t < n) {
      for (int j = 0; j <= n; ++j) {
        float acc = (sgm[t * lds] * se[0]) * A[m + j];
        for (int k = 1; k < m; ++k) {
          const float rn = k < n ? sgm[t * lds + k] * se[k]
                                 : sgp[t * lds + k - n];
          acc = acc + rn * A[k * ld + m + j];
        }
        if (j < n) {
          sq[t * lds + j] = acc;
        } else {
          srg[t] = acc;
        }
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Shapes as pyharp_bvp_forward (bvp_forward.cu), for n = 17..32.
PYHARP_API int pyharp_bvp_forward_big(int n, const float* gp, const float* gm,
                                      const float* expd, const float* dblk,
                                      const float* albedo, float* p, float* g,
                                      int L, long long B, const float* wmu,
                                      void* stream) {
  if (n < kBigMinN || n > kBigMaxN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  FloatN<kBigMaxN> w{};
  for (int i = 0; i < n; ++i) w.v[i] = wmu[i];
  const int bytes = kCols * BigGeom(n).floats * static_cast<int>(sizeof(float));
  // the attribute belongs to the current device: set it on every launch
  const cudaError_t err = cudaFuncSetAttribute(
      bvp_forward_big_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto blocks = static_cast<unsigned>((B + kCols - 1) / kCols);
  bvp_forward_big_kernel<<<blocks, 32 * kCols, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, dblk, albedo, p, g, n, L, B, w);
  return static_cast<int>(cudaGetLastError());
}
