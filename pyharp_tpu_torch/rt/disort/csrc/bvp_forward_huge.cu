// K2 at N = 33..64 (nstr 66..128): forward elimination of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:754 (_bvp_fwd_kernel),
// reached through _bvp_forward (:1180), at the N that bvp_forward_big.cu
// does not take.  It computes what bvp_forward_big.cu computes, per column
// and layer top-down: the 2N x 2N diagonal block
//     [ -[gm, gp E] + Q [gp, gm E] ;  [gp E, gm] ]
// (the Lambertian fold on the last layer's lower rows), solved against N
// unit columns and [d_top - rg ; d_bot] with the plain version's pivoted
// LU, P_l (2N x N) and g_l (2N) written, and the carry Q = R_l P_l,
// rg = R_l g_l, R_l = [gm E, gp]: kernels._bvp_forward_step, every sum in
// its order.
//
// Bound on the H100: latency and shared-memory traffic.  Per column and
// layer it reads (2N^2 + 3N)*4 bytes and writes (2N^2 + 2N)*4 (66,048 at
// N = 64) against ~(2N)^2 (3N + 1) ~ 3.2e6 flops of elimination at N = 64,
// and the layer loop is serial.
//
// Design: a block of kWarps = 8 warps per column, one body for every
// N = 33..64 with N a run-time argument.  The 2N x (3N + 1) system (98.8 KB
// at N = 64), the layer's gp and gm, and the carry Q stay in shared memory
// (150 KB at N = 64, one column an SM).  The system is built as
// bvp_forward_big.cu builds it.  Each elimination step: warp 0 finds the
// plain bubble's records of the pivot column over four sets of 32 rows
// (huge.cuh's record_bits_sets), the threads over the live columns move
// the rows as the bubble's swaps do (each column's records rotated in row
// order), then thread (warp y, lane x) takes a_rj - f a_pj, f = a_r,col
// (1 / a_col,col), on rows col + 1 + y + 8i and columns col + 1 + x + 32k,
// each entry's updates in column order as the plain version.  Back
// substitution takes right-hand side q on thread q, each sum in ascending
// column order.  A simple body: the system is not held in registers, and
// the back substitution keeps N + 1 of the 256 threads busy.
// chip_smoke.py phase 1 prints registers, stack and spills.

#include "huge.cuh"

namespace {

constexpr int kWarps = 8;                // warps a column (block)
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                 // rows of a thread's block sums
constexpr int kSets = 4;                 // row sets of 32 in 2N <= 128

// Shared-memory layout of a column for n: the system (2n rows of 3n + 1 at
// stride ld), gp, gm and Q (n rows at stride lds), E, d, rg, the
// Lambertian sums of the last layer (2n) and the pivot column's records.
struct HugeGeom {
  int m, w, ld, lds, gp, gm, q, e, d, rg, refl, bits, floats;
  __host__ __device__ explicit HugeGeom(int n)
      : m(2 * n), w(3 * n + 1), ld(odd_stride(3 * n + 1)), lds(odd_stride(n)),
        gp(m * ld), gm(gp + n * lds), q(gm + n * lds), e(q + n * lds),
        d(e + n), rg(d + m), refl(rg + n), bits(refl + m),
        floats(bits + kSets) {}
};

// Input k of a layer (gp, gm, E, d flattened in that order).
__device__ __forceinline__ float layer_input(const float* __restrict__ gp,
                                             const float* __restrict__ gm,
                                             const float* __restrict__ ev,
                                             const float* __restrict__ dv,
                                             int k, int n, int64_t LB,
                                             int64_t o) {
  const int nn = n * n;
  if (k < nn) return gp[k * LB + o];
  if (k < 2 * nn) return gm[(k - nn) * LB + o];
  if (k < 2 * nn + n) return ev[(k - 2 * nn) * LB + o];
  return dv[(k - 2 * nn - n) * LB + o];
}

__global__ void __launch_bounds__(kThreads, 1)
bvp_forward_huge_kernel(const float* __restrict__ gp_in,
                        const float* __restrict__ gm_in,
                        const float* __restrict__ e_in,
                        const float* __restrict__ d_in,
                        const float* __restrict__ alb_in,
                        float* __restrict__ p_out, float* __restrict__ g_out,
                        int n, int L, int64_t B, FloatN<kHugeMaxN> wmu) {
  extern __shared__ __align__(16) float smem[];
  const HugeGeom G(n);
  const int tid = static_cast<int>(threadIdx.x);
  const int t = tid & 31;
  const int wy = tid >> 5;
  const int64_t b = blockIdx.x;
  const int64_t LB = static_cast<int64_t>(L) * B;
  float* A = smem;
  float* sgp = smem + G.gp;
  float* sgm = smem + G.gm;
  float* sq = smem + G.q;
  float* se = smem + G.e;
  float* sd = smem + G.d;
  float* srg = smem + G.rg;
  float* srefl = smem + G.refl;
  unsigned* sbits = reinterpret_cast<unsigned*>(smem + G.bits);
  const int m = G.m, w = G.w, ld = G.ld, lds = G.lds;
  const int nn = n * n;
  const int nin = 2 * nn + 3 * n;
  const int nb = (n + kRows - 1) / kRows;    // batches of kRows rows
  const float alb2 = 2.0f * alb_in[b];

  // the carry above the first layer: zeros
  for (int k = tid; k < n * lds; k += kThreads) sq[k] = 0.0f;
  for (int k = tid; k < n; k += kThreads) srg[k] = 0.0f;

  for (int l = 0; l < L; ++l) {
    const int64_t o = static_cast<int64_t>(l) * B + b;
    // stage this layer's inputs, every load before the first store
    {
      float v[(2 * kHugeMaxN * kHugeMaxN + 3 * kHugeMaxN + kThreads - 1)
              / kThreads];
      constexpr int kPre = sizeof(v) / sizeof(float);
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int k = tid + i * kThreads;
        v[i] = k < nin ? layer_input(gp_in, gm_in, e_in, d_in, k, n, LB, o)
                       : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < kPre; ++i) {
        const int k = tid + i * kThreads;
        if (k < nn) {
          sgp[(k / n) * lds + k % n] = v[i];
        } else if (k < 2 * nn) {
          sgm[((k - nn) / n) * lds + (k - nn) % n] = v[i];
        } else if (k < 2 * nn + n) {
          se[k - 2 * nn] = v[i];
        } else if (k < nin) {
          sd[k - 2 * nn - n] = v[i];
        }
      }
    }
    __syncthreads();

    const bool last = l == L - 1;
    if (last) {
      // sum_r wmu_r Rn[r][c], Rn = [gm E, gp], for the block columns c
      for (int c = tid; c < m; c += kThreads) {
        const int cc = c < n ? c : c - n;
        const float ec = se[cc];
        float acc = 0.0f;
        for (int r = 0; r < n; ++r) {
          const float rv = c < n ? sgm[r * lds + cc] * ec : sgp[r * lds + cc];
          acc = (r == 0) ? wmu.v[0] * rv : acc + wmu.v[r] * rv;
        }
        srefl[c] = acc;
      }
      __syncthreads();
    }
    // the upper block rows -Ttop + Q Dn (Ttop = [gm, gp E], Dn = [gp,
    // gm E]), kRows rows of one column c a thread, each sum over j in order
    for (int k = tid; k < nb * m; k += kThreads) {
      const int i0 = (k / m) * kRows;
      const int c = k - (k / m) * m;
      const bool hi = c >= n;
      const int cc = hi ? c - n : c;
      const float ec = se[cc];
      const float* dcol = hi ? sgm + cc : sgp + cc;
      float acc[kRows] = {};
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float dj = dcol[j * lds];
        if (hi) dj = dj * ec;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qv = sq[min(i0 + r, n - 1) * lds + j];
          acc[r] = j == 0 ? qv * dj : acc[r] + qv * dj;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < n) {
          const float tv = hi ? sgp[i * lds + cc] * ec : sgm[i * lds + cc];
          A[i * ld + c] = -tv + acc[r];
        }
      }
    }
    // the lower block rows Blow = [gp E, gm], less the fold on the last
    // layer, the unit columns and the right-hand side
    for (int k = tid; k < n * m; k += kThreads) {
      const int ii = k / m;
      const int c = k - ii * m;
      const bool hi = c >= n;
      const int cc = hi ? c - n : c;
      float v = hi ? sgm[ii * lds + cc] : sgp[ii * lds + cc] * se[cc];
      if (last) v = v - alb2 * srefl[c];
      A[(n + ii) * ld + c] = v;
    }
    for (int k = tid; k < m * (n + 1); k += kThreads) {
      const int r = k / (n + 1);
      const int q = k - r * (n + 1);
      A[r * ld + m + q] = q < n ? ((r == n + q) ? 1.0f : 0.0f)
                                : (r < n ? sd[r] - srg[r] : sd[r]);
    }
    __syncthreads();

    // the elimination in shared memory
    for (int col = 0; col + 1 < m; ++col) {
      if (wy == 0) {
        float a[kSets];
#pragma unroll
        for (int h = 0; h < kSets; ++h) {
          const int r = t + 32 * h;
          a[h] = r < m ? A[r * ld + col] : 0.0f;
        }
        unsigned bits[kSets];
        record_bits_sets<kSets>(a, m, col, t, bits);
        if (t < kSets) {
#pragma unroll
          for (int h = 0; h < kSets; ++h) {
            if (t == h) sbits[h] = bits[h];
          }
        }
      }
      __syncthreads();
      // the bubble's swaps of row col with each record in row order: row
      // col's entry moves to the first record, each record's to the next,
      // the last record's to row col
      for (int j = col + tid; j < w; j += kThreads) {
        float v = A[col * ld + j];
        bool any = false;
#pragma unroll
        for (int h = 0; h < kSets; ++h) {
          unsigned bits = sbits[h];
          while (bits != 0u) {
            const int r = 32 * h + __ffs(static_cast<int>(bits)) - 1;
            bits &= bits - 1u;
            const float x = A[r * ld + j];
            A[r * ld + j] = v;
            v = x;
            any = true;
          }
        }
        if (any) A[col * ld + j] = v;
      }
      __syncthreads();
      // every row below the pivot less f times the pivot row, right of col
      const float inv = 1.0f / A[col * ld + col];
      for (int j = col + 1 + t; j < w; j += 32) {
        const float pj = A[col * ld + j];
        for (int r = col + 1 + wy; r < m; r += kWarps) {
          const float f = A[r * ld + col] * inv;
          A[r * ld + j] = A[r * ld + j] - f * pj;
        }
      }
      __syncthreads();
    }

    // back substitution, right-hand side q on thread q, each sum in
    // ascending column order, the solution over the right-hand side
    if (tid <= n) {
      const int q = m + tid;
      for (int i = m - 1; i >= 0; --i) {
        const float* row = A + i * ld;
        float acc = row[q];
        int c = i + 1;
        for (; c + 4 <= m; c += 4) {
          float u[4];
          float x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            u[k] = row[c + k];
            x[k] = A[(c + k) * ld + q];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc = acc - u[k] * x[k];
        }
        for (; c < m; ++c) acc = acc - row[c] * A[c * ld + q];
        A[i * ld + q] = acc / row[i];
      }
    }
    __syncthreads();

    // P_l[r][q] = x_q[r], g_l = x_n
    for (int k = tid; k < m * n; k += kThreads) {
      const int r = k / n;
      const int q = k - r * n;
      p_out[k * LB + o] = A[r * ld + m + q];
    }
    for (int r = tid; r < m; r += kThreads) {
      g_out[r * LB + o] = A[r * ld + m + n];
    }
    if (l + 1 == L) break;
    // the carry: Q[i][j] = sum_k Rn[i][k] P[k][j], rg[i] = sum_k Rn[i][k]
    // g[k], Rn = [gm E, gp]; kRows rows of one column j a thread
    for (int k = tid; k < nb * (n + 1); k += kThreads) {
      const int i0 = (k / (n + 1)) * kRows;
      const int j = k - (k / (n + 1)) * (n + 1);
      float acc[kRows] = {};
#pragma unroll 4
      for (int kk = 0; kk < m; ++kk) {
        const float xv = A[kk * ld + m + j];
        const bool lo = kk < n;
        const float ek = lo ? se[kk] : 1.0f;
        const float* rcol = lo ? sgm + kk : sgp + (kk - n);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float rn = rcol[min(i0 + r, n - 1) * lds];
          if (lo) rn = rn * ek;
          acc[r] = kk == 0 ? rn * xv : acc[r] + rn * xv;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int i = i0 + r;
        if (i < n) {
          if (j < n) {
            sq[i * lds + j] = acc[r];
          } else {
            srg[i] = acc[r];
          }
        }
      }
    }
    __syncthreads();
  }
}

int smem_bytes(int n) {
  return HugeGeom(n).floats * static_cast<int>(sizeof(float));
}

// The attribute belongs to the current device: set it on every launch (and
// every occupancy query).
cudaError_t allow_smem(int n) {
  return cudaFuncSetAttribute(bvp_forward_huge_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(n));
}

}  // namespace

// Shapes as pyharp_bvp_forward (bvp_forward.cu), for n = 33..64.
PYHARP_API int pyharp_bvp_forward_huge(int n, const float* gp, const float* gm,
                                       const float* expd, const float* dblk,
                                       const float* albedo, float* p, float* g,
                                       int L, long long B, const float* wmu,
                                       void* stream) {
  if (n < kHugeMinN || n > kHugeMaxN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  FloatN<kHugeMaxN> w{};
  for (int i = 0; i < n; ++i) w.v[i] = wmu[i];
  const cudaError_t err = allow_smem(n);
  if (err != cudaSuccess) return static_cast<int>(err);
  bvp_forward_huge_kernel<<<static_cast<unsigned>(B), kThreads,
                            smem_bytes(n),
                            static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, dblk, albedo, p, g, n, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM at n, by the occupancy calculator.
PYHARP_API int pyharp_bvp_forward_huge_occupancy(int n) {
  if (allow_smem(n) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bvp_forward_huge_kernel, kThreads, smem_bytes(n)) !=
      cudaSuccess)
    return -1;
  return blocks;
}
