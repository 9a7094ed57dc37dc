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
// rg = R_l g_l, R_l = [gm E, gp]: kernels._bvp_forward_step, each sum of
// the build, the elimination and the carry in its order.
//
// Bound on the H100: latency.  Per column and layer it reads (2N^2 + 3N)*4
// bytes and writes (2N^2 + 2N)*4 (66,048 at N = 64) against ~(2N)^2 (3N +
// 1) ~ 3.2e6 flops of elimination at N = 64, and the layer loop is serial.
//
// Design: bvp_forward_big.cu's body over a block of kWarps = 16 warps per
// column, one body for every N = 33..64 with N a run-time argument (the
// block takes its SM: 512 threads at up to 128 registers and ~150 KB of
// shared memory at N = 64).
//  - The layer's gp, gm (N x N at an odd row stride), E and d are staged in
//    shared memory, every load of a thread issued before its first store.
//  - The system is built straight into the elimination's register tiles:
//    thread (ty, tx) = (tid / 16, tid % 16) holds rows ty + 32i (i < 4)
//    and columns tx + 16k (k < 13) of the 2N x (3N + 1) system, 52 values.
//    Its upper rows -Ttop + Q Dn (rows ty and ty + 32, columns tx + 16k,
//    k < 8: 16 sums a thread, each over j in order), its lower rows, unit
//    columns and right-hand side entry by entry.
//  - Rows never move.  Each warp keeps its own logical-to-physical row map,
//    lane t holding logical rows t + 32h (h < 4).  A step col: the threads
//    holding column col publish it (two buffers, so that a step's writes
//    never meet the last step's reads); every warp reads it through its
//    map, finds the plain bubble's records over four sets of 32 rows
//    (huge.cuh's record_bits_sets) and updates the map in one step
//    (apply_records_sets); the threads holding the pivot row publish it
//    right of col; every thread takes a_rj - f a_pj, f = a_r,col (1 /
//    a_p,col), on the live rows and the columns right of col of its tile,
//    each entry's updates in column order as the plain version.  Two
//    barriers a step, no shared-memory round trip per update; the column
//    loop runs in unrolled blocks of 16, so every register index is a
//    constant.  The search through the maps is the long part (~2,600 of
//    ~3,400 cycles a step at N = 64, tools/wide_ab.py's k2_cycles); one
//    searching warp, 8 warps a column, or the next column searched under
//    the update did not shorten the step.
//  - The rows go back to shared memory in logical order, and back
//    substitution takes each right-hand side on a group of four lanes of
//    one warp (the N + 1 of them on 4N + 4 threads): for row i, lane s of
//    the group sums u_ic x_c over its columns c = s (mod 4), c > i, in
//    ascending order, the four sums are added as (s0 + s1) + (s2 + s3) by
//    two shuffles, and x_i = (b_i - sum) / u_ii.  This order is not the
//    plain version's (b_i less each product in ascending c): the body is
//    built with multiply-add contraction and held to the BVP bound.
//  - The stores of P and g entry by entry; the carry Q = R_l P_l (8 rows
//    of one column a thread, 8N <= 512 threads) and rg = R_l g_l (a row a
//    thread), each sum over k in order.
// chip_smoke.py phase 22 prints registers, stack and spills;
// tools/wide_ab.py's part k2_cycles the cycles by phase.

#include "huge.cuh"

namespace {

constexpr int kWarps = 16;               // warps a column (block)
constexpr int kThreads = 32 * kWarps;
constexpr int kStep = kThreads / 16;     // tile rows: ty + kStep i
constexpr int kTr = 128 / kStep;         // (i < kTr: 2N <= 128 rows)
constexpr int kTc = 13;                  // tile columns: tx + 16k (208 >= 193)
constexpr int kUp = 8;                   // tile columns of the block (c < 128)
constexpr int kUpRows = 64 / kStep;      // tile rows of the block (r < 64)
constexpr int kLanes = kThreads / 128;   // lanes a right-hand side (65 of them)
constexpr int kCarryRows = 64 * 64 / kThreads;   // rows of a carry sum
constexpr int kSets = 4;                 // row sets of 32 in 2N <= 128
static_assert(kLanes == 2 || kLanes == 4, "lanes a right-hand side");

// Shared-memory layout of a column for n: the system in logical order for
// the back substitution (2n rows of 3n + 1 at stride ld), gp, gm and Q (n
// rows at stride lds), E, d, rg, the Lambertian sums of the last layer
// (2n), the pivot column (two buffers of 128), the pivot row (16 kTc) and
// the final row map (128 ints).
struct HugeGeom {
  int m, w, ld, lds, gp, gm, q, e, d, rg, refl, col, piv, perm, floats;
  __host__ __device__ explicit HugeGeom(int n)
      : m(2 * n), w(3 * n + 1), ld(odd_stride(3 * n + 1)), lds(odd_stride(n)),
        gp(m * ld), gm(gp + n * lds), q(gm + n * lds), e(q + n * lds),
        d(e + n), rg(d + m), refl(rg + n), col(refl + m), piv(col + 256),
        perm(piv + 16 * kTc), floats(perm + 128) {}
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

// a[i][k] with i a run-time index, by selects over the constant indices.
__device__ __forceinline__ float tile_row(const float (&a)[kTr][kTc], int i,
                                          int k) {
  float v = a[0][k];
#pragma unroll
  for (int r = 1; r < kTr; ++r) v = i == r ? a[r][k] : v;
  return v;
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
  const int ty = tid >> 4;
  const int tx = tid & 15;
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
  float* scol = smem + G.col;           // the pivot column, two buffers
  float* spiv = smem + G.piv;           // the pivot row
  int* slog = reinterpret_cast<int*>(smem + G.perm);
  const int m = G.m, w = G.w, ld = G.ld, lds = G.lds;
  const int nn = n * n;
  const int nin = 2 * nn + 3 * n;
  const float alb2 = 2.0f * alb_in[b];
  BIG_PROF_START();

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
    BIG_PROF_MARK(0);

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

    // the system straight into the tiles
    float a[kTr][kTc];
    {
      // the upper block rows -Ttop + Q Dn (Ttop = [gm, gp E], Dn = [gp,
      // gm E]) at rows ty + kStep i, i < kUpRows (clamped past n), and
      // the block columns tx + 16k, k < kUp (clamped past m): each sum
      // over j in order
      int qofs[kUpRows];
#pragma unroll
      for (int i = 0; i < kUpRows; ++i) {
        qofs[i] = min(ty + kStep * i, n - 1) * lds;
      }
      int dofs[kUp];
      float dsc[kUp];
#pragma unroll
      for (int k = 0; k < kUp; ++k) {
        const int c = min(tx + 16 * k, m - 1);
        const bool hi = c >= n;
        const int cc = hi ? c - n : c;
        dofs[k] = (hi ? G.gm : G.gp) + cc;
        dsc[k] = hi ? se[cc] : 1.0f;
      }
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        float qv[kUpRows];
#pragma unroll
        for (int i = 0; i < kUpRows; ++i) qv[i] = sq[qofs[i] + j];
#pragma unroll
        for (int k = 0; k < kUp; ++k) {
          const float dj = smem[dofs[k] + j * lds] * dsc[k];
#pragma unroll
          for (int i = 0; i < kUpRows; ++i) {
            a[i][k] = j == 0 ? qv[i] * dj : a[i][k] + qv[i] * dj;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
      const int r = ty + kStep * i;
#pragma unroll
      for (int k = 0; k < kTc; ++k) {
        const int c = tx + 16 * k;
        float v = 0.0f;
        if (r < m && c < m) {
          const bool hi = c >= n;
          const int cc = hi ? c - n : c;
          if (r < n) {
            if (i < kUpRows && k < kUp) {
              const float tv = hi ? sgp[r * lds + cc] * se[cc]
                                  : sgm[r * lds + cc];
              v = -tv + a[i][k];
            }
          } else {
            // the lower block rows Blow = [gp E, gm], less the fold on
            // the last layer
            const int ii = r - n;
            v = hi ? sgm[ii * lds + cc] : sgp[ii * lds + cc] * se[cc];
            if (last) v = v - alb2 * srefl[c];
          }
        } else if (r < m && c < w) {
          // the unit columns and the right-hand side
          const int q = c - m;
          v = q < n ? ((r == n + q) ? 1.0f : 0.0f)
                    : (r < n ? sd[r] - srg[r] : sd[r]);
        }
        a[i][k] = v;
      }
    }
    BIG_PROF_MARK(1);

    // the elimination in registers, rows never moved
    unsigned dead = 0u;   // bit i: row ty + kStep i a pivot row or past m
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
      if (ty + kStep * i >= m) dead |= 1u << i;
    }
    int p[kSets];              // each warp's map: logical t + 32h -> physical
#pragma unroll
    for (int h = 0; h < kSets; ++h) p[h] = t + 32 * h;
#pragma unroll
    for (int kb = 0; kb < kUp; ++kb) {
      if (16 * kb + 1 >= m) break;
      for (int cl = 0; cl < 16; ++cl) {
        const int col = 16 * kb + cl;
        if (col + 1 >= m) break;
        float* cv = scol + 128 * (col & 1);
        // the owners of column col publish it
        if (tx == cl) {
#pragma unroll
          for (int i = 0; i < kTr; ++i) {
            if (ty + kStep * i < m) cv[ty + kStep * i] = a[i][kb];
          }
        }
        __syncthreads();
        // every warp: the records through its map, the map in one step
        float av[kSets];
#pragma unroll
        for (int h = 0; h < kSets; ++h) {
          av[h] = t + 32 * h < m ? cv[p[h]] : 0.0f;
        }
        unsigned bits[kSets];
        record_bits_sets<kSets>(av, m, col, t, bits);
        if ((bits[0] | bits[1] | bits[2] | bits[3]) != 0u) {
          apply_records_sets<kSets>(bits, col, t, p);
        }
        const int pv = __shfl_sync(kBigFull, p[kb >> 1], col & 31);
        const float inv = 1.0f / cv[pv];
        if (pv % kStep == ty) dead |= 1u << (pv / kStep);
        // the owners of the pivot row publish it right of col
        if (ty == pv % kStep) {
          const int ip = pv / kStep;
#pragma unroll
          for (int k = kb; k < kTc; ++k) spiv[tx + 16 * k] = tile_row(a, ip, k);
        }
        __syncthreads();
        BIG_PROF_MARK(2);
        // every live row less f times the pivot row, right of col
        float pj[kTc];
#pragma unroll
        for (int k = kb; k < kTc; ++k) pj[k] = spiv[tx + 16 * k];
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          if (((dead >> i) & 1u) == 0u) {
            const float f = cv[ty + kStep * i] * inv;
#pragma unroll
            for (int k = kb; k < kTc; ++k) {
              const int c = tx + 16 * k;
              if (c < w && (k > kb || tx > cl)) {
                a[i][k] = a[i][k] - f * pj[k];
              }
            }
          }
        }
        BIG_PROF_MARK(3);
      }
    }
    // the rows in logical order back into shared memory
    if (tid < 32) {
#pragma unroll
      for (int h = 0; h < kSets; ++h) {
        if (t + 32 * h < m) slog[p[h]] = t + 32 * h;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
      const int r = ty + kStep * i;
      if (r < m) {
        const int lr = slog[r];
#pragma unroll
        for (int k = 0; k < kTc; ++k) {
          const int c = tx + 16 * k;
          if (c < w) A[lr * ld + c] = a[i][k];
        }
      }
    }
    __syncthreads();

    // back substitution: right-hand side q on the kLanes lanes kLanes q
    // on, lane s summing the columns c = s (mod kLanes) in ascending
    // order, the solution over the right-hand side
    if (tid < ((kLanes * (n + 1) + 31) & ~31)) {
      const int s = tid & (kLanes - 1);
      const int qq = tid / kLanes;
      const int q = m + min(qq, n);
      for (int i = m - 1; i >= 0; --i) {
        const float* row = A + i * ld;
        float acc = 0.0f;
        // the first c > i with c = s (mod kLanes)
        int c = i + 1 + ((s - (i + 1)) & (kLanes - 1));
        for (; c + 3 * kLanes < m; c += 4 * kLanes) {
          float u[4];
          float x[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            u[k] = row[c + kLanes * k];
            x[k] = A[(c + kLanes * k) * ld + q];
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) acc = acc + u[k] * x[k];
        }
        for (; c < m; c += kLanes) acc = acc + row[c] * A[c * ld + q];
#pragma unroll
        for (int off = 1; off < kLanes; off *= 2) {
          acc = acc + __shfl_xor_sync(kBigFull, acc, off);
        }
        const float xi = (row[q] - acc) / row[i];
        __syncwarp();
        if (s == 0 && qq <= n) A[i * ld + q] = xi;
        __syncwarp();
      }
    }
    __syncthreads();
    BIG_PROF_MARK(4);

    // P_l[r][q] = x_q[r], g_l = x_n
    for (int k = tid; k < m * n; k += kThreads) {
      const int r = k / n;
      const int q = k - r * n;
      p_out[k * LB + o] = A[r * ld + m + q];
    }
    for (int r = tid; r < m; r += kThreads) {
      g_out[r * LB + o] = A[r * ld + m + n];
    }
    BIG_PROF_MARK(5);
    if (l + 1 == L) break;
    // the carry: Q[i][j] = sum_k Rn[i][k] P[k][j], Rn = [gm E, gp];
    // kCarryRows rows of one column j a thread, then rg[i] = sum_k
    // Rn[i][k] g[k] a row a thread (each sum over k in order)
    {
      const int nb = (n + kCarryRows - 1) / kCarryRows;
      if (tid < nb * n) {
        const int i0 = (tid / n) * kCarryRows;
        const int j = tid - (tid / n) * n;
        float acc[kCarryRows];
#pragma unroll 2
        for (int kk = 0; kk < m; ++kk) {
          const float xv = A[kk * ld + m + j];
          const bool lo = kk < n;
          const float ek = lo ? se[kk] : 1.0f;
          const float* rcol = lo ? sgm + kk : sgp + (kk - n);
#pragma unroll
          for (int r = 0; r < kCarryRows; ++r) {
            const float rn = rcol[min(i0 + r, n - 1) * lds] * ek;
            acc[r] = kk == 0 ? rn * xv : acc[r] + rn * xv;
          }
        }
#pragma unroll
        for (int r = 0; r < kCarryRows; ++r) {
          if (i0 + r < n) sq[(i0 + r) * lds + j] = acc[r];
        }
      }
      if (tid < n) {
        float acc = 0.0f;
        for (int kk = 0; kk < m; ++kk) {
          const float xv = A[kk * ld + m + n];
          const float rn = kk < n ? sgm[tid * lds + kk] * se[kk]
                                  : sgp[tid * lds + kk - n];
          acc = kk == 0 ? rn * xv : acc + rn * xv;
        }
        srg[tid] = acc;
      }
    }
    __syncthreads();
    BIG_PROF_MARK(6);
  }
  BIG_PROF_FLUSH();
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

BIG_PROF_READER(bvp_forward_huge)

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

// Dynamic shared memory a block (a column) takes at n, in bytes.
PYHARP_API int pyharp_bvp_forward_huge_smem(int n) { return smem_bytes(n); }
