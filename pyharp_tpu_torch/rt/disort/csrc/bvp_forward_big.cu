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
// Design: a block of kWarps = 4 warps per column, one body for every
// N = 17..32 with N a run-time argument (shared memory sized at launch:
// 39.5 KB at N = 32, so five columns an SM).  The earlier body (a warp per
// column, the system in shared memory) ran each row update as a serial
// chain of shared-memory round trips with six warps an SM; a first
// redesign with the rows on lanes and the columns over the warps kept the
// system in shared memory and was bound by its traffic (two accesses an
// entry a step).  Here the elimination holds the system in registers.  (A
// variant with the columns cyclic over the warps and rows on lanes, one
// barrier a step and the pivot row by shuffles, fully unrolled, was 2.4x
// slower: ~90 KB of code a body.)
//  - The layer's gp, gm (N x N at an odd row stride), E and d are staged in
//    shared memory, every load of a thread issued before its first store.
//    A block takes one column, so each load fetches its own 32-byte
//    sector; the blocks of neighbouring columns run the same layer at
//    about the same time, and their loads of one sector meet in L2.
//  - The system is built in shared memory: the upper block rows Q Dn a
//    thread summing kRows rows of one column at once (each sum over j in
//    order), neighbouring threads on neighbouring columns; the lower rows,
//    the unit columns and the right-hand side entry by entry.
//  - The elimination holds the system in registers: thread (ty, tx) a
//    tile of kTr x kTc entries (rows ty + 8i, columns tx + 16k).  Rows
//    never move.  A step col: the threads holding column col publish it
//    (two buffers, so that a step's writes never meet the last step's
//    reads); every warp reads it through its own copy of the
//    logical-to-physical row map (lane t: logical rows t and t + 32),
//    finds the plain bubble's records (record_bits_of) and updates the map
//    in one step (apply_records: the swaps amount to one permutation,
//    position col taking the last record's row, each record the row of the
//    record before it, the first record col's row); the threads holding
//    the pivot row publish it right of col; every thread takes
//    a_rj - f a_pj, f = a_r,col (1 / a_p,col), on the live rows and the
//    columns right of col of its tile, each entry's updates in column
//    order as the plain version.  Two barriers a step; the column loop
//    runs in kTc unrolled blocks of 16, so every register index is a
//    constant.  The rows then go back to shared memory in logical order.
//  - Back substitution for all N + 1 right-hand sides at once, right-hand
//    side q on thread q (warps 0 and 1 at N = 32), each sum in ascending
//    column order, its loads four terms ahead.
//  - The stores of P and g entry by entry; the carry Q = R_l P_l,
//    rg = R_l g_l as the upper rows, kRows rows of one column a thread.
// chip_smoke.py phase 1 prints registers, stack and spills;
// tools/wide_ab.py's part big_cycles the cycles by phase.

#include "big.cuh"

namespace {

constexpr int kWarps = 4;                // warps a column (block)
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                 // rows of a thread's block sums
// the elimination's tile: thread (ty, tx) = (tid / 16, tid % 16) holds rows
// ty + 8i (i < kTr) and columns tx + 16k (k < kTc) of the 2N x (3N + 1)
// system: kTr = 8, kTc = 7 (64 x 112 positions over the block) at
// N = 25..32 with five blocks an SM; kTr = 6, kTc = 5 (48 x 80) at
// N <= 24, fewer registers, seven blocks an SM
constexpr int kTcMax = 7;
constexpr int kSmallN = 24;

// Shared-memory layout of a column for n: the system (2n rows of 3n + 1 at
// stride ld), gp, gm and Q (n rows at stride lds), E, d, rg, the Lambertian
// sums of the last layer (2n), the pivot column (two buffers of 64), the
// pivot row (16 kTcMax) and the final row map (64 ints).
struct BigGeom {
  int m, w, ld, lds, gp, gm, q, e, d, rg, refl, col, piv, perm, floats;
  __host__ __device__ explicit BigGeom(int n)
      : m(2 * n), w(3 * n + 1), ld(odd_stride(3 * n + 1)), lds(odd_stride(n)),
        gp(m * ld), gm(gp + n * lds), q(gm + n * lds), e(q + n * lds),
        d(e + n), rg(d + m), refl(rg + n), col(refl + m), piv(col + 128),
        perm(piv + 16 * kTcMax), floats(perm + 64) {}
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

template <int kTr, int kTc, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
bvp_forward_big_kernel(const float* __restrict__ gp_in,
                       const float* __restrict__ gm_in,
                       const float* __restrict__ e_in,
                       const float* __restrict__ d_in,
                       const float* __restrict__ alb_in,
                       float* __restrict__ p_out, float* __restrict__ g_out,
                       int n, int L, int64_t B, FloatN<kBigMaxN> wmu) {
  extern __shared__ __align__(16) float smem[];
  const BigGeom G(n);
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
  const int nb = (n + kRows - 1) / kRows;    // batches of kRows rows
  const float alb2 = 2.0f * alb_in[b];
  BIG_PROF_START();

  // the carry above the first layer: zeros
  for (int k = tid; k < n * lds; k += kThreads) sq[k] = 0.0f;
  for (int k = tid; k < n; k += kThreads) srg[k] = 0.0f;

  for (int l = 0; l < L; ++l) {
    const int64_t o = static_cast<int64_t>(l) * B + b;
    // stage this layer's inputs, every load before the first store
    {
      float v[(2 * kBigMaxN * kBigMaxN + 3 * kBigMaxN + kThreads - 1)
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
    BIG_PROF_MARK(1);

    // the elimination in registers, rows never moved
    float a[kTr][kTc];
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
#pragma unroll
      for (int k = 0; k < kTc; ++k) {
        const int r = ty + 8 * i;
        const int c = tx + 16 * k;
        a[i][k] = (r < m && c < w) ? A[r * ld + c] : 0.0f;
      }
    }
    // pivot rows so far and the rows past m, as bits of the physical row
    unsigned long long dead = m < 64 ? ~0ull << m : 0ull;
    int p0 = t;          // each warp's map: physical rows of logical t, t + 32
    int p1 = t + 32;
#pragma unroll
    for (int kb = 0; kb < kTc; ++kb) {
      if (16 * kb + 1 >= m) break;
      for (int cl = 0; cl < 16; ++cl) {
        const int col = 16 * kb + cl;
        if (col + 1 >= m) break;
        float* cv = scol + 64 * (col & 1);
        // the owners of column col publish it
        if (tx == cl) {
#pragma unroll
          for (int i = 0; i < kTr; ++i) {
            if (ty + 8 * i < m) cv[ty + 8 * i] = a[i][kb];
          }
        }
        __syncthreads();
        // every warp: the records through its map, the map in one step
        float a0 = cv[p0];
        float a1 = t + 32 < m ? cv[p1] : 0.0f;
        const unsigned long long bits = record_bits_of(a0, a1, m, col, t);
        if (bits != 0ull) apply_records(bits, col, t, p0, p1, a0, a1);
        const int pv = __shfl_sync(kBigFull, col < 32 ? p0 : p1, col & 31);
        const float apv =
            __shfl_sync(kBigFull, col < 32 ? a0 : a1, col & 31);
        const float inv = 1.0f / apv;
        dead |= 1ull << pv;
        BIG_PROF_MARK(2);
        // the owners of the pivot row publish it right of col
        if (ty == (pv & 7)) {
          const int ip = pv >> 3;
#pragma unroll
          for (int k = kb; k < kTc; ++k) {
            float v = a[0][k];
#pragma unroll
            for (int i = 1; i < kTr; ++i) v = ip == i ? a[i][k] : v;
            spiv[tx + 16 * k] = v;
          }
        }
        __syncthreads();
        // every live row less f times the pivot row, right of col
        float pj[kTc];
#pragma unroll
        for (int k = kb; k < kTc; ++k) pj[k] = spiv[tx + 16 * k];
#pragma unroll
        for (int i = 0; i < kTr; ++i) {
          const int r = ty + 8 * i;
          if (((dead >> r) & 1ull) == 0ull) {
            const float f = cv[r] * inv;
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
      slog[p0] = t;
      if (t + 32 < m) slog[p1] = t + 32;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTr; ++i) {
      const int r = ty + 8 * i;
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
    BIG_PROF_MARK(6);
  }
  BIG_PROF_FLUSH();
}

int smem_bytes(int n) {
  return BigGeom(n).floats * static_cast<int>(sizeof(float));
}

// The instantiation for n, its shared memory attribute set (it belongs to
// the current device: set on every launch).
using Body = void (*)(const float*, const float*, const float*, const float*,
                      const float*, float*, float*, int, int, int64_t,
                      FloatN<kBigMaxN>);
cudaError_t body_for(int n, Body* fn) {
  *fn = n <= kSmallN ? bvp_forward_big_kernel<6, 5, 7>
                     : bvp_forward_big_kernel<8, 7, 5>;
  return cudaFuncSetAttribute(*fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem_bytes(n));
}

}  // namespace

BIG_PROF_READER(bvp_forward_big)

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
  Body fn = nullptr;
  const cudaError_t err = body_for(n, &fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  fn<<<static_cast<unsigned>(B), kThreads, smem_bytes(n),
       static_cast<cudaStream_t>(stream)>>>(gp, gm, expd, dblk, albedo, p, g,
                                            n, L, B, w);
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM at n, by the occupancy calculator.
PYHARP_API int pyharp_bvp_forward_big_occupancy(int n) {
  Body fn = nullptr;
  if (body_for(n, &fn) != cudaSuccess) return -1;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, fn, kThreads, smem_bytes(n)) != cudaSuccess)
    return -1;
  return blocks;
}
