// K2 at N > 64 (nstr > 128): forward elimination of the layer-coupling
// boundary-value problem.
//
// Replaces pyharp_tpu/rt/disort/pallas_kernels.py:754 (_bvp_fwd_kernel),
// reached through _bvp_forward (:1180), at the N that bvp_forward_huge.cu
// does not take.  It computes what bvp_forward_huge.cu computes, per column
// and layer top-down: the 2N x 2N diagonal block
//     [ -[gm, gp E] + Q [gp, gm E] ;  [gp E, gm] ]
// (the Lambertian fold on the last layer's lower rows), solved against N
// unit columns and [d_top - rg ; d_bot] with the plain version's pivoted
// LU, P_l (2N x N) and g_l (2N) written, and the carry Q = R_l P_l,
// rg = R_l g_l, R_l = [gm E, gp]: kernels._bvp_forward_step, every sum in
// its order.  Built with --fmad=false, so it is bit-equal to
// bvp_forward_plain: contracted, the elimination's rounding at N = 129
// read 3.4e-5 of max|ref| beyond the BVP bound's 3e-4 rtol.
//
// Bound on the H100: latency.  Per column and layer it reads (2N^2 + 3N)*4
// bytes and writes (2N^2 + 2N)*4 (262,656 at N = 128) against ~(2N)^2 (3N
// + 1) ~ 2.5e7 flops of elimination at N = 128, and the layer loop is
// serial.
//
// Two bodies.  Up to kClusterReach (N = 170, nstr 340) the cluster body
// keeps a column's system on chip, in the shared memory of a thread-block
// cluster; above it the slab body keeps it in global scratch.
//
// The cluster body: a column runs on a cluster of C blocks of kCThreads =
// 256 threads, C the smallest of 1, 2, 4 and 8 whose blocks each hold
// their share in at most 227 KB (cluster_blocks: C = 1 up to N = 87, 2 up
// to 115, 4 up to 143, 8 up to 170; a block then takes its SM).  Block
// rank r of the cluster holds:
//  - the columns j = r (mod C) of the 2N x (3N + 1) system, column-major
//    at an odd stride (cyclic ownership keeps every block busy as the
//    live columns shrink);
//  - all of the carry Q (N x N, N^2 floats: the build of its columns needs
//    every row of it; the blocks of the right-hand sides write it into
//    every block), rg where it owns column 2N + N, E;
//  - a work area of kChunk x 2N floats (the build's staged columns of gp
//    and gm, the back substitution's rows of U, the carry's columns of
//    R_l), and the pivot steps' f and record words, three buffers each.
//  gp and gm are read from global memory (through L2) where the build and
//  the carry stage them: each block reads the two columns of gp and gm
//  behind each of its system columns, and all of R_l for the carry.
// The steps, every operation in the plain order:
//  - build: each block its own columns, kChunk at a time (the upper rows
//    -Ttop + Q Dn, each sum over j in order; the lower rows; the unit
//    columns and the right-hand side);
//  - elimination, one cluster barrier a step: the block that owns column
//    col finds its records (record_words, global.cuh's record_bits_global
//    with the row sets unrolled), rotates its column as the bubble's swaps
//    do, forms f_r = a_r,col * (1 / a_col,col) for the rows below the
//    pivot and writes f and the record words into every block of the
//    cluster (distributed shared memory), then arrives at the barrier;
//    every block waits on it, rotates the rows of its own columns right of
//    col by the same records and takes a_rj - f_r a_col,j.  The owner of
//    column col + 1 updates that column first and searches it before it
//    arrives, so the search overlaps the other columns' updates; three
//    buffers of f and the words keep a step's writes off the buffers any
//    block still reads;
//  - back substitution, after a cluster barrier: each block its own
//    right-hand sides, a thread each, rows of U copied kChunk at a time
//    from the blocks that own their columns, each sum in ascending column
//    order;
//  - the stores of P and g; the carry Q[:, j] = R_l x_j by the block of
//    x_j (R_l staged 32 columns at a time), written into every block; a
//    cluster barrier ends the layer.
// The launch is persistent: as many clusters as cudaOccupancyMaxActive-
// Clusters allows, at most B, walking the columns.  No global scratch.
//
// The slab body, above the cluster's reach: a block of kWarps = 8 warps
// per column with N a run-time argument and no bound on it.  The 2N x (3N
// + 1) system, the layer's gp and gm, the carry Q and the pivot column's
// records (R = row_sets(2N) words) sit in a slab of global scratch per
// resident block (594 KB at N = 128, 1.06 MB at N = 171), not in shared
// memory; the blocks walk the columns in a grid-stride loop.  The steps
// are the parent huge body's: the system built as there; each elimination
// step warp 0 finds the plain bubble's records of the pivot column over
// the R sets (global.cuh's record_bits_global), the threads over the live
// columns move the rows as the bubble's swaps do (each column's records
// rotated in row order), then thread (warp y, lane x) takes a_rj - f a_pj,
// f = a_r,col (1 / a_col,col), on rows col + 1 + y + 8i and columns col +
// 1 + x + 32k, each entry's updates in column order as the plain version;
// back substitution takes right-hand side q on thread q, each sum in
// ascending column order.  wmu comes by device pointer.  A simple body:
// every entry of the system goes through the L1 and L2 caches at every
// step.
// chip_smoke.py phase 23 prints registers, stack and spills, the cluster
// size and shared memory; tools/wide_ab.py's part k2_cycles the cluster
// body's cycles by phase.

#include <cooperative_groups.h>

#include "global.cuh"

namespace {

constexpr int kWarps = 8;                // warps a column (block)
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 4;                 // rows of a thread's block sums

// A column's slab for n: the system (2n rows of 3n + 1 at stride ld), gp,
// gm and Q (n rows at stride lds), E, d, rg, the Lambertian sums of the
// last layer (2n) and the pivot column's records (row_sets(2n) words).
struct GlobalGeom {
  int64_t m, w, ld, lds, gp, gm, q, e, d, rg, refl, bits, floats;
  __host__ __device__ explicit GlobalGeom(int n)
      : m(2 * n), w(3 * n + 1), ld(3 * n + 1), lds(n), gp(m * ld),
        gm(gp + n * lds), q(gm + n * lds), e(q + n * lds), d(e + n),
        rg(d + m), refl(rg + n), bits(refl + m),
        floats(bits + row_sets(2 * n)) {}
};

__global__ void __launch_bounds__(kThreads)
bvp_forward_global_kernel(const float* __restrict__ gp_in,
                          const float* __restrict__ gm_in,
                          const float* __restrict__ e_in,
                          const float* __restrict__ d_in,
                          const float* __restrict__ alb_in,
                          float* __restrict__ p_out, float* __restrict__ g_out,
                          int n, int L, int64_t B,
                          const float* __restrict__ wmu,
                          float* scratch) {
  const GlobalGeom G(n);
  float* A = scratch + blockIdx.x * G.floats;
  float* sgp = A + G.gp;
  float* sgm = A + G.gm;
  float* sq = A + G.q;
  float* se = A + G.e;
  float* sd = A + G.d;
  float* srg = A + G.rg;
  float* srefl = A + G.refl;
  unsigned* sbits = reinterpret_cast<unsigned*>(A + G.bits);
  const int tid = static_cast<int>(threadIdx.x);
  const int t = tid & 31;
  const int wy = tid >> 5;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const int m = static_cast<int>(G.m);
  const int w = static_cast<int>(G.w);
  const int64_t ld = G.ld;
  const int64_t lds = G.lds;
  const int nn = n * n;
  const int nb = (n + kRows - 1) / kRows;    // batches of kRows rows
  const int sets = row_sets(m);

  for (int64_t b = blockIdx.x; b < B; b += gridDim.x) {
    const float alb2 = 2.0f * alb_in[b];
    // the carry above the first layer: zeros
    for (int64_t k = tid; k < n * lds; k += kThreads) sq[k] = 0.0f;
    for (int k = tid; k < n; k += kThreads) srg[k] = 0.0f;

    for (int l = 0; l < L; ++l) {
      const int64_t o = static_cast<int64_t>(l) * B + b;
      // this layer's inputs
      for (int k = tid; k < nn; k += kThreads) {
        sgp[(k / n) * lds + k % n] = gp_in[k * LB + o];
        sgm[(k / n) * lds + k % n] = gm_in[k * LB + o];
      }
      for (int k = tid; k < n; k += kThreads) se[k] = e_in[k * LB + o];
      for (int k = tid; k < m; k += kThreads) sd[k] = d_in[k * LB + o];
      __syncthreads();

      const bool last = l == L - 1;
      if (last) {
        // sum_r wmu_r Rn[r][c], Rn = [gm E, gp], for the block columns c
        for (int c = tid; c < m; c += kThreads) {
          const int cc = c < n ? c : c - n;
          const float ec = se[cc];
          float acc = 0.0f;
          for (int r = 0; r < n; ++r) {
            const float rv = c < n ? sgm[r * lds + cc] * ec
                                   : sgp[r * lds + cc];
            acc = (r == 0) ? wmu[0] * rv : acc + wmu[r] * rv;
          }
          srefl[c] = acc;
        }
        __syncthreads();
      }
      // the upper block rows -Ttop + Q Dn (Ttop = [gm, gp E], Dn = [gp,
      // gm E]), kRows rows of one column c a thread, each sum over j in
      // order
      for (int k = tid; k < nb * m; k += kThreads) {
        const int i0 = (k / m) * kRows;
        const int c = k - (k / m) * m;
        const bool hi = c >= n;
        const int cc = hi ? c - n : c;
        const float ec = se[cc];
        const float* dcol = hi ? sgm + cc : sgp + cc;
        float acc[kRows] = {};
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

      // the elimination in the slab
      for (int col = 0; col + 1 < m; ++col) {
        if (wy == 0) record_bits_global(A + col, ld, m, col, t, sbits);
        __syncthreads();
        // the bubble's swaps of row col with each record in row order: row
        // col's entry moves to the first record, each record's to the
        // next, the last record's to row col
        for (int j = col + tid; j < w; j += kThreads) {
          float v = A[col * ld + j];
          bool any = false;
          for (int h = col >> 5; h < sets; ++h) {
            unsigned word = sbits[h];
            while (word != 0u) {
              const int r = 32 * h + __ffs(static_cast<int>(word)) - 1;
              word &= word - 1u;
              const float x = A[r * ld + j];
              A[r * ld + j] = v;
              v = x;
              any = true;
            }
          }
          if (any) A[col * ld + j] = v;
        }
        __syncthreads();
        // every row below the pivot less f times the pivot row, right of
        // col
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
      for (int qq = tid; qq <= n; qq += kThreads) {
        const int q = m + qq;
        for (int i = m - 1; i >= 0; --i) {
          const float* row = A + i * ld;
          float acc = row[q];
          for (int c = i + 1; c < m; ++c) acc = acc - row[c] * A[c * ld + q];
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
      // the carry: Q[i][j] = sum_k Rn[i][k] P[k][j], rg[i] = sum_k
      // Rn[i][k] g[k], Rn = [gm E, gp]; kRows rows of one column j a thread
      for (int k = tid; k < nb * (n + 1); k += kThreads) {
        const int i0 = (k / (n + 1)) * kRows;
        const int j = k - (k / (n + 1)) * (n + 1);
        float acc[kRows] = {};
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
    __syncthreads();                 // the slab is free for the next column
  }
}

// Columns resident on an SM; -1 on an error.
int per_sm() {
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, bvp_forward_global_kernel, kThreads, 0) != cudaSuccess)
    return -1;
  return blocks;
}

// Blocks of the launch at (n, B), one slab each; -1 on an error.
int64_t grid_of(int64_t B) {
  const int cols = per_sm();
  return cols < 0 ? -1 : resident_units(cols, B);
}


// ---- the cluster body --------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kCThreads = 256;           // threads a block
constexpr int kCWarps = kCThreads / 32;
constexpr int kClusterMax = 8;           // the portable cluster size
constexpr int kSmemLimit = 232448;       // bytes a block may take (227 KB)
constexpr int kChunk = 16;               // columns (rows) staged at once
constexpr int kCarryK = 32;              // columns of R_l staged at once
constexpr int kCarryCols = 16;           // right-hand sides of a carry item
constexpr int kCarryItems = 3;           // carry items a thread

__host__ __device__ constexpr int codd(int x) { return x | 1; }
__host__ __device__ constexpr int csets(int rows) { return (rows + 31) >> 5; }

// Shared-memory layout of a block of a cluster of c blocks at n: its
// ncl = ceil((3n + 1) / c) columns of the system (2n rows at stride ldc),
// Q (n rows at stride ldq), the work area (kChunk x 2n), f (three buffers
// of 2n), the record words (three buffers of row_sets(2n)), E, rg, the
// Lambertian sums of its columns.
struct ClusterGeom {
  int m, w, sets, ldc, ncl, ldq, q, work, f, bits, e, rg, refl, floats;
  __host__ __device__ constexpr ClusterGeom(int n, int c)
      : m(2 * n), w(3 * n + 1), sets(csets(2 * n)), ldc(codd(2 * n)),
        ncl((3 * n + c) / c), ldq(codd(n)), q(ncl * ldc), work(q + n * ldq),
        f(work + kChunk * m), bits(f + 3 * m), e(bits + 3 * sets),
        rg(e + n), refl(rg + n), floats(refl + ncl) {}
};

// The blocks of n's cluster: the smallest of 1, 2, 4, 8 whose blocks each
// hold their share in kSmemLimit bytes; 0 where none does.
__host__ __device__ constexpr int cluster_blocks(int n) {
  for (int c = 1; c <= kClusterMax; c *= 2) {
    if (ClusterGeom(n, c).floats * 4 <= kSmemLimit) return c;
  }
  return 0;
}

constexpr int cluster_reach() {
  int n = kGlobalMinN;
  while (cluster_blocks(n + 1) != 0) ++n;
  return n;
}

constexpr int kClusterReach = cluster_reach();
constexpr int kMaxSets = csets(2 * kClusterReach);
static_assert(cluster_blocks(kGlobalMinN) == 1, "N = 65 fits one block");
static_assert(kMaxSets <= 16, "the record words of a column fit a warp");

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The record words of column col of an nr-row column a (a[r], r < nr):
// record_bits_global over sets sets with the sets unrolled (kMaxSets),
// so that their scans overlap.  Every lane of a warp calls it; lane 0
// stores the sets words into out (the sets below col / 32 hold 0).
__device__ __forceinline__ void record_words(const float* a, int nr, int col,
                                             int t, int sets,
                                             unsigned* out) {
  const float inf = big_inf();
  float key[kMaxSets];
  float s[kMaxSets];
#pragma unroll
  for (int h = 0; h < kMaxSets; ++h) {
    const int r = t + 32 * h;
    float k = -inf;
    if (h < sets && r >= col && r < nr) {
      const float v = fabsf(a[r]);
      k = v != v ? (r == col ? inf : -inf) : v;
    }
    key[h] = k;
    s[h] = k;
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < kMaxSets; ++h) {
      if (h < sets) {
        const float y = __shfl_up_sync(kBigFull, s[h], off);
        if (t >= off) s[h] = fmaxf(s[h], y);
      }
    }
  }
  float carry = -inf;                  // the max of the sets before
#pragma unroll
  for (int h = 0; h < kMaxSets; ++h) {
    if (h < sets) {
      float e = __shfl_up_sync(kBigFull, s[h], 1);
      if (t == 0) e = -inf;
      e = fmaxf(e, carry);
      const unsigned word =
          __ballot_sync(kBigFull, t + 32 * h > col && key[h] > e);
      if (t == 0) out[h] = word;
      carry = fmaxf(carry, __shfl_sync(kBigFull, s[h], 31));
    }
  }
}

// The bubble's swaps of row col with each record (words, row order) on a
// column cp: row col's entry to the first record, each record's to the
// next, the last record's to row col.
__device__ __forceinline__ void rotate_column(float* cp,
                                              const unsigned* words, int col,
                                              int sets) {
  float v = cp[col];
  bool any = false;
  for (int h = col >> 5; h < sets; ++h) {
    unsigned word = words[h];
    while (word != 0u) {
      const int r = 32 * h + __ffs(static_cast<int>(word)) - 1;
      word &= word - 1u;
      const float x = cp[r];
      cp[r] = v;
      v = x;
      any = true;
    }
  }
  if (any) cp[col] = v;
}

__global__ void __launch_bounds__(kCThreads, 1)
bvp_forward_cluster_kernel(const float* __restrict__ gp_in,
                           const float* __restrict__ gm_in,
                           const float* __restrict__ e_in,
                           const float* __restrict__ d_in,
                           const float* __restrict__ alb_in,
                           float* __restrict__ p_out,
                           float* __restrict__ g_out, int n, int L,
                           int64_t B, const float* __restrict__ wmu) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int cshift = __ffs(C) - 1;
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterGeom G(n, C);
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t LB = static_cast<int64_t>(L) * B;
  const int m = G.m, w = G.w, R = G.sets, ldc = G.ldc, ldq = G.ldq;
  float* sys = smem;                    // own column jl (j = jl C + rank)
  float* sq = smem + G.q;
  float* work = smem + G.work;
  float* sf = smem + G.f;
  unsigned* sbits = reinterpret_cast<unsigned*>(smem + G.bits);
  float* se = smem + G.e;
  float* srg = smem + G.rg;
  float* srefl = smem + G.refl;
  // the block's columns: nown in all, the first nsys of them (j < m) the
  // block's, the rest right-hand sides
  const int nown = (w - rank + C - 1) >> cshift;
  const int nsys = (m - rank + C - 1) >> cshift;
  const int nrhs = nown - nsys;
  BIG_PROF_START();

  // the owner of column kk (local column cp): its records, the column
  // rotated, f and the words into buffer slot of every block
  auto pivot = [&](float* cp, int kk, int slot) {
    unsigned* ws = sbits + slot * R;
    if (warp == 0) {
      record_words(cp, m, kk, lane, R, ws);
      __syncwarp();
      if (lane == 0) rotate_column(cp, ws, kk, R);
    }
    __syncthreads();
    const float inv = 1.0f / cp[kk];
    float* fs = sf + slot * m;
    for (int r = kk + 1 + tid; r < m; r += kCThreads) {
      const float fv = cp[r] * inv;
      for (int pr = 0; pr < C; ++pr) cluster.map_shared_rank(fs, pr)[r] = fv;
    }
    if (tid < R) {
      const unsigned wv = ws[tid];
      for (int pr = 0; pr < C; ++pr) {
        if (pr != rank) cluster.map_shared_rank(ws, pr)[tid] = wv;
      }
    }
  };

  const int64_t nclusters = gridDim.x >> cshift;
  for (int64_t b = blockIdx.x >> cshift; b < B; b += nclusters) {
    const float alb2 = 2.0f * alb_in[b];
    // the carry above the first layer: zeros
    for (int k = tid; k < n * ldq; k += kCThreads) sq[k] = 0.0f;
    for (int k = tid; k < n; k += kCThreads) srg[k] = 0.0f;

    for (int l = 0; l < L; ++l) {
      const int64_t o = static_cast<int64_t>(l) * B + b;
      const bool last = l == L - 1;
      for (int k = tid; k < n; k += kCThreads) se[k] = e_in[k * LB + o];
      __syncthreads();
      BIG_PROF_MARK(0);

      // the block's columns c < m, kChunk at a time: column u of the chunk
      // stages a = (c < n ? gp : gm)[:, c mod n] at work[u m + r] and b =
      // (c < n ? gm : gp)[:, c mod n] at work[u m + n + r]
      for (int j0 = 0; j0 < nsys; j0 += kChunk) {
        const int cnt = min(kChunk, nsys - j0);
        for (int idx = tid; idx < cnt * m; idx += kCThreads) {
          const int u = idx / m;
          const int rr = idx - u * m;
          const int c = ((j0 + u) << cshift) + rank;
          const bool hi = c >= n;
          const bool isb = rr >= n;
          const int r = isb ? rr - n : rr;
          const float* src = hi != isb ? gm_in : gp_in;
          work[idx] = src[static_cast<int64_t>(r * n + (hi ? c - n : c)) * LB
                          + o];
        }
        __syncthreads();
        if (last) {
          // sum_r wmu_r Rn[r][c], Rn = [gm E, gp], for the chunk's columns
          for (int u = tid; u < cnt; u += kCThreads) {
            const int c = ((j0 + u) << cshift) + rank;
            const bool hi = c >= n;
            const float ec = se[hi ? c - n : c];
            const float* bv = work + u * m + n;
            float acc = 0.0f;
            for (int r = 0; r < n; ++r) {
              const float rv = hi ? bv[r] : bv[r] * ec;
              acc = (r == 0) ? wmu[0] * rv : acc + wmu[r] * rv;
            }
            srefl[j0 + u] = acc;
          }
          __syncthreads();
        }
        // the upper rows -Ttop + Q Dn (Ttop = [gm, gp E], Dn = [gp, gm E]),
        // each sum over j in order, and the lower rows Blow = [gp E, gm]
        // less the fold on the last layer: row i of four columns an item
        const int ngrp = (cnt + 3) >> 2;
        for (int item = tid; item < n * ngrp; item += kCThreads) {
          const int g = item / n;
          const int i = item - g * n;
          int us[4];
          bool his[4];
          float ecs[4];
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            us[v] = min(4 * g + v, cnt - 1);
            const int c = ((j0 + us[v]) << cshift) + rank;
            his[v] = c >= n;
            ecs[v] = se[his[v] ? c - n : c];
          }
          float acc[4];
          for (int j = 0; j < n; ++j) {
            const float qv = sq[i * ldq + j];
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              float dj = work[us[v] * m + j];
              if (his[v]) dj = dj * ecs[v];
              acc[v] = j == 0 ? qv * dj : acc[v] + qv * dj;
            }
          }
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            if (4 * g + v < cnt) {
              const float* ab = work + us[v] * m;
              float* cp = sys + (j0 + us[v]) * ldc;
              const float bi = ab[n + i];
              const float tv = his[v] ? bi * ecs[v] : bi;
              cp[i] = -tv + acc[v];
              const float ai = ab[i];
              float lv = his[v] ? ai : ai * ecs[v];
              if (last) lv = lv - alb2 * srefl[j0 + us[v]];
              cp[n + i] = lv;
            }
          }
        }
        __syncthreads();
      }
      // the unit columns and the right-hand side
      for (int idx = tid; idx < nrhs * m; idx += kCThreads) {
        const int u = idx / m;
        const int r = idx - u * m;
        const int q = ((nsys + u) << cshift) + rank - m;
        float v;
        if (q < n) {
          v = r == n + q ? 1.0f : 0.0f;
        } else {
          const float dv = d_in[r * LB + o];
          v = r < n ? dv - srg[r] : dv;
        }
        sys[(nsys + u) * ldc + r] = v;
      }
      __syncthreads();
      BIG_PROF_MARK(1);

      // the elimination, one cluster barrier a step (module note)
      if (rank == 0) pivot(sys, 0, 0);
      cluster_arrive();
      for (int k = 0; k + 1 < m; ++k) {
        cluster_wait();
        BIG_PROF_MARK(7);
        const float* fk = sf + (k % 3) * m;
        const unsigned* wk = sbits + (k % 3) * R;
        bool any = false;
        for (int h = k >> 5; h < R; ++h) any = any || wk[h] != 0u;
        const int kk = k + 1;
        const bool look = kk + 1 < m && (kk & (C - 1)) == rank;
        const int jk = kk >> cshift;
        if (look) {
          float* cp = sys + jk * ldc;
          if (any && tid == 0) rotate_column(cp, wk, k, R);
          __syncthreads();
          const float a = cp[k];
          for (int r = kk + tid; r < m; r += kCThreads) {
            cp[r] = cp[r] - fk[r] * a;
          }
          __syncthreads();
          pivot(cp, kk, kk % 3);
        }
        if (k + 2 < m) cluster_arrive();
        BIG_PROF_MARK(2);
        // the rest of the block's columns right of k: the rows rotated,
        // then every row below k less f times row k
        const int jl0 = kk > rank ? (kk - rank + C - 1) >> cshift : 0;
        if (any) {
          for (int jl = jl0 + tid; jl < nown; jl += kCThreads) {
            if (!look || jl != jk) rotate_column(sys + jl * ldc, wk, k, R);
          }
          __syncthreads();
        }
        float fr[kMaxSets];
#pragma unroll
        for (int s = 0; s < kMaxSets; ++s) {
          const int r = 32 * s + lane;
          fr[s] = (s < R && r > k && r < m) ? fk[r] : 0.0f;
        }
        for (int jl = jl0 + warp; jl < nown; jl += kCWarps) {
          if (look && jl == jk) continue;
          float* cp = sys + jl * ldc;
          const float a = cp[k];
#pragma unroll
          for (int s = 0; s < kMaxSets; ++s) {
            const int r = 32 * s + lane;
            if (s < R && r > k && r < m) cp[r] = cp[r] - fr[s] * a;
          }
        }
        __syncthreads();
        BIG_PROF_MARK(3);
      }
      // every block done with the last step before any reads U
      cluster_arrive();
      cluster_wait();
      BIG_PROF_MARK(7);

      // back substitution: the block's right-hand sides a thread each, the
      // rows of U copied kChunk at a time, each sum in ascending column
      // order, the solution over the right-hand side
      for (int ihi = m - 1; ihi >= 0; ihi -= kChunk) {
        const int ilo = max(ihi - kChunk + 1, 0);
        __syncthreads();
        for (int idx = tid; idx < (ihi - ilo + 1) * m; idx += kCThreads) {
          const int ii = idx / m;
          const int c = idx - ii * m;
          const int i = ilo + ii;
          if (c >= i) {
            work[idx] = cluster.map_shared_rank(sys, c & (C - 1))[
                (c >> cshift) * ldc + i];
          }
        }
        __syncthreads();
        if (tid < nrhs) {
          float* x = sys + (nsys + tid) * ldc;
          for (int i = ihi; i >= ilo; --i) {
            const float* u = work + (i - ilo) * m;
            float acc = x[i];
            int c = i + 1;
            for (; c + 8 <= m; c += 8) {
              float pr[8];
#pragma unroll
              for (int v = 0; v < 8; ++v) pr[v] = u[c + v] * x[c + v];
#pragma unroll
              for (int v = 0; v < 8; ++v) acc = acc - pr[v];
            }
            for (; c < m; ++c) acc = acc - u[c] * x[c];
            x[i] = acc / u[i];
          }
        }
      }
      __syncthreads();
      BIG_PROF_MARK(4);

      // P_l[r][q] = x_q[r], g_l = x_n
      for (int idx = tid; idx < nrhs * m; idx += kCThreads) {
        const int u = idx / m;
        const int r = idx - u * m;
        const int q = ((nsys + u) << cshift) + rank - m;
        const float v = sys[(nsys + u) * ldc + r];
        if (q < n) {
          p_out[static_cast<int64_t>(r * n + q) * LB + o] = v;
        } else {
          g_out[r * LB + o] = v;
        }
      }
      BIG_PROF_MARK(5);
      if (l + 1 < L) {
        // the carry of the block's right-hand sides: Q[i][q] = sum_k
        // Rn[i][k] x_q[k] (rg[i] for q = n), Rn = [gm E, gp] staged
        // kCarryK columns at a time, each sum over k in order; an item is
        // row i of kCarryCols right-hand sides; Q into every block
        const int ngrp = (nrhs + kCarryCols - 1) / kCarryCols;
        const int items = n * ngrp;
        for (int base = 0; base < items; base += kCarryItems * kCThreads) {
          float acc[kCarryItems][kCarryCols];
          for (int k0 = 0; k0 < m; k0 += kCarryK) {
            const int kc = min(kCarryK, m - k0);
            __syncthreads();
            for (int idx = tid; idx < kc * n; idx += kCThreads) {
              const int kl = idx / n;
              const int i = idx - kl * n;
              const int k = k0 + kl;
              work[idx] = k < n ? gm_in[static_cast<int64_t>(i * n + k) * LB
                                        + o] * se[k]
                                : gp_in[static_cast<int64_t>(i * n + k - n)
                                        * LB + o];
            }
            __syncthreads();
#pragma unroll
            for (int it = 0; it < kCarryItems; ++it) {
              const int item = base + tid + it * kCThreads;
              if (item < items) {
                const int g = item / n;
                const int i = item - g * n;
                int xs[kCarryCols];        // the right-hand sides' columns
#pragma unroll
                for (int v = 0; v < kCarryCols; ++v) {
                  xs[v] = (nsys + min(g * kCarryCols + v, nrhs - 1)) * ldc;
                }
                for (int kl = 0; kl < kc; ++kl) {
                  const int k = k0 + kl;
                  const float rn = work[kl * n + i];
#pragma unroll
                  for (int v = 0; v < kCarryCols; ++v) {
                    const float xv = sys[xs[v] + k];
                    acc[it][v] = k == 0 ? rn * xv : acc[it][v] + rn * xv;
                  }
                }
              }
            }
          }
#pragma unroll
          for (int it = 0; it < kCarryItems; ++it) {
            const int item = base + tid + it * kCThreads;
            if (item < items) {
              const int g = item / n;
              const int i = item - g * n;
#pragma unroll
              for (int v = 0; v < kCarryCols; ++v) {
                const int u = g * kCarryCols + v;
                if (u < nrhs) {
                  const int q = ((nsys + u) << cshift) + rank - m;
                  if (q < n) {
                    for (int pr = 0; pr < C; ++pr) {
                      cluster.map_shared_rank(sq, pr)[i * ldq + q] =
                          acc[it][v];
                    }
                  } else {
                    srg[i] = acc[it][v];
                  }
                }
              }
            }
          }
        }
        BIG_PROF_MARK(6);
      }
      // the layer's end: Q in every block, every block done with the U
      // rows it read from the others
      cluster_arrive();
      cluster_wait();
    }
  }
  BIG_PROF_FLUSH();
}

// Bytes of shared memory a block of n's cluster takes.
int cluster_smem(int n) {
  return ClusterGeom(n, cluster_blocks(n)).floats
         * static_cast<int>(sizeof(float));
}

// The launch configuration of n's cluster body over `clusters` clusters
// (attr: its cluster dimension), the shared-memory attribute set for the
// current device.
cudaError_t cluster_config(int n, int64_t clusters, cudaStream_t stream,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  const int c = cluster_blocks(n);
  const cudaError_t err = cudaFuncSetAttribute(
      bvp_forward_cluster_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, cluster_smem(n));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(clusters * c));
  cfg->blockDim = dim3(kCThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(cluster_smem(n));
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(c);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of n's body the current device holds at once; -1 on an error.
int cluster_occupancy(int n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  if (cluster_config(n, 1, nullptr, &cfg, &attr) != cudaSuccess) return -1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, bvp_forward_cluster_kernel,
                                     &cfg) != cudaSuccess)
    return -1;
  return clusters;
}

cudaError_t launch_cluster(int n, const float* gp, const float* gm,
                           const float* expd, const float* dblk,
                           const float* albedo, float* p, float* g, int L,
                           int64_t B, const float* wmu,
                           cudaStream_t stream) {
  const int resident = cluster_occupancy(n);
  if (resident < 0) return cudaGetLastError();
  if (resident == 0) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t err = cluster_config(
      n, resident < B ? resident : B, stream, &cfg, &attr);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, bvp_forward_cluster_kernel, gp, gm, expd,
                            dblk, albedo, p, g, n, L, B, wmu);
}

}  // namespace

BIG_PROF_READER(bvp_forward_global)

// Floats of global scratch a launch at (n, B) needs (none up to the
// cluster body's reach); -1 on an error.
PYHARP_API long long pyharp_bvp_forward_global_scratch(int n, long long B) {
  if (n < kGlobalMinN) return -1;
  if (B == 0 || cluster_blocks(n) != 0) return 0;
  const int64_t grid = grid_of(B);
  return grid < 0 ? -1 : grid * GlobalGeom(n).floats;
}

// Shapes as pyharp_bvp_forward (bvp_forward.cu), for n > 64; wmu (n) on
// the device, scratch holding pyharp_bvp_forward_global_scratch(n, B)
// floats: the cluster body up to its reach, the slab body above it.
PYHARP_API int pyharp_bvp_forward_global(int n, const float* gp,
                                         const float* gm, const float* expd,
                                         const float* dblk,
                                         const float* albedo, float* p,
                                         float* g, int L, long long B,
                                         const float* wmu, float* scratch,
                                         void* stream) {
  if (n < kGlobalMinN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster_blocks(n) != 0) {
    const cudaError_t err = launch_cluster(n, gp, gm, expd, dblk, albedo, p,
                                           g, L, B, wmu, st);
    return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
  }
  const int64_t grid = grid_of(B);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  bvp_forward_global_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                              st>>>(gp, gm, expd, dblk, albedo, p, g, n, L,
                                    B, wmu, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM in the slab body, by the occupancy calculator.
PYHARP_API int pyharp_bvp_forward_global_occupancy() { return per_sm(); }

// The cluster body at n: out[0] its blocks a cluster (0 past its reach,
// where the slab body runs), out[1] the shared memory of a block in bytes,
// out[2] the clusters the device holds at once; returns the reach.
PYHARP_API int pyharp_bvp_forward_cluster_info(int n, int* out) {
  const int c = n >= kGlobalMinN ? cluster_blocks(n) : 0;
  out[0] = c;
  out[1] = c != 0 ? cluster_smem(n) : 0;
  out[2] = c != 0 ? cluster_occupancy(n) : 0;
  return kClusterReach;
}
