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
// Bound on the H100: latency and the traffic of the system through the
// caches.  Per column and layer it reads (2N^2 + 3N)*4 bytes and writes
// (2N^2 + 2N)*4 (262,656 at N = 128) against ~(2N)^2 (3N + 1) ~ 2.5e7
// flops of elimination at N = 128, and the layer loop is serial.
//
// Design: bvp_forward_huge.cu's block of kWarps = 8 warps per column with
// N a run-time argument and no bound on it.  The 2N x (3N + 1) system, the
// layer's gp and gm, the carry Q and the pivot column's records (R =
// row_sets(2N) words) sit in a slab of global scratch per resident block
// (2.4 MB at N = 128), not in shared memory (the system alone passes a
// block's 227 KB near N = 97); the blocks walk the columns in a
// grid-stride loop.  The steps are the huge body's: the system built as
// there; each elimination step warp 0 finds the plain bubble's records of
// the pivot column over the R sets (global.cuh's record_bits_global), the
// threads over the live columns move the rows as the bubble's swaps do
// (each column's records rotated in row order), then thread (warp y, lane
// x) takes a_rj - f a_pj, f = a_r,col (1 / a_col,col), on rows col + 1 + y
// + 8i and columns col + 1 + x + 32k, each entry's updates in column order
// as the plain version; back substitution takes right-hand side q on
// thread q, each sum in ascending column order.  wmu comes by device
// pointer.  A simple body: every entry of the system goes through the L1
// and L2 caches at every step.
// chip_smoke.py phase 23 prints registers, stack and spills.

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

}  // namespace

// Floats of global scratch a launch at (n, B) needs; -1 on an error.
PYHARP_API long long pyharp_bvp_forward_global_scratch(int n, long long B) {
  if (n < kGlobalMinN) return -1;
  if (B == 0) return 0;
  const int64_t grid = grid_of(B);
  return grid < 0 ? -1 : grid * GlobalGeom(n).floats;
}

// Shapes as pyharp_bvp_forward (bvp_forward.cu), for n > 64; wmu (n) on
// the device, scratch holding pyharp_bvp_forward_global_scratch(n, B)
// floats.
PYHARP_API int pyharp_bvp_forward_global(int n, const float* gp,
                                         const float* gm, const float* expd,
                                         const float* dblk,
                                         const float* albedo, float* p,
                                         float* g, int L, long long B,
                                         const float* wmu, float* scratch,
                                         void* stream) {
  if (n < kGlobalMinN) return PYHARP_UNSUPPORTED_N;
  if (B == 0 || L == 0) return 0;
  const int64_t grid = grid_of(B);
  if (grid < 0) return static_cast<int>(cudaGetLastError());
  bvp_forward_global_kernel<<<static_cast<unsigned>(grid), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      gp, gm, expd, dblk, albedo, p, g, n, L, B, wmu, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Columns resident on an SM, by the occupancy calculator.
PYHARP_API int pyharp_bvp_forward_global_occupancy() { return per_sm(); }
