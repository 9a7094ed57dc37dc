// Shared pieces of the kernels at N = 33..64 (nstr 66..128).  Past N = 32 a
// lane of the layouts of big.cuh (a root, a row or a column a lane) holds R
// of them: lane t the rows t, t + 32, ..., t + 32 (R - 1).  R = 2 covers the
// N x N systems of K1 beam and K4 (big.cuh's warp_lu_solve already spans
// two halves of 32 rows), R = 4 the 2N = 128 rows of K2's system.  Past
// N = 64 K2's 2N x (3N + 1) system (98.8 KB at N = 64) nears a block's
// shared memory: the bodies of global.cuh take any N there, R a run-time
// count and the matrices in global scratch (K2's in a thread-block
// cluster's shared memory up to N = 170).
#pragma once

#include "big.cuh"

constexpr int kHugeMaxN = 64;
constexpr int kHugeMinN = kBigMaxN + 1;

// The swap bits of the pivot search in column col of an nr-row system
// (nr <= 32 R), as big.cuh's record_bits_of over R row sets: bits[h], bit
// t, is set where row t + 32 h > col is a record of the column, |a_r|
// beating strictly every |a_k| for col <= k < r, the rows the plain bubble
// swaps with row col.  A NaN pivot is never beaten (+inf) and a NaN below
// it never beats (-inf).  Lane t gives a[h], the column's entry in row
// t + 32 h (any value past nr).  An inclusive prefix max over each set
// (five shuffles a set), the totals of the sets before carried into each,
// and R ballots give every lane the same bits.
template <int R>
__device__ __forceinline__ void record_bits_sets(const float (&a)[R], int nr,
                                                 int col, int t,
                                                 unsigned (&bits)[R]) {
  const float inf = big_inf();
  float k[R];
  float s[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int r = t + 32 * h;
    const float m = fabsf(a[h]);
    k[h] = (r < col || r >= nr) ? -inf
         : (m != m ? (r == col ? inf : -inf) : m);
    s[h] = k[h];
  }
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
#pragma unroll
    for (int h = 0; h < R; ++h) {
      const float y = __shfl_up_sync(kBigFull, s[h], off);
      if (t >= off) s[h] = fmaxf(s[h], y);
    }
  }
  float carry = -inf;                  // the max of the sets before
#pragma unroll
  for (int h = 0; h < R; ++h) {
    float e = __shfl_up_sync(kBigFull, s[h], 1);
    if (t == 0) e = -inf;
    e = fmaxf(e, carry);
    bits[h] = __ballot_sync(kBigFull, t + 32 * h > col && k[h] > e);
    carry = fmaxf(carry, __shfl_sync(kBigFull, s[h], 31));
  }
}

// The highest record (set bit of bits[R], bit t of word h the row position
// t + 32 h) below position lim, or -1: every word read with a constant
// index, so the words stay in registers.
template <int R>
__device__ __forceinline__ int highest_record_below(const unsigned (&bits)[R],
                                                    int lim) {
  int r = -1;
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int lo = 32 * h;
    unsigned word = bits[h];
    if (lim <= lo) {
      word = 0u;
    } else if (lim < lo + 32) {
      word &= (1u << (lim - lo)) - 1u;
    }
    if (word != 0u) r = lo + 31 - __clz(static_cast<int>(word));
  }
  return r;
}

// big.cuh's apply_records over R sets: a warp's logical-to-physical row map
// of a system of up to 32 R rows, lane t holding in p[h] the physical row
// of the logical row t + 32 h, after the bubble's swaps of the records
// `bits` (record_bits_sets) in column col.  The swaps amount to one
// permutation (big.cuh's record_source): position col takes the last
// record's row, each record the row of the record before it (col's for the
// first), every other position its own; one gather by shuffles, R * R of
// them.
template <int R>
__device__ __forceinline__ void apply_records_sets(const unsigned (&bits)[R],
                                                   int col, int t,
                                                   int (&p)[R]) {
  int src[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    const int x = t + 32 * h;
    int s = x;
    if (x == col || ((bits[h] >> t) & 1u) != 0u) {
      const int r = highest_record_below(bits, x == col ? 32 * R : x);
      s = r >= 0 ? r : col;
    }
    src[h] = s;
  }
  int q[R];
#pragma unroll
  for (int h = 0; h < R; ++h) {
    int v = 0;
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int g = __shfl_sync(kBigFull, p[u], src[h] & 31);
      if ((src[h] >> 5) == u) v = g;
    }
    q[h] = v;
  }
#pragma unroll
  for (int h = 0; h < R; ++h) p[h] = q[h];
}
