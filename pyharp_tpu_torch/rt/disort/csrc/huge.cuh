// Shared pieces of the kernels at N = 33..64 (nstr 66..128).  Past N = 32 a
// lane of the layouts of big.cuh (a root, a row or a column a lane) holds R
// of them: lane t the rows t, t + 32, ..., t + 32 (R - 1).  R = 2 covers the
// N x N systems of K1 beam and K4 (big.cuh's warp_lu_solve already spans
// two halves of 32 rows), R = 4 the 2N = 128 rows of K2's system.  Past
// N = 64 K2's 2N x (3N + 1) system (98.8 KB at N = 64) nears a block's
// shared memory: the bodies of global.cuh take any N there, R a run-time
// count and the matrices in global scratch.
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
