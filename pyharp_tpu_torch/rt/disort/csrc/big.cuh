// Shared pieces of the kernels at N = 17..32 (nstr 34..64).  Each of them
// gives an element (K1, K4) or a column (K2) a whole warp, lane t owning row
// t (and t + 32 where a system has 2N rows), and keeps its matrices in
// shared memory at a run-time N: at these sizes no element's matrices fit in
// a thread's registers, and the bodies of N <= 16 (wide.cuh) size theirs
// for kNMax = 16.
#pragma once

#include "common.cuh"

constexpr int kBigMaxN = 32;
constexpr int kBigMinN = 17;
constexpr unsigned kBigFull = 0xffffffffu;

__device__ __forceinline__ float big_inf() { return __int_as_float(0x7f800000); }

// An odd row stride of at least n floats: the lanes of a warp, each on its
// own row at one column, then meet 32 distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

// NaN-propagating max, as torch.maximum.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The swap bits of the pivot search in column col of an nr-row system
// (nr <= 64) held by a warp in shared memory at row stride ld: bit r of the
// result is set where row r > col is a record of the column, |a_r| beating
// strictly every |a_k| for col <= k < r.  These are the rows the plain
// bubble (strict |a_r| > |a_col| swaps of row col with each row r in
// order) swaps with row col.  A NaN pivot is never beaten (+inf) and a NaN
// below it never beats (-inf), as the bubble's comparisons leave them.
// Lane t holds rows t and t + 32; an inclusive prefix max over each half
// (five shuffles), the lower half's total carried into the upper, and two
// ballots give every lane the same 64 bits.
__device__ __forceinline__ unsigned long long record_bits(const float* A,
                                                          int ld, int nr,
                                                          int col, int t) {
  const float inf = big_inf();
  auto key = [&](int r) {
    if (r < col || r >= nr) return -inf;
    const float a = fabsf(A[r * ld + col]);
    return a != a ? (r == col ? inf : -inf) : a;
  };
  const float k0 = key(t);
  const float k1 = key(t + 32);
  float s0 = k0;
  float s1 = k1;
#pragma unroll
  for (int off = 1; off < 32; off *= 2) {
    const float y0 = __shfl_up_sync(kBigFull, s0, off);
    const float y1 = __shfl_up_sync(kBigFull, s1, off);
    if (t >= off) {
      s0 = fmaxf(s0, y0);
      s1 = fmaxf(s1, y1);
    }
  }
  const float low_total = __shfl_sync(kBigFull, s0, 31);
  float e0 = __shfl_up_sync(kBigFull, s0, 1);
  float e1 = __shfl_up_sync(kBigFull, s1, 1);
  if (t == 0) {
    e0 = -inf;
    e1 = -inf;
  }
  e1 = fmaxf(e1, low_total);
  const unsigned lo = __ballot_sync(kBigFull, t > col && k0 > e0);
  const unsigned hi = __ballot_sync(kBigFull, t + 32 > col && k1 > e1);
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// lu_solve of the port's plain linsolve (common.cuh's lu_solve) by a warp,
// on an nr x nr system (nr <= 64) in shared memory at row stride ld with
// nq right-hand sides (nq <= 64) in columns nr..nr+nq-1, the solution
// written over them; every lane of the warp calls it.  The operations and
// their order are the plain version's: for each column but the last, the
// bubble's row swaps (record_bits, applied in row order to the live
// columns, lanes over columns), then each row below the pivot (on its lane)
// less its multiplier a_r,col * (1 / a_col,col) times the pivot row; back
// substitution dividing by the pivot, each right-hand side on a lane of
// its own.  The columns left of a pivot are never read again, so they are
// neither swapped nor updated.
__device__ __forceinline__ void warp_lu_solve(float* A, int ld, int nr,
                                              int nq, int t) {
  const int w = nr + nq;
  for (int col = 0; col + 1 < nr; ++col) {
    unsigned long long bits = record_bits(A, ld, nr, col, t);
    while (bits != 0ull) {
      const int r = __ffsll(static_cast<long long>(bits)) - 1;
      bits &= bits - 1ull;
      for (int j = col + t; j < w; j += 32) {
        const float a = A[col * ld + j];
        A[col * ld + j] = A[r * ld + j];
        A[r * ld + j] = a;
      }
    }
    __syncwarp();
    const float inv = 1.0f / A[col * ld + col];
    for (int r = t; r < nr; r += 32) {
      if (r > col) {
        const float f = A[r * ld + col] * inv;
        for (int j = col + 1; j < w; ++j) {
          A[r * ld + j] = A[r * ld + j] - f * A[col * ld + j];
        }
      }
    }
    __syncwarp();
  }
  for (int q = t; q < nq; q += 32) {
    for (int row = nr - 1; row >= 0; --row) {
      float acc = A[row * ld + nr + q];
      for (int c = row + 1; c < nr; ++c) {
        acc = acc - A[row * ld + c] * A[c * ld + nr + q];
      }
      A[row * ld + nr + q] = acc / A[row * ld + row];
    }
  }
  __syncwarp();
}
