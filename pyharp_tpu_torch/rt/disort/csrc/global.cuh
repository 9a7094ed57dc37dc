// Shared pieces of the kernels at N > 64 (nstr > 128).  There N is any
// run-time value: a lane of the layouts of huge.cuh (a root, a row or a
// column a lane) takes every 32nd of them, lane t the rows t + 32 j,
//
//     for (int r = t; r < n; r += 32) ...
//
// over R = row_sets(n) sets of 32, R itself a run-time count, and the
// working matrices of an element (K1 beam, K4) or a column (K2) live in a
// slab of global scratch, not in registers or shared memory: no bound on N
// but the card's memory.  The wrapper (kernels.py) allocates the scratch
// as a torch tensor on the inputs' device, one slab for each element or
// column the card holds at once (resident_units: the occupancy
// calculator's count times the SMs, at most the work there is), and the
// body walks its elements or columns in a grid-stride loop on its slab.
// Offsets into the inputs, the outputs and the scratch are 64-bit wherever
// a product N^2 L B can pass 2^31 (at N = 128 from L B = 131,072 on).  The
// scratch pointer is not __restrict__: the lanes of a warp read what
// other lanes wrote to it before a __syncwarp, and with the qualifier
// nvcc moved K4's Cholesky stores across that barrier (every column of Lc
// scaled twice on the H100).
#pragma once

#include "huge.cuh"

constexpr int kGlobalMinN = kHugeMaxN + 1;

// Sets of 32 rows in `rows`.
__host__ __device__ __forceinline__ int row_sets(int rows) {
  return (rows + 31) >> 5;
}

// The swap bits of the pivot search in column col of an nr-row system,
// huge.cuh's record_bits_sets over R = row_sets(nr) sets with R a loop
// count: bits[h], bit t, is set where row t + 32 h > col is a record of the
// column, |a_r| beating strictly every |a_k| for col <= k < r, the rows the
// plain bubble swaps with row col.  A NaN pivot is never beaten (+inf) and
// a NaN below it never beats (-inf).  Row r's entry is a[r * stride].  The
// sets run in order, an inclusive prefix max over each (five shuffles)
// with the max of the sets before carried in, one ballot a set; every
// lane of the warp calls it, and lane 0 stores the words of the sets from
// col / 32 on (the sets above hold no record) into bits, which the caller
// reads after a __syncwarp (or __syncthreads).
__device__ __forceinline__ void record_bits_global(const float* a,
                                                   int64_t stride, int nr,
                                                   int col, int t,
                                                   unsigned* bits) {
  const float inf = big_inf();
  float carry = -inf;                  // the max of the sets before
  const int sets = row_sets(nr);
  for (int h = col >> 5; h < sets; ++h) {
    const int r = t + 32 * h;
    float k = -inf;
    if (r >= col && r < nr) {
      const float m = fabsf(a[r * stride]);
      k = m != m ? (r == col ? inf : -inf) : m;
    }
    float s = k;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float y = __shfl_up_sync(kBigFull, s, off);
      if (t >= off) s = fmaxf(s, y);
    }
    float e = __shfl_up_sync(kBigFull, s, 1);
    if (t == 0) e = -inf;
    e = fmaxf(e, carry);
    const unsigned word = __ballot_sync(kBigFull, r > col && k > e);
    if (t == 0) bits[h] = word;
    carry = fmaxf(carry, __shfl_sync(kBigFull, s, 31));
  }
}

// big.cuh's warp_lu_solve (the port's plain lu_solve by a warp) on an
// nr x nr system of any size in global scratch at row stride ld, nq
// right-hand sides in columns nr..nr+nq-1, the solution written over them;
// `bits` holds row_sets(nr) words of the warp's own.  For each column but
// the last: the records (record_bits_global), the bubble's swaps of row
// col with each record in row order over the live columns (lanes over
// columns), then each row below the pivot (rows over lanes) less its
// multiplier a_r,col * (1 / a_col,col) times the pivot row; back
// substitution dividing by the pivot, a right-hand side a lane, each sum in
// ascending column order.  The operations and their order are the plain
// version's; the columns left of a pivot are never read again, so they
// are neither swapped nor updated.
__device__ __forceinline__ void warp_lu_solve_global(float* A, int64_t ld,
                                                     int nr, int nq, int t,
                                                     unsigned* bits) {
  const int w = nr + nq;
  const int sets = row_sets(nr);
  for (int col = 0; col + 1 < nr; ++col) {
    record_bits_global(A + col, ld, nr, col, t, bits);
    __syncwarp();
    for (int h = col >> 5; h < sets; ++h) {
      unsigned word = bits[h];
      while (word != 0u) {
        const int r = 32 * h + __ffs(static_cast<int>(word)) - 1;
        word &= word - 1u;
        for (int j = col + t; j < w; j += 32) {
          const float a = A[col * ld + j];
          A[col * ld + j] = A[r * ld + j];
          A[r * ld + j] = a;
        }
      }
    }
    __syncwarp();
    const float inv = 1.0f / A[col * ld + col];
    for (int r = t; r < nr; r += 32) {
      if (r <= col) continue;
      const float f = A[r * ld + col] * inv;
      for (int j = col + 1; j < w; ++j) {
        A[r * ld + j] = A[r * ld + j] - f * A[col * ld + j];
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

// Units (elements or columns) of `per_sm` a streaming multiprocessor that
// the current device holds at once, at most `work`, at least 1; -1 where
// the device cannot be queried.
inline int64_t resident_units(int64_t per_sm, int64_t work) {
  int dev = 0;
  int sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  const int64_t units = per_sm * static_cast<int64_t>(sms);
  return units < work ? (units > 0 ? units : 1) : work;
}
