// Shared pieces of the kernels at N = 17..32 (nstr 34..64).  Each of them
// gives an element (K1, K4) a whole warp or a column (K2) a block of warps,
// lane t owning row t (and t + 32 where a system has 2N rows), and keeps
// its matrices in shared memory at a run-time N: at these sizes no
// element's matrices fit in a thread's registers, and the bodies of
// N <= 16 (wide.cuh) size theirs for kNMax = 16.
#pragma once

#include "common.cuh"

constexpr int kBigMaxN = 32;
constexpr int kBigMinN = 17;
constexpr unsigned kBigFull = 0xffffffffu;

__device__ __forceinline__ float big_inf() { return __int_as_float(0x7f800000); }

// Cycles by phase, for tools/wide_ab.py's part big_cycles, which builds
// the bodies with -DPYHARP_BIG_PROFILE: BIG_PROF_START() where a warp (K4)
// or a block (K2) begins, BIG_PROF_MARK(k) at the end of phase k (lane 0
// of warp w adds the clock64() cycles since its previous mark to its
// phase-k slot in shared memory), BIG_PROF_FLUSH() once at the end (the
// slots into the device counters, one unit counted in slot kProfPhases).
// A source defines the reader of its counters with
// BIG_PROF_READER(name): pyharp_<name>_profile(out) copies the
// kProfPhases + 1 counters to the host and zeroes them.  Without the macro
// every mark is empty.
constexpr int kProfPhases = 8;
#ifdef PYHARP_BIG_PROFILE
constexpr int kProfWarps = 16;
namespace {
__shared__ long long big_prof_last[kProfWarps];
__shared__ unsigned long long big_prof_acc[kProfWarps][kProfPhases];
__device__ unsigned long long big_prof_total[kProfPhases + 1];
}  // namespace
#define BIG_PROF_START()                                                    \
  do {                                                                      \
    const int w_ = static_cast<int>(threadIdx.x) >> 5;                      \
    if ((threadIdx.x & 31) == 0) {                                          \
      for (int k_ = 0; k_ < kProfPhases; ++k_) big_prof_acc[w_][k_] = 0;    \
      big_prof_last[w_] = clock64();                                        \
    }                                                                       \
  } while (0)
#define BIG_PROF_MARK(k)                                                    \
  do {                                                                      \
    const int w_ = static_cast<int>(threadIdx.x) >> 5;                      \
    if ((threadIdx.x & 31) == 0) {                                          \
      const long long now_ = clock64();                                     \
      big_prof_acc[w_][k] += now_ - big_prof_last[w_];                      \
      big_prof_last[w_] = now_;                                             \
    }                                                                       \
  } while (0)
#define BIG_PROF_FLUSH()                                                    \
  do {                                                                      \
    const int w_ = static_cast<int>(threadIdx.x) >> 5;                      \
    if ((threadIdx.x & 31) == 0) {                                          \
      for (int k_ = 0; k_ < kProfPhases; ++k_)                              \
        atomicAdd(&big_prof_total[k_], big_prof_acc[w_][k_]);               \
      atomicAdd(&big_prof_total[kProfPhases], 1ull);                        \
    }                                                                       \
  } while (0)
#define BIG_PROF_READER(name)                                               \
  PYHARP_API int pyharp_##name##_profile(unsigned long long* out) {         \
    cudaError_t e = cudaMemcpyFromSymbol(                                   \
        out, big_prof_total, sizeof(unsigned long long) * (kProfPhases + 1)); \
    if (e != cudaSuccess) return static_cast<int>(e);                       \
    unsigned long long zero[kProfPhases + 1] = {};                          \
    return static_cast<int>(                                                \
        cudaMemcpyToSymbol(big_prof_total, zero, sizeof(zero)));            \
  }
#else
#define BIG_PROF_START() do { } while (0)
#define BIG_PROF_MARK(k) do { } while (0)
#define BIG_PROF_FLUSH() do { } while (0)
#define BIG_PROF_READER(name)
#endif

// An odd row stride of at least n floats: the lanes of a warp, each on its
// own row at one column, then meet 32 distinct banks.
__host__ __device__ __forceinline__ int odd_stride(int n) { return n | 1; }

// NaN-propagating max, as torch.maximum.
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// The swap bits of the pivot search in column col of an nr-row system
// (nr <= 64): bit r of the result is set where row r > col is a record of
// the column, |a_r| beating strictly every |a_k| for col <= k < r.  These
// are the rows the plain bubble (strict |a_r| > |a_col| swaps of row col
// with each row r in order) swaps with row col.  A NaN pivot is never
// beaten (+inf) and a NaN below it never beats (-inf), as the bubble's
// comparisons leave them.  Lane t gives a0 and a1, the column's entries in
// rows t and t + 32 (any value where the row is past nr); an inclusive
// prefix max over each half (five shuffles), the lower half's total
// carried into the upper, and two ballots give every lane the same 64
// bits.
__device__ __forceinline__ unsigned long long record_bits_of(float a0,
                                                             float a1, int nr,
                                                             int col, int t) {
  const float inf = big_inf();
  auto key = [&](int r, float v) {
    if (r < col || r >= nr) return -inf;
    const float a = fabsf(v);
    return a != a ? (r == col ? inf : -inf) : a;
  };
  const float k0 = key(t, a0);
  const float k1 = key(t + 32, a1);
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

// record_bits_of for column col of a system held by a warp in shared
// memory at row stride ld.
__device__ __forceinline__ unsigned long long record_bits(const float* A,
                                                          int ld, int nr,
                                                          int col, int t) {
  const float a0 = t < nr ? A[t * ld + col] : 0.0f;
  const float a1 = t + 32 < nr ? A[(t + 32) * ld + col] : 0.0f;
  return record_bits_of(a0, a1, nr, col, t);
}

// The logical position whose row the bubble's swaps in column col (records
// `bits`, record_bits_of) move to position x: the swaps amount to one
// permutation, position col taking the last record's row, each record the
// row of the record before it (col's for the first), every other position
// its own.
__device__ __forceinline__ int record_source(unsigned long long bits,
                                             int col, int x) {
  if (x == col) return bits != 0ull ? 63 - __clzll(bits) : col;
  if (((bits >> x) & 1ull) == 0ull) return x;
  const unsigned long long below = bits & ((1ull << x) - 1ull);
  return below != 0ull ? 63 - __clzll(below) : col;
}

// A warp's logical-to-physical row map of a system of up to 64 rows, lane
// t holding the physical rows p0, p1 of the logical rows t and t + 32 and
// their entries a0, a1 in the pivot column, after the swaps of records
// `bits` in column col: one gather by shuffles.
__device__ __forceinline__ void apply_records(unsigned long long bits,
                                              int col, int t, int& p0,
                                              int& p1, float& a0, float& a1) {
  const int s0 = record_source(bits, col, t);
  const int s1 = record_source(bits, col, t + 32);
  const int i00 = __shfl_sync(kBigFull, p0, s0 & 31);
  const int i01 = __shfl_sync(kBigFull, p1, s0 & 31);
  const int i10 = __shfl_sync(kBigFull, p0, s1 & 31);
  const int i11 = __shfl_sync(kBigFull, p1, s1 & 31);
  const float v00 = __shfl_sync(kBigFull, a0, s0 & 31);
  const float v01 = __shfl_sync(kBigFull, a1, s0 & 31);
  const float v10 = __shfl_sync(kBigFull, a0, s1 & 31);
  const float v11 = __shfl_sync(kBigFull, a1, s1 & 31);
  p0 = s0 < 32 ? i00 : i01;
  p1 = s1 < 32 ? i10 : i11;
  a0 = s0 < 32 ? v00 : v01;
  a1 = s1 < 32 ? v10 : v11;
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
