// Shared pieces of the kernels at N = 9..16 (nstr 18..32).  Each of them is
// one body for every such N, with N a run-time argument and arrays sized
// kNMax = 16: eight template instantiations with fully unrolled N^3 loops
// would multiply the build time, and at these sizes an element's matrices
// no longer fit in registers whatever the unrolling.
#pragma once

#include "common.cuh"

constexpr int kNMax = 16;
constexpr int kWideMinN = kNarrowMaxN + 1;

// lu_solve of common.cuh for one right-hand side at a run-time n <= kNMax:
// the operations of the port's plain linsolve.lu_solve in its order (strict
// |a_r| > |a_col| row swaps over the live suffix, multipliers times the
// pivot's reciprocal, back substitution dividing by the pivot).  A and b
// are overwritten.
__device__ __forceinline__ void lu_solve_rt(float (*A)[kNMax], float* b,
                                            float* x, int n) {
  for (int col = 0; col < n; ++col) {
    for (int r = col + 1; r < n; ++r) {
      if (fabsf(A[r][col]) > fabsf(A[col][col])) {
        for (int j = col; j < n; ++j) {
          const float t = A[r][j];
          A[r][j] = A[col][j];
          A[col][j] = t;
        }
        const float t = b[r];
        b[r] = b[col];
        b[col] = t;
      }
    }
    const float inv = 1.0f / A[col][col];
    for (int r = col + 1; r < n; ++r) {
      const float f = A[r][col] * inv;
      for (int j = col + 1; j < n; ++j) A[r][j] = A[r][j] - f * A[col][j];
      b[r] = b[r] - f * b[col];
    }
  }
  for (int row = n - 1; row >= 0; --row) {
    float acc = b[row];
    for (int c = row + 1; c < n; ++c) acc = acc - A[row][c] * x[c];
    x[row] = acc / A[row][row];
  }
}
