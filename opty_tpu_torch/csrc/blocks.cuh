// Device functions on one small d x d matrix held in registers: the
// inverse shared by the PCR kernels (pcr.cu) and the standalone
// batched inverse (blocks.cu), so both run the same arithmetic, and the
// product of the PCR kernels.  scan.cu takes the NaN test, so its
// pivot search keeps the same rule.
//
// Both mirror the plain PyTorch versions operation for operation
// (ops/lanes.py: block_inv_nl, matmul_nl): same pivot rule, same
// summation order.  Build with -fmad=false so products and sums round
// as they do there.

#pragma once

#include <cuda_runtime.h>

namespace blocks {

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

// Pivoted inverse of one d x d matrix: Gaussian elimination with
// partial pivoting (largest |entry| at or below the diagonal, the first
// one on ties, NaN counted as largest), select-based row swaps, then
// back substitution — the algorithm of block_inv_nl.  M is overwritten.
template <typename T, int D>
__device__ __forceinline__ void block_inv(T (&M)[D][D], T (&X)[D][D]) {
  T R[D][D];
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) R[i][j] = (i == j) ? T(1) : T(0);

#pragma unroll
  for (int k = 0; k < D; ++k) {
    int p = k;
    T best = fabs(M[k][k]);
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      T v = fabs(M[i][k]);
      if (v > best || (is_nan(v) && !is_nan(best))) {
        best = v;
        p = i;
      }
    }
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const bool s = (i == p);
#pragma unroll
      for (int j = 0; j < D; ++j) {
        T a = M[k][j], b = M[i][j];
        M[k][j] = s ? b : a;
        M[i][j] = s ? a : b;
        a = R[k][j];
        b = R[i][j];
        R[k][j] = s ? b : a;
        R[i][j] = s ? a : b;
      }
    }
    const T piv = M[k][k];
    T rowM[D], rowR[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      rowM[j] = M[k][j];
      rowR[j] = R[k][j];
    }
#pragma unroll
    for (int i = k + 1; i < D; ++i) {
      const T f = M[i][k] / piv;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        M[i][j] = M[i][j] - f * rowM[j];
        R[i][j] = R[i][j] - f * rowR[j];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) X[i][j] = T(0);
#pragma unroll
  for (int k = D - 1; k >= 0; --k) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = M[k][0] * X[0][j];
#pragma unroll
      for (int i = 1; i < D; ++i) acc = acc + M[k][i] * X[i][j];
      X[k][j] = (R[k][j] - acc) / M[k][k];
    }
  }
}

// C = X @ Y with the inner sum in order (matmul_nl's order).
template <typename T, int D>
__device__ __forceinline__ void matmul(const T (&X)[D][D], const T (&Y)[D][D],
                                       T (&C)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) {
      T acc = X[i][0] * Y[0][j];
#pragma unroll
      for (int m = 1; m < D; ++m) acc = acc + X[i][m] * Y[m][j];
      C[i][j] = acc;
    }
}

}  // namespace blocks
