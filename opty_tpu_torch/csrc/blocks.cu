// Batched small-matrix kernels for Hopper (sm_90a): the inverse and the
// product of a batch of d x d matrices, d = 2..8, float and double.
//
// block_inv replaces the Pallas kernel _inv_kernel
// (opty_tpu/ops/pallas_blocks.py, reached through block_inv_pallas);
// block_matmul replaces _matmul_kernel (block_matmul_pallas).  The PCR
// path's border Schur inverse (ops/tridiag.py) calls block_inv once per
// factorization.  The scan KKT path does its per-node inverses and
// products inside the scan_factor kernel (scan.cu), one launch per
// factorization, so block_matmul has no caller on a solver path.
//
// block_inv: one thread per matrix, the matrix in registers, the
// arithmetic the device function of blocks.cuh (shared with pcr.cu).  A
// block of kThreads threads stages its contiguous span of kThreads
// matrices through shared memory, so global loads and stores are
// coalesced and every loaded line is used; the ragged end of the batch
// is masked here.
//
// block_matmul: one thread per output entry, which loads its row of A
// and its column of B in one round and sums in order.
//
// Both read the batch as it comes, (batch, d, d) row-major: no
// transpose to a batch-last layout and no padding of the batch, as the
// TPU kernels need.  What bounds them on an H100: at a few tens of
// matrices the launch latency, a few microseconds against well under
// one of bytes (empty_launch, an empty kernel, measures that floor).
// At a whole node axis (16,032 matrices of d = 5, float32) device
// memory: the inverse reads and writes 3.2 MB (about 1.0 us at
// 3.35 TB/s) for ~485 FLOP a matrix, the product moves 4.8 MB (about
// 1.4 us).
//
// Built with -fmad=false, so on finite inputs both equal their plain
// PyTorch versions (ops/block_kernels.py) bitwise.

#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kThreads = 64;   // 64 matrices a block: 32 KB of shared
                               // memory at d = 8 in double
constexpr int kProductThreads = 256;   // output entries a block

template <typename T, int D>
__device__ __forceinline__ void load_tile(T* tile, const T* src, int n) {
  for (int e = threadIdx.x; e < n * D * D; e += kThreads) tile[e] = src[e];
}

template <typename T, int D>
__device__ __forceinline__ void store_tile(const T* tile, T* dst, int n) {
  for (int e = threadIdx.x; e < n * D * D; e += kThreads) dst[e] = tile[e];
}

template <typename T, int D>
__device__ __forceinline__ void read_own(T (&m)[D][D], const T* tile) {
  const T* mine = tile + threadIdx.x * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) m[i][j] = mine[i * D + j];
}

template <typename T, int D>
__device__ __forceinline__ void write_own(const T (&m)[D][D], T* tile) {
  T* mine = tile + threadIdx.x * D * D;
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) mine[i * D + j] = m[i][j];
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
block_inv_kernel(const T* __restrict__ A, T* __restrict__ X, int batch) {
  __shared__ T tile[kThreads * D * D];
  const int first = blockIdx.x * kThreads;
  const int n = min(kThreads, batch - first);
  const size_t offset = size_t(first) * D * D;
  load_tile<T, D>(tile, A + offset, n);
  __syncthreads();
  if (threadIdx.x < n) {
    T M[D][D], R[D][D];
    read_own<T, D>(M, tile);
    blocks::block_inv<T, D>(M, R);
    write_own<T, D>(R, tile);
  }
  __syncthreads();
  store_tile<T, D>(tile, X + offset, n);
}

template <typename T, int D>
__global__ void __launch_bounds__(kProductThreads)
block_matmul_kernel(const T* __restrict__ A, const T* __restrict__ B,
                    T* __restrict__ C, size_t entries) {
  const size_t e = size_t(blockIdx.x) * kProductThreads + threadIdx.x;
  if (e >= entries) return;
  const size_t m = e / (D * D);
  const int i = int(e % (D * D)) / D, j = int(e % D);
  const T* a = A + m * D * D + i * D;       // row i
  const T* b = B + m * D * D + j;           // column j
  T x[D], y[D];
#pragma unroll
  for (int q = 0; q < D; ++q) {
    x[q] = a[q];
    y[q] = b[q * D];
  }
  T acc = x[0] * y[0];
#pragma unroll
  for (int q = 1; q < D; ++q) acc = acc + x[q] * y[q];
  C[e] = acc;
}

__global__ void empty_kernel() {}

template <typename T, int D>
cudaError_t launch_inv(const void* A, void* X, int batch, cudaStream_t st) {
  const int grid = (batch + kThreads - 1) / kThreads;
  block_inv_kernel<T, D><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(A), static_cast<T*>(X), batch);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_matmul(const void* A, const void* B, void* C, int batch,
                          cudaStream_t st) {
  const size_t entries = size_t(batch) * D * D;
  const unsigned grid =
      unsigned((entries + kProductThreads - 1) / kProductThreads);
  block_matmul_kernel<T, D><<<grid, kProductThreads, 0, st>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<T*>(C), entries);
  return cudaGetLastError();
}

template <typename T>
int inv_dispatch(const void* A, void* X, int batch, int d, void* stream) {
  if (batch < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_inv<T, 2>(A, X, batch, st);
    case 3: return launch_inv<T, 3>(A, X, batch, st);
    case 4: return launch_inv<T, 4>(A, X, batch, st);
    case 5: return launch_inv<T, 5>(A, X, batch, st);
    case 6: return launch_inv<T, 6>(A, X, batch, st);
    case 7: return launch_inv<T, 7>(A, X, batch, st);
    case 8: return launch_inv<T, 8>(A, X, batch, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int matmul_dispatch(const void* A, const void* B, void* C, int batch, int d,
                    void* stream) {
  if (batch < 1) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 2: return launch_matmul<T, 2>(A, B, C, batch, st);
    case 3: return launch_matmul<T, 3>(A, B, C, batch, st);
    case 4: return launch_matmul<T, 4>(A, B, C, batch, st);
    case 5: return launch_matmul<T, 5>(A, B, C, batch, st);
    case 6: return launch_matmul<T, 6>(A, B, C, batch, st);
    case 7: return launch_matmul<T, 7>(A, B, C, batch, st);
    case 8: return launch_matmul<T, 8>(A, B, C, batch, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry returns the
// cudaError_t of its launch; 0 means launched.
extern "C" {

int block_inv_f32(const void* A, void* X, int batch, int d, void* stream) {
  return inv_dispatch<float>(A, X, batch, d, stream);
}

int block_inv_f64(const void* A, void* X, int batch, int d, void* stream) {
  return inv_dispatch<double>(A, X, batch, d, stream);
}

int block_matmul_f32(const void* A, const void* B, void* C, int batch, int d,
                     void* stream) {
  return matmul_dispatch<float>(A, B, C, batch, d, stream);
}

int block_matmul_f64(const void* A, const void* B, void* C, int batch, int d,
                     void* stream) {
  return matmul_dispatch<double>(A, B, C, batch, d, stream);
}

// An empty kernel: the time of a launch that does no work.
int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return int(cudaGetLastError());
}

}  // extern "C"
