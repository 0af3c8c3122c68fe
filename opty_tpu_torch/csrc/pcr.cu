// Parallel cyclic reduction (PCR) kernels for the bordered
// block-tridiagonal KKT system of a collocation NLP, for Hopper (sm_90a).
//
// pcr_factor_levels replaces the Pallas kernel _factor_kernel
// (opty_tpu/ops/pallas_pcr.py, reached through pcr_factor_fused); it
// runs every PCR level of one instance in one thread block.
// pcr_downsweep replaces _downsweep_kernel (pcr_downsweep_fused); it
// pushes one right-hand side through every stored level.
//
// Layout: node axis last.  A block array of one instance is (d, d, N)
// with element (i, j) of node k at (i * d + j) * N + k, so the threads
// of a warp, one node each, read neighbouring addresses.
//
// Both kernels are bound by device memory on an H100: the factor
// writes L = ceil(log2 N) levels of two d x d multipliers per node and
// does ~2.2 kFLOP per node per level, the downsweep reads them all back
// for ~0.1 kFLOP per node per level.  The design keeps everything else
// out of device memory traffic that matters: the factor's level state
// (D, Lb, Ub, F, ping-pong) and the per-level inverses stay in a
// per-instance scratch of ~0.4 MB that lives in the 50 MB L2 at the
// main path's 32 instances; the downsweep keeps r in shared memory
// across all levels and writes it back once.  One block per instance
// leaves most of the 132 SMs idle at 32 instances — accepted in this
// first version.
//
// Arithmetic mirrors the plain PyTorch versions in ops/pcr_kernels.py
// (same pivoting, same summation order): the per-node inverse and
// block product are the device functions of blocks.cuh, shared with
// the standalone kernels of blocks.cu.  Build with -fmad=false so
// products and sums round as they do there.

#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kThreads = 256;

using blocks::block_inv;
using blocks::matmul;

template <typename T, int D>
__device__ __forceinline__ void load_block(T (&m)[D][D], const T* base,
                                           int k, int N, bool valid) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      m[i][j] = valid ? base[(i * D + j) * N + k] : T(0);
}

template <typename T, int D>
__device__ __forceinline__ void store_block(const T (&m)[D][D], T* base,
                                            int k, int N) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) base[(i * D + j) * N + k] = m[i][j];
}

// All PCR levels of one instance per block.  Level state lives in
// `scratch` (per instance: two buffers of [D | Lb | Ub | F] plus the
// level's inverses), node axis last.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
pcr_factor_kernel(const T* __restrict__ Din, const T* __restrict__ Ein,
                  const T* __restrict__ Fin, T* __restrict__ Aout,
                  T* __restrict__ Bout, T* __restrict__ Dinv_out,
                  T* __restrict__ Fp_out, T* __restrict__ Z_out,
                  T* scratch, int N, int nb, int levels) {
  const size_t dd = size_t(D) * D * N;
  const size_t db = size_t(D) * nb * N;
  const size_t inst = blockIdx.x;
  const T* D0 = Din + inst * dd;
  const T* E0 = Ein + inst * dd;
  const T* F0 = Fin + inst * db;
  T* A_o = Aout + inst * levels * dd;
  T* B_o = Bout + inst * levels * dd;
  const size_t state = 3 * dd + db;
  T* cur = scratch + inst * (2 * state + dd);
  T* nxt = cur + state;
  T* dinv = nxt + state;

  // level-0 state: D, Lb = E, Ub_k = E_{k+1}^T (0 at the last node), F
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int ij = (i * D + j) * N + k;
        cur[ij] = D0[ij];
        cur[dd + ij] = E0[ij];
        cur[2 * dd + ij] = (k + 1 < N) ? E0[(j * D + i) * N + k + 1] : T(0);
      }
    for (int c = 0; c < D * nb; ++c) cur[3 * dd + c * N + k] = F0[c * N + k];
  }
  __syncthreads();

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    // phase 1: every node inverts its own diagonal block
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      T Dk[D][D], Xk[D][D];
      load_block(Dk, cur, k, N, true);
      block_inv(Dk, Xk);
      store_block(Xk, dinv, k, N);
    }
    __syncthreads();

    // phase 2: eliminate the neighbours at distance s
    T* A_l = A_o + l * dd;
    T* B_l = B_o + l * dd;
    const T* Dc = cur;
    const T* Lc = cur + dd;
    const T* Uc = cur + 2 * dd;
    const T* Fc = cur + 3 * dd;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int km = k - s, kp = k + s;
      const bool hm = km >= 0, hp = kp < N;
      const int km_c = hm ? km : 0, kp_c = hp ? kp : 0;
      T A[D][D], B[D][D], X[D][D], Y[D][D], C[D][D];

      load_block(X, Lc, k, N, true);
      load_block(Y, dinv, km_c, N, hm);
      matmul(X, Y, A);                                  // A = Lb Dinv_{k-s}
      load_block(X, Uc, k, N, true);
      load_block(Y, dinv, kp_c, N, hp);
      matmul(X, Y, B);                                  // B = Ub Dinv_{k+s}
      store_block(A, A_l, k, N);
      store_block(B, B_l, k, N);

      // D' = D - A Ub_{k-s} - B Lb_{k+s}
      load_block(X, Uc, km_c, N, hm);
      matmul(A, X, C);
      load_block(X, Dc, k, N, true);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) X[i][j] = X[i][j] - C[i][j];
      load_block(Y, Lc, kp_c, N, hp);
      matmul(B, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) X[i][j] = X[i][j] - C[i][j];
      store_block(X, nxt, k, N);

      // Lb' = -A Lb_{k-s},  Ub' = -B Ub_{k+s}
      load_block(Y, Lc, km_c, N, hm);
      matmul(A, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) C[i][j] = -C[i][j];
      store_block(C, nxt + dd, k, N);
      load_block(Y, Uc, kp_c, N, hp);
      matmul(B, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) C[i][j] = -C[i][j];
      store_block(C, nxt + 2 * dd, k, N);

      // F' = F - A F_{k-s} - B F_{k+s}, one border column at a time
      for (int c = 0; c < nb; ++c) {
        T fm[D], fp[D];
#pragma unroll
        for (int m = 0; m < D; ++m) {
          fm[m] = hm ? Fc[(m * nb + c) * N + km_c] : T(0);
          fp[m] = hp ? Fc[(m * nb + c) * N + kp_c] : T(0);
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          T ta = A[i][0] * fm[0];
          T tb = B[i][0] * fp[0];
#pragma unroll
          for (int m = 1; m < D; ++m) {
            ta = ta + A[i][m] * fm[m];
            tb = tb + B[i][m] * fp[m];
          }
          const int ic = (i * nb + c) * N + k;
          nxt[3 * dd + ic] = (Fc[ic] - ta) - tb;
        }
      }
    }
    __syncthreads();
    T* t = cur;
    cur = nxt;
    nxt = t;
    s *= 2;
  }

  // final inverse, eliminated border columns, Z = Dinv^T F_original
  T* dinv_o = Dinv_out + inst * dd;
  T* fp_o = Fp_out + inst * db;
  T* z_o = Z_out + inst * db;
  for (int k = threadIdx.x; k < N; k += blockDim.x) {
    T Dk[D][D], Xk[D][D];
    load_block(Dk, cur, k, N, true);
    block_inv(Dk, Xk);
    store_block(Xk, dinv_o, k, N);
    for (int c = 0; c < nb; ++c) {
      T f0[D];
#pragma unroll
      for (int m = 0; m < D; ++m) {
        f0[m] = F0[(m * nb + c) * N + k];
        fp_o[(m * nb + c) * N + k] = cur[3 * dd + (m * nb + c) * N + k];
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T acc = Xk[0][i] * f0[0];
#pragma unroll
        for (int m = 1; m < D; ++m) acc = acc + Xk[m][i] * f0[m];
        z_o[(i * nb + c) * N + k] = acc;
      }
    }
  }
}

// r <- r - A_l r_{k-s} - B_l r_{k+s} through every stored level, r
// held in shared memory (two ping-pong copies of d x N).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
pcr_downsweep_kernel(const T* __restrict__ Ain, const T* __restrict__ Bin,
                     const T* __restrict__ rin, T* __restrict__ rout, int N,
                     int levels) {
  extern __shared__ unsigned char smem_raw[];
  T* r0 = reinterpret_cast<T*>(smem_raw);
  T* r1 = r0 + D * N;
  const size_t inst = blockIdx.x;
  const size_t dd = size_t(D) * D * N;
  const T* A_i = Ain + inst * levels * dd;
  const T* B_i = Bin + inst * levels * dd;
  for (int e = threadIdx.x; e < D * N; e += blockDim.x)
    r0[e] = rin[inst * D * N + e];
  __syncthreads();

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    const T* A_l = A_i + l * dd;
    const T* B_l = B_i + l * dd;
    for (int k = threadIdx.x; k < N; k += blockDim.x) {
      const int km = k - s, kp = k + s;
      const bool hm = km >= 0, hp = kp < N;
      T rm[D], rp[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        rm[j] = hm ? r0[j * N + km] : T(0);
        rp[j] = hp ? r0[j * N + kp] : T(0);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T ta = A_l[(i * D) * N + k] * rm[0];
        T tb = B_l[(i * D) * N + k] * rp[0];
#pragma unroll
        for (int j = 1; j < D; ++j) {
          ta = ta + A_l[(i * D + j) * N + k] * rm[j];
          tb = tb + B_l[(i * D + j) * N + k] * rp[j];
        }
        r1[i * N + k] = (r0[i * N + k] - ta) - tb;
      }
    }
    __syncthreads();
    T* t = r0;
    r0 = r1;
    r1 = t;
    s *= 2;
  }
  for (int e = threadIdx.x; e < D * N; e += blockDim.x)
    rout[inst * D * N + e] = r0[e];
}

template <typename T, int D>
cudaError_t launch_factor(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int nb, int N,
                          int levels, cudaStream_t stream) {
  pcr_factor_kernel<T, D><<<batch, kThreads, 0, stream>>>(
      static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<T*>(A), static_cast<T*>(B),
      static_cast<T*>(Dinv), static_cast<T*>(Fp), static_cast<T*>(Z),
      static_cast<T*>(scratch), N, nb, levels);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_downsweep(const void* A, const void* B, const void* r,
                             void* out, int batch, int N, int levels,
                             cudaStream_t stream) {
  const size_t smem = 2 * size_t(D) * N * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pcr_downsweep_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return err;
  }
  pcr_downsweep_kernel<T, D><<<batch, kThreads, smem, stream>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(r), static_cast<T*>(out), N, levels);
  return cudaGetLastError();
}

template <typename T>
int factor_dispatch(const void* Dm, const void* E, const void* F, void* A,
                    void* B, void* Dinv, void* Fp, void* Z, void* scratch,
                    int batch, int d, int nb, int N, int levels,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 3:
      return launch_factor<T, 3>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                 nb, N, levels, st);
    case 5:
      return launch_factor<T, 5>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                 nb, N, levels, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int downsweep_dispatch(const void* A, const void* B, const void* r,
                       void* out, int batch, int d, int N, int levels,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 3:
      return launch_downsweep<T, 3>(A, B, r, out, batch, N, levels, st);
    case 5:
      return launch_downsweep<T, 5>(A, B, r, out, batch, N, levels, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry returns the
// cudaError_t of its launch; 0 means launched.
extern "C" {

int pcr_factor_levels_f32(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int d, int nb, int N,
                          int levels, void* stream) {
  return factor_dispatch<float>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                d, nb, N, levels, stream);
}

int pcr_factor_levels_f64(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int d, int nb, int N,
                          int levels, void* stream) {
  return factor_dispatch<double>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                 d, nb, N, levels, stream);
}

int pcr_downsweep_f32(const void* A, const void* B, const void* r,
                      void* out, int batch, int d, int N, int levels,
                      void* stream) {
  return downsweep_dispatch<float>(A, B, r, out, batch, d, N, levels, stream);
}

int pcr_downsweep_f64(const void* A, const void* B, const void* r,
                      void* out, int batch, int d, int N, int levels,
                      void* stream) {
  return downsweep_dispatch<double>(A, B, r, out, batch, d, N, levels,
                                    stream);
}

}  // extern "C"
