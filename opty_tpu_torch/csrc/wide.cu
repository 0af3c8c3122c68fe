// Wide-block kernels for Hopper (sm_90a): the PCR factorization and
// downsweep of ops/pcr_kernels.py, and the batched inverse of
// ops/block_kernels.py, for blocks of any size 1 <= d <= 64 (the PCR
// border 0 <= b <= 64), float and double.  pcr.cu and blocks.cu keep a
// node's or a matrix's d x d block in one thread's registers, which
// holds for d <= 8; a 50 x 50 block (10 KB in float, 20 KB in double)
// does not fit there.  So here a whole thread block works on one node's
// (or one matrix's) blocks, held in shared memory.
//
// pcr_wide_factor replaces the Pallas kernel _factor_kernel
// (opty_tpu/ops/pallas_pcr.py, reached through pcr_factor_fused) for the
// wide class: the nlink-9 chain's d = 50, b = 41, N = 60.
// pcr_wide_downsweep replaces _downsweep_kernel (pcr_downsweep_fused).
// block_inv_wide replaces _inv_kernel (opty_tpu/ops/pallas_blocks.py,
// block_inv_pallas) for the PCR path's border Schur complement, b = 41.
//
// Layout of the PCR arrays as in pcr.cu: node axis last, element (i, j)
// of node k of an instance at (i * d + j) * N + k.
//
// What bounds them on an H100:
// * The factor, by arithmetic: a level costs a node about 6 d^3 + 2 d^2 b
//   multiply-adds for its six products and two border products, and
//   about 2 d^3 more for the pivoted inverse of its new diagonal block
//   (~2.2 MFLOP a node at d = 50, b = 41; 6.2 GFLOP per factorization of
//   B = 8 instances at N = 60, against 84 MB of outputs).  The design:
//   one launch per level (the barrier between levels over all nodes of
//   an instance), a thread block per (instance, node).  The level state
//   [D | Lb | Ub | F] of every node and the level's inverses live in a
//   global scratch, node-major, so a block reads a neighbour's blocks as
//   contiguous runs; the operands of each product are staged in shared
//   memory, and each thread sums a 4 x 4 tile of the product in
//   registers, its rows and columns interleaved over the tile grid so
//   that a warp reads consecutive shared-memory words.  A block inverts
//   its node's new diagonal block right after forming it, so level l's
//   launch also gives level l + 1 its inverses: L + 1 launches per
//   factorization (the first inverts the initial blocks).  No tensor
//   cores: TF32 is ruled out (config.py), and wgmma/DMMA tiling is
//   later work.
// * The downsweep, by reading the stored levels (2 L d^2 N values an
//   instance).  The design of pcr.cu's downsweep with d a runtime value:
//   an instance on a thread block cluster, r in shared memory, a thread
//   per (node, row) looping over its further pairs, neighbours in other
//   blocks read through distributed shared memory, one cluster barrier a
//   level.
// * block_inv_wide, at the PCR border's 8-32 matrices, by launch latency
//   and the inverse's d sequential pivot steps.
//
// The inverse is block_inv_nl's (ops/lanes.py): Gaussian elimination
// with partial pivoting (largest |entry| at or below the diagonal, the
// first one on ties, NaN counted as largest; here a warp reduction),
// row swaps, then back substitution, every column of M and R updated as
// there.  Products sum their inner index in order, as matmul_nl does,
// and the level updates subtract in the plain version's order.  Built
// with -fmad=false, the factor and the inverse equal their plain PyTorch
// versions bitwise on finite inputs; the downsweep differs from its
// plain version only by the order of torch's reduction in matvec_nl.

#include <atomic>
#include <cstddef>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;          // a block of the factor, the inverse
constexpr int kSweepThreads = 1024;    // a block of the downsweep
constexpr int kTile = 4;               // a thread's tile of a product
constexpr int kMaxD = 64;
constexpr int kMaxB = 64;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

template <typename T>
__device__ __forceinline__ bool is_nan(T v) { return v != v; }

// f(i, j, C(i, j)) for C = X Y, X (rows x inner) with element (i, m) at
// X[i * xr + m * xc], Y (inner x cols) row-major with row stride ldy;
// the sum over m in order.  Thread t owns rows it + a * tr and columns
// jt + b * tc (a, b < kTile) for (it, jt) = (t / tc, t % tc).
template <typename T, typename F>
__device__ __forceinline__ void tile_product(const T* X, int xr, int xc,
                                             const T* Y, int ldy, int rows,
                                             int cols, int inner, F&& f) {
  const int tr = (rows + kTile - 1) / kTile;
  const int tc = (cols + kTile - 1) / kTile;
  for (int t = threadIdx.x; t < tr * tc; t += blockDim.x) {
    const int it = t / tc, jt = t - (t / tc) * tc;
    int ri[kTile], cj[kTile];
#pragma unroll
    for (int a = 0; a < kTile; ++a) {
      ri[a] = min(it + a * tr, rows - 1);
      cj[a] = min(jt + a * tc, cols - 1);
    }
    T acc[kTile][kTile];
    {
      T x[kTile], y[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        x[a] = X[ri[a] * xr];
        y[a] = Y[cj[a]];
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) acc[a][b] = x[a] * y[b];
    }
    for (int m = 1; m < inner; ++m) {
      T x[kTile], y[kTile];
#pragma unroll
      for (int a = 0; a < kTile; ++a) {
        x[a] = X[ri[a] * xr + m * xc];
        y[a] = Y[m * ldy + cj[a]];
      }
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int b = 0; b < kTile; ++b) acc[a][b] = acc[a][b] + x[a] * y[b];
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int i = it + a * tr, j = jt + b * tc;
        if (i < rows && j < cols) f(i, j, acc[a][b]);
      }
  }
}

// Copy n values (zeros where !valid) into shared memory.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int n,
                                      bool valid) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    dst[e] = valid ? src[e] : T(0);
}

// The pivoted inverse of the d x d matrix M (row-major, shared memory,
// overwritten) into X, with R (d x d) and f (d values) as shared scratch:
// block_inv_nl's algorithm.  Every thread of the block calls it.
template <typename T>
__device__ void inverse_shared(T* M, T* R, T* X, T* f, int* pivot, int d) {
  const int dd = d * d;
  for (int e = threadIdx.x; e < dd; e += blockDim.x) {
    const int i = e / d;
    R[e] = (i == e - i * d) ? T(1) : T(0);
    X[e] = T(0);
  }
  __syncthreads();
  for (int k = 0; k < d; ++k) {
    if (threadIdx.x < 32) {
      // the pivot: the largest |M(i, k)|, i >= k; NaN beats any number,
      // and the lower row wins a tie
      T best = T(-1);
      int p = d;
      for (int i = k + int(threadIdx.x); i < d; i += 32) {
        const T v = fabs(M[i * d + k]);
        const bool take = (is_nan(v) && !is_nan(best)) ||
                          (!is_nan(best) && v > best);
        if (take) {
          best = v;
          p = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ob = __shfl_down_sync(0xffffffffu, best, off);
        const int op = __shfl_down_sync(0xffffffffu, p, off);
        const bool on = is_nan(ob), mn = is_nan(best);
        const bool take = (on && !mn) || (on == mn && !on && ob > best) ||
                          (on == mn && (on || ob == best) && op < p);
        if (take) {
          best = ob;
          p = op;
        }
      }
      if (threadIdx.x == 0) *pivot = p < d ? p : k;
    }
    __syncthreads();
    const int p = *pivot;
    if (p != k) {
      for (int j = threadIdx.x; j < d; j += blockDim.x) {
        T a = M[k * d + j];
        M[k * d + j] = M[p * d + j];
        M[p * d + j] = a;
        a = R[k * d + j];
        R[k * d + j] = R[p * d + j];
        R[p * d + j] = a;
      }
      __syncthreads();
    }
    const T piv = M[k * d + k];
    for (int i = k + 1 + int(threadIdx.x); i < d; i += blockDim.x)
      f[i] = M[i * d + k] / piv;
    __syncthreads();
    const int below = (d - k - 1) * d;
    for (int e = threadIdx.x; e < below; e += blockDim.x) {
      const int i = k + 1 + e / d, j = e - (e / d) * d;
      M[i * d + j] = M[i * d + j] - f[i] * M[k * d + j];
      R[i * d + j] = R[i * d + j] - f[i] * R[k * d + j];
    }
    __syncthreads();
  }
  // back substitution, a thread per column, the sum over i in order
  for (int k = d - 1; k >= 0; --k) {
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      T acc = M[k * d] * X[j];
      for (int i = 1; i < d; ++i) acc = acc + M[k * d + i] * X[i * d + j];
      X[k * d + j] = (R[k * d + j] - acc) / M[k * d + k];
    }
    __syncthreads();
  }
}

// Shared memory of a factor or inverse block: the multipliers A and B
// and the matrix M being inverted (d^2 each); R, X and Y (d max(d, b)
// each); f (kMaxD values) and the pivot index.
__host__ __device__ inline size_t block_values(int d, int nb) {
  const int w = d * (nb > d ? nb : d);
  return size_t(3 * d * d + 3 * w + kMaxD);
}

template <typename T>
struct Smem {
  T *A, *B, *M, *R, *X, *Y, *f;
  int* pivot;
  __device__ Smem(unsigned char* raw, int d, int nb) {
    const int w = d * (nb > d ? nb : d);
    T* p = reinterpret_cast<T*>(raw);
    A = p;
    B = A + d * d;
    M = B + d * d;
    R = M + d * d;
    X = R + w;
    Y = X + w;
    f = Y + w;
    pivot = reinterpret_cast<int*>(f + kMaxD);
  }
};

// Level-0 state of node g: D, Lb = E_g, Ub = E_{g+1}^T (0 at the last
// node), F, node-major at `state` (3 d^2 + d b values a node), and the
// inverse of D at `dinv` (d^2 values a node).  A block per (node,
// instance): blockIdx.x = g, blockIdx.y = instance.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pcr_wide_init(const T* __restrict__ Din, const T* __restrict__ Ein,
              const T* __restrict__ Fin, T* __restrict__ state,
              T* __restrict__ dinv, int N, int d, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm(smem_raw, d, nb);
  const int g = blockIdx.x;
  const size_t inst = blockIdx.y;
  const int dd = d * d, db = d * nb;
  const size_t P = size_t(3 * dd + db);
  const T* D0 = Din + inst * dd * size_t(N);
  const T* E0 = Ein + inst * dd * size_t(N);
  const T* F0 = Fin + inst * db * size_t(N);
  T* st = state + (inst * N + g) * P;
  for (int e = threadIdx.x; e < dd; e += blockDim.x) {
    const int i = e / d, j = e - (e / d) * d;
    const T v = D0[size_t(e) * N + g];
    sm.M[e] = v;
    st[e] = v;
    st[dd + e] = E0[size_t(e) * N + g];
    st[2 * dd + e] = (g + 1 < N) ? E0[size_t(j * d + i) * N + g + 1] : T(0);
  }
  for (int e = threadIdx.x; e < db; e += blockDim.x)
    st[3 * dd + e] = F0[size_t(e) * N + g];
  __syncthreads();
  inverse_shared(sm.M, sm.R, sm.X, sm.f, sm.pivot, d);
  T* out = dinv + (inst * N + g) * dd;
  for (int e = threadIdx.x; e < dd; e += blockDim.x) out[e] = sm.X[e];
}

// Level l (stride s) of node g: A = Lb Dinv_{g-s}, B = Ub Dinv_{g+s},
// D' = (D - A Ub_{g-s}) - B Lb_{g+s}, Lb' = -A Lb_{g-s},
// Ub' = -B Ub_{g+s}, F' = (F - A F_{g-s}) - B F_{g+s}; A and B to the
// node-last outputs, the new state to `nxt`, the inverse of D' to
// `dinv_nxt`.  At the last level (last != 0) Lb' and Ub' are not formed
// (nothing reads them), and D'^-1, F' and Z = D'^-T F_original go to the
// node-last outputs Dinv, Fp and Z.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pcr_wide_level(const T* __restrict__ cur, T* __restrict__ nxt,
               const T* __restrict__ dinv_cur, T* __restrict__ dinv_nxt,
               T* __restrict__ Aout, T* __restrict__ Bout,
               const T* __restrict__ Fin, T* __restrict__ Dinv_out,
               T* __restrict__ Fp_out, T* __restrict__ Z_out, int N, int d,
               int nb, int levels, int l, int s, int last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm(smem_raw, d, nb);
  const int g = blockIdx.x;
  const size_t inst = blockIdx.y;
  const int dd = d * d, db = d * nb;
  const size_t P = size_t(3 * dd + db);
  const bool has_m = g - s >= 0, has_p = g + s < N;
  const T* me = cur + (inst * N + g) * P;
  const T* mm = cur + (inst * N + (has_m ? g - s : g)) * P;
  const T* mp = cur + (inst * N + (has_p ? g + s : g)) * P;
  const T* dinv_m = dinv_cur + (inst * N + (has_m ? g - s : g)) * dd;
  const T* dinv_p = dinv_cur + (inst * N + (has_p ? g + s : g)) * dd;
  const size_t nodes = size_t(N);
  T* A_l = Aout + (inst * levels + l) * dd * nodes;
  T* B_l = Bout + (inst * levels + l) * dd * nodes;

  // A = Lb Dinv_{g-s}, B = Ub Dinv_{g+s}
  stage(sm.X, me + dd, dd, true);
  stage(sm.Y, dinv_m, dd, has_m);
  stage(sm.R, me + 2 * dd, dd, true);
  stage(sm.M, dinv_p, dd, has_p);
  __syncthreads();
  tile_product(sm.X, d, 1, sm.Y, d, d, d, d, [&](int i, int j, T v) {
    sm.A[i * d + j] = v;
    A_l[size_t(i * d + j) * nodes + g] = v;
  });
  tile_product(sm.R, d, 1, sm.M, d, d, d, d, [&](int i, int j, T v) {
    sm.B[i * d + j] = v;
    B_l[size_t(i * d + j) * nodes + g] = v;
  });
  __syncthreads();

  // D' = (D - A Ub_{g-s}) - B Lb_{g+s}, in M
  stage(sm.M, me, dd, true);
  stage(sm.X, mm + 2 * dd, dd, has_m);
  stage(sm.Y, mp + dd, dd, has_p);
  __syncthreads();
  tile_product(sm.A, d, 1, sm.X, d, d, d, d, [&](int i, int j, T v) {
    sm.M[i * d + j] = sm.M[i * d + j] - v;
  });
  __syncthreads();
  tile_product(sm.B, d, 1, sm.Y, d, d, d, d, [&](int i, int j, T v) {
    sm.M[i * d + j] = sm.M[i * d + j] - v;
  });
  __syncthreads();
  T* out = nxt + (inst * N + g) * P;
  if (!last) {
    for (int e = threadIdx.x; e < dd; e += blockDim.x) out[e] = sm.M[e];
    // Lb' = -A Lb_{g-s}, Ub' = -B Ub_{g+s}
    stage(sm.X, mm + dd, dd, has_m);
    stage(sm.Y, mp + 2 * dd, dd, has_p);
    __syncthreads();
    tile_product(sm.A, d, 1, sm.X, d, d, d, d,
                 [&](int i, int j, T v) { out[dd + i * d + j] = -v; });
    tile_product(sm.B, d, 1, sm.Y, d, d, d, d,
                 [&](int i, int j, T v) { out[2 * dd + i * d + j] = -v; });
    __syncthreads();
  }

  // F' = (F - A F_{g-s}) - B F_{g+s}, in R
  if (nb) {
    stage(sm.R, me + 3 * dd, db, true);
    stage(sm.X, mm + 3 * dd, db, has_m);
    stage(sm.Y, mp + 3 * dd, db, has_p);
    __syncthreads();
    tile_product(sm.A, d, 1, sm.X, nb, d, nb, d, [&](int i, int c, T v) {
      sm.R[i * nb + c] = sm.R[i * nb + c] - v;
    });
    __syncthreads();
    tile_product(sm.B, d, 1, sm.Y, nb, d, nb, d, [&](int i, int c, T v) {
      sm.R[i * nb + c] = sm.R[i * nb + c] - v;
    });
    __syncthreads();
    if (last) {
      T* fp = Fp_out + inst * db * nodes;
      for (int e = threadIdx.x; e < db; e += blockDim.x)
        fp[size_t(e) * nodes + g] = sm.R[e];
    } else {
      for (int e = threadIdx.x; e < db; e += blockDim.x)
        out[3 * dd + e] = sm.R[e];
    }
    __syncthreads();
  }

  // the inverse of D' (M), for the next level or the output
  inverse_shared(sm.M, sm.R, sm.X, sm.f, sm.pivot, d);
  if (!last) {
    T* di = dinv_nxt + (inst * N + g) * dd;
    for (int e = threadIdx.x; e < dd; e += blockDim.x) di[e] = sm.X[e];
    return;
  }
  T* di = Dinv_out + inst * dd * nodes;
  for (int e = threadIdx.x; e < dd; e += blockDim.x)
    di[size_t(e) * nodes + g] = sm.X[e];
  if (nb) {
    // Z = Dinv^T F_original
    const T* F0 = Fin + inst * db * nodes;
    for (int e = threadIdx.x; e < db; e += blockDim.x)
      sm.Y[e] = F0[size_t(e) * nodes + g];
    __syncthreads();
    T* z = Z_out + inst * db * nodes;
    tile_product(sm.X, 1, d, sm.Y, nb, d, nb, d, [&](int i, int c, T v) {
      z[size_t(i * nb + c) * nodes + g] = v;
    });
  }
}

// The inverse of every d x d matrix of a batch (row-major), a block per
// matrix.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_inv_wide_kernel(const T* __restrict__ A, T* __restrict__ Xout, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<T> sm(smem_raw, d, 0);
  const int dd = d * d;
  const size_t off = size_t(blockIdx.x) * dd;
  stage(sm.M, A + off, dd, true);
  __syncthreads();
  inverse_shared(sm.M, sm.R, sm.X, sm.f, sm.pivot, d);
  for (int e = threadIdx.x; e < dd; e += blockDim.x) Xout[off + e] = sm.X[e];
}

// The downsweep of pcr.cu with a runtime d.  Node g of the instance lives
// in block g / npb of the cluster, at local index g % npb; a neighbour
// outside [0, N) reads as zero.  Shared memory per block: r, two
// ping-pong copies of d planes of npb values.
template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
pcr_wide_downsweep(const T* __restrict__ Ain, const T* __restrict__ Bin,
                   const T* __restrict__ rin, T* __restrict__ rout, int N,
                   int d, int levels, int csize, int npb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const size_t inst = blockIdx.x / csize;   // clusters are consecutive
  const int k0 = rank * npb;
  const int n = max(0, min(npb, N - k0));
  const int pairs = d * n;
  T* r0 = reinterpret_cast<T*>(smem_raw);
  T* r1 = r0 + d * npb;
  const size_t nodes = size_t(N);
  const size_t dd = size_t(d) * d * nodes;
  const T* A0 = Ain + inst * levels * dd;
  const T* B0 = Bin + inst * levels * dd;

  // pair e is (row e / n, local node e % n): a warp's loads of one plane
  // coalesce
  for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
    const int i = e / n, kk = e - (e / n) * n;
    r0[i * npb + kk] = rin[(inst * d + i) * nodes + k0 + kk];
  }
  cluster.sync();

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
      const int i = e / n, kk = e - (e / n) * n;
      const int g = k0 + kk;
      const bool vm = g - s >= 0, vp = g + s < N;
      const int gm = vm ? g - s : 0, gp = vp ? g + s : 0;
      const T* rm = cluster.map_shared_rank(r0, unsigned(gm / npb)) +
                    (gm - (gm / npb) * npb);
      const T* rp = cluster.map_shared_rank(r0, unsigned(gp / npb)) +
                    (gp - (gp / npb) * npb);
      const T* a = A0 + l * dd + size_t(i * d) * nodes + g;
      const T* b = B0 + l * dd + size_t(i * d) * nodes + g;
      T ta = a[0] * (vm ? rm[0] : T(0));
      T tb = b[0] * (vp ? rp[0] : T(0));
      for (int j = 1; j < d; ++j) {
        ta = ta + a[j * nodes] * (vm ? rm[j * npb] : T(0));
        tb = tb + b[j * nodes] * (vp ? rp[j * npb] : T(0));
      }
      r1[i * npb + kk] = (r0[i * npb + kk] - ta) - tb;
    }
    // r1 complete everywhere; every read of r0 done
    cluster.sync();
    T* t = r0;
    r0 = r1;
    r1 = t;
    s *= 2;
  }
  for (int e = threadIdx.x; e < pairs; e += blockDim.x) {
    const int i = e / n, kk = e - (e / n) * n;
    rout[(inst * d + i) * nodes + k0 + kk] = r0[i * npb + kk];
  }
}

// Dynamic shared memory each kernel is allowed so far on each device
// (raised under the lock to what a launch asks for, as in pcr.cu), and
// whether clusters above the portable 8 are.
struct Allowed {
  std::mutex lock;
  std::atomic<int> smem[kMaxDevices];
  std::atomic<bool> wide[kMaxDevices];
};

template <typename Kernel>
cudaError_t configure(Kernel kernel, Allowed& allowed, int smem,
                      int cluster) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  const bool wide = cluster > 8;
  if (smem <= allowed.smem[dev].load(std::memory_order_acquire) &&
      (!wide || allowed.wide[dev].load(std::memory_order_acquire)))
    return cudaSuccess;
  std::lock_guard<std::mutex> hold(allowed.lock);
  if (smem > allowed.smem[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed.smem[dev].store(smem, std::memory_order_release);
  }
  if (wide && !allowed.wide[dev].load(std::memory_order_relaxed)) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    allowed.wide[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// Launch kernel<<<grid, threads, smem, stream>>>(args...) once its
// attributes allow smem; the first error, cleared.
template <typename... Params, typename... Args>
cudaError_t launch_plain(void (*kernel)(Params...), Allowed& allowed,
                         dim3 grid, int smem, cudaStream_t stream,
                         Args... args) {
  cudaError_t err = configure(kernel, allowed, smem, 1);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  kernel<<<grid, kThreads, size_t(smem), stream>>>(args...);
  return cudaGetLastError();
}

bool dims_ok(int d, int nb) {
  return d >= 1 && d <= kMaxD && nb >= 0 && nb <= kMaxB;
}

template <typename T>
int wide_factor(const void* Dm, const void* E, const void* F, void* A,
                void* B, void* Dinv, void* Fp, void* Z, void* scratch,
                int batch, int d, int nb, int N, int levels, void* stream) {
  if (!dims_ok(d, nb) || batch < 1 || N < 1 || levels < 1)
    return int(cudaErrorInvalidValue);
  static Allowed init_allowed, level_allowed;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int smem = int(block_values(d, nb) * sizeof(T) + sizeof(int));
  const dim3 grid(unsigned(N), unsigned(batch), 1);
  // scratch: two states of 3 d^2 + d b values a node, then two inverse
  // buffers of d^2 values a node
  const size_t nodes = size_t(batch) * N;
  T* state[2];
  T* dinv[2];
  state[0] = static_cast<T*>(scratch);
  state[1] = state[0] + nodes * (3 * d * d + d * nb);
  dinv[0] = state[1] + nodes * (3 * d * d + d * nb);
  dinv[1] = dinv[0] + nodes * d * d;
  cudaError_t err = launch_plain(
      pcr_wide_init<T>, init_allowed, grid, smem, st,
      static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), state[0], dinv[0], N, d, nb);
  int s = 1;
  for (int l = 0; l < levels && err == cudaSuccess; ++l) {
    err = launch_plain(
        pcr_wide_level<T>, level_allowed, grid, smem, st, state[l & 1],
        state[(l + 1) & 1], dinv[l & 1], dinv[(l + 1) & 1],
        static_cast<T*>(A), static_cast<T*>(B), static_cast<const T*>(F),
        static_cast<T*>(Dinv), static_cast<T*>(Fp), static_cast<T*>(Z), N,
        d, nb, levels, l, s, int(l == levels - 1));
    s *= 2;
  }
  return int(err);
}

template <typename T>
int wide_downsweep(const void* A, const void* B, const void* r, void* out,
                   int batch, int d, int N, int levels, int cluster, int npb,
                   int threads, int smem, void* stream) {
  if (!dims_ok(d, 0) || batch < 1 || cluster < 1 || cluster > kMaxCluster ||
      npb < 1 || size_t(cluster) * npb < size_t(N) || threads < 1 ||
      threads > kSweepThreads || smem < 0 ||
      size_t(smem) < 2 * size_t(d) * npb * sizeof(T))
    return int(cudaErrorInvalidValue);
  static Allowed allowed;
  cudaError_t err = configure(pcr_wide_downsweep<T>, allowed, smem, cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch) * unsigned(cluster), 1, 1);
  cfg.blockDim = dim3(unsigned(threads), 1, 1);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, pcr_wide_downsweep<T>,
                           static_cast<const T*>(A), static_cast<const T*>(B),
                           static_cast<const T*>(r), static_cast<T*>(out), N,
                           d, levels, cluster, npb);
  const cudaError_t last = cudaGetLastError();
  return int(err != cudaSuccess ? err : last);
}

template <typename T>
int wide_inv(const void* A, void* X, int batch, int d, void* stream) {
  if (!dims_ok(d, 0) || batch < 1) return int(cudaErrorInvalidValue);
  static Allowed allowed;
  const int smem = int(block_values(d, 0) * sizeof(T) + sizeof(int));
  return int(launch_plain(block_inv_wide_kernel<T>, allowed,
                          dim3(unsigned(batch), 1, 1), smem,
                          static_cast<cudaStream_t>(stream),
                          static_cast<const T*>(A), static_cast<T*>(X), d));
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry returns the
// cudaError_t of its launches; 0 means launched.  pcr_wide_factor makes
// levels + 1 launches; its scratch holds 2 (3 d^2 + d b) + 2 d^2 values
// for each node of each instance.  pcr_wide_downsweep takes the launch
// plan of ops/pcr_kernels.py, as pcr_downsweep does.
extern "C" {

int pcr_wide_factor_f32(const void* Dm, const void* E, const void* F,
                        void* A, void* B, void* Dinv, void* Fp, void* Z,
                        void* scratch, int batch, int d, int nb, int N,
                        int levels, void* stream) {
  return wide_factor<float>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch, d,
                            nb, N, levels, stream);
}

int pcr_wide_factor_f64(const void* Dm, const void* E, const void* F,
                        void* A, void* B, void* Dinv, void* Fp, void* Z,
                        void* scratch, int batch, int d, int nb, int N,
                        int levels, void* stream) {
  return wide_factor<double>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch, d,
                             nb, N, levels, stream);
}

int pcr_wide_downsweep_f32(const void* A, const void* B, const void* r,
                           void* out, int batch, int d, int N, int levels,
                           int cluster, int npb, int threads, int smem,
                           void* stream) {
  return wide_downsweep<float>(A, B, r, out, batch, d, N, levels, cluster,
                               npb, threads, smem, stream);
}

int pcr_wide_downsweep_f64(const void* A, const void* B, const void* r,
                           void* out, int batch, int d, int N, int levels,
                           int cluster, int npb, int threads, int smem,
                           void* stream) {
  return wide_downsweep<double>(A, B, r, out, batch, d, N, levels, cluster,
                                npb, threads, smem, stream);
}

int block_inv_wide_f32(const void* A, void* X, int batch, int d,
                       void* stream) {
  return wide_inv<float>(A, X, batch, d, stream);
}

int block_inv_wide_f64(const void* A, void* X, int batch, int d,
                       void* stream) {
  return wide_inv<double>(A, X, batch, d, stream);
}

}  // extern "C"
