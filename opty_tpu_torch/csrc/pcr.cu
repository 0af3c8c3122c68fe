// Parallel cyclic reduction (PCR) kernels for the bordered
// block-tridiagonal KKT system of a collocation NLP, for Hopper (sm_90a).
//
// pcr_factor_levels replaces the Pallas kernel _factor_kernel
// (opty_tpu/ops/pallas_pcr.py, reached through pcr_factor_fused): every
// PCR level of one instance in one launch.  pcr_downsweep replaces
// _downsweep_kernel (pcr_downsweep_fused): one right-hand side pushed
// through every stored level.
//
// Layout: node axis last.  A block array of one instance is (d, d, N)
// with element (i, j) of node k at (i * d + j) * N + k, so neighbouring
// threads, on neighbouring nodes, touch neighbouring addresses.
//
// What bounds them on an H100: device memory.  The factor writes
// L = ceil(log2 N) levels of two d x d multipliers per node plus the
// final inverse and border columns (37.5 MB at B = 32, d = 5, b = 4,
// N = 501, float32; ~2.2 kFLOP per node per level); the downsweep reads
// the levels back (28.9 MB) for ~0.1 kFLOP per node per level.  What
// keeps them from it: the main path has only 16,032 nodes, each level
// depends on the last, and the factor's per-node d x d arithmetic is
// long.  So the design spreads each instance over many SMs, keeps every
// intermediate on chip and keeps the levels' loads in flight:
//
// * One instance runs on a thread block cluster of C blocks (C from the
//   launch plan of ops/pcr_kernels.py), each block owning a contiguous
//   range of nodes_per_block nodes.  A neighbour at k +- s in another
//   block is read from that block's shared memory (distributed shared
//   memory, cooperative_groups::this_cluster().map_shared_rank).  One
//   launch per factorization and per downsweep at any batch; the grid is
//   batch * C blocks.
// * The factor runs one thread per node over the per-node functions of
//   blocks.cuh.  Its level state [D | Lb | Ub | F] (ping-pong) and the
//   level's inverses (double-buffered) stay in shared memory; only the
//   outputs A_l, B_l, Dinv, Fp and Z go to device memory.  Its time is
//   the SMs' instruction throughput on the d x d arithmetic (bitwise
//   parity rules out fused multiply-adds and fast division), so the
//   plan keeps every SM busy with two blocks rather than spreading
//   nodes thinner: one thread per (node, column) was tried and lost,
//   its redundant elimination costing more than its parallelism gained.
//   An instance whose state outgrows its cluster's shared memory
//   (d = 5, b = 4: N above 3,872 in float32, 1,936 in float64) keeps it
//   in a global scratch instead: the same kernel, the same barriers,
//   the state read at the L2.
// * The downsweep runs one thread per (node, row), which holds its row
//   of A_l and B_l in registers and loads the next level's while this
//   one computes: coalesced loads, the whole level in flight at once.
//   Where a block owns more (node, row) pairs than threads, each thread
//   loops over its further pairs, loading their rows at their level.
//   r (ping-pong) stays in shared memory, 2 d values per node.  (A ring
//   of 4-byte cp.async copies was tried first: on the H100 issuing them
//   cost more than the level's arithmetic and barrier together.)
// * One cluster barrier per level in each kernel.
//
// Arithmetic mirrors the plain PyTorch versions in ops/pcr_kernels.py
// (same pivoting, same summation order): the factor is bitwise equal to
// its plain version.  Build with -fmad=false so products and sums round
// as they do there.

#include <atomic>
#include <cstddef>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "blocks.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kFactorThreads = 256;    // one node each
constexpr int kSweepThreads = 1024;    // one (node, row) each
constexpr int kMaxCluster = 16;        // the most an H100 schedules
constexpr int kMaxDevices = 64;

using blocks::block_inv;
using blocks::matmul;

// Node g of the instance lives in block g / npb of the cluster, at local
// index g % npb.  A neighbour outside [0, N) reads as zero.
struct Neighbour {
  unsigned rank;
  int local;
  bool valid;
};

__device__ __forceinline__ Neighbour neighbour(int g, int N, int npb) {
  Neighbour nb;
  nb.valid = g >= 0 && g < N;
  const int gc = nb.valid ? g : 0;
  nb.rank = unsigned(gc / npb);
  nb.local = gc - int(nb.rank) * npb;
  return nb;
}

// Where a block's state lives.  kShared: its shared memory, which the
// other blocks of the cluster read through distributed shared memory.
// Otherwise its own region of `region` values in a global scratch, read
// with ld.global.cg (at the L2, past an L1 that another SM's writes
// would leave stale).  The cluster barrier, a release and an acquire at
// cluster scope, orders the writes before the reads in both cases.
template <typename T, bool kShared>
struct State {
  cg::cluster_group cluster;
  int rank;
  ptrdiff_t region;

  // Node nb's entry of the plane that starts at `local` in this block,
  // in the state of the block that owns it (a valid pointer even
  // outside [0, N), where callers read zero instead).
  __device__ __forceinline__ const T* peer(const T* local,
                                           const Neighbour& nb) {
    if constexpr (kShared)
      return cluster.map_shared_rank(local, nb.rank) + nb.local;
    else
      return local + (ptrdiff_t(nb.rank) - rank) * region + nb.local;
  }

  static __device__ __forceinline__ T ld(const T* p) {
    if constexpr (kShared)
      return *p;
    else
      return __ldcg(p);
  }

  static __device__ __forceinline__ T at(const T* p, int offset,
                                         bool valid) {
    return valid ? ld(p + offset) : T(0);
  }
};

template <typename S, typename T, int D>
__device__ __forceinline__ void load_block(T (&m)[D][D], const T* base,
                                           int k, int stride, bool valid) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j)
      m[i][j] = valid ? S::ld(base + (i * D + j) * stride + k) : T(0);
}

template <typename T, int D>
__device__ __forceinline__ void store_block(const T (&m)[D][D], T* base,
                                            int k, int stride) {
#pragma unroll
  for (int i = 0; i < D; ++i)
#pragma unroll
    for (int j = 0; j < D; ++j) base[(i * D + j) * stride + k] = m[i][j];
}

// All PCR levels of one instance per cluster, one thread per node.
// State per block, planes of npb values: two state buffers of
// 3 d^2 + d b planes and two inverse buffers of d^2 planes, in shared
// memory (kShared) or in the block's region of `scratch`.
template <typename T, int D, bool kShared>
__global__ void __launch_bounds__(kFactorThreads)
pcr_factor_kernel(const T* __restrict__ Din, const T* __restrict__ Ein,
                  const T* __restrict__ Fin, T* __restrict__ Aout,
                  T* __restrict__ Bout, T* __restrict__ Dinv_out,
                  T* __restrict__ Fp_out, T* __restrict__ Z_out,
                  T* __restrict__ scratch, int N, int nb, int levels,
                  int csize, int npb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = int(cg::this_cluster().block_rank());
  const size_t inst = blockIdx.x / csize;   // clusters are consecutive
  const int k0 = rank * npb;
  const int n = max(0, min(npb, N - k0));

  const int DD = D * D;
  const int planes = 3 * DD + D * nb;
  using S = State<T, kShared>;
  S st{cg::this_cluster(), rank, ptrdiff_t(2 * planes + 2 * DD) * npb};
  T* cur = kShared ? reinterpret_cast<T*>(smem_raw)
                   : scratch + (inst * csize + rank) * st.region;
  T* nxt = cur + size_t(planes) * npb;
  T* dinv_buf[2] = {nxt + size_t(planes) * npb,
                    nxt + size_t(planes + DD) * npb};

  const size_t dd = size_t(DD) * N;
  const size_t db = size_t(D) * nb * N;
  const T* D0 = Din + inst * dd;
  const T* E0 = Ein + inst * dd;
  const T* F0 = Fin + inst * db;
  T* A_o = Aout + inst * levels * dd;
  T* B_o = Bout + inst * levels * dd;

  // Every loop below gives local node kk to the same thread, so a
  // thread reads back only what it wrote itself between the cluster
  // barriers.
  // level-0 state: D, Lb = E, Ub_k = E_{k+1}^T (0 at the last node), F
  for (int kk = threadIdx.x; kk < n; kk += blockDim.x) {
    const int g = k0 + kk;
#pragma unroll
    for (int i = 0; i < D; ++i)
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const int ij = i * D + j;
        cur[ij * npb + kk] = D0[ij * N + g];
        cur[(DD + ij) * npb + kk] = E0[ij * N + g];
        cur[(2 * DD + ij) * npb + kk] =
            (g + 1 < N) ? E0[(j * D + i) * N + g + 1] : T(0);
      }
    for (int c = 0; c < D * nb; ++c)
      cur[(3 * DD + c) * npb + kk] = F0[c * N + g];
  }

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    T* dinv = dinv_buf[l & 1];
    // phase 1: every node inverts its own diagonal block
    for (int kk = threadIdx.x; kk < n; kk += blockDim.x) {
      T Dk[D][D], Xk[D][D];
      load_block<S>(Dk, cur, kk, npb, true);
      block_inv(Dk, Xk);
      store_block(Xk, dinv, kk, npb);
    }
    // After this barrier the inverses and the state are complete in
    // every block of the cluster, and nxt is free: its last readers (the
    // previous level's phase 2) have all arrived here.  The inverse
    // buffer that the next level writes was last read two levels ago.
    st.cluster.sync();

    // phase 2: eliminate the neighbours at distance s
    T* A_l = A_o + l * dd;
    T* B_l = B_o + l * dd;
    for (int kk = threadIdx.x; kk < n; kk += blockDim.x) {
      const int g = k0 + kk;
      const Neighbour m = neighbour(g - s, N, npb);
      const Neighbour p = neighbour(g + s, N, npb);
      const T* cur_m = st.peer(cur, m);
      const T* cur_p = st.peer(cur, p);
      const T* Lc = cur + DD * npb;
      const T* Uc = cur + 2 * DD * npb;
      T A[D][D], B[D][D], X[D][D], Y[D][D], C[D][D];

      load_block<S>(X, Lc, kk, npb, true);
      load_block<S>(Y, st.peer(dinv, m), 0, npb, m.valid);
      matmul(X, Y, A);                                  // A = Lb Dinv_{k-s}
      load_block<S>(X, Uc, kk, npb, true);
      load_block<S>(Y, st.peer(dinv, p), 0, npb, p.valid);
      matmul(X, Y, B);                                  // B = Ub Dinv_{k+s}
      store_block(A, A_l, g, N);
      store_block(B, B_l, g, N);

      // D' = D - A Ub_{k-s} - B Lb_{k+s}
      load_block<S>(X, cur_m + 2 * DD * npb, 0, npb, m.valid);
      matmul(A, X, C);
      load_block<S>(X, cur, kk, npb, true);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) X[i][j] = X[i][j] - C[i][j];
      load_block<S>(Y, cur_p + DD * npb, 0, npb, p.valid);
      matmul(B, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) X[i][j] = X[i][j] - C[i][j];
      store_block(X, nxt, kk, npb);

      // Lb' = -A Lb_{k-s},  Ub' = -B Ub_{k+s}
      load_block<S>(Y, cur_m + DD * npb, 0, npb, m.valid);
      matmul(A, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) C[i][j] = -C[i][j];
      store_block(C, nxt + DD * npb, kk, npb);
      load_block<S>(Y, cur_p + 2 * DD * npb, 0, npb, p.valid);
      matmul(B, Y, C);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int j = 0; j < D; ++j) C[i][j] = -C[i][j];
      store_block(C, nxt + 2 * DD * npb, kk, npb);

      // F' = F - A F_{k-s} - B F_{k+s}, one border column at a time
      const T* Fc = cur + 3 * DD * npb;
      for (int c = 0; c < nb; ++c) {
        T fm[D], fp[D];
#pragma unroll
        for (int q = 0; q < D; ++q) {
          fm[q] = S::at(cur_m, (3 * DD + q * nb + c) * npb, m.valid);
          fp[q] = S::at(cur_p, (3 * DD + q * nb + c) * npb, p.valid);
        }
#pragma unroll
        for (int i = 0; i < D; ++i) {
          T ta = A[i][0] * fm[0];
          T tb = B[i][0] * fp[0];
#pragma unroll
          for (int q = 1; q < D; ++q) {
            ta = ta + A[i][q] * fm[q];
            tb = tb + B[i][q] * fp[q];
          }
          const int ic = (i * nb + c) * npb + kk;
          nxt[3 * DD * npb + ic] = (S::ld(Fc + ic) - ta) - tb;
        }
      }
    }
    T* t = cur;
    cur = nxt;
    nxt = t;
    s *= 2;
  }

  // final inverse, eliminated border columns, Z = Dinv^T F_original
  // (local state only)
  T* dinv_o = Dinv_out + inst * dd;
  T* fp_o = Fp_out + inst * db;
  T* z_o = Z_out + inst * db;
  for (int kk = threadIdx.x; kk < n; kk += blockDim.x) {
    const int g = k0 + kk;
    T Dk[D][D], Xk[D][D];
    load_block<S>(Dk, cur, kk, npb, true);
    block_inv(Dk, Xk);
    store_block(Xk, dinv_o, g, N);
    for (int c = 0; c < nb; ++c) {
      T f0[D];
#pragma unroll
      for (int q = 0; q < D; ++q) {
        f0[q] = F0[(q * nb + c) * N + g];
        fp_o[(q * nb + c) * N + g] =
            S::ld(cur + (3 * DD + q * nb + c) * npb + kk);
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        T acc = Xk[0][i] * f0[0];
#pragma unroll
        for (int q = 1; q < D; ++q) acc = acc + Xk[q][i] * f0[q];
        z_o[(i * nb + c) * N + g] = acc;
      }
    }
  }
  // no block leaves while a neighbour may still read its last state
  st.cluster.sync();
}

// r_i <- r_i - A_l[i, :] r_{k-s} - B_l[i, :] r_{k+s} for row i of local
// node kk, from r0 in the cluster's shared memory into r1.
template <typename T, int D>
__device__ __forceinline__ void sweep_pair(State<T, true>& st, const T* r0,
                                           T* r1, int i, int kk, int k0,
                                           int N, int npb, int s,
                                           const T (&a)[D],
                                           const T (&b)[D]) {
  using S = State<T, true>;
  const int g = k0 + kk;
  const Neighbour m = neighbour(g - s, N, npb);
  const Neighbour p = neighbour(g + s, N, npb);
  const T* rm = st.peer(r0, m);
  const T* rp = st.peer(r0, p);
  T ta, tb;
  if constexpr (sizeof(T) == 4) {
    // all 2 d neighbour loads first, so that their distributed shared
    // memory round trips overlap (interleaved with the sums, the
    // compiler let them wait on each other: 6-10 % of the kernel's time)
    T xm[D], xp[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      xm[j] = S::at(rm, j * npb, m.valid);
      xp[j] = S::at(rp, j * npb, p.valid);
    }
    ta = a[0] * xm[0];
    tb = b[0] * xp[0];
#pragma unroll
    for (int j = 1; j < D; ++j) {
      ta = ta + a[j] * xm[j];
      tb = tb + b[j] * xp[j];
    }
  } else {
    // double: 2 d more values beside the 4 d rows the thread holds
    // spill at the 64 registers a thread of 1,024 has (10 % of the
    // kernel's time), so each is loaded as it is summed
    ta = a[0] * S::at(rm, 0, m.valid);
    tb = b[0] * S::at(rp, 0, p.valid);
#pragma unroll
    for (int j = 1; j < D; ++j) {
      ta = ta + a[j] * S::at(rm, j * npb, m.valid);
      tb = tb + b[j] * S::at(rp, j * npb, p.valid);
    }
  }
  r1[i * npb + kk] = (r0[i * npb + kk] - ta) - tb;
}

// r <- r - A_l r_{k-s} - B_l r_{k+s} through every stored level, one
// thread per (node, row), looping where a block owns more (kLoop; a
// separate instantiation, so that the loop's registers do not crowd the
// prefetch of the one-pair kernel).  Shared memory per block: r, two
// ping-pong copies of d planes of npb values.
template <typename T, int D, bool kLoop>
__global__ void __launch_bounds__(kSweepThreads)
pcr_downsweep_kernel(const T* __restrict__ Ain, const T* __restrict__ Bin,
                     const T* __restrict__ rin, T* __restrict__ rout, int N,
                     int levels, int csize, int npb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = int(cg::this_cluster().block_rank());
  State<T, true> st{cg::this_cluster(), rank, 0};
  const size_t inst = blockIdx.x / csize;   // clusters are consecutive
  const int k0 = rank * npb;
  const int n = max(0, min(npb, N - k0));
  const int pairs = D * n;
  T* r0 = reinterpret_cast<T*>(smem_raw);
  T* r1 = r0 + D * npb;
  const size_t dd = size_t(D) * D * N;
  const T* A0 = Ain + inst * levels * dd;
  const T* B0 = Bin + inst * levels * dd;

  // Pair e is (row e / n, local node e % n), so a warp's loads of one
  // plane coalesce.  A thread's first pair keeps its rows of A_l and B_l
  // in registers and has the next level's in flight while this one
  // computes.
  const int e0 = int(threadIdx.x);
  const bool first = e0 < pairs;
  const int i0 = first ? e0 / n : 0;
  const int kk0 = first ? e0 - i0 * n : 0;
  const T* A_r = A0 + size_t(i0 * D) * N + k0 + kk0;   // its row, level 0
  const T* B_r = B0 + size_t(i0 * D) * N + k0 + kk0;

  T a[D], b[D];
  if (first) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      a[j] = A_r[j * size_t(N)];
      b[j] = B_r[j * size_t(N)];
    }
  }
  // f(row, local node) for every pair the thread owns: its first alone
  // where the plan gives each pair a thread (!kLoop), else all of them
  auto each_pair = [&](auto&& f) {
    if constexpr (kLoop) {
      for (int e = e0; e < pairs; e += blockDim.x) f(e / n, e - (e / n) * n);
    } else if (first) {
      f(i0, kk0);
    }
  };
  each_pair([&](int i, int kk) {
    r0[i * npb + kk] = rin[(inst * D + i) * N + k0 + kk];
  });
  st.cluster.sync();

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    T an[D], bn[D];                 // the next level, in flight meanwhile
    if (first && l + 1 < levels) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        an[j] = A_r[(l + 1) * dd + j * size_t(N)];
        bn[j] = B_r[(l + 1) * dd + j * size_t(N)];
      }
    }
    if (first) sweep_pair(st, r0, r1, i0, kk0, k0, N, npb, s, a, b);
    if constexpr (kLoop) {
      for (int e = e0 + blockDim.x; e < pairs; e += blockDim.x) {
        const int i = e / n;
        const int kk = e - i * n;
        const size_t off = l * dd + size_t(i * D) * N + k0 + kk;
        T x[D], y[D];
#pragma unroll
        for (int j = 0; j < D; ++j) {
          x[j] = A0[off + j * size_t(N)];
          y[j] = B0[off + j * size_t(N)];
        }
        sweep_pair(st, r0, r1, i, kk, k0, N, npb, s, x, y);
      }
    }
    // r1 complete everywhere; every read of r0 done
    st.cluster.sync();
#pragma unroll
    for (int j = 0; j < D; ++j) {
      a[j] = an[j];
      b[j] = bn[j];
    }
    T* t = r0;
    r0 = r1;
    r1 = t;
    s *= 2;
  }
  each_pair([&](int i, int kk) {
    rout[(inst * D + i) * N + k0 + kk] = r0[i * npb + kk];
  });
}

// What a kernel's attributes allow on each device so far: dynamic shared
// memory up to smem[dev] bytes, clusters above the portable 8 where
// wide[dev].  Attributes are set only when a launch needs more, under
// the lock, so they only grow and always match what is recorded; the
// path launches these kernels thousands of times per queue and reads
// the record without the lock.  The limit is raised to what a launch
// asks for, not to the card's maximum.
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

// Launch `kernel` on batch clusters of `cluster` blocks.  Returns the
// first error: too much shared memory, a cluster that cannot be
// scheduled (cudaErrorClusterOutOfResources) or any other refusal.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), Allowed& allowed,
                            int batch, int cluster, int threads, int smem,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = configure(kernel, allowed, smem, cluster);
  if (err != cudaSuccess) {
    cudaGetLastError();   // clear it, or the next launch would report it
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch) * unsigned(cluster), 1, 1);
  cfg.blockDim = dim3(unsigned(threads), 1, 1);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();   // and clears it
  return err != cudaSuccess ? err : last;
}

// A plan the kernels can run without touching memory outside their
// arrays: every node owned by a block of the cluster, the threads within
// the kernel's bound, and (shared state) the shared memory the layout
// needs.
bool plan_ok(int N, int cluster, int npb, int threads, int max_threads,
             int smem, size_t smem_needed) {
  return cluster >= 1 && cluster <= kMaxCluster && npb >= 1 &&
         size_t(cluster) * size_t(npb) >= size_t(N) && threads >= 1 &&
         threads <= max_threads && smem >= 0 && size_t(smem) >= smem_needed;
}

template <typename T, int D, bool kShared>
cudaError_t launch_factor(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int nb, int N,
                          int levels, int cluster, int npb, int threads,
                          int smem, cudaStream_t stream) {
  static Allowed allowed;
  return launch_clusters(
      pcr_factor_kernel<T, D, kShared>, allowed, batch, cluster, threads, smem,
      stream, static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<T*>(A), static_cast<T*>(B),
      static_cast<T*>(Dinv), static_cast<T*>(Fp), static_cast<T*>(Z),
      static_cast<T*>(scratch), N, nb, levels, cluster, npb);
}

template <typename T, int D>
cudaError_t factor_for_d(const void* Dm, const void* E, const void* F,
                         void* A, void* B, void* Dinv, void* Fp, void* Z,
                         void* scratch, int batch, int nb, int N, int levels,
                         int cluster, int npb, int threads, int smem,
                         cudaStream_t stream) {
  // the state of one block: two buffers of 3 d^2 + d b planes and two
  // of d^2, npb values each
  const size_t state = size_t(2 * (3 * D * D + D * nb) + 2 * D * D) *
                       size_t(npb) * sizeof(T);
  if (!plan_ok(N, cluster, npb, threads, kFactorThreads, smem,
               scratch ? 0 : state))
    return cudaErrorInvalidValue;
  if (scratch)
    return launch_factor<T, D, false>(Dm, E, F, A, B, Dinv, Fp, Z, scratch,
                                      batch, nb, N, levels, cluster, npb,
                                      threads, smem, stream);
  return launch_factor<T, D, true>(Dm, E, F, A, B, Dinv, Fp, Z, nullptr,
                                   batch, nb, N, levels, cluster, npb,
                                   threads, smem, stream);
}

template <typename T, int D, bool kLoop>
cudaError_t launch_downsweep(const void* A, const void* B, const void* r,
                             void* out, int batch, int N, int levels,
                             int cluster, int npb, int threads, int smem,
                             cudaStream_t stream) {
  static Allowed allowed;
  return launch_clusters(
      pcr_downsweep_kernel<T, D, kLoop>, allowed, batch, cluster, threads,
      smem, stream, static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const T*>(r), static_cast<T*>(out), N, levels, cluster,
      npb);
}

template <typename T, int D>
cudaError_t downsweep_for_d(const void* A, const void* B, const void* r,
                            void* out, int batch, int N, int levels,
                            int cluster, int npb, int threads, int smem,
                            cudaStream_t stream) {
  if (!plan_ok(N, cluster, npb, threads, kSweepThreads, smem,
               2 * size_t(D) * size_t(npb) * sizeof(T)))
    return cudaErrorInvalidValue;
  if (size_t(D) * size_t(npb) > size_t(threads))
    return launch_downsweep<T, D, true>(A, B, r, out, batch, N, levels,
                                        cluster, npb, threads, smem, stream);
  return launch_downsweep<T, D, false>(A, B, r, out, batch, N, levels,
                                       cluster, npb, threads, smem, stream);
}

template <typename T>
int factor_dispatch(const void* Dm, const void* E, const void* F, void* A,
                    void* B, void* Dinv, void* Fp, void* Z, void* scratch,
                    int batch, int d, int nb, int N, int levels, int cluster,
                    int npb, int threads, int smem, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 3:
      return factor_for_d<T, 3>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                nb, N, levels, cluster, npb, threads, smem,
                                st);
    case 5:
      return factor_for_d<T, 5>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                nb, N, levels, cluster, npb, threads, smem,
                                st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int downsweep_dispatch(const void* A, const void* B, const void* r,
                       void* out, int batch, int d, int N, int levels,
                       int cluster, int npb, int threads, int smem,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 3:
      return downsweep_for_d<T, 3>(A, B, r, out, batch, N, levels, cluster,
                                   npb, threads, smem, st);
    case 5:
      return downsweep_for_d<T, 5>(A, B, r, out, batch, N, levels, cluster,
                                   npb, threads, smem, st);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry takes the launch
// plan of ops/pcr_kernels.py (cluster size, nodes per block, threads per
// block, dynamic shared memory) and returns the cudaError_t of its
// launch; 0 means launched.  The factor's `scratch` is null where its
// state lies in shared memory, else batch * cluster regions of
// (2 (3 d^2 + d b) + 2 d^2) * npb values.
extern "C" {

int pcr_factor_levels_f32(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int d, int nb, int N,
                          int levels, int cluster, int npb, int threads,
                          int smem, void* stream) {
  return factor_dispatch<float>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                d, nb, N, levels, cluster, npb, threads,
                                smem, stream);
}

int pcr_factor_levels_f64(const void* Dm, const void* E, const void* F,
                          void* A, void* B, void* Dinv, void* Fp, void* Z,
                          void* scratch, int batch, int d, int nb, int N,
                          int levels, int cluster, int npb, int threads,
                          int smem, void* stream) {
  return factor_dispatch<double>(Dm, E, F, A, B, Dinv, Fp, Z, scratch, batch,
                                 d, nb, N, levels, cluster, npb, threads,
                                 smem, stream);
}

int pcr_downsweep_f32(const void* A, const void* B, const void* r,
                      void* out, int batch, int d, int N, int levels,
                      int cluster, int npb, int threads, int smem,
                      void* stream) {
  return downsweep_dispatch<float>(A, B, r, out, batch, d, N, levels,
                                   cluster, npb, threads, smem, stream);
}

int pcr_downsweep_f64(const void* A, const void* B, const void* r,
                      void* out, int batch, int d, int N, int levels,
                      int cluster, int npb, int threads, int smem,
                      void* stream) {
  return downsweep_dispatch<double>(A, B, r, out, batch, d, N, levels,
                                    cluster, npb, threads, smem, stream);
}

}  // extern "C"
