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
// * The factor, by arithmetic: a level costs a node 6 d^3 + 2 d^2 b
//   multiply-adds for its six products and two border products and
//   about d^3 more for the pivoted inverse of its new diagonal block
//   (~2 MFLOP a node at d = 50, b = 41), against 84 MB of outputs at
//   B = 8 instances of N = 60.  The design: one launch per level (the
//   barrier between levels over all nodes of an instance), a thread
//   block per (instance, node).  The level state [D | Lb | Ub | F] of
//   every node and the level's inverses live in a global scratch,
//   node-major, so a block reads a neighbour's blocks as contiguous
//   runs, staged into shared memory by asynchronous copies.  Every
//   product is wide.cuh's tile product (FP64 tensor cores in double,
//   fused multiply-add register tiles in float), every inverse its
//   panelled LU inverse (block_inv_nl's elimination and back
//   substitution in panels of 8, with look-ahead in double).  A level
//   runs the products in four passes that need six shared matrices at
//   most (227 KB at d = b = 64 in double with the inverse's scratch):
//   A, then everything that reads A (D' -= A Ub_{g-s}, F' -= A F_{g-s},
//   Lb'), then B and everything that reads B; the updates subtract in
//   the plain version's order.  The inverse writes into the first
//   operand buffer, free by then.  A block inverts its node's new diagonal
//   block right after forming it, so level l's launch also gives level
//   l + 1 its inverses: L + 1 launches per factorization (the first
//   inverts the initial blocks).  At B = 1 a factorization's 60 blocks
//   use 60 of the 132 SMs; more SMs a node (a cluster splitting the
//   products' rows) is not built.
// * The downsweep, by reading the stored levels (2 L d^2 N values an
//   instance).  The design of pcr.cu's downsweep with d a runtime value:
//   an instance on a thread block cluster, r in shared memory, a thread
//   per (node, row) looping over its further pairs, neighbours in other
//   blocks read through distributed shared memory, one cluster barrier a
//   level.
// * block_inv_wide, at the PCR border's 8-32 matrices, by launch latency
//   and the inverse's chain of panels.
//
// The factor and the inverse sum in another order than their plain
// versions (tensor-core accumulation, fused multiply-adds, the inverse's
// updates blocked in panels), so they agree with them to round-off, not
// bitwise as the CUDA-core design with in-order sums did: bitwise
// equality is given up for the tensor cores and the panels.  The
// downsweep sums each row in order where the plain version's matvec_nl
// lets torch reduce in its own.

#include <atomic>
#include <cstddef>
#include <mutex>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "wide.cuh"

namespace cg = cooperative_groups;

namespace {

using wide::Mat;
using wide::kThreads;

constexpr int kSweepThreads = 1024;    // a block of the downsweep
constexpr int kMaxD = 64;
constexpr int kMaxB = 64;
constexpr int kMaxCluster = 16;
constexpr int kMaxDevices = 64;

// Shared memory of a factor level, in values: Ab (A, then B), M (D'),
// O1 and O2 (d x d operands), Fb (F') and O3 (a d x b operand), then an
// inverse's scratch rows; the inverse's ints follow.  The init kernel
// and the batched inverse use M and the scratch of the same layout.
struct Layout {
  int P, Pb, ab, m, o1, o2, fb, o3, scratch, total;
  __host__ __device__ Layout(int d, int nb) {
    P = wide::pitch(d);
    Pb = wide::pitch(nb);
    const int mat = wide::values(d, d), matb = wide::values(d, nb);
    ab = 0;
    m = mat;
    o1 = 2 * mat;
    o2 = 3 * mat;
    fb = 4 * mat;
    o3 = fb + matb;
    scratch = o3 + matb;
    total = scratch + wide::inverse_scratch(P);
  }
  __host__ __device__ size_t bytes(size_t es) const {
    return size_t(total) * es + wide::kInverseInts * sizeof(int);
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
  const Layout lay(d, nb);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* M = sm + lay.m;
  int* ints = reinterpret_cast<int*>(sm + lay.total);
  const int g = blockIdx.x;
  const size_t inst = blockIdx.y;
  const int dd = d * d, db = d * nb;
  const size_t P = size_t(3 * dd + db);
  const T* D0 = Din + inst * dd * size_t(N);
  const T* E0 = Ein + inst * dd * size_t(N);
  const T* F0 = Fin + inst * db * size_t(N);
  T* st = state + (inst * N + g) * P;
  wide::stage(M, lay.P, D0 + g, d, d, size_t(N), true);
  for (int e = threadIdx.x; e < dd; e += blockDim.x) {
    const int i = e / d, j = e - (e / d) * d;
    st[e] = D0[size_t(e) * N + g];
    st[dd + e] = E0[size_t(e) * N + g];
    st[2 * dd + e] = (g + 1 < N) ? E0[size_t(j * d + i) * N + g + 1] : T(0);
  }
  for (int e = threadIdx.x; e < db; e += blockDim.x)
    st[3 * dd + e] = F0[size_t(e) * N + g];
  wide::wait_copies();
  __syncthreads();
  T* out = dinv + (inst * N + g) * dd;
  wide::inverse(M, sm + lay.o1, lay.P, d, sm + lay.scratch, ints,
                [&](int i, int j, T v) { out[i * d + j] = v; });
}

// Level l (stride s) of node g: A = Lb Dinv_{g-s}, B = Ub Dinv_{g+s},
// D' = (D - A Ub_{g-s}) - B Lb_{g+s}, Lb' = -A Lb_{g-s},
// Ub' = -B Ub_{g+s}, F' = (F - A F_{g-s}) - B F_{g+s}; A and B to the
// node-last outputs, the new state to `nxt`, the inverse of D' to
// `dinv_nxt`.  At the last level (last != 0) Lb' and Ub' are not formed
// (nothing reads them), and D'^-1, F' and Z = D'^-T F_original go to the
// node-last outputs Dinv, Fp and Z.  A neighbour outside [0, N) reads
// as zero.
template <typename T>
__global__ void __launch_bounds__(kThreads)
pcr_wide_level(const T* __restrict__ cur, T* __restrict__ nxt,
               const T* __restrict__ dinv_cur, T* __restrict__ dinv_nxt,
               T* __restrict__ Aout, T* __restrict__ Bout,
               const T* __restrict__ Fin, T* __restrict__ Dinv_out,
               T* __restrict__ Fp_out, T* __restrict__ Z_out, int N, int d,
               int nb, int levels, int l, int s, int last) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay(d, nb);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Ab = sm + lay.ab;
  T* M = sm + lay.m;
  T* O1 = sm + lay.o1;
  T* O2 = sm + lay.o2;
  T* Fb = sm + lay.fb;
  T* O3 = sm + lay.o3;
  int* ints = reinterpret_cast<int*>(sm + lay.total);
  const int P = lay.P, Pb = lay.Pb;
  const int g = blockIdx.x;
  const size_t inst = blockIdx.y;
  const int dd = d * d, db = d * nb;
  const size_t S = size_t(3 * dd + db);
  const bool has_m = g - s >= 0, has_p = g + s < N;
  const T* me = cur + (inst * N + g) * S;
  const T* mm = cur + (inst * N + (has_m ? g - s : g)) * S;
  const T* mp = cur + (inst * N + (has_p ? g + s : g)) * S;
  const T* dinv_m = dinv_cur + (inst * N + (has_m ? g - s : g)) * dd;
  const T* dinv_p = dinv_cur + (inst * N + (has_p ? g + s : g)) * dd;
  const size_t nodes = size_t(N);
  T* A_l = Aout + (inst * levels + l) * dd * nodes;
  T* B_l = Bout + (inst * levels + l) * dd * nodes;
  T* out = nxt + (inst * N + g) * S;
  const Mat<T> ab{Ab, P, false};

  // A = Lb Dinv_{g-s}; D and F into M and Fb
  wide::stage(O1, P, me + dd, d, d, 1, true);
  wide::stage(O2, P, dinv_m, d, d, 1, has_m);
  wide::stage(M, P, me, d, d, 1, true);
  wide::stage(Fb, Pb, me + 3 * dd, d, nb, 1, true);
  wide::wait_copies();
  __syncthreads();
  wide::product(Mat<T>{O1, P, false}, Mat<T>{O2, P, false}, d, d, d, 0,
                [&](int i, int j, T v) {
                  Ab[i * P + j] = v;
                  A_l[size_t(i * d + j) * nodes + g] = v;
                });
  __syncthreads();

  // D -= A Ub_{g-s}; F -= A F_{g-s}; Lb' = -A Lb_{g-s}
  wide::stage(O1, P, mm + 2 * dd, d, d, 1, has_m);
  if (!last) wide::stage(O2, P, mm + dd, d, d, 1, has_m);
  wide::stage(O3, Pb, mm + 3 * dd, d, nb, 1, has_m);
  wide::wait_copies();
  __syncthreads();
  int off = wide::product(ab, Mat<T>{O1, P, false}, d, d, d, 0,
                          [&](int i, int j, T v) {
                            M[i * P + j] = M[i * P + j] - v;
                          });
  off = wide::product(ab, Mat<T>{O3, Pb, false}, d, nb, d, off,
                      [&](int i, int c, T v) {
                        Fb[i * Pb + c] = Fb[i * Pb + c] - v;
                      });
  if (!last)
    wide::product(ab, Mat<T>{O2, P, false}, d, d, d, off,
                  [&](int i, int j, T v) { out[dd + i * d + j] = -v; });
  __syncthreads();

  // B = Ub Dinv_{g+s}
  wide::stage(O1, P, me + 2 * dd, d, d, 1, true);
  wide::stage(O2, P, dinv_p, d, d, 1, has_p);
  wide::wait_copies();
  __syncthreads();
  wide::product(Mat<T>{O1, P, false}, Mat<T>{O2, P, false}, d, d, d, 0,
                [&](int i, int j, T v) {
                  Ab[i * P + j] = v;
                  B_l[size_t(i * d + j) * nodes + g] = v;
                });
  __syncthreads();

  // D' = D - B Lb_{g+s}; F' = F - B F_{g+s}; Ub' = -B Ub_{g+s}; D' and
  // F' also to the next state (F' to Fp at the last level)
  wide::stage(O1, P, mp + dd, d, d, 1, has_p);
  if (!last) wide::stage(O2, P, mp + 2 * dd, d, d, 1, has_p);
  wide::stage(O3, Pb, mp + 3 * dd, d, nb, 1, has_p);
  wide::wait_copies();
  __syncthreads();
  T* fp = Fp_out + inst * db * nodes;
  off = wide::product(ab, Mat<T>{O1, P, false}, d, d, d, 0,
                      [&](int i, int j, T v) {
                        const T dn = M[i * P + j] - v;
                        M[i * P + j] = dn;
                        if (!last) out[i * d + j] = dn;
                      });
  off = wide::product(ab, Mat<T>{O3, Pb, false}, d, nb, d, off,
                      [&](int i, int c, T v) {
                        const T fn = Fb[i * Pb + c] - v;
                        if (last)
                          fp[size_t(i * nb + c) * nodes + g] = fn;
                        else
                          out[3 * dd + i * nb + c] = fn;
                      });
  if (!last)
    wide::product(ab, Mat<T>{O2, P, false}, d, d, d, off,
                  [&](int i, int j, T v) { out[2 * dd + i * d + j] = -v; });
  __syncthreads();

  // the inverse of D', for the next level or the output
  if (!last) {
    T* di = dinv_nxt + (inst * N + g) * dd;
    wide::inverse(M, O1, P, d, sm + lay.scratch, ints,
                  [&](int i, int j, T v) { di[i * d + j] = v; });
    return;
  }
  // at the last level F_original comes in while D' is inverted
  wide::stage(O3, Pb, Fin + inst * db * nodes + g, d, nb, nodes, true);
  T* di = Dinv_out + inst * dd * nodes;
  wide::inverse(M, O1, P, d, sm + lay.scratch, ints, [&](int i, int j, T v) {
    di[size_t(i * d + j) * nodes + g] = v;
    Ab[i * P + j] = v;
  });
  wide::wait_copies();
  __syncthreads();
  // Z = Dinv^T F_original
  T* z = Z_out + inst * db * nodes;
  wide::product(Mat<T>{Ab, P, true}, Mat<T>{O3, Pb, false}, d, nb, d, 0,
                [&](int i, int c, T v) {
                  z[size_t(i * nb + c) * nodes + g] = v;
                });
}

// The inverse of every d x d matrix of a batch (row-major), a block per
// matrix.
template <typename T>
__global__ void __launch_bounds__(kThreads)
block_inv_wide_kernel(const T* __restrict__ A, T* __restrict__ Xout, int d) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Layout lay(d, 0);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* M = sm + lay.m;
  const int dd = d * d;
  const size_t off = size_t(blockIdx.x) * dd;
  wide::stage(M, lay.P, A + off, d, d, 1, true);
  wide::wait_copies();
  __syncthreads();
  wide::inverse(M, sm + lay.o1, lay.P, d, sm + lay.scratch,
                reinterpret_cast<int*>(sm + lay.total),
                [&](int i, int j, T v) { Xout[off + i * d + j] = v; });
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
  const int smem = int(Layout(d, nb).bytes(sizeof(T)));
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
  const int smem = int(Layout(d, 0).bytes(sizeof(T)));
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
