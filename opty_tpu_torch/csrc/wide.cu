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
//   instance, 7.2 MB in float at d = 50, N = 60).  A and B do not depend
//   on r, so every level could be in flight before the sums need it;
//   only r carries the dependence from level to level.  An instance
//   runs on a cluster of up to 16 blocks that split its d rows (block q
//   owns rows [q d / C, (q + 1) d / C) at every node), so one row of one
//   level of A (or B), d x N values, is one contiguous run of device
//   memory.  A unit of the stream is that run of A and of B, brought
//   into a ring of shared-memory stages by bulk asynchronous copies
//   (TMA, cp.async.bulk) with a full and an empty mbarrier; a run that is
//   not 16-byte aligned has its ragged ends copied by cp.async beside it.
//   A producer warp keeps the ring full (up to two levels ahead) while
//   the other warps sum out of shared memory only, a thread per (row,
//   node).  Each block keeps all of r in shared memory; after a level
//   it sends its rows of the new r to every other block of the cluster
//   as one bulk copy between shared memories each, counted by the
//   receiver's mbarrier, so no cluster barrier stands between levels.
//   One SM streams ~62 GB/s this way (scripts/bulk_copy_rate.py), so at
//   one instance the 16 blocks, not the device memory, bound the stream.
//   The plan (ops/pcr_kernels.py:launch_plan('wide_downsweep')) picks the
//   cluster so that the batch's clusters fit the card at once (16 blocks
//   at one instance) and the stages.  Where two units cannot fit beside
//   r (large N) it picks zero stages, and the kernel takes its other
//   branch: the design of pcr.cu's downsweep with a runtime d (nodes
//   split over the cluster, A and B read from device memory inside the
//   sums, the neighbours read from their blocks' shared memory).
// * block_inv_wide, at the PCR border's 8-32 matrices, by launch latency
//   and the inverse's chain of panels.
//
// The factor and the inverse sum in another order than their plain
// versions (tensor-core accumulation, fused multiply-adds, the inverse's
// updates blocked in panels), so they agree with them to round-off, not
// bitwise as the CUDA-core design with in-order sums did: bitwise
// equality is given up for the tensor cores and the panels.  The
// downsweep sums each row in order where the plain version's matvec_nl
// lets torch reduce in its own: both of its branches give the bits of
// ops/pcr_kernels.py:pcr_downsweep_in_order (a product, then a sum, over
// j ascending; ta and tb apart; then (r - ta) - tb).

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

__host__ __device__ constexpr size_t align16(size_t bytes) {
  return (bytes + 15) & ~size_t(15);
}

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

// The staged downsweep's shared memory (bytes): 2 M + 3 mbarriers (a
// full and an empty one for each of M = max(stages, rows) units in turn,
// two for the exchange of r, one for r's first copy) and a zero; r twice
// (ping-pong, rows of P values: N rounded up to 16 bytes); then `stages`
// units, each a slab of A and a slab of B holding d x N values at the
// 16-byte phase of their source in device memory, so that the interior
// of the run copies in bulk.  Unit u's barriers are u % M: M >= rows, so
// a barrier serves one unit of a level, and a parity wait for a unit
// cannot take another unit's phase for its own.  Mirrored by
// ops/pcr_kernels.py:wide_sweep_smem.
struct SweepLayout {
  size_t r, rbuf, slab, slots, total;
  int M, P;
  __host__ __device__ SweepLayout(int d, int N, int stages, int rows,
                                  size_t es) {
    M = stages > rows ? stages : rows;
    P = int(align16(size_t(N) * es) / es);
    r = align16((2 * size_t(M) + 4) * sizeof(unsigned long long));
    rbuf = align16(size_t(d) * P * es);
    slab = align16(size_t(d) * N * es) + 16;
    slots = r + 2 * rbuf;
    total = slots + size_t(stages) * 2 * slab;
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return unsigned(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar,
                                         unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait for the completion of the phase of `parity`.
__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The cluster barrier in halves, by threads that may diverge (no
// .aligned): arrive (relaxed: it publishes nothing) and wait.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Bring the n values at src into `slot` at src's 16-byte phase and have
// `bar` (two arrivals a copy) complete when they are there: the ragged
// ends by cp.async (at most 15 bytes each), tracked by an arrival on
// their completion; the 16-byte-aligned interior by one bulk copy
// (TMA), announced by the other arrival with its byte count.  One
// thread.
template <typename T>
__device__ __forceinline__ void run_copy(unsigned char* slot, const T* src,
                                         size_t n, unsigned long long* bar) {
  const size_t a = reinterpret_cast<size_t>(src);
  T* dst = reinterpret_cast<T*>(slot + (a & 15));
  const size_t lo = (a + 15) & ~size_t(15);
  const size_t hi = (a + n * sizeof(T)) & ~size_t(15);
  const size_t head = lo < hi ? (lo - a) / sizeof(T) : n;
  const size_t tail = lo < hi ? (hi - a) / sizeof(T) : n;
  for (size_t e = 0; e < head; ++e) wide::copy_async(dst + e, src + e);
  for (size_t e = tail; e < n; ++e) wide::copy_async(dst + e, src + e);
  const unsigned b = smem_u32(bar);
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               ::"r"(b) : "memory");
  const unsigned bytes = lo < hi ? unsigned(hi - lo) : 0u;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(b), "r"(bytes) : "memory");
  if (bytes) {
    const unsigned to = smem_u32(slot + (lo - (a & ~size_t(15))));
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(to),
        "l"(reinterpret_cast<const void*>(lo)), "r"(bytes), "r"(b)
        : "memory");
  }
}

// Where unit u (row i0 + u % nr of level u / nr) of the stored levels M0
// starts in device memory, and its slab of A (b = 0) or B (b = 1) in its
// stage.
template <typename T>
__device__ __forceinline__ const T* unit_src(const T* M0, int u, int nr,
                                             int i0, size_t level,
                                             size_t plane) {
  const int l = u / nr;
  return M0 + size_t(l) * level + size_t(i0 + u - l * nr) * plane;
}

__device__ __forceinline__ unsigned char* unit_slot(unsigned char* smem,
                                                    const SweepLayout& lay,
                                                    int u, int stages,
                                                    int b) {
  return smem + lay.slots + (size_t(u % stages) * 2 + b) * lay.slab;
}

// The run at src as run_copy placed it in `slot`.
template <typename T>
__device__ __forceinline__ const T* unit_slab(const T* src,
                                              const unsigned char* slot) {
  return reinterpret_cast<const T*>(slot +
                                    (reinterpret_cast<size_t>(src) & 15));
}

// ta = sum over j of a[j N] r_m[j], tb likewise of b and r_p, each in
// order (a product, then a sum); r_m and r_p at strides sm and sp (0: a
// neighbour outside [0, N), the one zero).  The loads of kBatch terms
// are issued before their sums, so that the sums' chain, not the
// loads' latency, sets the pace.
constexpr int kBatch = 8;

template <typename T>
__device__ __forceinline__ void row_sums(const T* a, const T* b,
                                         const T* rm, int sm, const T* rp,
                                         int sp, int d, int N, T& ta,
                                         T& tb) {
  ta = a[0] * rm[0];
  tb = b[0] * rp[0];
  int j = 1;
  for (; j + kBatch <= d; j += kBatch) {
    T pa[kBatch], pb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      pa[k] = a[(j + k) * N] * rm[(j + k) * sm];
      pb[k] = b[(j + k) * N] * rp[(j + k) * sp];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      ta = ta + pa[k];
      tb = tb + pb[k];
    }
  }
  for (; j < d; ++j) {
    ta = ta + a[j * N] * rm[j * sm];
    tb = tb + b[j * N] * rp[j * sp];
  }
}

// A barrier of the consumer warps alone (named barrier 1).
__device__ __forceinline__ void consumers_sync(int consumers) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(consumers) : "memory");
}

// The staged branch of pcr_wide_downsweep (see the note at the top).  The
// block's last warp produces: its lane 0 copies r into the first r buffer
// (in one bulk copy where its rows need no padding), then issues the units
// in order, each into stage u % stages once the empty barrier of the
// stage's previous unit says that the N threads that read it are done.
// The other warps consume: a thread per (row, node) waits for its unit's
// full barrier, sums in order, arrives on the empty barrier and writes
// its new r into the block's own rows of the next r buffer (the last
// level to device memory).  Then the consumers meet at a named barrier,
// and lane c of the first warp copies the block's rows into block c's
// buffer with one bulk copy between shared memories, whose bytes
// complete block c's exchange barrier; every block waits for all the
// other rows on its own.  r is ping-pong: a block's rows of level l + 1
// go out only after it has all of level l's, so after every block has
// read level l - 1's buffer, which they overwrite, and after its own
// copies of level l - 1 out of that buffer have landed.  Cluster
// barriers only at the start (every block's barriers are set before any
// copy into it) and at the end (no block leaves while a copy out of it
// may run).
template <typename T>
__device__ __forceinline__ void sweep_staged(
    const T* __restrict__ A0, const T* __restrict__ B0,
    const T* __restrict__ r0, T* __restrict__ out0, int N, int d,
    int levels, int csize, int rank, int stages, unsigned char* smem) {
  const int i0 = rank * d / csize;
  const int nr = (rank + 1) * d / csize - i0;
  const size_t plane = size_t(d) * N, level = plane * d;
  const SweepLayout lay(d, N, stages, (d + csize - 1) / csize, sizeof(T));
  const int M = lay.M;
  const int P = lay.P;
  unsigned long long* full = reinterpret_cast<unsigned long long*>(smem);
  unsigned long long* empty = full + M;
  unsigned long long* xbar = empty + M;
  unsigned long long* rbar = xbar + 2;
  // after the barriers, a zero that stands for the neighbours outside
  // [0, N)
  T* zero = reinterpret_cast<T*>(rbar + 1);
  // r comes in one bulk copy where its rows need no padding
  const bool r_bulk = P == N && (reinterpret_cast<size_t>(r0) & 15) == 0;
  // r ping-pong: buffer p at rb + p * rstride, row j at j P
  T* rb = reinterpret_cast<T*>(smem + lay.r);
  const size_t rstride = lay.rbuf / sizeof(T);
  const int units = levels * nr;
  const int tid = int(threadIdx.x);
  const int consumers = int(blockDim.x) - 32;
  if (tid == 0) {
    for (int k = 0; k < M; ++k) {
      bar_init(full + k, 4);          // two copies a unit
      bar_init(empty + k, unsigned(N));  // a thread per node of the row
    }
    bar_init(xbar, 1);
    bar_init(xbar + 1, 1);
    bar_init(rbar, 2);
    *zero = T(0);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every block's barriers are set before any copy into it
  cluster_arrive_relaxed();
  cluster_wait();

  if (tid >= consumers) {
    if (tid == consumers) {
      if (r_bulk) run_copy(smem + lay.r, r0, plane, rbar);
      for (int u = 0; u < units; ++u) {
        if (u >= stages) {
          bar_wait(empty + (u - stages) % M,
                   unsigned((u - stages) / M) & 1u);
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        unsigned long long* bar = full + u % M;
        run_copy(unit_slot(smem, lay, u, stages, 0),
                 unit_src(A0, u, nr, i0, level, plane), plane, bar);
        run_copy(unit_slot(smem, lay, u, stages, 1),
                 unit_src(B0, u, nr, i0, level, plane), plane, bar);
      }
    }
    // no block leaves while a copy out of its shared memory may run
    cluster_arrive_relaxed();
    cluster_wait();
    return;
  }

  // r into the first buffer, the loads of a pass issued before its stores
  if (r_bulk) bar_wait(rbar, 0);
  for (int e0 = r_bulk ? d * N : tid; e0 < d * N; e0 += consumers * kBatch) {
    T v[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * consumers;
      if (e < d * N) v[k] = r0[e];
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = e0 + k * consumers;
      if (e < d * N) rb[(e / N) * P + e % N] = v[k];
    }
  }
  consumers_sync(consumers);
  const unsigned own_bytes = unsigned(size_t(nr) * P * sizeof(T));
  const unsigned in_bytes = unsigned(size_t(d - nr) * P * sizeof(T));
  int s = 1;
  for (int l = 0; l < levels; ++l) {
    const T* rc = rb + (l & 1) * rstride;
    T* rn = rb + ((l + 1) & 1) * rstride;
    const bool last = l + 1 == levels;
    unsigned long long* xb = xbar + ((l + 1) & 1);
    if (!last && tid == 0 && csize > 1)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_u32(xb)), "r"(in_bytes) : "memory");
    for (int e = tid; e < nr * N; e += consumers) {
      const int q = e / N, g = e - (e / N) * N;
      const int u = l * nr + q;
      bar_wait(full + u % M, unsigned(u / M) & 1u);
      const T* a = unit_slab(unit_src(A0, u, nr, i0, level, plane),
                             unit_slot(smem, lay, u, stages, 0)) + g;
      const T* b = unit_slab(unit_src(B0, u, nr, i0, level, plane),
                             unit_slot(smem, lay, u, stages, 1)) + g;
      // a neighbour outside [0, N) is a zero multiplied in: its column
      // of r is read as the one zero, at stride 0
      const bool vm = g - s >= 0, vp = g + s < N;
      T ta, tb;
      row_sums(a, b, vm ? rc + (g - s) : zero, vm ? P : 0,
               vp ? rc + (g + s) : zero, vp ? P : 0, d, N, ta, tb);
      bar_arrive(empty + u % M);
      const T v = (rc[(i0 + q) * P + g] - ta) - tb;
      if (last)
        out0[(i0 + q) * N + g] = v;
      else
        rn[(i0 + q) * P + g] = v;
    }
    if (last) break;
    // the block's rows of the new r complete, and every read of this r
    // done; lane c of the first warp copies them to block c, whose
    // exchange barrier counts the bytes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync(consumers);
    if (tid < csize && tid != rank) {
      unsigned dst, bar;
      const unsigned src = smem_u32(rn + size_t(i0) * P);
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(dst) : "r"(src), "r"(tid));
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
                   : "=r"(bar) : "r"(smem_u32(xb)), "r"(tid));
      asm volatile(
          "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
          "::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(src),
          "r"(own_bytes), "r"(bar)
          : "memory");
    }
    if (csize > 1) bar_wait(xb, unsigned(l >> 1) & 1u);
    s *= 2;
  }
  // no block leaves while a copy out of its shared memory may run
  cluster_arrive_relaxed();
  cluster_wait();
}

// The downsweep: r <- r - A_l r_{g-s} - B_l r_{g+s} through every level,
// an instance on a cluster of `csize` blocks (grid: batch * csize).
// stages > 0: block q owns rows [q d / C, (q + 1) d / C) at every node,
// the levels streamed through `stages` units of shared memory
// (sweep_staged).  stages == 0: node g of the instance lives in block
// g / npb at local index g % npb, every row; shared memory: r, two
// ping-pong copies of d planes of npb values; A and B are read from
// device memory.  Either way a neighbour outside [0, N) reads as zero.
template <typename T>
__global__ void __launch_bounds__(kSweepThreads)
pcr_wide_downsweep(const T* __restrict__ Ain, const T* __restrict__ Bin,
                   const T* __restrict__ rin, T* __restrict__ rout, int N,
                   int d, int levels, int csize, int npb, int stages) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const size_t inst = blockIdx.x / csize;   // clusters are consecutive
  const size_t nodes = size_t(N);
  const size_t dd = size_t(d) * d * nodes;
  const T* A0 = Ain + inst * levels * dd;
  const T* B0 = Bin + inst * levels * dd;
  const int tid = int(threadIdx.x), nthreads = int(blockDim.x);

  if (stages > 0) {
    sweep_staged(A0, B0, rin + inst * d * nodes, rout + inst * d * nodes, N,
                 d, levels, csize, rank, stages, smem_raw);
    return;
  }

  const int k0 = rank * npb;
  const int n = max(0, min(npb, N - k0));
  const int pairs = d * n;
  T* r0 = reinterpret_cast<T*>(smem_raw);
  T* r1 = r0 + d * npb;

  // pair e is (row e / n, local node e % n): a warp's loads of one plane
  // coalesce
  for (int e = tid; e < pairs; e += nthreads) {
    const int i = e / n, kk = e - (e / n) * n;
    r0[i * npb + kk] = rin[(inst * d + i) * nodes + k0 + kk];
  }
  cluster.sync();

  int s = 1;
  for (int l = 0; l < levels; ++l) {
    for (int e = tid; e < pairs; e += nthreads) {
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
  for (int e = tid; e < pairs; e += nthreads) {
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
                   int threads, int smem, int stages, void* stream) {
  if (!dims_ok(d, 0) || batch < 1 || N < 1 || levels < 1 || cluster < 1 ||
      cluster > kMaxCluster || threads < 1 || threads > kSweepThreads ||
      smem < 0 || stages < 0)
    return int(cudaErrorInvalidValue);
  if (stages > 0) {
    // a warp of consumers and the producer's warp at least
    if (cluster > d || threads < 64 || threads % 32 ||
        size_t(smem) < SweepLayout(d, N, stages, (d + cluster - 1) / cluster,
                                   sizeof(T)).total)
      return int(cudaErrorInvalidValue);
  } else if (npb < 1 || size_t(cluster) * npb < size_t(N) ||
             size_t(smem) < 2 * size_t(d) * npb * sizeof(T)) {
    return int(cudaErrorInvalidValue);
  }
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
                           d, levels, cluster, npb, stages);
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
// for each node of each instance.  pcr_wide_downsweep takes the plan of
// ops/pcr_kernels.py:launch_plan('wide_downsweep') and refuses one that
// leaves a row or node unowned, a ring smaller than a level of units, or
// too little shared memory.
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
                           int stages, void* stream) {
  return wide_downsweep<float>(A, B, r, out, batch, d, N, levels, cluster,
                               npb, threads, smem, stages, stream);
}

int pcr_wide_downsweep_f64(const void* A, const void* B, const void* r,
                           void* out, int batch, int d, int N, int levels,
                           int cluster, int npb, int threads, int smem,
                           int stages, void* stream) {
  return wide_downsweep<double>(A, B, r, out, batch, d, N, levels, cluster,
                                npb, threads, smem, stages, stream);
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
