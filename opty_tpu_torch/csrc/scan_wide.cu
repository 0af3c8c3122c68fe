// The scan KKT factorization and solve for Hopper (sm_90a) at wide
// blocks: scan.cu's two kernels for the shapes its thread-per-entry
// design does not take, any d = 1..64 with a border of b = 0..64 that
// the shared memory holds (ops/scan_kernels.py:wide_smem), float and
// double.  The nlink-9 chain's d = 50, b = 41 is the case it is built
// for (the JAX package's gait-scale configuration runs kkt_method='scan'
// with a float64 factorization).
//
// scan_wide_factor is the forward elimination of nlp/kkt.py:factor_kkt
// (opty_tpu/nlp/kkt.py:225-253); scan_wide_solve is solve_factored
// (opty_tpu/nlp/kkt.py:256-295).  As scan.cu's they take in the work the
// Pallas kernels _inv_kernel and _matmul_kernel
// (opty_tpu/ops/pallas_blocks.py) do on the reference's scan path: one
// launch a factorization, one a solve.  Layout: lanes first, row-major,
// as scan.cu: D, E, S_inv, Melim (B, N, d, d), F, Ft (B, N, d, b), r, u
// (B, N, d), Kbb and its Schur inverse (B, b, b), beta (B, b).
//
// What bounds them on an H100: the dependent chain of N node steps of
// each lane.  A factor node step is ~4 d^3 + 3 d^2 b FLOPs of products
// and a d x d inverse (0.85 MFLOP at d = 50, b = 41); a lane at N = 60
// moves 4.9 MB in double (1.5 us at 3.35 TB/s) and needs 51 MFLOP (0.8
// us at 67 TFLOP/s), while each node waits on the last.  So the design
// keeps only the chain on the critical path and spreads the rest:
//
// * A lane runs on a thread block cluster of `csize` blocks of 256
//   threads (ops/scan_kernels.py:cluster_size picks it from the batch:
//   the factor two while 2 B blocks fit the 132 SMs, the solve 8, 4 or 2
//   while B c blocks fit half of them; one block where there is no
//   border).
// * scan_wide_factor: the chain of node k is M_k = E_k S_{k-1}^-1, S_k =
//   D_k - M_k E_k^T and S_k^-1 (wide.cuh's tile products, DMMA in
//   double, and its panelled LU inverse); S_k's first 8 columns come
//   first and warp 0 factors them while the other warps form the rest of
//   S_k.  Off the chain, node k's Ft_k = F_k - M_k Ft_{k-1}, T_k = S_k^-1
//   Ft_k and the border sum += Ft_k^T T_k.  In a cluster of two, block 0
//   walks the chain and block 1 takes node k - 1 off it meanwhile,
//   reading M_{k-1} and S_{k-1}^-1 back from device memory at the L2
//   (ld.global.cg) after the cluster barrier that ends each node (a
//   release and an acquire at cluster scope), then inverts Kbb - sum.
//   In one block the same steps run in turn.  The chain's block keeps
//   E_k, two D / S buffers, M_k and S^-1 in shared memory (140 KB at d =
//   50, b = 41 in double; 224 KB in one block), and d = b = 64 in double
//   fits a cluster of two only.
// * scan_wide_solve: the forward chain rt_k = r_k - Melim_k rt_{k-1}
//   (block 0; Melim_k and r_k stream through a ring of four stages, one
//   barrier a node); then y_k = S_k^-1 rt_k, each block over its share
//   of the nodes, into a scratch; on block 0 the border sum Ft_k^T y_k
//   over the nodes in order (Ft_k and y_k streamed) and beta = Kbb_schur_
//   inv (rb - sum); each block's threads' parts of Ft_k beta, into the
//   scratch; the backward chain u_k = S_k^-1 (rt_k - Ft_k beta -
//   E_{k+1}^T u_{k+1}) on block 0 (E_{k+1} and S_k^-1 through a ring of
//   three; rt_k and the parts, other blocks' writes, read at the L2 a
//   node ahead).  Every sum runs in the order of the earlier one-block
//   kernel, so the solve gives its bits at every cluster size.  A
//   cluster barrier separates the phases; ring copies go 16 bytes at a
//   time where a run is aligned.
//
// A singular pivot gives inf/nan in its lane's remaining outputs, as
// the plain versions do; other lanes are untouched.  The products and
// the blocked inverse sum in another order than the plain versions
// (ops/scan_kernels.py), so the two agree to round-off, not bitwise;
// against the earlier one-block kernels every value is the same bits
// (the solver's decisions can follow the round-off of nearly singular
// blocks, wide.cuh's header says how that was seen).

#include <atomic>
#include <cstddef>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "wide.cuh"

namespace cg = cooperative_groups;

namespace {

using wide::Mat;
using wide::kThreads;

constexpr int kMaxDevices = 64;
constexpr int kChainStages = 4;   // the solve's forward-chain ring
constexpr int kStages = 3;        // its other rings

// Shared memory of a factor block, in values.  The chain's region (the
// block at csize 1, rank 0 of a cluster of two): E_k, the two D / S
// buffers, M_k and S^-1 (S_{k-1}^-1 until S_k's inverse replaces it).
// The off-chain region (after the chain's at csize 1, rank 1 of two):
// the two F / Ft buffers, T, and in a cluster M_k and S_k^-1 as read
// back from device memory; then the border sum, before which at least
// b x b values take the border inverse's result.  Then an inverse's
// scratch and, after `total`, its ints.
struct FactorLayout {
  int P, Pb, es, ds0, ds1, ms, si, fb0, fb1, tb, mst, sst, acc, scratch,
      total;
  __host__ __device__ FactorLayout(int d, int nb, int csize, int rank) {
    P = wide::pitch(d);
    Pb = wide::pitch(nb);
    const int mat = wide::values(d, d), matb = wide::values(d, nb);
    const int bb = wide::values(nb, nb);
    const bool chain = rank == 0, off = csize == 1 || rank == 1;
    es = ds0 = ds1 = ms = si = fb0 = fb1 = tb = mst = sst = acc = 0;
    int at = 0, ld = 0;
    if (chain) {
      es = at;
      ds0 = at + mat;
      ds1 = at + 2 * mat;
      ms = at + 3 * mat;
      si = at + 4 * mat;
      at += 5 * mat;
      ld = P;
    }
    if (off) {
      fb0 = at;
      fb1 = at + matb;
      tb = at + 2 * matb;
      at += 3 * matb;
      if (csize > 1) {
        mst = at;
        sst = at + mat;
        at += 2 * mat;
      }
      acc = at > bb ? at : bb;
      at = acc + bb;
      ld = ld > Pb ? ld : Pb;
    }
    scratch = at;
    total = scratch + wide::inverse_scratch(ld);
  }
  __host__ __device__ size_t bytes(size_t es_) const {
    return size_t(total) * es_ + wide::kInverseInts * sizeof(int);
  }
};

// The dynamic shared memory of a factor launch: its largest block.
size_t factor_bytes(int d, int nb, int csize, size_t es) {
  size_t m = FactorLayout(d, nb, csize, 0).bytes(es);
  if (csize > 1) {
    const size_t m1 = FactorLayout(d, nb, csize, 1).bytes(es);
    m = m1 > m ? m1 : m;
  }
  return m;
}

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Shared memory of a solve block, in values: a ring that each phase cuts
// into stages of its own (a run of n values takes round8(n + 4): room to
// keep its source's alignment mod 16 bytes), then the vectors x (two), y,
// v and beta.
struct SolveLayout {
  int mat, ft, vec, ring, x0, x1, y, vb, bt, total;
  __host__ __device__ SolveLayout(int d, int nb) {
    mat = round8(d * d + 4);
    ft = round8(d * nb + 4);
    vec = round8(d + 4);
    ring = imax(imax(kChainStages, kStages) * (mat + vec),
                imax(kStages * (ft + vec), kStages * 2 * mat));
    x0 = ring;
    x1 = x0 + round8(d);
    y = x1 + round8(d);
    vb = y + round8(d);
    bt = vb + round8(nb);
    total = bt + round8(nb);
  }
  __host__ __device__ size_t bytes(size_t es) const {
    return size_t(total) * es;
  }
};

// n values read once from device memory into shared memory at s (16-byte
// aligned), by the block's threads: they land at run_at(s, g), which
// keeps g's alignment mod 16 bytes, so that all but at most three values
// at each end go by 16-byte asynchronous copies (at the L2); the rest
// one value each.
template <typename T>
__device__ __forceinline__ int run_lead(const T* g) {
  return int((reinterpret_cast<uintptr_t>(g) & 15) / sizeof(T));
}

template <typename T>
__device__ __forceinline__ const T* run_at(const T* s, const T* g) {
  return s + run_lead(g);
}

template <typename T>
__device__ __forceinline__ void copy_run(T* s, const T* g, int n) {
  constexpr int V = 16 / int(sizeof(T));
  const int lead = run_lead(g);
  T* dst = s + lead;
  const int head = lead ? (n < V - lead ? n : V - lead) : 0;
  const int body = (n - head) / V;
  const int tail = head + body * V;
  const int t = int(threadIdx.x), nt = int(blockDim.x);
  for (int e = t; e < head; e += nt) wide::copy_async(dst + e, g + e);
  for (int v = t; v < body; v += nt)
    wide::copy_async16(dst + head + v * V, g + head + v * V);
  for (int e = tail + t; e < n; e += nt) wide::copy_async(dst + e, g + e);
}

// rows x cols values (row-major at src, written in this launch by another
// block) into dst (row pitch ld), read at the L2 (ld.global.cg: past an
// L1 that may hold lines from before the writes), eight loads in flight
// a thread.
template <typename T>
__device__ __forceinline__ void load_l2(T* dst, int ld, const T* src,
                                        int rows, int cols) {
  constexpr int kBatch = 8;
  const int n = rows * cols, nt = int(blockDim.x);
  for (int e0 = int(threadIdx.x); e0 < n; e0 += kBatch * nt) {
    T v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nt;
      v[u] = e < n ? __ldcg(src + e) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int e = e0 + u * nt;
      if (e < n) dst[(e / cols) * ld + e % cols] = v[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_wide_factor(const T* __restrict__ Dm, const T* __restrict__ E,
                 const T* __restrict__ F, const T* __restrict__ Kbb,
                 T* __restrict__ S_inv, T* __restrict__ Melim,
                 T* __restrict__ Ft, T* __restrict__ Kbb_schur_inv, int N,
                 int d, int nb, int csize) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rank = csize > 1 ? int(cg::this_cluster().block_rank()) : 0;
  const bool chain = rank == 0, off = csize == 1 || rank == 1;
  const FactorLayout lay(d, nb, csize, rank);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Es = sm + lay.es;
  T* Ds[2] = {sm + lay.ds0, sm + lay.ds1};
  T* Ms = sm + lay.ms;
  T* Si = sm + lay.si;
  T* Fb[2] = {sm + lay.fb0, sm + lay.fb1};
  T* Tb = sm + lay.tb;
  T* Acc = sm + lay.acc;
  T* scratch = sm + lay.scratch;
  int* ints = reinterpret_cast<int*>(sm + lay.total);
  // the off-chain step's M_k and S_k^-1: the chain's own at csize 1, in a
  // cluster read back from device memory
  const T* Mk = csize > 1 ? sm + lay.mst : Ms;
  const T* Sk = csize > 1 ? sm + lay.sst : Si;
  const int P = lay.P, Pb = lay.Pb;
  const size_t lane = blockIdx.x / unsigned(csize);
  const size_t dd = size_t(d) * d, db = size_t(d) * nb;
  const T* Dl = Dm + lane * N * dd;
  const T* El = E + lane * N * dd;
  const T* Fl = F + lane * N * db;
  T* Sl = S_inv + lane * N * dd;
  T* Ml = Melim + lane * N * dd;
  T* Ftl = Ft + lane * N * db;

  // S_{-1}^-1 = 0, node 0's E and D; Ft_{-1} = 0, the border sum 0,
  // node 0's F
  if (chain) {
    for (int e = threadIdx.x; e < d * d; e += blockDim.x)
      Si[(e / d) * P + e % d] = T(0);
    wide::stage(Es, P, El, d, d, 1, true);
    wide::stage(Ds[0], P, Dl, d, d, 1, true);
  }
  if (off) {
    for (int e = threadIdx.x; e < d * nb; e += blockDim.x)
      Fb[1][(e / nb) * Pb + e % nb] = T(0);
    for (int e = threadIdx.x; e < nb * nb; e += blockDim.x)
      Acc[(e / nb) * Pb + e % nb] = T(0);
    wide::stage(Fb[0], Pb, Fl, d, nb, 1, true);
  }
  wide::wait_copies();
  __syncthreads();

  // The chain of node k: M_k = E_k S_{k-1}^-1, S_k = D_k - M_k E_k^T,
  // S_k^-1.  S_k's first panel of columns comes first, and warp 0 factors
  // it (the inverse's first LU panel) while the other warps form the
  // rest of S_k.  D_{k+1} and E_{k+1} come in during the inverse.
  const int w0 = d < wide::kPanel ? d : wide::kPanel;
  auto chain_step = [&](int k) {
    T* Sc = Ds[k & 1];
    wide::product(Mat<T>{Es, P, false}, Mat<T>{Si, P, false}, d, d, d, 0,
                  [&](int i, int j, T v) {
                    Ms[i * P + j] = v;
                    Ml[k * dd + i * d + j] = v;
                  });
    __syncthreads();
    wide::product(Mat<T>{Ms, P, false}, Mat<T>{Es, P, true}, d, w0, d, 0,
                  [&](int i, int j, T v) {
                    Sc[i * P + j] = Sc[i * P + j] - v;
                  });
    __syncthreads();
    if (threadIdx.x < 32)
      wide::lu_panel(Sc, P, d, 0, w0, ints);
    else
      wide::product(Mat<T>{Ms, P, false}, Mat<T>{Es + w0 * P, P, true}, d,
                    d - w0, d, 0,
                    [&](int i, int j, T v) {
                      Sc[i * P + w0 + j] = Sc[i * P + w0 + j] - v;
                    }, ~0x1u);
    __syncthreads();
    if (k + 1 < N) {
      wide::stage(Ds[(k + 1) & 1], P, Dl + (k + 1) * dd, d, d, 1, true);
      wide::stage(Es, P, El + (k + 1) * dd, d, d, 1, true);
    }
    wide::inverse(Sc, Si, P, d, scratch, ints, [&](int i, int j, T v) {
      Sl[k * dd + i * d + j] = v;
    }, true);
    wide::wait_copies();
  };

  // Node k off the chain: Ft_k = F_k - M_k Ft_{k-1}, T_k = S_k^-1 Ft_k,
  // the border sum += Ft_k^T T_k.  F_{k+1} comes in over Ft_{k-1}.
  auto off_step = [&](int k) {
    if (csize > 1) {
      load_l2(sm + lay.mst, P, Ml + k * dd, d, d);
      load_l2(sm + lay.sst, P, Sl + k * dd, d, d);
      __syncthreads();
    }
    T* Fk = Fb[k & 1];
    T* Fp = Fb[(k + 1) & 1];
    wide::product(Mat<T>{Mk, P, false}, Mat<T>{Fp, Pb, false}, d, nb, d, 0,
                  [&](int i, int c, T v) {
                    const T f = Fk[i * Pb + c] - v;
                    Fk[i * Pb + c] = f;
                    Ftl[k * db + i * nb + c] = f;
                  });
    __syncthreads();
    if (k + 1 < N)
      wide::stage(Fp, Pb, Fl + (k + 1) * db, d, nb, 1, true);
    wide::product(Mat<T>{Sk, P, false}, Mat<T>{Fk, Pb, false}, d, nb, d, 0,
                  [&](int i, int c, T v) { Tb[i * Pb + c] = v; });
    __syncthreads();
    wide::product(Mat<T>{Fk, Pb, true}, Mat<T>{Tb, Pb, false}, nb, nb, d, 0,
                  [&](int i, int c, T v) {
                    Acc[i * Pb + c] = Acc[i * Pb + c] + v;
                  });
    wide::wait_copies();
  };

  if (csize == 1) {
    for (int k = 0; k < N; ++k) {
      chain_step(k);
      __syncthreads();
      if (nb) {
        off_step(k);
        __syncthreads();
      }
    }
  } else {
    // rank 0 walks the chain; rank 1 takes node k - 1 off it meanwhile,
    // reading M_{k-1} and S_{k-1}^-1 that rank 0 wrote before the last
    // cluster barrier (a release and an acquire at cluster scope)
    cg::cluster_group cluster = cg::this_cluster();
    for (int k = 0; k <= N; ++k) {
      if (chain && k < N)
        chain_step(k);
      else if (off && k > 0 && nb)
        off_step(k - 1);
      cluster.sync();
    }
  }
  if (!off || nb == 0) return;

  // the inverse of Kbb - sum, its result over the region before Acc
  const T* K = Kbb + lane * nb * nb;
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x) {
    const int i = e / nb, c = e - (e / nb) * nb;
    Acc[i * Pb + c] = K[e] - Acc[i * Pb + c];
  }
  __syncthreads();
  T* Ki = Kbb_schur_inv + lane * nb * nb;
  wide::inverse(Acc, sm, Pb, nb, scratch, ints,
                [&](int i, int c, T v) { Ki[i * nb + c] = v; });
}

// sum over the four threads of a row (consecutive lanes)
template <typename T>
__device__ __forceinline__ T row_sum(T v) {
  v = v + __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_wide_solve(const T* __restrict__ S_inv, const T* __restrict__ Melim,
                const T* __restrict__ Ft, const T* __restrict__ E,
                const T* __restrict__ Kinv, const T* __restrict__ r,
                const T* __restrict__ rb, T* u, T* __restrict__ beta,
                T* __restrict__ scratch, int N, int d, int nb, int csize) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SolveLayout lay(d, nb);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* ring = sm;
  T* x[2] = {sm + lay.x0, sm + lay.x1};
  T* y = sm + lay.y;
  T* vb = sm + lay.vb;
  T* bt = sm + lay.bt;
  const int t = threadIdx.x;
  const int i = t >> 2, q = t & 3;          // row i, a quarter of it
  const bool row = i < d;
  const int rank = csize > 1 ? int(cg::this_cluster().block_rank()) : 0;
  const size_t lane = blockIdx.x / unsigned(csize);
  const size_t dd = size_t(d) * d, db = size_t(d) * nb;
  const T* Sg = S_inv + lane * N * dd;
  const T* Mg = Melim + lane * N * dd;
  const T* Eg = E + lane * N * dd;
  const T* Fg = Ft + lane * N * db;
  const T* rg = r + lane * N * d;
  T* ug = u + lane * N * d;                 // rt, then u
  auto sync_all = [&]() {
    if (csize > 1)
      cg::this_cluster().sync();
    else
      __syncthreads();
  };

  // forward chain (rank 0): rt_k = r_k - Melim_k rt_{k-1}, streaming
  // Melim_k and r_k through a ring of kChainStages
  if (rank == 0) {
    const int Z = lay.mat + lay.vec;
    auto fetch = [&](int k) {
      if (k < N) {
        T* s = ring + (k % kChainStages) * Z;
        copy_run(s, Mg + k * dd, int(dd));
        copy_run(s + lay.mat, rg + size_t(k) * d, d);
      }
      wide::commit_copies();
    };
    for (int e = t; e < d; e += blockDim.x) x[1][e] = T(0);
    for (int k = 0; k < kChainStages - 1; ++k) fetch(k);
    for (int k = 0; k < N; ++k) {
      wide::wait_groups<kChainStages - 2>();
      __syncthreads();                      // stage k in; rt_{k-1} visible
      fetch(k + kChainStages - 1);
      const T* s = ring + (k % kChainStages) * Z;
      const T* m = run_at(s, Mg + k * dd) + i * d;
      const T* rk = run_at(s + lay.mat, rg + size_t(k) * d);
      const T* xm = x[(k + 1) & 1];
      T a = T(0);
      if (row)
        for (int j = q; j < d; j += 4) a = wide::fma_rn(m[j], xm[j], a);
      a = row_sum(a);
      if (row && q == 0) {
        const T rt = rk[i] - a;
        x[k & 1][i] = rt;
        ug[size_t(k) * d + i] = rt;
      }
    }
  }

  // the lane's scratch: y_k (d values a node), then the thread parts of
  // Ft_k beta (4 d a node, thread (i, q)'s at 4 i + q)
  T* yg = scratch + lane * N * (5 * size_t(d));
  T* pg = yg + size_t(N) * d;
  if (nb) {
    sync_all();                             // rt in device memory
    const int k0 = int(int64_t(rank) * N / csize);
    const int k1 = int(int64_t(rank + 1) * N / csize);
    {
      // this block's nodes: y_k = S_k^-1 rt_k
      const int Z = lay.mat + lay.vec;
      auto fetch = [&](int k) {
        if (k < k1) {
          T* s = ring + ((k - k0) % kStages) * Z;
          copy_run(s, Sg + k * dd, int(dd));
          copy_run(s + lay.mat, ug + size_t(k) * d, d);
        }
        wide::commit_copies();
      };
      for (int k = k0; k < k0 + kStages - 1; ++k) fetch(k);
      for (int k = k0; k < k1; ++k) {
        wide::wait_groups<kStages - 2>();
        __syncthreads();
        fetch(k + kStages - 1);
        const T* s = ring + ((k - k0) % kStages) * Z;
        const T* sv = run_at(s, Sg + k * dd) + i * d;
        const T* rt = run_at(s + lay.mat, ug + size_t(k) * d);
        T b = T(0);
        if (row)
          for (int j = q; j < d; j += 4) b = wide::fma_rn(sv[j], rt[j], b);
        b = row_sum(b);
        if (row && q == 0) yg[size_t(k) * d + i] = b;
      }
    }
    sync_all();                             // every y_k in device memory

    // border (rank 0): s = sum_k Ft_k^T y_k, each thread (i, q) summing
    // its quarter of column i over the nodes in order; then beta =
    // Kbb_schur_inv (rb - s)
    if (rank == 0) {
      const int Z = lay.ft + lay.vec;
      auto fetch = [&](int k) {
        if (k < N) {
          T* s = ring + (k % kStages) * Z;
          copy_run(s, Fg + k * db, int(db));
          copy_run(s + lay.ft, yg + size_t(k) * d, d);
        }
        wide::commit_copies();
      };
      for (int k = 0; k < kStages - 1; ++k) fetch(k);
      T s_part = T(0);
      for (int k = 0; k < N; ++k) {
        wide::wait_groups<kStages - 2>();
        __syncthreads();
        fetch(k + kStages - 1);
        const T* s = ring + (k % kStages) * Z;
        if (i < nb) {
          const T* f = run_at(s, Fg + k * db) + i;      // column i of Ft_k
          const T* yk = run_at(s + lay.ft, yg + size_t(k) * d);
          for (int j = q; j < d; j += 4)
            s_part = wide::fma_rn(f[j * nb], yk[j], s_part);
        }
      }
      const T sum = row_sum(s_part);
      if (i < nb && q == 0) vb[i] = rb[lane * nb + i] - sum;
      __syncthreads();
      T b = T(0);
      if (i < nb) {
        const T* kr = Kinv + lane * nb * nb + i * nb;
        for (int c = q; c < nb; c += 4) b = wide::fma_rn(kr[c], vb[c], b);
      }
      b = row_sum(b);
      if (i < nb && q == 0) {
        bt[i] = b;
        beta[lane * nb + i] = b;
      }
    }
    sync_all();                             // beta in rank 0's bt

    // this block's nodes: each thread's part of row i of Ft_k beta, the
    // start of the backward chain's sum (not summed over the row here)
    if (rank != 0) {
      if (t < nb) bt[t] = cg::this_cluster().map_shared_rank(bt, 0)[t];
      __syncthreads();
    }
    {
      const int Z = lay.ft;
      auto fetch = [&](int k) {
        if (k < k1)
          copy_run(ring + ((k - k0) % kStages) * Z, Fg + k * db, int(db));
        wide::commit_copies();
      };
      for (int k = k0; k < k0 + kStages - 1; ++k) fetch(k);
      for (int k = k0; k < k1; ++k) {
        wide::wait_groups<kStages - 2>();
        __syncthreads();
        fetch(k + kStages - 1);
        if (row) {
          const T* f = run_at(ring + ((k - k0) % kStages) * Z, Fg + k * db)
                       + i * nb;
          T a = T(0);
          for (int c = q; c < nb; c += 4) a = wide::fma_rn(f[c], bt[c], a);
          pg[size_t(k) * 4 * d + t] = a;
        }
      }
    }
    sync_all();                             // the parts in device memory
  }

  // backward chain (rank 0): u_k = S_k^-1 (rt_k - Ft_k beta -
  // E_{k+1}^T u_{k+1}) from the last node, each row one sum (thread (i,
  // q)'s part of Ft_k beta, then its quarter of E_{k+1}^T u_{k+1}, then
  // the row's four); E_{k+1} and S_k^-1 stream through a ring of
  // kStages, rt_k and the parts (other blocks' writes) are read at the
  // L2 a node ahead
  if (rank != 0) return;
  __syncthreads();                          // the ring's last readers done
  const int Z = 2 * lay.mat;
  auto fetch = [&](int it) {
    if (it < N) {
      const int k = N - 1 - it;
      T* s = ring + (it % kStages) * Z;
      if (k + 1 < N) copy_run(s, Eg + (k + 1) * dd, int(dd));
      copy_run(s + lay.mat, Sg + k * dd, int(dd));
    }
    wide::commit_copies();
  };
  auto rt_at = [&](int k) {
    return row && q == 0 ? __ldcg(ug + size_t(k) * d + i) : T(0);
  };
  auto part_at = [&](int k) {
    return row && nb ? __ldcg(pg + size_t(k) * 4 * d + t) : T(0);
  };
  for (int it = 0; it < kStages - 1; ++it) fetch(it);
  T rk = rt_at(N - 1), pk = part_at(N - 1);
  for (int it = 0; it < N; ++it) {
    const int k = N - 1 - it;
    const T rn = k > 0 ? rt_at(k - 1) : T(0);
    const T pn = k > 0 ? part_at(k - 1) : T(0);
    wide::wait_groups<kStages - 2>();
    __syncthreads();                        // stage in; u_{k+1} visible
    fetch(it + kStages - 1);
    const T* s = ring + (it % kStages) * Z;
    const T* un = x[(it + 1) & 1];
    T* uk = x[it & 1];
    T a = pk;
    if (row && k + 1 < N) {
      const T* ec = run_at(s, Eg + (k + 1) * dd) + i;    // column i
      for (int j = q; j < d; j += 4) a = wide::fma_rn(ec[j * d], un[j], a);
    }
    a = row_sum(a);
    if (row && q == 0) y[i] = rk - a;
    __syncthreads();
    const T* sv = run_at(s + lay.mat, Sg + k * dd) + i * d;
    T b = T(0);
    if (row)
      for (int j = q; j < d; j += 4) b = wide::fma_rn(sv[j], y[j], b);
    b = row_sum(b);
    if (row && q == 0) {
      uk[i] = b;
      ug[size_t(k) * d + i] = b;
    }
    rk = rn;
    pk = pn;
  }
}

// Dynamic shared memory each kernel is allowed so far on each device,
// raised (cudaFuncSetAttribute) to what a launch asks for.
template <typename Kernel>
cudaError_t allow(Kernel kernel, std::atomic<int>* allowed, size_t smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (int(smem) <= allowed[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             int(smem));
  if (err == cudaSuccess) allowed[dev].store(int(smem));
  return err;
}

// Launch `kernel` on batch clusters of csize blocks (a cluster of one is
// a plain block); the first error, cleared.
template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...),
                            std::atomic<int>* allowed, int batch, int csize,
                            size_t smem, void* stream, Args... args) {
  cudaError_t err = allow(kernel, allowed, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch) * unsigned(csize), 1, 1);
  cfg.blockDim = dim3(unsigned(kThreads), 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(csize);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  const cudaError_t last = cudaGetLastError();   // and clears it
  return err != cudaSuccess ? err : last;
}

bool dims_ok(int batch, int d, int N, int nb) {
  return batch >= 1 && N >= 1 && d >= 1 && d <= wide::kMaxN && nb >= 0 &&
         nb <= wide::kMaxN;
}

// the cluster sizes each kernel is built for (ops/scan_kernels.py:
// FACTOR_CLUSTERS, SOLVE_CLUSTERS)
bool factor_cluster_ok(int c) { return c == 1 || c == 2; }
bool solve_cluster_ok(int c) { return c == 1 || c == 2 || c == 4 || c == 8; }

template <typename T>
int factor(const void* Dm, const void* E, const void* F, const void* Kbb,
           void* S_inv, void* Melim, void* Ft, void* Kinv, int batch, int d,
           int N, int nb, int csize, void* stream) {
  if (!dims_ok(batch, d, N, nb) || !factor_cluster_ok(csize))
    return int(cudaErrorInvalidValue);
  static std::atomic<int> allowed[kMaxDevices];
  return int(launch_clusters(
      scan_wide_factor<T>, allowed, batch, csize,
      factor_bytes(d, nb, csize, sizeof(T)), stream,
      static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<const T*>(Kbb),
      static_cast<T*>(S_inv), static_cast<T*>(Melim), static_cast<T*>(Ft),
      static_cast<T*>(Kinv), N, d, nb, csize));
}

template <typename T>
int solve(const void* S_inv, const void* Melim, const void* Ft,
          const void* E, const void* Kinv, const void* r, const void* rb,
          void* u, void* beta, void* scratch, int batch, int d, int N,
          int nb, int csize, void* stream) {
  if (!dims_ok(batch, d, N, nb) || !solve_cluster_ok(csize))
    return int(cudaErrorInvalidValue);
  static std::atomic<int> allowed[kMaxDevices];
  return int(launch_clusters(
      scan_wide_solve<T>, allowed, batch, csize,
      SolveLayout(d, nb).bytes(sizeof(T)), stream,
      static_cast<const T*>(S_inv), static_cast<const T*>(Melim),
      static_cast<const T*>(Ft), static_cast<const T*>(E),
      static_cast<const T*>(Kinv), static_cast<const T*>(r),
      static_cast<const T*>(rb), static_cast<T*>(u), static_cast<T*>(beta),
      static_cast<T*>(scratch), N, d, nb, csize));
}

}  // namespace

// Plain C interface (loaded with ctypes), the arguments of scan.cu's
// entries and the cluster size (factor 1 or 2, solve 1, 2, 4 or 8
// blocks a lane).  Every entry returns the cudaError_t of its launch (0:
// launched), having cleared it; a shape whose shared memory exceeds the
// card's is refused there.
extern "C" {

int scan_wide_factor_f32(const void* Dm, const void* E, const void* F,
                         const void* Kbb, void* S_inv, void* Melim, void* Ft,
                         void* Kinv, int batch, int d, int N, int nb,
                         int cluster, void* stream) {
  return factor<float>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch, d, N,
                       nb, cluster, stream);
}

int scan_wide_factor_f64(const void* Dm, const void* E, const void* F,
                         const void* Kbb, void* S_inv, void* Melim, void* Ft,
                         void* Kinv, int batch, int d, int N, int nb,
                         int cluster, void* stream) {
  return factor<double>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch, d, N,
                        nb, cluster, stream);
}

int scan_wide_solve_f32(const void* S_inv, const void* Melim, const void* Ft,
                        const void* E, const void* Kinv, const void* r,
                        const void* rb, void* u, void* beta, void* scratch,
                        int batch, int d, int N, int nb, int cluster,
                        void* stream) {
  return solve<float>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta, scratch,
                    batch, d, N, nb, cluster, stream);
}

int scan_wide_solve_f64(const void* S_inv, const void* Melim, const void* Ft,
                        const void* E, const void* Kinv, const void* r,
                        const void* rb, void* u, void* beta, void* scratch,
                        int batch, int d, int N, int nb, int cluster,
                        void* stream) {
  return solve<double>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta, scratch,
                    batch, d, N, nb, cluster, stream);
}

// The bytes of dynamic shared memory that a factor and a solve launch
// ask for a block at (d, nb) in values of `itemsize` bytes with
// `cluster` blocks a lane, into out[0] and out[1] (what
// ops/scan_kernels.py:wide_smem must equal); launches nothing and
// returns 0.
int scan_wide_smem(int d, int nb, int itemsize, int cluster,
                   unsigned long long* out) {
  out[0] = factor_bytes(d, nb, cluster, size_t(itemsize));
  out[1] = SolveLayout(d, nb).bytes(size_t(itemsize));
  return 0;
}

}  // extern "C"
