// The scan KKT factorization and solve for Hopper (sm_90a): the whole
// node recursion of one lane in one thread block, d = 2..8 node blocks,
// a border of b = 0..8 columns, float and double.
//
// scan_factor is the forward elimination of nlp/kkt.py:factor_kkt (the
// port's counterpart of opty_tpu/nlp/kkt.py:225-253); scan_solve is
// solve_factored (opty_tpu/nlp/kkt.py:256-295).  They take in the work
// of the Pallas kernels _inv_kernel and _matmul_kernel
// (opty_tpu/ops/pallas_blocks.py, block_inv_pallas/block_matmul_pallas)
// on this path: before, every node of every factorization was two
// block_matmul launches, a block_inv launch and three torch launches
// over only the lanes' matrices, and every node of every solve about
// seven torch launches; now a factorization is one launch and a solve
// one launch.
//
// Layout: lanes first, as nlp/kkt.py assembles them.  D, E, S_inv and
// Melim are (B, N, d, d), F and Ft (B, N, d, b), r and u (B, N, d), Kbb
// and its Schur inverse (B, b, b), beta (B, b), all row-major.
//
// What bounds them on an H100: neither bytes nor operations but the
// dependent chain of N node steps of each lane.  At the main path's
// B = 32, N = 501, d = 5, b = 4 the factor moves 18 MB in float64
// (5.4 us at 3.35 TB/s) and the solve 13.5 MB (4.0 us); a node step of
// the factor is ~1.5 kFLOP of d x d arithmetic whose every part waits
// on the last.  So the design shortens the chain of one node step and
// keeps everything else off it:
//
// * scan_factor runs one thread per matrix entry: w x w threads a block,
//   w = max(d, b) (one warp at d = 5, b = 4; two at d = 8).  A product
//   is then d dependent steps, and the pivot inverse is Gauss-Jordan
//   elimination with partial pivoting in d steps, each one barrier:
//   every thread finds the pivot row by a tournament over the column
//   (the largest |entry| at or below the diagonal, the first on ties,
//   NaN counted largest: the rule of blocks.cuh), scales the pivot row
//   by one reciprocal, and writes its entry of the swapped, normalized
//   and eliminated [S | R] into the other of two shared buffers.
//   Elimination and back substitution would take two d-step chains.
//   The border term Ft_k^T S_k^-1 Ft_k, which no later node needs, is
//   computed in the next node's phases and summed in registers.  Every
//   thread computes every product (on indices clamped into the tile),
//   so no branch splits the products and their chains overlap.  Each
//   node is 2 + d barriers.
// * scan_solve runs one warp per lane.  Thread t < d holds row t of the
//   recursion's vector and passes it on by shuffles; only the
//   recursion's matrix-vector products run node after node.  The rest
//   (S^-1 rt and the border sum in the forward sweep, Ft beta in the
//   backward one) is computed for a chunk of 8 nodes at once, its
//   (node, row) pairs spread over the warp.
// * Prefetch: the factor's threads load their entries of D, E, F two
//   nodes ahead into registers; the solve streams its inputs through a
//   ring of three 8-node chunks in shared memory with cp.async, two
//   chunks in flight.  At d = 5 a node's rows are only 4- or 8-byte
//   aligned, so TMA and 16-byte copies do not apply.
// * Occupancy: one block per lane, so B blocks use B SMs (32 of 132 on
//   the main queue).  Splitting a lane's recursion across SMs would
//   change the algorithm (a parallel prefix over nodes) and is not done.
//
// A singular pivot gives inf/nan in its lane's remaining outputs (the
// reciprocal of a zero pivot), as the plain versions do; other lanes
// are untouched.  Built with -fmad=false like the other sources; the
// sums run in index order, but the inverse is Gauss-Jordan where the
// plain version does elimination and back substitution, so the two
// agree to round-off, not bitwise.

#include <cuda_runtime.h>

#include "blocks.cuh"

namespace {

constexpr int kMaxW = 8;         // the largest d and b
// A small matrix in shared memory: rows kS apart, one more than the
// widest row, so that the threads of a warp reading a column (one row
// each) hit distinct banks in float and in double.
constexpr int kS = kMaxW + 1;
constexpr int kTile = kMaxW * kS;

// The row of the pivot of column c: the largest |entry| of rows c..n-1,
// the first one on ties, NaN counted largest (the rule of blocks.cuh),
// found by a tournament over the 8 rows, which keeps the rule: rows
// below c and from n on enter as -1 and never win, and on a tie the
// lower row wins.
template <typename T>
__device__ __forceinline__ int pivot_row(const T* a, int c, int n) {
  T v[kMaxW];
  int p[kMaxW];
#pragma unroll
  for (int q = 0; q < kMaxW; ++q) {
    v[q] = (q >= c && q < n) ? fabs(a[q * kS + c]) : T(-1);
    p[q] = q;
  }
#pragma unroll
  for (int s = 1; s < kMaxW; s *= 2)
#pragma unroll
    for (int q = 0; q + s < kMaxW; q += 2 * s)
      if (v[q + s] > v[q] ||
          (blocks::is_nan(v[q + s]) && !blocks::is_nan(v[q]))) {
        v[q] = v[q + s];
        p[q] = p[q + s];
      }
  return p[0];
}

// Gauss-Jordan inverse of the n x n matrix in A[0] (row stride kS),
// R[0] holding the identity; every thread of the block calls it, thread
// (i, j) owns entry (i, j) where `active` (and computes on clamped
// indices where not).  Step c reads buffers c & 1 and writes
// (c + 1) & 1, then a barrier: the inverse ends in R[n & 1].  Each
// thread loads its entries of rows i and c before the pivot search, so
// only the pivot row's three values wait on it; the pivot row is scaled
// by one reciprocal (two divisions cost several times one on this
// card).  Returns the thread's entry of the inverse.
template <typename T>
__device__ __forceinline__ T gauss_jordan(T (*A)[kTile], T (*R)[kTile], int n,
                                          int i, int j, bool active) {
  const int ic = min(i, kMaxW - 1), jc = min(j, kMaxW - 1);
  T inv = T(0);
#pragma unroll
  for (int c = 0; c < n; ++c) {
    const T* a = A[c & 1];
    const T* r = R[c & 1];
    const T ai = a[ic * kS + jc], ri = r[ic * kS + jc];
    const T fi = a[ic * kS + c];
    const T ac = a[c * kS + jc], rc = r[c * kS + jc];
    const T fc = a[c * kS + c];
    const int p = pivot_row(a, c, n);
    const T rp = T(1) / a[p * kS + c];
    const T pa = a[p * kS + jc] * rp;
    const T pr = r[p * kS + jc] * rp;
    T na = pa, nr = pr;
    if (i != c) {                           // rows c and p swap
      const bool from_c = i == p;
      const T f = from_c ? fc : fi;
      na = (from_c ? ac : ai) - f * pa;
      nr = (from_c ? rc : ri) - f * pr;
    }
    if (active) {
      A[(c + 1) & 1][i * kS + j] = na;
      R[(c + 1) & 1][i * kS + j] = nr;
      inv = nr;
    }
    __syncthreads();
  }
  return inv;
}

// x[row] . y[:, col] of two tiles, the sum in index order.
template <typename T, int D>
__device__ __forceinline__ T row_col(const T* x, int row, const T* y,
                                     int col) {
  T acc = x[row * kS] * y[col];
#pragma unroll
  for (int q = 1; q < D; ++q)
    acc = acc + x[row * kS + q] * y[q * kS + col];
  return acc;
}

// x[row] . y[col] (the product with y transposed).
template <typename T, int D>
__device__ __forceinline__ T row_row(const T* x, int row, const T* y,
                                     int col) {
  T acc = x[row * kS] * y[col * kS];
#pragma unroll
  for (int q = 1; q < D; ++q)
    acc = acc + x[row * kS + q] * y[col * kS + q];
  return acc;
}

// x[:, row] . y[:, col] (the product with x transposed).
template <typename T, int D>
__device__ __forceinline__ T col_col(const T* x, int row, const T* y,
                                     int col) {
  T acc = x[row] * y[col];
#pragma unroll
  for (int q = 1; q < D; ++q)
    acc = acc + x[q * kS + row] * y[q * kS + col];
  return acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(64)
scan_factor_kernel(const T* __restrict__ Dm, const T* __restrict__ E,
                   const T* __restrict__ F, const T* __restrict__ Kbb,
                   T* __restrict__ S_inv, T* __restrict__ Melim,
                   T* __restrict__ Ft, T* __restrict__ Kbb_schur_inv, int N,
                   int nb) {
  __shared__ T sA[2][kTile], sR[2][kTile];  // [S | R] of the inverse
  __shared__ T sE[2][kTile];                // E_k, E_{k+1}
  __shared__ T sFt[2][kTile];               // Ft_k, Ft_{k-1}
  __shared__ T sM[kTile], sT[kTile];        // M_k, S_{k-1}^-1 Ft_{k-1}

  const int w = max(D, nb);
  const int i = threadIdx.x / w, j = threadIdx.x % w;
  const bool dd = i < D && j < D;           // an entry of a d x d block
  const bool db = i < D && j < nb;          // of a d x b block
  const bool bb = i < nb && j < nb;         // of the b x b border
  // every thread computes every product on indices clamped into the
  // tile and stores only its own entries: no branch splits the
  // products, so their dependent chains overlap
  const int ic = min(i, kMaxW - 1), jc = min(j, kMaxW - 1);
  const int e = i * kS + j;              // its place in a tile
  const size_t lane = blockIdx.x;
  const size_t ndd = size_t(D) * D, ndb = size_t(D) * nb;
  const T* Dl = Dm + lane * N * ndd + i * D + j;
  const T* El = E + lane * N * ndd + i * D + j;
  const T* Fl = F + lane * N * ndb + i * nb + j;
  T* Sl = S_inv + lane * N * ndd + i * D + j;
  T* Ml = Melim + lane * N * ndd + i * D + j;
  T* Ftl = Ft + lane * N * ndb + i * nb + j;
  const T* Sprev = sR[D & 1];               // where the inverse ends

  // node k's D, E, F entries of this thread, two nodes ahead
  auto load = [&](int k, T& dk, T& ek, T& fk) {
    dk = ek = fk = T(0);
    if (k < N) {
      if (dd) {
        dk = Dl[k * ndd];
        ek = El[k * ndd];
      }
      if (db) fk = Fl[k * ndb];
    }
  };
  T d_cur, e_cur, f_cur, d_1, e_1, f_1;
  load(0, d_cur, e_cur, f_cur);
  load(1, d_1, e_1, f_1);
  // S_{-1}^-1 = 0, Ft_{-1} = 0, E_0
  if (i < kMaxW && j < kMaxW) {
    sR[D & 1][e] = T(0);
    sFt[1][e] = T(0);
  }
  if (dd) sE[0][e] = e_cur;
  T acc = T(0);                             // sum of the border terms
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    T d_2, e_2, f_2;
    load(k + 2, d_2, e_2, f_2);
    const T* Ek = sE[k & 1];
    const T* Fprev = sFt[(k + 1) & 1];

    // phase 1: M_k = E_k S_{k-1}^-1; T = S_{k-1}^-1 Ft_{k-1}
    const T m = row_col<T, D>(Ek, ic, Sprev, jc);
    const T t = row_col<T, D>(Sprev, ic, Fprev, jc);
    if (dd) {
      sM[e] = m;
      Ml[k * ndd] = m;
    }
    if (db) sT[e] = t;
    __syncthreads();

    // phase 2: S_k = D_k - M_k E_k^T; Ft_k = F_k - M_k Ft_{k-1};
    // the border term of node k - 1: Ft_{k-1}^T (S_{k-1}^-1 Ft_{k-1})
    const T s = row_row<T, D>(sM, ic, Ek, jc);
    const T mf = row_col<T, D>(sM, ic, Fprev, jc);
    const T border = col_col<T, D>(Fprev, ic, sT, jc);
    if (dd) {
      sA[0][e] = d_cur - s;
      sR[0][e] = (i == j) ? T(1) : T(0);
      if (k + 1 < N) sE[(k + 1) & 1][e] = e_1;
    }
    if (db) {
      const T ft = f_cur - mf;
      sFt[k & 1][e] = ft;
      Ftl[k * ndb] = ft;
    }
    if (bb && k > 0) acc = acc + border;
    __syncthreads();

    // phase 3: S_k^-1
    const T sinv = gauss_jordan<T>(sA, sR, D, i, j, dd);
    if (dd) Sl[k * ndd] = sinv;
    d_cur = d_1;
    f_cur = f_1;
    d_1 = d_2;
    e_1 = e_2;
    f_1 = f_2;
  }
  if (nb == 0) return;

  // the last node's border term, then inv(Kbb - sum)
  const T* Flast = sFt[(N - 1) & 1];
  const T t = row_col<T, D>(Sprev, ic, Flast, jc);
  if (db) sT[e] = t;
  __syncthreads();
  const T border = col_col<T, D>(Flast, ic, sT, jc);
  if (bb) acc = acc + border;
  __syncthreads();   // every read of sR[D & 1] done before it is reused
  if (bb) {
    sA[0][e] = Kbb[lane * nb * nb + i * nb + j] - acc;
    sR[0][e] = (i == j) ? T(1) : T(0);
  }
  __syncthreads();
  const T kinv = gauss_jordan<T>(sA, sR, nb, i, j, bb);
  if (bb) Kbb_schur_inv[lane * nb * nb + i * nb + j] = kinv;
}

// v[m] of the warp's thread m, for every thread (the warp is the lane).
template <typename T>
__device__ __forceinline__ T from(T v, int m) {
  return __shfl_sync(0xffffffffu, v, m);
}

// Asynchronous copies from device memory into shared memory (cp.async),
// one value each, and their groups.
template <typename T>
__device__ __forceinline__ void copy_async(T* smem, const T* gmem) {
  const unsigned dst = unsigned(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// n contiguous values from g to s, spread over the warp.
template <typename T>
__device__ __forceinline__ void stage(T* s, const T* g, int n) {
  for (int e = threadIdx.x; e < n; e += 32) copy_async(s + e, g + e);
}

constexpr int kChunk = 8;    // nodes a stage of the solve's ring
constexpr int kStages = 3;   // the ring: two chunks in flight

// One chunk of the solve's inputs (forward: Melim, S_inv, Ft, r;
// backward: E of the next node, S_inv, Ft, rt) and the chunk's values
// computed off the recursion's chain (forward: rt, S^-1 rt; backward:
// Ft beta).
template <typename T, int D>
struct Chunk {
  T a[kChunk * D * D];
  T s[kChunk * D * D];
  T f[kChunk * D * kMaxW];
  T v[kChunk * D];
  T x[kChunk * D];
  T y[kChunk * D];
};

// The solve, one warp per lane.  Each thread t < d holds row t of the
// recursion's vector and passes it on by shuffles; only the
// matrix-vector products of the recursion run on the chain, one node
// after another.  What does not feed the next node (S^-1 rt and its
// border sum in the forward sweep, Ft beta in the backward one) is
// computed for a whole chunk at once, its (node, row) pairs spread
// over the warp.
template <typename T, int D>
__global__ void __launch_bounds__(32)
scan_solve_kernel(const T* __restrict__ S_inv, const T* __restrict__ Melim,
                  const T* __restrict__ Ft, const T* __restrict__ E,
                  const T* __restrict__ Kinv, const T* __restrict__ r,
                  const T* __restrict__ rb, T* u, T* __restrict__ beta, int N,
                  int nb) {
  __shared__ Chunk<T, D> ring[kStages];
  const int t = threadIdx.x;
  const bool row = t < D;                   // thread t holds row t
  const bool col = t < nb;                  // and border entry t
  const int tr = row ? t : 0;
  const size_t lane = blockIdx.x;
  const int ndd = D * D, ndb = D * nb;
  const T* Sg = S_inv + lane * N * ndd;
  const T* Mg = Melim + lane * N * ndd;
  const T* Eg = E + lane * N * ndd;
  const T* Fg = Ft + lane * N * ndb;
  const T* rg = r + lane * N * D;
  T* ug = u + lane * N * D;                 // rt, then u
  const int chunks = (N + kChunk - 1) / kChunk;

  // forward: rt_k = r_k - Melim_k rt_{k-1}, and s = sum_k Ft_k^T S_k^-1 rt_k
  auto fetch_forward = [&](int c) {
    if (c < chunks) {
      Chunk<T, D>& ch = ring[c % kStages];
      const int k0 = c * kChunk, n = min(kChunk, N - k0);
      stage(ch.a, Mg + size_t(k0) * ndd, n * ndd);
      stage(ch.s, Sg + size_t(k0) * ndd, n * ndd);
      stage(ch.f, Fg + size_t(k0) * ndb, n * ndb);
      stage(ch.v, rg + size_t(k0) * D, n * D);
    }
    commit_copies();                        // empty groups keep the count
  };
  auto forward_node = [&](Chunk<T, D>& ch, int k0, int kk, T& rt) {
    const T* m = ch.a + kk * ndd + tr * D;
    T a = m[0] * from(rt, 0);
#pragma unroll
    for (int q = 1; q < D; ++q) a = a + m[q] * from(rt, q);
    rt = row ? ch.v[kk * D + tr] - a : T(0);
    if (row) {
      ug[(k0 + kk) * D + t] = rt;
      ch.x[kk * D + t] = rt;
    }
  };
  for (int c = 0; c < kStages - 1; ++c) fetch_forward(c);
  T rt = T(0), s_sum = T(0);
  for (int c = 0; c < chunks; ++c) {
    wait_copies<kStages - 2>();
    __syncthreads();                        // chunk c in; c - 1's stage free
    fetch_forward(c + kStages - 1);
    Chunk<T, D>& ch = ring[c % kStages];
    const int k0 = c * kChunk, n = min(kChunk, N - k0);
    if (n == kChunk) {
#pragma unroll
      for (int kk = 0; kk < kChunk; ++kk) forward_node(ch, k0, kk, rt);
    } else {
      for (int kk = 0; kk < n; ++kk) forward_node(ch, k0, kk, rt);
    }
    __syncwarp();
    // off the chain: y = S^-1 rt for every (node, row) of the chunk ...
    for (int pr = t; pr < n * D; pr += 32) {
      const int kk = pr / D, i = pr - kk * D;
      const T* s = ch.s + kk * ndd + i * D;
      const T* x = ch.x + kk * D;
      T y = s[0] * x[0];
#pragma unroll
      for (int q = 1; q < D; ++q) y = y + s[q] * x[q];
      ch.y[pr] = y;
    }
    __syncwarp();
    // ... and thread j < b sums Ft_k[:, j] . y_k over the chunk's nodes
    if (col) {
      for (int kk = 0; kk < n; ++kk) {
        const T* f = ch.f + kk * ndb + t;
        const T* y = ch.y + kk * D;
        T z = f[0] * y[0];
#pragma unroll
        for (int q = 1; q < D; ++q) z = z + f[q * nb] * y[q];
        s_sum = s_sum + z;
      }
    }
  }

  // border: beta = Kbb_schur_inv (rb - s)
  const T v = col ? rb[lane * nb + t] - s_sum : T(0);
  T bt = T(0);
  for (int q = 0; q < nb; ++q) {
    const T kq = col ? Kinv[lane * nb * nb + t * nb + q] : T(0);
    bt = (q == 0) ? kq * from(v, 0) : bt + kq * from(v, q);
  }
  if (col) beta[lane * nb + t] = bt;
  T bq[kMaxW];                              // beta, in every thread
#pragma unroll
  for (int q = 0; q < kMaxW; ++q) bq[q] = q < nb ? from(bt, q) : T(0);

  // backward: u_k = S_k^-1 (rt_k - E_{k+1}^T u_{k+1} - Ft_k beta), the
  // chunks from the last; rt is read back from u, so the forward's
  // writes must be visible to every thread's copies first
  __syncthreads();
  auto fetch_backward = [&](int c) {
    if (c < chunks) {
      Chunk<T, D>& ch = ring[c % kStages];
      const int k0 = (chunks - 1 - c) * kChunk, n = min(kChunk, N - k0);
      stage(ch.a, Eg + size_t(k0 + 1) * ndd, min(n, N - 1 - k0) * ndd);
      stage(ch.s, Sg + size_t(k0) * ndd, n * ndd);
      stage(ch.f, Fg + size_t(k0) * ndb, n * ndb);
      stage(ch.v, ug + size_t(k0) * D, n * D);
    }
    commit_copies();
  };
  auto backward_node = [&](Chunk<T, D>& ch, int k0, int kk, T& un) {
    const int k = k0 + kk;
    const T* s = ch.s + kk * ndd + tr * D;
    const T* ec = ch.a + kk * ndd + tr;     // column t of E_{k+1}
    T rhs = ch.v[kk * D + tr];
    if (k + 1 < N) {
      T a = ec[0] * from(un, 0);
#pragma unroll
      for (int q = 1; q < D; ++q) a = a + ec[q * D] * from(un, q);
      rhs = rhs - a;
    }
    if (nb) rhs = rhs - ch.x[kk * D + tr];
    T x = s[0] * from(rhs, 0);
#pragma unroll
    for (int q = 1; q < D; ++q) x = x + s[q] * from(rhs, q);
    un = row ? x : T(0);
    if (row) ug[k * D + t] = un;
  };
  for (int c = 0; c < kStages - 1; ++c) fetch_backward(c);
  T un = T(0);                              // u_{k+1}[t]
  for (int c = 0; c < chunks; ++c) {
    wait_copies<kStages - 2>();
    __syncthreads();
    fetch_backward(c + kStages - 1);
    Chunk<T, D>& ch = ring[c % kStages];
    const int k0 = (chunks - 1 - c) * kChunk, n = min(kChunk, N - k0);
    // off the chain: Ft_k beta for every (node, row) of the chunk
    if (nb) {
      for (int pr = t; pr < n * D; pr += 32) {
        const T* f = ch.f + pr * nb;        // row pr % d of node pr / d
        T fb = f[0] * bq[0];
#pragma unroll
        for (int q = 1; q < kMaxW; ++q)
          if (q < nb) fb = fb + f[q] * bq[q];
        ch.x[pr] = fb;
      }
      __syncwarp();
    }
    if (n == kChunk) {
#pragma unroll
      for (int kk = kChunk - 1; kk >= 0; --kk) backward_node(ch, k0, kk, un);
    } else {
      for (int kk = n - 1; kk >= 0; --kk) backward_node(ch, k0, kk, un);
    }
  }
}

template <typename T, int D>
cudaError_t launch_factor(const void* Dm, const void* E, const void* F,
                          const void* Kbb, void* S_inv, void* Melim,
                          void* Ft, void* Kinv, int batch, int N, int nb,
                          cudaStream_t st) {
  const int w = D > nb ? D : nb;
  const int threads = (w * w + 31) / 32 * 32;
  scan_factor_kernel<T, D><<<batch, threads, 0, st>>>(
      static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<const T*>(Kbb),
      static_cast<T*>(S_inv), static_cast<T*>(Melim), static_cast<T*>(Ft),
      static_cast<T*>(Kinv), N, nb);
  return cudaGetLastError();   // and clears it
}

template <typename T, int D>
cudaError_t launch_solve(const void* S_inv, const void* Melim, const void* Ft,
                         const void* E, const void* Kinv, const void* r,
                         const void* rb, void* u, void* beta, int batch,
                         int N, int nb, cudaStream_t st) {
  scan_solve_kernel<T, D><<<batch, 32, 0, st>>>(
      static_cast<const T*>(S_inv), static_cast<const T*>(Melim),
      static_cast<const T*>(Ft), static_cast<const T*>(E),
      static_cast<const T*>(Kinv), static_cast<const T*>(r),
      static_cast<const T*>(rb), static_cast<T*>(u), static_cast<T*>(beta),
      N, nb);
  return cudaGetLastError();
}

bool dims_ok(int batch, int N, int nb) {
  return batch >= 1 && N >= 1 && nb >= 0 && nb <= kMaxW;
}

#define SCAN_DISPATCH(CALL)                          \
  switch (d) {                                       \
    case 2: return int(CALL(2));                     \
    case 3: return int(CALL(3));                     \
    case 4: return int(CALL(4));                     \
    case 5: return int(CALL(5));                     \
    case 6: return int(CALL(6));                     \
    case 7: return int(CALL(7));                     \
    case 8: return int(CALL(8));                     \
    default: return int(cudaErrorInvalidValue);      \
  }

template <typename T>
int factor_dispatch(const void* Dm, const void* E, const void* F,
                    const void* Kbb, void* S_inv, void* Melim, void* Ft,
                    void* Kinv, int batch, int d, int N, int nb,
                    void* stream) {
  if (!dims_ok(batch, N, nb)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FACTOR(DD)                                                        \
  launch_factor<T, DD>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch, N, \
                       nb, st)
  SCAN_DISPATCH(FACTOR)
#undef FACTOR
}

template <typename T>
int solve_dispatch(const void* S_inv, const void* Melim, const void* Ft,
                   const void* E, const void* Kinv, const void* r,
                   const void* rb, void* u, void* beta, int batch, int d,
                   int N, int nb, void* stream) {
  if (!dims_ok(batch, N, nb)) return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SOLVE(DD)                                                          \
  launch_solve<T, DD>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta, batch, N, \
                      nb, st)
  SCAN_DISPATCH(SOLVE)
#undef SOLVE
}

}  // namespace

// Plain C interface (loaded with ctypes).  Every entry returns the
// cudaError_t of its launch (0: launched), having cleared it.
extern "C" {

int scan_factor_f32(const void* Dm, const void* E, const void* F,
                    const void* Kbb, void* S_inv, void* Melim, void* Ft,
                    void* Kinv, int batch, int d, int N, int nb,
                    void* stream) {
  return factor_dispatch<float>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch,
                                d, N, nb, stream);
}

int scan_factor_f64(const void* Dm, const void* E, const void* F,
                    const void* Kbb, void* S_inv, void* Melim, void* Ft,
                    void* Kinv, int batch, int d, int N, int nb,
                    void* stream) {
  return factor_dispatch<double>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv,
                                 batch, d, N, nb, stream);
}

int scan_solve_f32(const void* S_inv, const void* Melim, const void* Ft,
                   const void* E, const void* Kinv, const void* r,
                   const void* rb, void* u, void* beta, int batch, int d,
                   int N, int nb, void* stream) {
  return solve_dispatch<float>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta,
                               batch, d, N, nb, stream);
}

int scan_solve_f64(const void* S_inv, const void* Melim, const void* Ft,
                   const void* E, const void* Kinv, const void* r,
                   const void* rb, void* u, void* beta, int batch, int d,
                   int N, int nb, void* stream) {
  return solve_dispatch<double>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta,
                                batch, d, N, nb, stream);
}

}  // extern "C"
