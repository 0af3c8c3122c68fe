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
// each lane, as at d = 5.  A factor node step is ~4 d^3 + 3 d^2 b
// FLOPs of products and a d x d inverse (0.85 MFLOP at d = 50, b = 41);
// a lane at N = 60 moves 4.9 MB in double (1.5 us at 3.35 TB/s) and
// needs 51 MFLOP (0.8 us at 67 TFLOP/s), while each node waits on the
// last.  So a thread block walks one lane's nodes (one SM a lane: at
// B = 1 the factor uses one of 132 SMs) and shortens the node step:
//
// * scan_wide_factor keeps S_{k-1}^-1, M_k, Ft_{k-1}, E_k, the border
//   sum and the matrix being inverted in shared memory (216 KB at d = 50,
//   b = 41 in double; wide_smem says which (d, b, dtype) fit).  A node
//   step is two passes of wide.cuh's tile products (FP64 tensor cores in
//   double) and its panelled LU inverse:
//   pass 1: M_k = E_k S_{k-1}^-1, and T = S_{k-1}^-1 Ft_{k-1}, the
//           previous node's border term, which no later node needs;
//   pass 2: S_k = D_k - M_k E_k^T, Ft_k = F_k - M_k Ft_{k-1}, and the
//           border sum += Ft_{k-1}^T T;
//   then S_k^-1.  D_{k+1} streams in by asynchronous copies from pass 1
//   on (two D buffers), E_{k+1} and F_{k+1} during the inverse.  At the
//   end the inverse of Kbb - sum.  About 25 barriers a node at d = 50.
// * scan_wide_solve runs a block of 256 threads per lane, four threads a
//   row.  The forward sweep rt_k = r_k - Melim_k rt_{k-1} (one
//   matrix-vector product on the chain), then y_k = S_k^-1 rt_k and the
//   border sum of Ft_k^T y_k; the border solve; the backward sweep
//   u_k = S_k^-1 (rt_k - Ft_k beta - E_{k+1}^T u_{k+1}).  A node's
//   matrices come through a ring of two stages in shared memory by
//   asynchronous copies, the next node's in flight while this one
//   computes.  rt goes to u and is read back by the backward sweep.
//
// A singular pivot gives inf/nan in its lane's remaining outputs, as
// the plain versions do; other lanes are untouched.  The products and
// the blocked inverse sum in another order than the plain versions
// (ops/scan_kernels.py), so the two agree to round-off, not bitwise.

#include <atomic>
#include <cstddef>

#include <cuda_runtime.h>

#include "wide.cuh"

namespace {

using wide::Mat;
using wide::kThreads;

constexpr int kMaxDevices = 64;

// Shared memory of the factor, in values: E_k, S_{k-1}^-1 (row-major),
// M_k, the two D / S buffers, Ft_k and Ft_{k-1}, T (the node loop's
// region, which the border inverse then takes for its result), the
// border sum (b x b), then an inverse's scratch; the inverse's ints
// follow.  M_k's buffer holds S_k's inverse while it is formed.
struct FactorLayout {
  int P, Pb, es, sp, ms, ss0, ss1, ft0, ft1, tb, acc, scratch, total;
  __host__ __device__ FactorLayout(int d, int nb) {
    P = wide::pitch(d);
    Pb = wide::pitch(nb);
    const int mat = wide::values(d, d), matb = wide::values(d, nb);
    const int bb = wide::values(nb, nb);
    es = 0;
    sp = mat;
    ms = 2 * mat;
    ss0 = 3 * mat;
    ss1 = 4 * mat;
    ft0 = 5 * mat;
    ft1 = ft0 + matb;
    tb = ft1 + matb;
    acc = tb + matb > bb ? tb + matb : bb;
    scratch = acc + bb;
    total = scratch + wide::inverse_scratch(P > Pb ? P : Pb);
  }
  __host__ __device__ size_t bytes(size_t es_) const {
    return size_t(total) * es_ + wide::kInverseInts * sizeof(int);
  }
};

__host__ __device__ constexpr int round8(int n) { return (n + 7) / 8 * 8; }

// Shared memory of the solve, in values: two stages of [two d x d
// matrices | a d x b matrix | a vector of d], then the vectors x (two),
// y, and the border's v and beta.
struct SolveLayout {
  int mat, ft, stage, x0, x1, y, vb, bt, total;
  __host__ __device__ SolveLayout(int d, int nb) {
    mat = round8(d * d);
    ft = round8(d * nb);
    stage = 2 * mat + ft + round8(d);
    x0 = 2 * stage;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_wide_factor(const T* __restrict__ Dm, const T* __restrict__ E,
                 const T* __restrict__ F, const T* __restrict__ Kbb,
                 T* __restrict__ S_inv, T* __restrict__ Melim,
                 T* __restrict__ Ft, T* __restrict__ Kbb_schur_inv, int N,
                 int d, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const FactorLayout lay(d, nb);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* Es = sm + lay.es;
  T* Sp = sm + lay.sp;
  T* Ms = sm + lay.ms;
  T* Ss[2] = {sm + lay.ss0, sm + lay.ss1};
  T* Fts[2] = {sm + lay.ft0, sm + lay.ft1};
  T* Tb = sm + lay.tb;
  T* Acc = sm + lay.acc;
  T* scratch = sm + lay.scratch;
  int* ints = reinterpret_cast<int*>(sm + lay.total);
  const int P = lay.P, Pb = lay.Pb;
  const size_t lane = blockIdx.x;
  const size_t dd = size_t(d) * d, db = size_t(d) * nb;
  const T* Dl = Dm + lane * N * dd;
  const T* El = E + lane * N * dd;
  const T* Fl = F + lane * N * db;
  T* Sl = S_inv + lane * N * dd;
  T* Ml = Melim + lane * N * dd;
  T* Ftl = Ft + lane * N * db;

  // S_{-1}^-1 = 0, Ft_{-1} = 0, the border sum 0; node 0's E, D, F
  for (int e = threadIdx.x; e < d * d; e += blockDim.x)
    Sp[(e / d) * P + e % d] = T(0);
  for (int e = threadIdx.x; e < d * nb; e += blockDim.x)
    Fts[1][(e / nb) * Pb + e % nb] = T(0);
  for (int e = threadIdx.x; e < nb * nb; e += blockDim.x)
    Acc[(e / nb) * Pb + e % nb] = T(0);
  wide::stage(Es, P, El, d, d, 1, true);
  wide::stage(Ss[0], P, Dl, d, d, 1, true);
  wide::stage(Fts[0], Pb, Fl, d, nb, 1, true);
  wide::wait_copies();
  __syncthreads();

  for (int k = 0; k < N; ++k) {
    T* Sk = Ss[k & 1];
    T* Ftk = Fts[k & 1];
    T* Ftp = Fts[(k + 1) & 1];
    // D_{k+1} into the other buffer (S_{k-1}, inverted and read out)
    if (k + 1 < N) wide::stage(Ss[(k + 1) & 1], P, Dl + (k + 1) * dd, d, d, 1,
                               true);

    // pass 1: M_k = E_k S_{k-1}^-1; T = S_{k-1}^-1 Ft_{k-1}
    int off = wide::product(Mat<T>{Es, P, false}, Mat<T>{Sp, P, false}, d, d,
                            d, 0, [&](int i, int j, T v) {
                              Ms[i * P + j] = v;
                              Ml[k * dd + i * d + j] = v;
                            });
    if (k > 0)
      wide::product(Mat<T>{Sp, P, false}, Mat<T>{Ftp, Pb, false}, d, nb, d,
                    off, [&](int i, int c, T v) { Tb[i * Pb + c] = v; });
    __syncthreads();

    // pass 2: S_k = D_k - M_k E_k^T; Ft_k = F_k - M_k Ft_{k-1}; the
    // border sum += Ft_{k-1}^T T
    off = wide::product(Mat<T>{Ms, P, false}, Mat<T>{Es, P, true}, d, d, d, 0,
                        [&](int i, int j, T v) {
                          Sk[i * P + j] = Sk[i * P + j] - v;
                        });
    off = wide::product(Mat<T>{Ms, P, false}, Mat<T>{Ftp, Pb, false}, d, nb,
                        d, off, [&](int i, int c, T v) {
                          const T f = Ftk[i * Pb + c] - v;
                          Ftk[i * Pb + c] = f;
                          Ftl[k * db + i * nb + c] = f;
                        });
    if (k > 0)
      wide::product(Mat<T>{Ftp, Pb, true}, Mat<T>{Tb, Pb, false}, nb, nb, d,
                    off, [&](int i, int c, T v) {
                      Acc[i * Pb + c] = Acc[i * Pb + c] + v;
                    });
    __syncthreads();

    // E_{k+1} and F_{k+1} come in while S_k is inverted
    if (k + 1 < N) {
      wide::stage(Es, P, El + (k + 1) * dd, d, d, 1, true);
      wide::stage(Ftp, Pb, Fl + (k + 1) * db, d, nb, 1, true);
    }
    wide::inverse(Sk, Ms, P, d, scratch, ints, [&](int i, int j, T v) {
      Sp[i * P + j] = v;
      Sl[k * dd + i * d + j] = v;
    });
    wide::wait_copies();
    __syncthreads();
  }
  if (nb == 0) return;

  // the last node's border term, then the inverse of Kbb - sum
  const T* Ftl_last = Fts[(N - 1) & 1];
  wide::product(Mat<T>{Sp, P, false}, Mat<T>{Ftl_last, Pb, false}, d, nb, d,
                0, [&](int i, int c, T v) { Tb[i * Pb + c] = v; });
  __syncthreads();
  wide::product(Mat<T>{Ftl_last, Pb, true}, Mat<T>{Tb, Pb, false}, nb, nb, d,
                0, [&](int i, int c, T v) {
                  Acc[i * Pb + c] = Acc[i * Pb + c] + v;
                });
  __syncthreads();
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

// n contiguous values from g to s by asynchronous copies.
template <typename T>
__device__ __forceinline__ void copy_run(T* s, const T* g, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x)
    wide::copy_async(s + e, g + e);
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
                const T* __restrict__ rb, T* u, T* __restrict__ beta, int N,
                int d, int nb) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const SolveLayout lay(d, nb);
  T* sm = reinterpret_cast<T*>(smem_raw);
  T* x[2] = {sm + lay.x0, sm + lay.x1};
  T* y = sm + lay.y;
  T* vb = sm + lay.vb;
  T* bt = sm + lay.bt;
  const int t = threadIdx.x;
  const int i = t >> 2, q = t & 3;          // row i, a quarter of it
  const bool row = i < d;
  const size_t lane = blockIdx.x;
  const size_t dd = size_t(d) * d, db = size_t(d) * nb;
  const T* Sg = S_inv + lane * N * dd;
  const T* Mg = Melim + lane * N * dd;
  const T* Eg = E + lane * N * dd;
  const T* Fg = Ft + lane * N * db;
  const T* rg = r + lane * N * d;
  T* ug = u + lane * N * d;                 // rt, then u
  // stage s: [m0 | m1 | f | v] at s * lay.stage
  auto m0 = [&](int s) { return sm + s * lay.stage; };
  auto m1 = [&](int s) { return sm + s * lay.stage + lay.mat; };
  auto fs = [&](int s) { return sm + s * lay.stage + 2 * lay.mat; };
  auto vs = [&](int s) { return sm + s * lay.stage + 2 * lay.mat + lay.ft; };

  // forward: rt_k = r_k - Melim_k rt_{k-1}; s = sum_k Ft_k^T S_k^-1 rt_k
  auto fetch_forward = [&](int k) {
    if (k < N) {
      const int s = k & 1;
      copy_run(m0(s), Mg + k * dd, int(dd));
      copy_run(m1(s), Sg + k * dd, nb ? int(dd) : 0);
      copy_run(fs(s), Fg + k * db, int(db));
      copy_run(vs(s), rg + size_t(k) * d, d);
    }
  };
  for (int e = t; e < d; e += blockDim.x) x[1][e] = T(0);
  fetch_forward(0);
  T s_part = T(0);                          // thread (i, q): column i's sum
  for (int k = 0; k < N; ++k) {
    const int s = k & 1;
    wide::wait_copies();
    __syncthreads();                        // stage k in; rt_{k-1} visible
    fetch_forward(k + 1);
    const T* xm = x[(k + 1) & 1];
    T* xk = x[k & 1];
    const T* m = m0(s) + i * d;
    T a = T(0);
    if (row)
      for (int j = q; j < d; j += 4) a = wide::fma_rn(m[j], xm[j], a);
    a = row_sum(a);
    if (row && q == 0) {
      const T rt = vs(s)[i] - a;
      xk[i] = rt;
      ug[size_t(k) * d + i] = rt;
    }
    if (nb) {
      __syncthreads();
      const T* sv = m1(s) + i * d;
      T b = T(0);
      if (row)
        for (int j = q; j < d; j += 4) b = wide::fma_rn(sv[j], xk[j], b);
      b = row_sum(b);
      if (row && q == 0) y[i] = b;
      __syncthreads();
      if (i < nb) {
        const T* f = fs(s) + i;             // column i of Ft_k
        for (int j = q; j < d; j += 4) s_part = wide::fma_rn(f[j * nb], y[j],
                                                             s_part);
      }
    }
  }
  __syncthreads();

  // border: beta = Kbb_schur_inv (rb - s)
  if (nb) {
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
    __syncthreads();
  }

  // backward: u_k = S_k^-1 (rt_k - Ft_k beta - E_{k+1}^T u_{k+1}), from
  // the last node; stage it - 1 holds E_{k+1}, S_k, Ft_k and rt_k
  auto fetch_backward = [&](int it) {
    if (it < N) {
      const int k = N - 1 - it, s = it & 1;
      copy_run(m0(s), Eg + (k + 1) * dd, k + 1 < N ? int(dd) : 0);
      copy_run(m1(s), Sg + k * dd, int(dd));
      copy_run(fs(s), Fg + k * db, int(db));
      copy_run(vs(s), ug + size_t(k) * d, d);
    }
  };
  for (int e = t; e < d; e += blockDim.x) x[1][e] = T(0);
  fetch_backward(0);
  for (int it = 0; it < N; ++it) {
    const int k = N - 1 - it, s = it & 1;
    wide::wait_copies();
    __syncthreads();                        // stage in; u_{k+1} visible
    fetch_backward(it + 1);
    const T* un = x[(it + 1) & 1];
    T* uk = x[it & 1];
    T a = T(0);
    if (row) {
      const T* f = fs(s) + i * nb;
      for (int c = q; c < nb; c += 4) a = wide::fma_rn(f[c], bt[c], a);
      if (k + 1 < N) {
        const T* ec = m0(s) + i;            // column i of E_{k+1}
        for (int j = q; j < d; j += 4) a = wide::fma_rn(ec[j * d], un[j], a);
      }
    }
    a = row_sum(a);
    if (row && q == 0) y[i] = vs(s)[i] - a;
    __syncthreads();
    const T* sv = m1(s) + i * d;
    T b = T(0);
    if (row)
      for (int j = q; j < d; j += 4) b = wide::fma_rn(sv[j], y[j], b);
    b = row_sum(b);
    if (row && q == 0) {
      uk[i] = b;
      ug[size_t(k) * d + i] = b;
    }
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

bool dims_ok(int batch, int d, int N, int nb) {
  return batch >= 1 && N >= 1 && d >= 1 && d <= wide::kMaxN && nb >= 0 &&
         nb <= wide::kMaxN;
}

template <typename T>
int factor(const void* Dm, const void* E, const void* F, const void* Kbb,
           void* S_inv, void* Melim, void* Ft, void* Kinv, int batch, int d,
           int N, int nb, void* stream) {
  if (!dims_ok(batch, d, N, nb)) return int(cudaErrorInvalidValue);
  static std::atomic<int> allowed[kMaxDevices];
  const size_t smem = FactorLayout(d, nb).bytes(sizeof(T));
  cudaError_t err = allow(scan_wide_factor<T>, allowed, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  scan_wide_factor<T><<<batch, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Dm), static_cast<const T*>(E),
      static_cast<const T*>(F), static_cast<const T*>(Kbb),
      static_cast<T*>(S_inv), static_cast<T*>(Melim), static_cast<T*>(Ft),
      static_cast<T*>(Kinv), N, d, nb);
  return int(cudaGetLastError());   // and clears it
}

template <typename T>
int solve(const void* S_inv, const void* Melim, const void* Ft,
          const void* E, const void* Kinv, const void* r, const void* rb,
          void* u, void* beta, int batch, int d, int N, int nb,
          void* stream) {
  if (!dims_ok(batch, d, N, nb)) return int(cudaErrorInvalidValue);
  static std::atomic<int> allowed[kMaxDevices];
  const size_t smem = SolveLayout(d, nb).bytes(sizeof(T));
  cudaError_t err = allow(scan_wide_solve<T>, allowed, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return int(err);
  }
  scan_wide_solve<T><<<batch, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(S_inv), static_cast<const T*>(Melim),
      static_cast<const T*>(Ft), static_cast<const T*>(E),
      static_cast<const T*>(Kinv), static_cast<const T*>(r),
      static_cast<const T*>(rb), static_cast<T*>(u), static_cast<T*>(beta),
      N, d, nb);
  return int(cudaGetLastError());
}

}  // namespace

// Plain C interface (loaded with ctypes), the arguments of scan.cu's
// entries.  Every entry returns the cudaError_t of its launch (0:
// launched), having cleared it; a shape whose shared memory exceeds the
// card's is refused there.
extern "C" {

int scan_wide_factor_f32(const void* Dm, const void* E, const void* F,
                         const void* Kbb, void* S_inv, void* Melim, void* Ft,
                         void* Kinv, int batch, int d, int N, int nb,
                         void* stream) {
  return factor<float>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch, d, N,
                       nb, stream);
}

int scan_wide_factor_f64(const void* Dm, const void* E, const void* F,
                         const void* Kbb, void* S_inv, void* Melim, void* Ft,
                         void* Kinv, int batch, int d, int N, int nb,
                         void* stream) {
  return factor<double>(Dm, E, F, Kbb, S_inv, Melim, Ft, Kinv, batch, d, N,
                        nb, stream);
}

int scan_wide_solve_f32(const void* S_inv, const void* Melim, const void* Ft,
                        const void* E, const void* Kinv, const void* r,
                        const void* rb, void* u, void* beta, int batch, int d,
                        int N, int nb, void* stream) {
  return solve<float>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta, batch, d, N,
                      nb, stream);
}

int scan_wide_solve_f64(const void* S_inv, const void* Melim, const void* Ft,
                        const void* E, const void* Kinv, const void* r,
                        const void* rb, void* u, void* beta, int batch, int d,
                        int N, int nb, void* stream) {
  return solve<double>(S_inv, Melim, Ft, E, Kinv, r, rb, u, beta, batch, d,
                       N, nb, stream);
}

// The bytes of dynamic shared memory that a factor and a solve block
// ask for at (d, nb) in values of `itemsize` bytes, into out[0] and
// out[1] (what ops/scan_kernels.py:wide_smem must equal); launches
// nothing and returns 0.
int scan_wide_smem(int d, int nb, int itemsize, unsigned long long* out) {
  out[0] = FactorLayout(d, nb).bytes(size_t(itemsize));
  out[1] = SolveLayout(d, nb).bytes(size_t(itemsize));
  return 0;
}

}  // extern "C"
