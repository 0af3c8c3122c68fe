"""Hand-written CUDA kernels for the PCR factorization, their plain
PyTorch versions and their launch counters.

The counterpart of opty_tpu/ops/pallas_pcr.py.  Two kernels, both in
csrc/pcr.cu, built for Hopper (sm_90a) with nvcc at first use and
loaded through ctypes (ops/cuda_build.py):

* ``pcr_factor_levels`` replaces ``_factor_kernel`` (reached through
  ``pcr_factor_fused``): every PCR level of the bordered
  block-tridiagonal system in one launch, one thread block per
  instance.  Bound on an H100 by device memory: it writes L levels of
  two d x d multipliers per node (28.9 MB at the main path's
  B = 32, d = 5, b = 4, N = 501, float32) for ~0.3 GFLOP.  The level
  state ping-pongs through a per-instance scratch that stays in L2;
  nothing else is re-read from device memory.
* ``pcr_downsweep`` replaces ``_downsweep_kernel`` (reached through
  ``pcr_downsweep_fused``): r <- r - A_l r_{k-s} - B_l r_{k+s} through
  every stored level.  Bound by reading the stored levels (28.9 MB at
  the main path); r stays in shared memory across the levels and is
  written back once.

Unlike the Pallas kernels, neither pads the node axis: outputs keep the
caller's N.  A tensor on the CPU goes to the plain version
(``pcr_factor_levels_plain``/``pcr_downsweep_plain``, the level loops
of opty_tpu/ops/tridiag.py); a CUDA tensor goes to the kernel, or the
wrapper raises.  Each wrapper counts its kernel launches in
``factor_launches``/``downsweep_launches``.
"""

import ctypes

import torch

from .cuda_build import build_kernels, check_cuda, launch, load
from .lanes import block_inv_nl, matmul_nl, matvec_nl, transpose_nl
from .tridiag import _down, _up, num_levels

__all__ = ['pcr_factor_levels', 'pcr_downsweep', 'pcr_factor_levels_plain',
           'pcr_downsweep_plain', 'build_kernels', 'reset_launch_counts',
           'SUPPORTED_D', 'MAX_B']

SUPPORTED_D = (3, 5)      # block sizes instantiated in csrc/pcr.cu
MAX_B = 8                 # widest border the kernels take
_MAX_SMEM = 227 * 1024    # dynamic shared memory a block may use (H100)

factor_launches = 0
downsweep_launches = 0


def reset_launch_counts():
    global factor_launches, downsweep_launches
    factor_launches = 0
    downsweep_launches = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def pcr_factor_levels_plain(D, E, F):
    """Every PCR level of (..., d, d, N) systems in plain PyTorch.

    Returns (A (..., L, d, d, N), B (..., L, d, d, N), Dinv (..., d, d, N),
    Fp (..., d, b, N), Z (..., d, b, N)) with Z = Dinv^T F."""
    N = D.shape[-1]
    F0 = F
    Lb = E                                    # couples u_{k-s}
    Ub = transpose_nl(_up(E, 1))              # E_{k+1}^T couples u_{k+s}
    A_levels, B_levels = [], []
    s = 1
    for _ in range(num_levels(N)):
        Dinv = block_inv_nl(D)
        A = matmul_nl(Lb, _down(Dinv, s))
        B = matmul_nl(Ub, _up(Dinv, s))
        D = D - matmul_nl(A, _down(Ub, s)) - matmul_nl(B, _up(Lb, s))
        F = F - matmul_nl(A, _down(F, s)) - matmul_nl(B, _up(F, s))
        Lb, Ub = -matmul_nl(A, _down(Lb, s)), -matmul_nl(B, _up(Ub, s))
        A_levels.append(A)
        B_levels.append(B)
        s *= 2
    Dinv = block_inv_nl(D)
    Z = matmul_nl(transpose_nl(Dinv), F0)
    return (torch.stack(A_levels, dim=-4), torch.stack(B_levels, dim=-4),
            Dinv, F, Z)


def pcr_downsweep_plain(A, B, r):
    """r (..., d, N) through every stored level of A, B (..., L, d, d, N)."""
    s = 1
    for l in range(A.shape[-4]):
        r = (r - matvec_nl(A[..., l, :, :, :], _down(r, s))
             - matvec_nl(B[..., l, :, :, :], _up(r, s)))
        s *= 2
    return r


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
               for name, args in (
                   ('pcr_factor_levels', [_VP] * 9 + [_CI] * 5 + [_VP]),
                   ('pcr_downsweep', [_VP] * 4 + [_CI] * 4 + [_VP]))}


def _check_dims(name, d, b, N):
    if d not in SUPPORTED_D:
        raise ValueError('{}: block size d={} is not built (built: {})'
                         .format(name, d, SUPPORTED_D))
    if not 0 <= b <= MAX_B:
        raise ValueError('{}: border width b={} exceeds {}'.format(
            name, b, MAX_B))
    if N < 1:
        raise ValueError('{}: empty node axis'.format(name))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def pcr_factor_levels(D, E, F):
    """PCR factorization levels of a batch of systems.

    D, E (B, d, d, N) with E[..., 0] = 0, F (B, d, b, N).  Returns
    (A (B, L, d, d, N), B (B, L, d, d, N), Dinv (B, d, d, N),
    Fp (B, d, b, N), Z (B, d, b, N)), L = ceil(log2 N)."""
    if D.ndim != 4:
        raise ValueError('pcr_factor_levels: D must be (B, d, d, N)')
    nbatch, d, _, N = D.shape
    b = F.shape[-2]
    if D.device.type == 'cpu' and E.device.type == 'cpu' \
            and F.device.type == 'cpu':
        return pcr_factor_levels_plain(D, E, F)
    suffix = check_cuda('pcr_factor_levels', (D, E, F),
                        ((nbatch, d, d, N), (nbatch, d, d, N),
                         (nbatch, d, b, N)))
    _check_dims('pcr_factor_levels', d, b, N)
    L = num_levels(N)
    new = lambda *shape: torch.empty(shape, dtype=D.dtype, device=D.device)
    A = new(nbatch, L, d, d, N)
    B = new(nbatch, L, d, d, N)
    Dinv = new(nbatch, d, d, N)
    Fp = new(nbatch, d, b, N)
    Z = new(nbatch, d, b, N)
    scratch = new(nbatch, 2 * (3 * d * d + d * b) + d * d, N)
    fn = getattr(load('pcr', _SIGNATURES), 'pcr_factor_levels_' + suffix)
    launch('pcr_factor_levels', fn,
           (D.data_ptr(), E.data_ptr(), F.data_ptr(), A.data_ptr(),
            B.data_ptr(), Dinv.data_ptr(), Fp.data_ptr(), Z.data_ptr(),
            scratch.data_ptr(), nbatch, d, b, N, L), D.device)
    global factor_launches
    factor_launches += 1
    return A, B, Dinv, Fp, Z


def pcr_downsweep(A, B, r):
    """r (B, d, N) through every stored level of A, B (B, L, d, d, N)."""
    if A.ndim != 5:
        raise ValueError('pcr_downsweep: A must be (B, L, d, d, N)')
    nbatch, L, d, _, N = A.shape
    if A.device.type == 'cpu' and B.device.type == 'cpu' \
            and r.device.type == 'cpu':
        return pcr_downsweep_plain(A, B, r)
    suffix = check_cuda('pcr_downsweep', (A, B, r),
                        ((nbatch, L, d, d, N), (nbatch, L, d, d, N),
                         (nbatch, d, N)))
    _check_dims('pcr_downsweep', d, 0, N)
    smem = 2 * d * N * r.element_size()
    if smem > _MAX_SMEM:
        raise ValueError('pcr_downsweep: r needs {} bytes of shared memory '
                         '(limit {})'.format(smem, _MAX_SMEM))
    out = torch.empty_like(r)
    fn = getattr(load('pcr', _SIGNATURES), 'pcr_downsweep_' + suffix)
    launch('pcr_downsweep', fn, (A.data_ptr(), B.data_ptr(), r.data_ptr(),
                                 out.data_ptr(), nbatch, d, N, L), r.device)
    global downsweep_launches
    downsweep_launches += 1
    return out
