"""Hand-written CUDA kernels for batched small-matrix algebra, their
plain PyTorch versions and their launch counters.

The counterpart of opty_tpu/ops/pallas_blocks.py.  Two kernels, both in
csrc/blocks.cu, built for Hopper (sm_90a) with nvcc at first use and
loaded through ctypes (ops/cuda_build.py):

* ``block_inv`` replaces ``_inv_kernel`` (reached through
  ``block_inv_pallas``): the inverse of every d x d matrix of a batch,
  by Gaussian elimination with per-matrix partial pivoting
  (select-based row swaps) and back substitution.  Singular inputs give
  inf/nan entries.
* ``block_matmul`` replaces ``_matmul_kernel`` (``block_matmul_pallas``):
  the product of every pair of d x d matrices, the inner sum in order,
  a thread per output entry.

Both take the public ``(..., d, d)`` layout as it comes (no batch-last
transpose, no padding of the batch), d = 2..8, float32 or float64.
``block_inv`` also takes every other d up to 64 through its wide
variant (csrc/wide.cu: a thread block per matrix, the matrix in shared
memory, the plain version's algorithm and pivot rule in panels with
tensor-core updates, equal to it to round-off; counted in
``wide_inv_launches``),
which the PCR path's border needs at b = 1 and b > 8 (nlink-9: 41).  On
an H100 a call of a few tens of matrices is bound by launch latency
(``empty_launch`` times an empty kernel, that floor); a whole node axis
of matrices by device memory (see csrc/blocks.cu).  The PCR path calls
``block_inv`` once per factorization for its border; the scan path's
per-node inverses and products run inside ``scan_factor``
(ops/scan_kernels.py).

A tensor on the CPU goes to the plain version (``block_inv_plain``:
``lanes.block_inv_nl`` behind a layout change; ``block_matmul_plain``:
``lanes.matmul_nl``'s ordered sum); a CUDA tensor goes to the kernel,
or the wrapper raises.  Each wrapper counts its kernel launches in
``inv_launches``/``matmul_launches``.
"""

import ctypes

import torch

from .cuda_build import check_cuda, launch, load
from .lanes import block_inv_nl, from_lanes, to_lanes

__all__ = ['block_inv', 'block_matmul', 'block_inv_plain',
           'block_matmul_plain', 'empty_launch', 'reset_launch_counts',
           'SUPPORTED_D', 'WIDE_MAX_D']

SUPPORTED_D = tuple(range(2, 9))      # block sizes instantiated in blocks.cu
WIDE_MAX_D = 64                       # block_inv's wide variant: 1..64
_INV_D = tuple(range(1, WIDE_MAX_D + 1))

inv_launches = 0
matmul_launches = 0
wide_inv_launches = 0

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
               for name, args in (
                   ('block_inv', [_VP, _VP, _CI, _CI, _VP]),
                   ('block_matmul', [_VP, _VP, _VP, _CI, _CI, _VP]))}
_SIGNATURES['empty_launch'] = [_VP]         # the stream


def reset_launch_counts():
    global inv_launches, matmul_launches, wide_inv_launches
    inv_launches = 0
    matmul_launches = 0
    wide_inv_launches = 0


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def block_inv_plain(A):
    """Inverse of every matrix of A (..., d, d): block_inv_nl's pivot
    rule, select swaps and back-substitution order."""
    A3 = A.reshape((-1,) + tuple(A.shape[-2:]))
    return from_lanes(block_inv_nl(to_lanes(A3))).reshape(A.shape)


def block_matmul_plain(A, B):
    """A @ B for (..., d, d) batches, the inner sum unrolled in order
    (matmul_nl's order)."""
    acc = A[..., :, 0:1] * B[..., 0:1, :]
    for j in range(1, A.shape[-1]):
        acc = acc + A[..., :, j:j + 1] * B[..., j:j + 1, :]
    return acc


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _check(name, tensors, out, built=SUPPORTED_D):
    A = tensors[0]
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError('{}: expected (..., d, d) matrices, got shape {}'
                         .format(name, tuple(A.shape)))
    d = A.shape[-1]
    if out is not None:
        tensors = tensors + (out,)
    suffix = check_cuda(name, tensors, [A.shape] * len(tensors))
    if d not in built:
        raise ValueError('{}: block size d={} is not built (built: {}..{})'
                         .format(name, d, built[0], built[-1]))
    return suffix, d


def _plain_into(result, out):
    if out is None:
        return result
    return out.copy_(result)


def block_inv(A, out=None):
    """Inverse of every matrix of A (..., d, d), written into ``out``
    when given (same shape, dtype and device as A)."""
    if A.device.type == 'cpu' and (out is None or out.device.type == 'cpu'):
        return _plain_into(block_inv_plain(A), out)
    suffix, d = _check('block_inv', (A,), out, _INV_D)
    X = torch.empty_like(A) if out is None else out
    nbatch = A.numel() // (d * d)
    if nbatch:
        global inv_launches, wide_inv_launches
        narrow = d in SUPPORTED_D
        if narrow:
            fn = getattr(load('blocks', _SIGNATURES), 'block_inv_' + suffix)
        else:
            from .pcr_kernels import _WIDE_SIGNATURES
            fn = getattr(load('wide', _WIDE_SIGNATURES),
                         'block_inv_wide_' + suffix)
        launch('block_inv', fn, (A.data_ptr(), X.data_ptr(), nbatch, d),
               A.device)
        if narrow:
            inv_launches += 1
        else:
            wide_inv_launches += 1
    return X


def block_matmul(A, B, out=None):
    """A @ B for every pair of matrices of A, B (..., d, d), written
    into ``out`` when given."""
    if A.device.type == 'cpu' and B.device.type == 'cpu' \
            and (out is None or out.device.type == 'cpu'):
        return _plain_into(block_matmul_plain(A, B), out)
    suffix, d = _check('block_matmul', (A, B), out)
    C = torch.empty_like(A) if out is None else out
    nbatch = A.numel() // (d * d)
    if nbatch:
        fn = getattr(load('blocks', _SIGNATURES), 'block_matmul_' + suffix)
        launch('block_matmul', fn,
               (A.data_ptr(), B.data_ptr(), C.data_ptr(), nbatch, d),
               A.device)
        global matmul_launches
        matmul_launches += 1
    return C


def empty_launch(device):
    """Launch an empty kernel on ``device``'s current stream: the floor
    of any single launch's time (not counted)."""
    launch('empty_launch', load('blocks', _SIGNATURES).empty_launch, (),
           device)
