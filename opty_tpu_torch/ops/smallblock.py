"""Batched small-matrix inversion for the scan KKT factorization.

The counterpart of opty_tpu/ops/smallblock.py: Gaussian elimination
with partial pivoting on [A | I] (eliminating below the pivot only),
then triangular back substitution — the classical LU-based inverse.
The row swap is a gather, the form the JAX package runs on its CPU
backend, and the parity target of the float64 reference path.  Plain
PyTorch on any device: on the card the scan path inverts its pivots
inside the scan_factor kernel (ops/scan_kernels.py), whose plain
version calls this one; the standalone block_inv kernel
(ops/block_kernels.py) swaps by selects, as the JAX package's
accelerator form does.  On finite inputs the forms agree to round-off.
On non-finite rows they may differ: this form updates every row with a
multiplier, zero above the pivot, and 0 * inf is nan.
"""

import functools

import torch

__all__ = ['block_inv']


@functools.lru_cache(maxsize=None)
def _rows(d, device):
    """Row indices and the per-step row masks of a d x d elimination."""
    rows = torch.arange(d, device=device)
    return (rows, [rows >= k for k in range(d)],
            [(rows > k)[:, None] for k in range(d)],
            [(rows == k)[:, None] for k in range(d)])


def block_inv(A, out=None):
    """Inverse of a batch of small matrices, shape (..., d, d), written
    into ``out`` when given.

    Singular inputs produce inf/nan entries (callers detect non-finite
    directions and regularize, as LU factorizations surface
    singularity)."""
    d = A.shape[-1]
    rows, at_or_below, below, is_row = _rows(d, A.device)
    # the elimination runs on [M | R] at once: the same elementwise
    # arithmetic as on M and R apart, half the operations
    eye = torch.broadcast_to(torch.eye(d, dtype=A.dtype, device=A.device),
                             A.shape)
    MR = torch.cat([A, eye], dim=-1)

    for k in range(d):
        col = torch.where(at_or_below[k], torch.abs(MR[..., :, k]),
                          -torch.inf)
        p = torch.argmax(col, dim=-1, keepdim=True)           # (..., 1)
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        MR = torch.gather(MR, -2, perm[..., :, None].expand(MR.shape))
        f = torch.where(below[k], MR[..., :, k:k + 1]
                        / MR[..., k:k + 1, k:k + 1], 0.0)
        MR = MR - f * MR[..., k:k + 1, :]

    # back substitution: solve U X = R with U = M upper triangular
    M, R = MR[..., :d], MR[..., d:]
    X = torch.zeros_like(R)
    for k in reversed(range(d)):
        rhs = R[..., k:k + 1, :] - M[..., k:k + 1, :] @ X
        X = torch.where(is_row[k], rhs / M[..., k:k + 1, k:k + 1], X)
    return X if out is None else out.copy_(X)
