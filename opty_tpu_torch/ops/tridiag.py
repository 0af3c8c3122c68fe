"""Parallel cyclic reduction (PCR) for the bordered block-tridiagonal
KKT system, node axis last.

The counterpart of opty_tpu/ops/tridiag.py.  PCR restructures the
sequential block elimination into ceil(log2 N) levels: at level l every
equation k eliminates its neighbours at distance s = 2**l at once, so
each level is a batch of small block products and inverses over all
nodes and instances.  The level loop and the right-hand-side downsweep
run in the CUDA kernels of ops/pcr_kernels.py on the card (their plain
versions on the CPU); the border Schur complement is formed here and
inverted by the ``block_inv`` kernel (ops/block_kernels.py).  On the
card a system the kernels do not take (``pcr_kernels.kernel_supported``:
d or b above 64, or an r beyond a cluster's shared memory) raises with
its shape; the plain versions serve CPU tensors only.

After elimination each node satisfies ``D_k u_k + F'_k beta = r'_k``;
substituting into the border rows gives a small dense Schur complement
solved once.  No inter-block pivoting: like the JAX package, the solver
relies on Jacobi equilibration and iterative refinement (nlp/kkt.py).

Every function broadcasts over leading batch axes; outputs keep the
caller's node count N (no padding).
"""

from typing import NamedTuple

import torch

from .lanes import matvec_nl

__all__ = ['PCRFactorization', 'pcr_factor', 'pcr_solve', 'num_levels']


class PCRFactorization(NamedTuple):
    A: torch.Tensor          # (..., L, d, d, N) lower elimination multipliers
    B: torch.Tensor          # (..., L, d, d, N) upper elimination multipliers
    Dinv: torch.Tensor       # (..., d, d, N) inverses of the final diagonal
    Fp: torch.Tensor         # (..., d, b, N) fully-eliminated border columns
    Z: torch.Tensor          # (..., d, b, N) Dinv^T @ F_original
    schur_inv: torch.Tensor  # (..., b, b) inverse of the border Schur compl.


def num_levels(n):
    """ceil(log2 n): levels needed so the final stride covers n."""
    return max(1, (n - 1).bit_length())


def _down(x, s):
    """x[..., k] -> value at node k-s (zeros at the low boundary)."""
    return torch.cat([torch.zeros_like(x[..., :s]), x[..., :-s]], dim=-1)


def _up(x, s):
    """x[..., k] -> value at node k+s (zeros at the high boundary)."""
    return torch.cat([x[..., s:], torch.zeros_like(x[..., :s])], dim=-1)


def _flat(x, tail):
    """Collapse the leading axes of ``x`` into one batch axis."""
    lead = x.shape[:x.ndim - tail]
    return x.reshape((lead.numel(),) + tuple(x.shape[x.ndim - tail:]))


def pcr_factor(D, E, F, Kbb):
    """PCR factorization of the bordered block-tridiagonal system.

    Inputs are node-last: D (..., d, d, N), E (..., d, d, N) with
    E[..., 0] = 0, F (..., d, b, N), Kbb (..., b, b).  Equation k reads
    ``E_k u_{k-1} + D_k u_k + E_{k+1}^T u_{k+1} + F_k beta = r_k``, plus
    the border rows ``sum_k F_k^T u_k + Kbb beta = rb``.

    The levels (see opty_tpu's pcr_factor for the recurrence) run in
    ``pcr_factor_levels``; the border Schur complement is formed here.
    """
    from . import pcr_kernels as pk
    lead = D.shape[:-3]
    d, N = D.shape[-3], D.shape[-1]
    b = F.shape[-2]
    A, B, Dinv, Fp, Z = pk.pcr_factor_levels(
        _flat(D, 3).contiguous(), _flat(E, 3).contiguous(),
        _flat(F, 3).contiguous())
    L = A.shape[1]
    A = A.reshape(lead + (L, d, d, N))
    B = B.reshape(lead + (L, d, d, N))
    Dinv = Dinv.reshape(lead + (d, d, N))
    Fp = Fp.reshape(lead + (d, b, N))
    Z = Z.reshape(lead + (d, b, N))
    if b:
        schur = Kbb - torch.einsum('...dbn,...den->...be', Z, Fp)
        schur_inv = _small_inv(schur)
    else:
        schur_inv = D.new_zeros(lead + (0, 0))
    return PCRFactorization(A=A, B=B, Dinv=Dinv, Fp=Fp, Z=Z,
                            schur_inv=schur_inv)


def _small_inv(A):
    """Inverse of the (..., b, b) border Schur complements: the
    ``block_inv`` kernel on the card, its plain version (block_inv_nl,
    as before the kernel existed) on the CPU."""
    from .block_kernels import block_inv
    return block_inv(A.contiguous())


def pcr_solve(fac: PCRFactorization, r_nodes, r_border):
    """Solve with a PCR factorization.  r_nodes (..., d, N),
    r_border (..., b)."""
    from . import pcr_kernels as pk
    dtype = fac.Dinv.dtype
    r = r_nodes.to(dtype)
    rb = r_border.to(dtype)
    r = pk.pcr_downsweep(_flat(fac.A, 4).contiguous(),
                         _flat(fac.B, 4).contiguous(),
                         _flat(r, 2).contiguous()
                         ).reshape(fac.Dinv.shape[:-3] + r.shape[-2:])
    return _pcr_backsolve(fac, r, rb)


def _pcr_backsolve(fac, r, rb):
    """Border elimination + diagonal solve after the downsweep."""
    if fac.Fp.shape[-2]:
        rb_red = rb - torch.einsum('...dbn,...dn->...b', fac.Z, r)
        beta = torch.einsum('...be,...e->...b', fac.schur_inv, rb_red)
        rhs = r - torch.sum(fac.Fp * beta[..., None, :, None], dim=-2)
    else:
        beta = r.new_zeros(r.shape[:-2] + (0,))
        rhs = r
    return matvec_nl(fac.Dinv, rhs), beta
