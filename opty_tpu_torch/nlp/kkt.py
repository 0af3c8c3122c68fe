"""Structured KKT solves for collocation NLPs.

The counterpart of opty_tpu/nlp/kkt.py.  In node-major order the
primal-dual KKT matrix of a collocation NLP is symmetric
block-tridiagonal with a small dense border (unknown parameters, free
``h`` and the instance-constraint rows).  Two factorizations of it:

* ``'scan'`` (``factor_kkt``/``solve_factored``): the sequential block
  elimination, a Schur-complement recursion over the nodes with the
  border Schur complement accumulated along, then a small dense border
  solve and block back substitution.  The JAX package's ``lax.scan``
  recursions run in ops/scan_kernels.py: on the card a factorization is
  one ``scan_factor`` launch and a solve one ``scan_solve`` launch
  (a thread block per lane walking its nodes), on the CPU the plain
  node loops.  Refinement applies the operator from the blocks
  (``kkt_matvec``).
* ``'cr'`` (``factor_kkt_cr``): assembled node-last, factored by
  parallel cyclic reduction (ops/tridiag.py); the float64 operator rides
  along for iterative refinement.

Both equilibrate (Jacobi scaling) and cast to the factorization dtype.
Every function takes a leading lane axis (any leading axes broadcast):
the solver carries B lanes explicitly instead of vmapping.  The third
method, ``'spike'``, splits the node axis over a mesh
(parallel/spike.py; nlp/collocation.py wires it in).
"""

from typing import Any, NamedTuple

import torch

from ..ops import scan_kernels as sk
from ..ops.lanes import matvec_nl, to_lanes, transpose_nl

__all__ = ['KKTBlocks', 'KKTFactorization', 'CRFactorization', 'METHODS',
           'check_method', 'factor_kkt', 'solve_factored', 'kkt_matvec',
           'factor_kkt_cr', 'matvec_assembled_nl', 'solve_factored_cr_nl',
           'solve_structured_kkt']

METHODS = ('scan', 'cr', 'spike')


def check_method(method):
    """Raise for an unknown KKT method."""
    if method not in METHODS:
        raise ValueError("kkt_method must be one of {}, not {!r}".format(
            METHODS, method))


class KKTBlocks(NamedTuple):
    """Blocks of the symmetric collocation KKT matrix (leading lane axes
    omitted below).

    Per node the variable block is ``u_k = [dz_k (nz); dy_k (M)]``; the
    k = 0 constraint block is a structural dummy (P[0] = Q[0] = C[0] = 0,
    Ds[0] = 1).  Border variables are ``beta = [dw (bw); dy_inst (o)]``.
    """
    Hd: torch.Tensor    # (N, nz, nz) diagonal Hessian blocks (incl. Sigma_x)
    Ho: torch.Tensor    # (N, nz, nz) block (k-1, k); Ho[0] unused
    Hw: torch.Tensor    # (N, nz, bw) Hessian cross blocks with border w
    Hww: torch.Tensor   # (bw, bw) border Hessian (incl. Sigma_w)
    P: torch.Tensor     # (N, M, nz) d c_k / d z_k
    Q: torch.Tensor     # (N, M, nz) d c_k / d z_{k-1}
    C: torch.Tensor     # (N, M, bw) d c_k / d w
    Ds: torch.Tensor    # (N, M) slack diagonal of constraint rows (>= 0)
    Gz: torch.Tensor    # (o, N, nz) instance-constraint rows wrt z
    Gw: torch.Tensor    # (o, bw) instance-constraint rows wrt w
    Di: torch.Tensor    # (o,) slack diagonal of instance rows


def _diag_embed_nl(v):
    """(..., M, N) -> (..., M, M, N) diagonal blocks, node-last."""
    M = v.shape[-2]
    eye = torch.eye(M, dtype=v.dtype, device=v.device)[:, :, None]
    return eye * v[..., :, None, :]


def _assemble_node_blocks_nl(blocks: KKTBlocks):
    """Node-last assembly: returns D (..., d, d, N), E (..., d, d, N),
    F (..., d, b, N) and the border matrix Kbb (..., b, b)."""
    lead = blocks.Hd.shape[:-3]
    N, nz = blocks.Hd.shape[-3], blocks.Hd.shape[-1]
    M = blocks.P.shape[-2]
    bw = blocks.Hw.shape[-1]
    o = blocks.Gz.shape[-3]
    d = nz + M
    dt, dev = blocks.Hd.dtype, blocks.Hd.device
    new = lambda *shape: torch.zeros(lead + shape, dtype=dt, device=dev)

    PT = to_lanes(blocks.P)                         # (M, nz, N)
    D = new(d, d, N)
    D[..., :nz, :nz, :] = to_lanes(blocks.Hd)
    D[..., :nz, nz:, :] = transpose_nl(PT)
    D[..., nz:, :nz, :] = PT
    D[..., nz:, nz:, :] = -_diag_embed_nl(blocks.Ds.transpose(-1, -2))

    E = new(d, d, N)
    E[..., :nz, :nz, :] = transpose_nl(to_lanes(blocks.Ho))
    E[..., nz:, :nz, :] = to_lanes(blocks.Q)
    E[..., 0] = 0.0

    F = new(d, bw + o, N)
    F[..., :nz, :bw, :] = to_lanes(blocks.Hw)
    if o:
        F[..., :nz, bw:, :] = blocks.Gz.permute(
            *range(len(lead)), -1, -3, -2)
    F[..., nz:, :bw, :] = to_lanes(blocks.C)

    return D, E, F, _assemble_border(blocks)


def _equilibrate_nl(D, E, F, Kbb):
    """Symmetric Jacobi scaling s_i = 1/sqrt(|K_ii|), node-last.

    The barrier diagonal spans many orders of magnitude, which wrecks a
    float32 factorization long before the float64 operator degrades;
    the scaling compresses that range.  The floor is relative to the
    largest node diagonal of each lane.  Scales are sn (..., d, N) and
    sb (..., b)."""
    d = D.shape[-3]
    diag_nodes = torch.abs(torch.stack([D[..., i, i, :] for i in range(d)],
                                       dim=-2))                # (..., d, N)
    diag_border = torch.abs(torch.diagonal(Kbb, dim1=-2, dim2=-1))
    big = torch.clamp(torch.amax(diag_nodes, dim=(-2, -1)), min=1.0)
    floor = 1e-12 * big
    sn = _inv_sqrt(diag_nodes, floor[..., None, None])
    sb = _inv_sqrt(diag_border, floor[..., None]) if diag_border.numel() \
        else diag_border
    D = D * sn[..., :, None, :] * sn[..., None, :, :]
    sn_prev = torch.cat([sn[..., :1], sn[..., :-1]], dim=-1)
    E = E * sn[..., :, None, :] * sn_prev[..., None, :, :]
    F = F * sn[..., :, None, :] * sb[..., None, :, None]
    Kbb = Kbb * sb[..., :, None] * sb[..., None, :]
    return D, E, F, Kbb, sn, sb


class KKTFactorization(NamedTuple):
    """Scan factorization, lanes first like every solver array (the
    solver selects lanes of it).  On the card every array is contiguous
    as the kernels take it; on the CPU the per-node arrays are views of
    node-major storage, (N, ..., ·) in memory, so each step of the plain
    recursions reads and writes one contiguous slice over the lanes."""
    S_inv: torch.Tensor          # (..., N, d, d) inverses of the Schur pivots
    Melim: torch.Tensor          # (..., N, d, d) multipliers E_k S_{k-1}^-1
    Ft: torch.Tensor             # (..., N, d, b) eliminated border columns
    E: torch.Tensor              # (..., N, d, d) sub-diagonal blocks
    Kbb_schur_inv: torch.Tensor  # (..., b, b) inverse border Schur complement
    scale_nodes: torch.Tensor    # (..., N, d) Jacobi equilibration scales
    scale_border: torch.Tensor   # (..., b)


def _assemble_border(blocks: KKTBlocks):
    """The dense border matrix Kbb (..., b, b)."""
    lead = blocks.Hww.shape[:-2]
    bw = blocks.Hww.shape[-1]
    o = blocks.Gz.shape[-3]
    Kbb = blocks.Hww.new_zeros(lead + (bw + o, bw + o))
    Kbb[..., :bw, :bw] = blocks.Hww
    if o:
        Kbb[..., :bw, bw:] = blocks.Gw.transpose(-1, -2)
        Kbb[..., bw:, :bw] = blocks.Gw
        Kbb[..., bw:, bw:] = -torch.diag_embed(blocks.Di)
    return Kbb


def _assemble_node_blocks(blocks: KKTBlocks):
    """Node-major assembly: returns D (..., N, d, d), E (..., N, d, d),
    F (..., N, d, b) and the border matrix Kbb (..., b, b)."""
    lead = blocks.Hd.shape[:-3]
    N, nz = blocks.Hd.shape[-3], blocks.Hd.shape[-1]
    M = blocks.P.shape[-2]
    bw = blocks.Hw.shape[-1]
    o = blocks.Gz.shape[-3]
    d = nz + M
    new = lambda *shape: blocks.Hd.new_zeros(lead + shape)

    D = new(N, d, d)
    D[..., :nz, :nz] = blocks.Hd
    D[..., :nz, nz:] = blocks.P.transpose(-1, -2)
    D[..., nz:, :nz] = blocks.P
    D[..., nz:, nz:] = torch.diag_embed(-blocks.Ds)

    E = new(N, d, d)
    E[..., :nz, :nz] = blocks.Ho.transpose(-1, -2)
    E[..., nz:, :nz] = blocks.Q
    E[..., 0, :, :] = 0.0

    F = new(N, d, bw + o)
    F[..., :nz, :bw] = blocks.Hw
    if o:
        F[..., :nz, bw:] = blocks.Gz.movedim(-3, -1)
    F[..., nz:, :bw] = blocks.C
    return D, E, F, _assemble_border(blocks)


def _inv_sqrt(v, floor):
    return 1.0 / torch.sqrt(torch.maximum(v, floor))


def _equilibrate(D, E, F, Kbb):
    """Symmetric Jacobi scaling s_i = 1/sqrt(|K_ii|) of the node-major
    blocks (see _equilibrate_nl); the floor is relative to the largest
    node diagonal of each lane.  Scales are sn (..., N, d), sb (..., b).
    """
    diag_nodes = torch.abs(torch.diagonal(D, dim1=-2, dim2=-1))
    diag_border = torch.abs(torch.diagonal(Kbb, dim1=-2, dim2=-1))
    big = torch.clamp(torch.amax(diag_nodes, dim=(-2, -1)), min=1.0)
    floor = 1e-12 * big
    sn = _inv_sqrt(diag_nodes, floor[..., None, None])
    sb = _inv_sqrt(diag_border, floor[..., None]) if diag_border.numel() \
        else diag_border
    D = D * sn[..., :, :, None] * sn[..., :, None, :]
    sn_prev = torch.cat([sn[..., :1, :], sn[..., :-1, :]], dim=-2)
    E = E * sn[..., :, :, None] * sn_prev[..., :, None, :]
    F = F * sn[..., :, :, None] * sb[..., None, None, :]
    Kbb = Kbb * sb[..., :, None] * sb[..., None, :]
    return D, E, F, Kbb, sn, sb


def _cast_blocks(blocks: KKTBlocks, factor_dtype):
    """The blocks in the factorization dtype (placement and scaling then
    run in it; refinement uses the uncast blocks)."""
    if factor_dtype is None or blocks.Hd.dtype == factor_dtype:
        return blocks
    return KKTBlocks(*[a.to(factor_dtype) for a in blocks])


def factor_kkt(blocks: KKTBlocks, factor_dtype=None) -> KKTFactorization:
    """Block-tridiagonal forward elimination with border Schur
    accumulation.  RHS-independent; reused by every refinement solve."""
    blocks = _cast_blocks(blocks, factor_dtype)
    D, E, F, Kbb, sn, sb = _equilibrate(*_assemble_node_blocks(blocks))
    S_inv, Melim, Ft, Kbb_schur_inv = sk.scan_factor(D, E, F, Kbb)
    return KKTFactorization(S_inv, Melim, Ft, E, Kbb_schur_inv, sn, sb)


def solve_factored(fac: KKTFactorization, r_nodes, r_border):
    """Solve with a scan factorization: r_nodes (..., N, d), r_border
    (..., b) -> (u (..., N, d), beta (..., b)).

    The rhs and solution go through the equilibration scales
    (K = S^-1 K~ S^-1  =>  u = S K~^-1 S r)."""
    dtype = fac.S_inv.dtype
    r = (r_nodes * fac.scale_nodes).to(dtype).contiguous()
    rb = (r_border * fac.scale_border).to(dtype).contiguous()
    u, beta = sk.scan_solve(fac.S_inv, fac.Melim, fac.Ft, fac.E,
                            fac.Kbb_schur_inv, r, rb)
    return u * fac.scale_nodes, beta * fac.scale_border


def kkt_matvec(blocks: KKTBlocks, u, beta):
    """Apply the full KKT operator from its blocks: u (..., N, d),
    beta (..., b) -> (K @ [u; beta]) split the same way.  Used for the
    scan path's iterative refinement."""
    nz = blocks.Hd.shape[-1]
    M = blocks.P.shape[-2]
    bw = blocks.Hw.shape[-1]
    o = blocks.Gz.shape[-3]
    z, y = u[..., :nz], u[..., nz:nz + M]
    w, yi = beta[..., :bw], beta[..., bw:]

    def prev(a):                   # value at node k-1, zero at k = 0
        return torch.cat([torch.zeros_like(a[..., :1, :]),
                          a[..., :-1, :]], dim=-2)

    def nxt(a):                    # value at node k+1, zero at k = N-1
        return torch.cat([a[..., 1:, :], torch.zeros_like(a[..., :1, :])],
                         dim=-2)

    def nxt_block(a):
        return torch.cat([a[..., 1:, :, :],
                          torch.zeros_like(a[..., :1, :, :])], dim=-3)

    ein = torch.einsum
    z_prev = prev(z)
    # z rows: Hd_k z_k + Ho_k^T z_{k-1} + Ho_{k+1} z_{k+1} + Hw_k w
    #         + P_k^T y_k + Q_{k+1}^T y_{k+1} + Gz_k^T yi
    rz = (ein('...kij,...kj->...ki', blocks.Hd, z)
          + ein('...kji,...kj->...ki', blocks.Ho, z_prev)
          + ein('...kij,...kj->...ki', nxt_block(blocks.Ho), nxt(z))
          + ein('...kij,...j->...ki', blocks.Hw, w)
          + ein('...kji,...kj->...ki', blocks.P, y)
          + ein('...kji,...kj->...ki', nxt_block(blocks.Q), nxt(y)))
    if o:
        rz = rz + ein('...oki,...o->...ki', blocks.Gz, yi)

    # y rows: P_k z_k + Q_k z_{k-1} + C_k w - Ds_k y_k
    ry = (ein('...kij,...kj->...ki', blocks.P, z)
          + ein('...kij,...kj->...ki', blocks.Q, z_prev)
          + ein('...kij,...j->...ki', blocks.C, w)
          - blocks.Ds * y)

    # w rows: sum_k Hw_k^T z_k + Hww w + sum_k C_k^T y_k + Gw^T yi
    rw = (ein('...kij,...ki->...j', blocks.Hw, z)
          + ein('...ij,...j->...i', blocks.Hww, w)
          + ein('...kij,...ki->...j', blocks.C, y))
    if o:
        rw = rw + ein('...ij,...i->...j', blocks.Gw, yi)
        # instance rows: sum_k Gz z_k + Gw w - Di yi
        ri = (ein('...oki,...ki->...o', blocks.Gz, z)
              + ein('...ij,...j->...i', blocks.Gw, w) - blocks.Di * yi)
    else:
        ri = yi
    return torch.cat([rz, ry], dim=-1), torch.cat([rw, ri], dim=-1)


class CRFactorization(NamedTuple):
    """PCR factorization + equilibration scales + the full-precision
    assembled node-last operator (for the refinement matvecs)."""
    fac: Any
    sn: torch.Tensor
    sb: torch.Tensor
    D: torch.Tensor       # (..., d, d, N) full precision
    E: torch.Tensor       # (..., d, d, N), E[..., 0] = 0
    F: torch.Tensor       # (..., d, b, N)
    Kbb: torch.Tensor     # (..., b, b)


def factor_kkt_cr(blocks: KKTBlocks, factor_dtype=None):
    """Parallel-cyclic-reduction factorization: assembly once in full
    precision, equilibration and factorization in ``factor_dtype``."""
    from ..ops.tridiag import pcr_factor
    D, E, F, Kbb = _assemble_node_blocks_nl(blocks)
    if factor_dtype is not None and factor_dtype != D.dtype:
        Dc, Ec, Fc, Kbbc = (D.to(factor_dtype), E.to(factor_dtype),
                            F.to(factor_dtype), Kbb.to(factor_dtype))
    else:
        Dc, Ec, Fc, Kbbc = D, E, F, Kbb
    Dc, Ec, Fc, Kbbc, sn, sb = _equilibrate_nl(Dc, Ec, Fc, Kbbc)
    fac = pcr_factor(Dc, Ec, Fc, Kbbc)
    return CRFactorization(fac, sn, sb, D, E, F, Kbb)


def matvec_assembled_nl(cf: CRFactorization, u, beta):
    """Apply the full-precision KKT operator in node-last layout:
    u (..., d, N), beta (..., b) -> (K @ [u; beta]) split the same way."""
    from ..ops.tridiag import _down, _up
    node = (matvec_nl(cf.D, u)
            + matvec_nl(cf.E, _down(u, 1))
            + matvec_nl(transpose_nl(_up(cf.E, 1)), _up(u, 1)))
    b = cf.F.shape[-2]
    if b:
        node = node + torch.sum(cf.F * beta[..., None, :, None], dim=-2)
        border = (torch.einsum('...dbn,...dn->...b', cf.F, u)
                  + torch.einsum('...be,...e->...b', cf.Kbb, beta))
    else:
        border = u.new_zeros(u.shape[:-2] + (0,))
    return node, border


def solve_factored_cr_nl(cf: CRFactorization, r_nl, r_border):
    """Node-last solve: r_nl (..., d, N) -> u (..., d, N)."""
    from ..ops.tridiag import pcr_solve
    u, beta = pcr_solve(cf.fac, r_nl * cf.sn, r_border * cf.sb)
    return u * cf.sn, beta * cf.sb


def solve_structured_kkt(blocks: KKTBlocks, r_nodes, r_border,
                         factor_dtype=None, refine_steps=1,
                         method='scan'):
    """Solve K [u; beta] = [r_nodes (..., N, d); r_border (..., b)].

    The factorization runs once in ``factor_dtype``; ``refine_steps``
    rounds of iterative refinement with the full-precision operator
    recover accuracy.  ``method``: 'scan' (sequential block LU, lowest
    flops) or 'cr' (cyclic reduction, log depth); 'spike' needs a mesh
    (parallel.spike.solve_structured_kkt_sharded)."""
    check_method(method)
    if method == 'spike':
        raise ValueError("method='spike' splits the node axis over a mesh: "
                         'use parallel.spike.solve_structured_kkt_sharded')
    work_dtype = blocks.Hd.dtype
    if method == 'cr':
        cf = factor_kkt_cr(blocks, factor_dtype=factor_dtype)
        r_nl = r_nodes.transpose(-1, -2)
        u, beta = solve_factored_cr_nl(cf, r_nl, r_border)
        u = u.to(work_dtype)
        beta = beta.to(work_dtype)
        for _ in range(refine_steps):
            Ku, Kb = matvec_assembled_nl(cf, u, beta)
            du, dbeta = solve_factored_cr_nl(cf, r_nl - Ku, r_border - Kb)
            u = u + du.to(work_dtype)
            beta = beta + dbeta.to(work_dtype)
        return u.transpose(-1, -2), beta

    fac = factor_kkt(blocks, factor_dtype=factor_dtype)
    u, beta = solve_factored(fac, r_nodes, r_border)
    u = u.to(work_dtype)
    beta = beta.to(work_dtype)
    for _ in range(refine_steps):
        Ku, Kb = kkt_matvec(blocks, u, beta)
        du, dbeta = solve_factored(fac, r_nodes - Ku, r_border - Kb)
        u = u + du.to(work_dtype)
        beta = beta + dbeta.to(work_dtype)
    return u, beta
