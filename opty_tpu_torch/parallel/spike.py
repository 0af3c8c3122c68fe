"""Node-axis-split KKT solve: SPIKE-style substructuring over a node mesh.

The counterpart of opty_tpu/parallel/spike.py.  The node axis of the
bordered block-tridiagonal KKT system is cut into P contiguous slabs of
L = N / P nodes (parallel/mesh.py: all P in this process as a leading
tensor axis, or one a rank of a process group) and solved by the
classic domain decomposition:

1. **Local factorization**, no communication: each slab's block
   tridiagonal with its first coupling block dropped (``Eint[0] = 0``)
   is the scan path's Schur recursion (``Mk = Ek S_{k-1}^-1``,
   ``Sk = Dk - Mk Ek^T``).  It runs through ops/scan_kernels.py's
   ``scan_factor``, the slabs as its lanes, with the *spike columns*
   ``[e0 (x) E_head | eL (x) E_tail^T | F]`` (and, in ``spike_solve``,
   the right-hand side) as its border: one launch gives ``S_inv``,
   ``Melim`` and the columns swept forward.  The backward sweep of the
   spikes is plain torch; a right-hand side alone is one ``scan_solve``
   launch (border width 0).
2. **Interface system**: the first and last node rows of every slab
   couple across slabs.  Their closure is a dense system of size
   2 P d + b assembled from the slabs' boundary rows (one ``gather``)
   and border sums (``psum``), solved redundantly by every slab with
   the plain block inverse.
3. **Local correction**, no communication.

A system the kernels do not take (``kernel_supported``: d above 64, or
spike columns 2 d + b (+ 1) above 64, as nlink-9's d = 50, b = 41)
raises on the card with its shape; on the CPU the same wrappers run
their plain versions.

Arrays take the whole node axis and any leading lane axes (where the
P slabs of L = ceil(N / P) nodes overrun N, decoupled unit nodes pad the
end; the JAX package's ``shard_map`` needs N divisible by P):
D, E (..., N, d, d) with E[..., 0, :, :] = 0, F (..., N, d, b), Kbb
(..., b, b), r (..., N, d), rb (..., b).  On a process group each rank
works on its own slab of them and the node outputs are gathered back
whole, as the JAX package's global arrays read; a ``SpikeFactorization``
holds the rank's slab.
"""

from typing import NamedTuple

import torch

from ..ops import scan_kernels as sk
from ..ops.smallblock import block_inv

__all__ = ['spike_solve', 'solve_structured_kkt_sharded',
           'SpikeFactorization', 'spike_factor', 'spike_apply']


def _local_factor(D, Eint):
    """Schur-recursion factorization of local block tridiagonals, slabs
    as lanes: D, Eint (..., L, d, d) with ``Eint[..., 0] = 0`` (the
    external coupling goes through the spike columns).  Returns (S_inv,
    Melim) as nlp/kkt.py's scan path.  The plain version, on any
    device: the yardstick of the kernel's (``_factor_with_columns``)."""
    none = D.new_zeros(D.shape[:-1] + (0,))
    S_inv, Melim, _, _ = sk.scan_factor_plain(
        D, Eint, none, D.new_zeros(D.shape[:-3] + (0, 0)))
    return S_inv, Melim


def _backward(S_inv, Eint, Rt):
    """The backward sweep X_k = S_k^-1 (Rt_k - E_{k+1}^T X_{k+1}) of
    forward-swept columns Rt (..., L, d, m)."""
    L = S_inv.shape[-3]
    X = torch.empty_like(Rt)
    x_next = None
    for k in reversed(range(L)):
        rhs = Rt[..., k, :, :]
        if x_next is not None:
            rhs = rhs - Eint[..., k + 1, :, :].transpose(-1, -2) @ x_next
        x_next = S_inv[..., k, :, :] @ rhs
        X[..., k, :, :] = x_next
    return X


def _local_solve(S_inv, Melim, Eint, R):
    """Solve T X = R for a stack of right-hand sides R (..., L, d, m),
    plain: the forward sweep rt_k = R_k - M_k rt_{k-1}, then
    ``_backward``."""
    L = S_inv.shape[-3]
    Rt = torch.empty_like(R)
    rt = torch.zeros_like(R[..., 0, :, :])
    for k in range(L):
        rt = R[..., k, :, :] - Melim[..., k, :, :] @ rt
        Rt[..., k, :, :] = rt
    return _backward(S_inv, Eint, Rt)


def _factor_with_columns(D, Eint, R):
    """The local factorization and the solve of T X = R in one
    ``scan_factor`` launch (R as its border; its border inverse is not
    used) and the backward sweep: (S_inv, Melim, X)."""
    c = R.shape[-1]
    S_inv, Melim, Rt, _ = sk.scan_factor(
        D, Eint, R, D.new_zeros(D.shape[:-3] + (c, c)))
    return S_inv, Melim, _backward(S_inv, Eint, Rt)


def _solve_one(S_inv, Melim, Eint, r):
    """T y = r for one right-hand side r (..., L, d): one ``scan_solve``
    launch with an empty border."""
    lead = S_inv.shape[:-3]
    d = S_inv.shape[-1]
    L = S_inv.shape[-3]
    y, _ = sk.scan_solve(
        S_inv, Melim, S_inv.new_zeros(lead + (L, d, 0)), Eint,
        S_inv.new_zeros(lead + (0, 0)), r.contiguous(),
        S_inv.new_zeros(lead + (0,)))
    return y


def _slabs(axis, a, unit=False):
    """(..., N, x, y) -> this process's slabs (local, ..., L, x, y),
    L = ceil(N / P).  Where P does not divide N the node axis is padded
    at its end with decoupled nodes: zero blocks, or unit diagonal
    blocks (``unit``, for D), so the padded system's solution is the
    original's followed by zeros."""
    lead, N = a.shape[:-3], a.shape[-3]
    P = axis.n_slabs
    L = -(-N // P)
    if L * P != N:
        pad = a.new_zeros(lead + (L * P - N,) + a.shape[-2:])
        if unit:
            pad = pad + torch.eye(a.shape[-1], dtype=a.dtype,
                                  device=a.device)
        a = torch.cat([a, pad], dim=-3)
    a = a.reshape(lead + (P, L) + a.shape[-2:])
    return axis.take(a.movedim(-4, 0)).contiguous()


def _whole(axis, u, N):
    """(local, ..., L, d) -> (..., N, d): every slab's rows, the padding
    dropped."""
    u = axis.gather(u)
    u = u.movedim(0, -3)
    return u.reshape(u.shape[:-3] + (-1, u.shape[-1]))[..., :N, :]


def _couplings(axis, E):
    """The coupling blocks of each slab to its neighbours, from its
    E (local, ..., L, d, d): E_head = E[0] (to the previous slab's last
    node) and E_tail^T, the transposed E[0] of the next slab (zero for
    the last); and Eint, E with E[0] = 0."""
    E_head = E[..., 0, :, :]
    E_tail_T = axis.next_first(E_head).transpose(-1, -2)
    Eint = E.clone()
    Eint[..., 0, :, :] = 0.0
    return E_head, E_tail_T, Eint


def _spike_columns(E_head, E_tail_T, F, L):
    """[e0 (x) E_head | eL (x) E_tail^T | F] (local, ..., L, d, 2 d + b)."""
    d = E_head.shape[-1]
    b = F.shape[-1]
    R = F.new_zeros(F.shape[:-1] + (2 * d + b,))
    R[..., 0, :, :d] = E_head
    R[..., L - 1, :, d:2 * d] = E_tail_T
    R[..., 2 * d:] = F
    return R


def _interface_offsets(nP, d):
    def fi(q):
        return q * 2 * d            # offset of u_first_q

    def li(q):
        return q * 2 * d + d        # offset of u_last_q

    return fi, li, 2 * nP * d


def _interface_matrix(axis, F, V, W, G, Kbb):
    """The interface system (..., 2 P d + b, 2 P d + b) over
    [u_first_p, u_last_p]_p + beta, replicated: the spikes' boundary
    rows gathered, the border products summed."""
    nP, d, b = axis.n_slabs, V.shape[-1], G.shape[-1]
    L = V.shape[-3]
    gath = axis.gather
    V0g, VLg = gath(V[..., 0, :, :]), gath(V[..., L - 1, :, :])  # (P, ., d, d)
    W0g, WLg = gath(W[..., 0, :, :]), gath(W[..., L - 1, :, :])
    fi, li, bo = _interface_offsets(nP, d)
    lead = V.shape[1:-3]
    A = torch.eye(bo + b, dtype=V.dtype, device=V.device).repeat(
        lead + (1, 1))
    for q in range(nP):
        if q > 0:
            A[..., fi(q):fi(q) + d, li(q - 1):li(q - 1) + d] += V0g[q]
            A[..., li(q):li(q) + d, li(q - 1):li(q - 1) + d] += VLg[q]
        if q < nP - 1:
            A[..., fi(q):fi(q) + d, fi(q + 1):fi(q + 1) + d] += W0g[q]
            A[..., li(q):li(q) + d, fi(q + 1):fi(q + 1) + d] += WLg[q]
    if b:
        FtVg = gath(torch.einsum('...kdb,...kde->...be', F, V))  # (P, ., b, d)
        FtWg = gath(torch.einsum('...kdb,...kde->...be', F, W))
        FtG_sum = axis.psum(torch.einsum('...kdb,...kde->...be', F, G))
        G0g, GLg = gath(G[..., 0, :, :]), gath(G[..., L - 1, :, :])
        for q in range(nP):
            A[..., fi(q):fi(q) + d, bo:] += G0g[q]
            A[..., li(q):li(q) + d, bo:] += GLg[q]
            if q > 0:
                A[..., bo:, li(q - 1):li(q - 1) + d] -= FtVg[q]
            if q < nP - 1:
                A[..., bo:, fi(q + 1):fi(q + 1) + d] -= FtWg[q]
        A[..., bo:, bo:] = Kbb - FtG_sum
    return A


def _interface_rhs(axis, F, Y, rb):
    """The interface right-hand side (..., 2 P d + b): every slab's
    first and last rows of Y, and rb less the summed F^T Y."""
    nP, d, b = axis.n_slabs, Y.shape[-1], F.shape[-1]
    L = Y.shape[-2]
    Y0g, YLg = axis.gather(Y[..., 0, :]), axis.gather(Y[..., L - 1, :])
    rows = torch.stack([Y0g, YLg], dim=1)                # (P, 2, ..., d)
    rows = rows.movedim((0, 1), (-3, -2))                # (..., P, 2, d)
    rhs = rows.reshape(rows.shape[:-3] + (2 * nP * d,))
    if b:
        FtY_sum = axis.psum(torch.einsum('...kdb,...kd->...b', F, Y))
        rhs = torch.cat([rhs, rb - FtY_sum], dim=-1)
    return rhs


def _correct(axis, Y, V, W, G, sol):
    """u = Y - V u_prev_last - W u_next_first - G beta for this
    process's slabs, from the interface solution sol (..., 2 P d + b)."""
    nP, d = axis.n_slabs, Y.shape[-1]
    bo = 2 * nP * d
    ends = sol[..., :bo].reshape(sol.shape[:-1] + (nP, 2, d))
    ends = ends.movedim(-3, 0)                           # (P, ..., 2, d)
    zero = torch.zeros_like(ends[:1, ..., 0, :])
    prev_last = axis.take(torch.cat([zero, ends[:-1, ..., 1, :]], dim=0))
    next_first = axis.take(torch.cat([ends[1:, ..., 0, :], zero], dim=0))
    u = (Y - (V @ prev_last[..., None, :, None])[..., 0]
         - (W @ next_first[..., None, :, None])[..., 0])
    beta = sol[..., bo:]
    if beta.shape[-1]:
        u = u - (G @ beta[..., None, :, None])[..., 0]
    return u, beta


def _mesh_axis(mesh, axis_name, device):
    if mesh.shape.get(axis_name) is None:
        raise ValueError("the mesh has no '{}' axis".format(axis_name))
    return mesh.axis(device)


def _spike_local(axis, D, E, F, Kbb, r, rb):
    """One fused solve over this process's slabs (local, ..., L, ·)."""
    L, d = D.shape[-3], D.shape[-1]
    b = F.shape[-1]
    E_head, E_tail_T, Eint = _couplings(axis, E)
    R = torch.cat([r[..., None], _spike_columns(E_head, E_tail_T, F, L)],
                  dim=-1)
    S_inv, Melim, X = _factor_with_columns(D, Eint, R)
    Y, V, W, G = (X[..., 0], X[..., 1:1 + d], X[..., 1 + d:1 + 2 * d],
                  X[..., 1 + 2 * d:])
    A = _interface_matrix(axis, F, V, W, G, Kbb)
    sol = (block_inv(A) @ _interface_rhs(axis, F, Y, rb)[..., None])[..., 0]
    return _correct(axis, Y, V, W, G, sol)


class SpikeFactorization(NamedTuple):
    """RHS-independent part of the SPIKE solve, reusable across
    iterative-refinement rounds and SOC re-solves (the contract of
    nlp.kkt.KKTFactorization, split over the node slabs).

    Slab fields are this process's slabs, (local, ..., L, ·); ``A_inv``
    (the inverse of the interface system) is replicated."""
    S_inv: torch.Tensor    # (local, ..., L, d, d) local Schur pivots
    Melim: torch.Tensor    # (local, ..., L, d, d) elimination multipliers
    Eint: torch.Tensor     # (local, ..., L, d, d) intra-slab sub-diagonal
    V: torch.Tensor        # (local, ..., L, d, d) spike to prev slab's last
    W: torch.Tensor        # (local, ..., L, d, d) spike to next slab's first
    G: torch.Tensor        # (local, ..., L, d, b) border spikes
    F: torch.Tensor        # (local, ..., L, d, b) border columns
    A_inv: torch.Tensor    # (..., 2 P d + b, 2 P d + b) interface inverse


def _spike_factor_local(axis, D, E, F, Kbb):
    L, d = D.shape[-3], D.shape[-1]
    E_head, E_tail_T, Eint = _couplings(axis, E)
    S_inv, Melim, X = _factor_with_columns(
        D, Eint, _spike_columns(E_head, E_tail_T, F, L))
    V, W, G = X[..., :d], X[..., d:2 * d], X[..., 2 * d:]
    A_inv = block_inv(_interface_matrix(axis, F, V, W, G, Kbb))
    return SpikeFactorization(S_inv, Melim, Eint, V, W, G, F, A_inv)


def _spike_apply_local(axis, fac, r, rb):
    Y = _solve_one(fac.S_inv, fac.Melim, fac.Eint, r)
    sol = (fac.A_inv @ _interface_rhs(axis, fac.F, Y, rb)[..., None])[..., 0]
    return _correct(axis, Y, fac.V, fac.W, fac.G, sol)


def spike_factor(D, E, F, Kbb, mesh, axis_name='node'):
    """The split RHS-independent factorization (see
    :class:`SpikeFactorization`); layout as in :func:`spike_solve`."""
    axis = _mesh_axis(mesh, axis_name, D.device)
    return _spike_factor_local(axis, _slabs(axis, D, unit=True),
                               _slabs(axis, E), _slabs(axis, F), Kbb)


def spike_apply(fac: SpikeFactorization, r, rb, mesh, axis_name='node'):
    """Solve with a :class:`SpikeFactorization`: r (..., N, d), rb
    (..., b) -> (u (..., N, d), beta (..., b))."""
    axis = _mesh_axis(mesh, axis_name, r.device)
    u, beta = _spike_apply_local(axis, fac, _slabs(axis, r[..., None])[..., 0],
                                 rb)
    return _whole(axis, u, r.shape[-2]), beta


def spike_solve(D, E, F, Kbb, r, rb, mesh, axis_name='node'):
    """Split solve of the bordered block-tridiagonal system.

    ``D (..., N, d, d)``, ``E (..., N, d, d)`` (E[..., 0] = 0), ``F
    (..., N, d, b)``, ``Kbb (..., b, b)``, ``r (..., N, d)``, ``rb
    (..., b)``; the node axis is cut into ``mesh.shape[axis_name]``
    slabs.  Returns (u (..., N, d), beta (..., b))."""
    axis = _mesh_axis(mesh, axis_name, D.device)
    u, beta = _spike_local(
        axis, _slabs(axis, D, unit=True), _slabs(axis, E), _slabs(axis, F),
        Kbb, _slabs(axis, r[..., None])[..., 0], rb)
    return _whole(axis, u, r.shape[-2]), beta


def solve_structured_kkt_sharded(blocks, r_nodes, r_border, mesh,
                                 axis_name='node', factor_dtype=None,
                                 refine_steps=1):
    """Node-split counterpart of nlp.kkt.solve_structured_kkt: the same
    equilibration and mixed-precision iterative-refinement contract,
    with the factorization and solves split by :func:`spike_factor` and
    :func:`spike_apply` and the refinement operator applied whole."""
    from ..nlp.kkt import _assemble_node_blocks, _equilibrate, kkt_matvec

    work_dtype = blocks.Hd.dtype
    D, E, F, Kbb = _assemble_node_blocks(blocks)
    D, E, F, Kbb, sn, sb = _equilibrate(D, E, F, Kbb)
    if factor_dtype is not None:
        D, E, F, Kbb = (a.to(factor_dtype) for a in (D, E, F, Kbb))

    fac = spike_factor(D, E, F, Kbb, mesh, axis_name)

    def one_solve(rn, rbdr):
        u, beta = spike_apply(fac, (rn * sn).to(D.dtype),
                              (rbdr * sb).to(D.dtype), mesh, axis_name)
        return (u * sn).to(work_dtype), (beta * sb).to(work_dtype)

    u, beta = one_solve(r_nodes, r_border)
    for _ in range(refine_steps):
        Ku, Kb = kkt_matvec(blocks, u, beta)
        du, dbeta = one_solve(r_nodes - Ku, r_border - Kb)
        u = u + du
        beta = beta + dbeta
    return u, beta
