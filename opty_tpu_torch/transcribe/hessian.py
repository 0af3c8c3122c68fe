"""Structured Hessian recovery via colored Hessian-vector products.

The counterpart of opty_tpu/transcribe/hessian.py: the objective +
instance-constraint part of the Lagrangian Hessian is block-tridiagonal
in the node axis plus a dense border, so 3*(n+q) + bw Hessian-vector
products seeded by a 3-coloring of the node axis read off every entry
exactly.  See that module for the exactness conditions.
"""

import numpy as np
import torch
from torch.func import grad, jvp, vmap

from ..config import resolve_device

__all__ = ['make_hvp_seeds', 'make_structured_scalar_hessian',
           'structured_scalar_hessian', 'check_structured_hessian']


def make_hvp_seeds(N, n, q, bw, dtype, device=None):
    """(3*(n+q)+bw, nfree) seed matrix in free-vector layout, on
    ``device`` (None: the card).

    State loc < n lives at loc*N + node and unknown input loc in [n, nz)
    at n*N + (loc-n)*N + node, which is loc*N + node as well — one
    formula covers both."""
    device = resolve_device(device)
    nz = n + q
    nfree = nz * N + bw
    ncol = 3 * nz + bw
    i = torch.arange(nfree, device=device)
    r = torch.arange(ncol, device=device)
    loc_i = i // N
    node_i = i % N
    c_r = r // nz
    loc_r = r % nz
    main = ((i[None, :] < nz * N) & (r[:, None] < 3 * nz)
            & (loc_i[None, :] == loc_r[:, None])
            & (node_i[None, :] % 3 == c_r[:, None]))
    border = ((r[:, None] >= 3 * nz)
              & (i[None, :] == nz * N + (r[:, None] - 3 * nz)))
    return (main | border).to(dtype)


def structured_scalar_hessian(fun, free, N, n, q, bw, seeds=None):
    """Recover the block-tridiagonal + border Hessian of scalar ``fun``
    at one free vector.

    Returns (Hd (N,nz,nz), Ho (N,nz,nz) with Ho[k] the (k-1,k) block,
    Hw (N,nz,bw), Hww (bw,bw)).
    """
    nz = n + q
    if seeds is None:
        seeds = make_hvp_seeds(N, n, q, bw, free.dtype, free.device)

    grad_fn = grad(fun)

    def hvp(v):
        return jvp(grad_fn, (free,), (v,))[1]

    R = vmap(hvp)(seeds)                          # (ncol, nfree)

    # free layout -> node layout per row
    ncol = R.shape[0]
    X = R[:, :n * N].reshape(ncol, n, N)
    U = R[:, n * N:nz * N].reshape(ncol, q, N)
    Rn = torch.cat([X.transpose(1, 2), U.transpose(1, 2)], dim=2)
    Rw = R[:, nz * N:]                                     # (ncol, bw)

    dev = free.device
    nodes = torch.arange(N, device=dev)
    colsel = nodes % 3
    idx_mat = colsel[:, None] * nz + torch.arange(nz, device=dev)[None, :]

    # Hd[i][:, l] = Rn[colsel[i]*nz + l, i, :]
    gathered = Rn[idx_mat, nodes[:, None], :]               # (N, nz, nz)
    Hd = gathered.transpose(1, 2)

    # Ho[i] (block (i-1, i)): Ho[i][:, l] = Rn[colsel[i]*nz + l, i-1, :]
    prev_rows = torch.clamp(nodes - 1, min=0)
    Ho = Rn[idx_mat, prev_rows[:, None], :].transpose(1, 2)
    Ho = torch.cat([torch.zeros_like(Ho[:1]), Ho[1:]], dim=0)

    if bw:
        Hw = Rn[3 * nz:].permute(1, 2, 0)                   # (N, nz, bw)
        Hww = Rw[3 * nz:].T                                 # (bw, bw)
    else:
        Hw = free.new_zeros((N, nz, 0))
        Hww = free.new_zeros((0, 0))
    return Hd, Ho, Hw, Hww


def make_structured_scalar_hessian(N, n, q, bw, dtype):
    """Factory closing over the static shape parameters (``dtype`` is
    kept for the reference's signature: the seeds take ``free``'s)."""
    del dtype

    def run(fun, free):
        return structured_scalar_hessian(fun, free, N, n, q, bw)
    return run


def check_structured_hessian(fun, free, N, n, q, bw, seed=0):
    """Relative error of the recovered structured Hessian's action on
    a random probe against the true Hessian-vector product of ``fun``
    at ``free``: values well above sqrt(eps) mean ``fun`` couples nodes
    farther apart than the block-tridiagonal + border structure."""
    nz = n + q
    Hd, Ho, Hw, Hww = structured_scalar_hessian(fun, free, N, n, q, bw)
    rng = np.random.default_rng(seed)
    v = torch.as_tensor(rng.standard_normal(free.shape[0]),
                        dtype=free.dtype, device=free.device)

    vX = v[:n * N].reshape(n, N)
    vU = v[n * N:nz * N].reshape(q, N)
    vn = torch.cat([vX.T, vU.T], dim=1)                 # (N, nz)
    vw = v[nz * N:]

    zero = v.new_zeros((1, nz))
    vn_prev = torch.cat([zero, vn[:-1]], dim=0)
    vn_next = torch.cat([vn[1:], zero], dim=0)
    Ho_next = torch.cat([Ho[1:], v.new_zeros((1, nz, nz))], dim=0)
    rn = (torch.einsum('kij,kj->ki', Hd, vn)
          + torch.einsum('kji,kj->ki', Ho, vn_prev)
          + torch.einsum('kij,kj->ki', Ho_next, vn_next)
          + torch.einsum('kij,j->ki', Hw, vw))
    rw = torch.einsum('kij,ki->j', Hw, vn) + Hww @ vw

    back = torch.cat([rn[:, :n].T.reshape(-1),
                      rn[:, n:].T.reshape(-1), rw])
    true_hvp = jvp(grad(fun), (free,), (v,))[1]
    num = torch.linalg.norm(back - true_hvp)
    den = torch.clamp(torch.linalg.norm(true_hvp), min=1.0)
    return float(num / den)
