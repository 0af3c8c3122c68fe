"""How far round-off alone moves one nlink-9 interior-point iteration.

    JAX_PLATFORMS=cpu python scripts/nlink_scan_sensitivity.py [scan|cr]

Builds the nlink-9 chain at N = 60 (models/nlink.py) on the CPU with
chip_smoke.py's phase-7 options and a float64 factorization, runs the
first iteration, and from that state takes one iteration several ways
that differ only in the order of floating-point operations inside the
KKT factorization's plain versions:

* ``products``: the factor's block products summed through BLAS
  (``torch.matmul``) instead of in index order (scan: M_k = E_k S^-1 and
  S_k = D_k - M_k E_k^T, ops/scan_kernels.py; cr: every level product,
  ops/lanes.py:matmul_nl);
* ``back substitution``: the inverse's back substitution summed in index
  order instead of through BLAS (scan, ops/smallblock.py);
* ``Gauss-Jordan``: the pivot inverses by Gauss-Jordan elimination with
  the same pivot rule instead of elimination and back substitution.

It prints, for each, the largest relative difference of the next x, y,
zL and zU from the unchanged plain versions' (max |diff| / max |ref|):
the size of the differences that a kernel summing in another order
(tensor cores, fused multiply-adds, another inverse) must be expected
to show at that state.  About 40 s a method on 4 threads.
"""

import sys
import time

import numpy as np
import torch

sys.path.insert(0, __file__.rsplit('/scripts/', 1)[0])

from opty_tpu_torch import interop                       # noqa: E402
from opty_tpu_torch.models.nlink import (n_link_cart_problem,  # noqa: E402
                                         n_link_initial_guess)
from opty_tpu_torch.ops import pcr_kernels                # noqa: E402
from opty_tpu_torch.ops import scan_kernels, smallblock   # noqa: E402

OPTIONS = dict(max_iter=1500, mu_init=1e-5, use_soc=False, max_rest_visit=0,
               dw_decay='hold')      # chip_smoke.py:NLINK_OPTIONS


def gauss_jordan(A):
    """Inverse of (..., d, d) by Gauss-Jordan elimination on [A | I] with
    smallblock.block_inv's pivot rule, eliminating above and below."""
    d = A.shape[-1]
    rows = torch.arange(d)
    eye = torch.broadcast_to(torch.eye(d, dtype=A.dtype), A.shape)
    MR = torch.cat([A, eye], dim=-1)
    for k in range(d):
        col = torch.where(rows >= k, torch.abs(MR[..., :, k]), -torch.inf)
        p = torch.argmax(col, dim=-1, keepdim=True)
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        MR = torch.gather(MR, -2, perm[..., :, None].expand(MR.shape))
        prow = MR[..., k:k + 1, :] / MR[..., k:k + 1, k:k + 1]
        f = torch.where((rows == k)[:, None], 0.0, MR[..., :, k:k + 1])
        MR = torch.where((rows == k)[:, None], prow, MR - f * prow)
    return MR[..., d:]


def inverse_in_order(A, out=None):
    """smallblock.block_inv with its back substitution summed in index
    order (an explicit loop) instead of through BLAS."""
    d = A.shape[-1]
    rows, at_or_below, below, _ = smallblock._rows(d, A.device)
    eye = torch.broadcast_to(torch.eye(d, dtype=A.dtype), A.shape)
    MR = torch.cat([A, eye], dim=-1)
    for k in range(d):
        col = torch.where(at_or_below[k], torch.abs(MR[..., :, k]), -torch.inf)
        p = torch.argmax(col, dim=-1, keepdim=True)
        perm = torch.where(rows == k, p, torch.where(rows == p, k, rows))
        MR = torch.gather(MR, -2, perm[..., :, None].expand(MR.shape))
        f = torch.where(below[k], MR[..., :, k:k + 1]
                        / MR[..., k:k + 1, k:k + 1], 0.0)
        MR = MR - f * MR[..., k:k + 1, :]
    M, R = MR[..., :d], MR[..., d:]
    X = torch.zeros_like(R)
    for k in reversed(range(d)):
        acc = M[..., k, 0:1] * X[..., 0, :]
        for j in range(1, d):
            acc = acc + M[..., k, j:j + 1] * X[..., j, :]
        X[..., k, :] = (R[..., k, :] - acc) / M[..., k, k:k + 1]
    return X if out is None else out.copy_(X)


def variants(method):
    """(name, {module attribute: replacement}) for ``method``."""
    if method == 'scan':
        return (('products', {(scan_kernels, 'block_matmul_plain'):
                              lambda A, B: A @ B}),
                ('back substitution', {(scan_kernels, 'block_inv'):
                                       inverse_in_order}),
                ('Gauss-Jordan', {(scan_kernels, 'block_inv'):
                                  lambda A, out=None: (
                                      gauss_jordan(A) if out is None
                                      else out.copy_(gauss_jordan(A)))}))
    gj_nl = lambda A: gauss_jordan(A.movedim(-1, -3)).movedim(-3, -1)
    mm_nl = lambda A, B: torch.einsum('...ijn,...jkn->...ikn', A, B)
    return (('products', {(pcr_kernels, 'matmul_nl'): mm_nl}),
            ('Gauss-Jordan', {(pcr_kernels, 'block_inv_nl'): gj_nl}))


def main():
    method = sys.argv[1] if len(sys.argv) > 1 else 'scan'
    torch.set_num_threads(4)
    prob, q_start = n_link_cart_problem(9, 60, device='cpu')
    guess = n_link_initial_guess(prob, q_start)
    prob.set_solver_options(kkt_method=method, factor_dtype=torch.float64,
                            chunk_iters=1, **OPTIONS)
    cold, resume = prob._build_solver()[1:3]
    free = torch.as_tensor(guess)[None]
    t0 = time.time()
    _, state = cold(free)
    saved = {f: v.detach().numpy().copy() for f, v in state._asdict().items()}

    def step():
        return resume(free, interop.state_from_numpy(
            {f: v.copy() for f, v in saved.items()}, 'cpu'))[1]

    ref = step()
    rel = lambda a, b: float(np.max(np.abs(a - b))
                             / max(np.max(np.abs(b)), 1e-300))
    print('nlink-9 N=60 kkt_method={} float64: one iteration from the state '
          'after iteration {} (mu {:.1e})'.format(
              method, int(state.it[0]), float(state.mu[0])), flush=True)
    for name, patch in variants(method):
        kept = {key: getattr(*key) for key in patch}
        for (mod, attr), fn in patch.items():
            setattr(mod, attr, fn)
        try:
            got = step()
        finally:
            for (mod, attr), fn in kept.items():
                setattr(mod, attr, fn)
        diff = {f: rel(getattr(got, f)[0].numpy(), getattr(ref, f)[0].numpy())
                for f in ('x', 'y', 'zL', 'zU')}
        print('{}: {} (largest {:.3e})'.format(
            name, {f: '{:.3e}'.format(v) for f, v in diff.items()},
            max(diff.values())), flush=True)
    print('{:.1f} s'.format(time.time() - t0))


if __name__ == '__main__':
    main()
