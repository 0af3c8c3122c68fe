"""Shared helpers for the gallery problems.

Each problem exposes ``build_problem(..., device=None)`` returning what
the JAX package's module returns (the problem alone, ``(prob,
csv_path)`` where ``csv_path`` is the reference's committed Ipopt
solution for the same configuration, or ``(prob, guess[, data])``).
``certify`` checks the strongest form of parity we can assert without
Ipopt in the image: the reference optimum is feasible in our
transcription and is certified as a KKT point by our solver in a
handful of warm-started iterations.

``unit_gradient`` and ``interp`` are the torch counterparts of the JAX
idioms the gallery's objectives and data tables use
(``jnp.zeros_like(free).at[i].set(v)``, ``jnp.interp``), written
without in-place writes so that ``torch.func.vmap`` batches them.
"""

import os

import numpy as np
import torch

# the reference opty gallery's checkout, where its committed Ipopt
# solutions live (the JAX package's _common.py names a fixed directory)
REF_GALLERY = os.environ.get('OPTY_REFERENCE_GALLERY', '')


def csv(path):
    """The reference's CSV at ``path`` under REF_GALLERY, or None where
    it is absent."""
    p = os.path.join(REF_GALLERY, path)
    return p if REF_GALLERY and os.path.exists(p) else None


def certify(prob, csv_path, feas_tol=1e-6, max_certify_iters=25,
            verbose=True, solver_options=None):
    """Certify the reference's committed Ipopt solution with our
    solver.  Returns (solution, info)."""
    ref = np.loadtxt(csv_path)
    g = np.asarray(prob.con(ref))
    # feasibility = distance outside [cl, cu] (eom_bounds rows are
    # path inequalities, not equalities)
    cl, cu = prob._low_con_bounds, prob._upp_con_bounds
    resid = float(np.max(np.maximum(np.maximum(cl - g, g - cu), 0.0)))
    if verbose:
        print('reference solution constraint violation in our '
              'transcription: {:.2e}'.format(resid))
    assert resid < feas_tol, resid
    prob.set_solver_options(max_iter=max(50, max_certify_iters + 15),
                            mu_init=1e-9,
                            bound_push=1e-10, slack_push=1e-10,
                            **(solver_options or {}))
    sol, info = prob.solve(ref)
    if verbose:
        print('certification: status={} iters={} obj={:.6f}'.format(
            info['status'], info['iterations'], info['obj_val']))
    assert info['status'] in (0, 1), info['status_msg']
    assert info['iterations'] <= max_certify_iters
    return sol, info


def unit_gradient(free, entries):
    """A vector shaped like ``free``, zero but at ``entries`` (a dict of
    index -> value, negative indices allowed): the gradient of an
    objective that reads a few entries of the free vector."""
    n = free.shape[-1]
    idx = torch.arange(n, device=free.device)
    out = torch.zeros_like(free)
    for i, value in entries.items():
        out = torch.where(idx == i % n, value, out)
    return out


def interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)``: linear interpolation in the sorted
    table (xp, fp), clamped to its end values outside it.  A point on a
    knot takes the segment to its right (the last knot the one to its
    left), as JAX's does, which sets the derivative there."""
    def at(table, idx):
        return table.index_select(0, idx.reshape(-1)).reshape(idx.shape)

    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True),
                    1, xp.shape[0] - 1)
    x0, f0 = at(xp, i - 1), at(fp, i - 1)
    dx = at(xp, i) - x0
    dx0 = torch.abs(dx) <= np.spacing(np.finfo(np.float64).eps)
    f = torch.where(dx0, f0, f0 + ((x - x0) / torch.where(dx0, 1.0, dx))
                    * (at(fp, i) - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def solve_cold(prob, guess, max_iter, verbose=False, **options):
    """The cold solve of the JAX package's benchmarks/cold_gallery.py:
    the documented guess, ``max_iter`` and no second-order correction
    (``options`` go to ``set_solver_options`` as well).  Returns
    (solution, info)."""
    prob.set_solver_options(max_iter=max_iter, use_soc=False, **options)
    sol, info = prob.solve(guess)
    if verbose:
        print('cold solve: status={} iters={} obj={:.6f}'.format(
            info['status'], info['iterations'], info['obj_val']))
    return sol, info


def certify_or_solve(prob, csv_path, guess, max_iter, **certify_kwargs):
    """``certify`` where the reference's CSV is present, else a cold
    solve from the documented guess (``solve_cold``)."""
    if csv_path is None:
        print('no reference CSV under {}: solving cold from the '
              'documented guess'.format(REF_GALLERY))
        return solve_cold(prob, guess, max_iter, verbose=True)
    return certify(prob, csv_path, **certify_kwargs)
