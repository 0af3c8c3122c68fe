#!/usr/bin/env python
"""The JAX package's half of the float32 ``cr`` check (scripts/
cr_f32_check.py holds the port's half): bench queue row 16
(``default_rng(7)``, pendulum swing-up, N = 501) solved by opty_tpu with
``kkt_method='cr'``, a float32 factorization and every other option at
its default, one iteration a call.  Runs JAX on the CPU:

    JAX_PLATFORMS=cpu python scripts/reference_cr_f32_states.py OUT.npz

For every iteration k it saves the solver state (x, y, zL, zU, mu,
delta_w, mono), and at that state one KKT solve of a fixed right-hand
side: the Jacobian and Lagrangian Hessian blocks at (x, y)
(``kkt_prepare``), the barrier diagonal zL/(x - lb) + zU/(ub - x) plus
the state's delta_w, a zero slack diagonal (every row is an equality),
factored once in float32 (``kkt_factor``) and applied with its six
float64 refinement rounds (``kkt_apply``), and the same in float64 with
one round.  The port's half repeats the solves on the same arrays.
"""

import os
import sys
import time

import numpy as np

NODES, ROW = 501, 16


def main():
    out = sys.argv[1]
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import opty_tpu  # noqa: F401  (enables x64)
    from opty_tpu.models import swing_up_problem
    from opty_tpu.nlp.collocation import make_collocation_nlp_functions

    prob = swing_up_problem(num_nodes=NODES)
    prob.set_solver_options(kkt_method='cr', factor_dtype=jnp.float32,
                            chunk_iters=1)
    free = np.random.default_rng(7).standard_normal(
        (64, prob.num_free))[ROW]
    fj = jnp.asarray(free)
    _, run_cold, run_resume = prob._build_solver()
    col = prob.collocator
    lb, ub = prob.lower_bound, prob.upper_bound
    has_l, has_u = lb > -prob.INF / 2, ub < prob.INF / 2
    rng = np.random.default_rng(0)
    rx = rng.standard_normal(prob.num_free)
    rc = rng.standard_normal(prob.num_constraints)

    def solver(dt):
        f = make_collocation_nlp_functions(
            col, prob._obj_fn, prob._obj_grad_fn, scale_from=fj,
            factor_dtype=dt, kkt_method='cr')[0]

        def solve(x, y, sigma):
            fac = f.kkt_factor(f.kkt_prepare(x, y), sigma,
                               jnp.zeros(prob.num_constraints))
            dx, dy, _ = f.kkt_apply(fac, jnp.asarray(rx), jnp.asarray(rc))
            return dx, dy
        return jax.jit(solve)

    solvers = {'32': solver(jnp.float32), '64': solver(jnp.float64)}

    rec = {k: [] for k in ('x', 'y', 'zL', 'zU', 'mu', 'delta_w', 'mono',
                           'sigma_x', 'dx32', 'dy32', 'dx64', 'dy64')}
    t0 = time.time()
    _, state = run_cold(fj)
    while True:
        x = np.asarray(state.x)
        zl, zu = np.asarray(state.zL), np.asarray(state.zU)
        sigma = (np.where(has_l, zl / np.where(has_l, x - lb, 1.0), 0.0)
                 + np.where(has_u, zu / np.where(has_u, ub - x, 1.0), 0.0)
                 + float(state.delta_w))
        for key, val in (('x', x), ('y', state.y), ('zL', zl), ('zU', zu),
                         ('mu', state.mu), ('delta_w', state.delta_w),
                         ('mono', state.mono), ('sigma_x', sigma)):
            rec[key].append(np.asarray(val))
        for tag, solve in solvers.items():
            dx, dy = solve(state.x, state.y, jnp.asarray(sigma))
            rec['dx' + tag].append(np.asarray(dx))
            rec['dy' + tag].append(np.asarray(dy))
        if bool(state.done):
            break
        _, state = run_resume(fj, state)
    np.savez(out, free=free, rx=rx, rc=rc, iterations=int(state.it),
             status=int(state.status),
             **{k: np.stack(v) for k, v in rec.items()})
    print('row {}: status {} after {} iterations, {} states saved to {} '
          '({:.1f} s on the CPU)'.format(ROW, int(state.status),
                                         int(state.it), len(rec['x']), out,
                                         time.time() - t0))


if __name__ == '__main__':
    main()
