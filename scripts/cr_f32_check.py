#!/usr/bin/env python
"""The port's half of the float32 ``cr`` check: where does opty_tpu_torch
depart from opty_tpu on bench queue row 16 (``default_rng(7)``, pendulum
swing-up, N = 501, ``kkt_method='cr'``, float32 factorization, default
options), and is its float32 solve less accurate than the JAX
package's there?  Runs the port on the CPU (no JAX imported), after the
JAX half has written its states:

    JAX_PLATFORMS=cpu python scripts/reference_cr_f32_states.py \
        build/row16.npz
    python scripts/cr_f32_check.py build/row16.npz

It solves the row with the port one iteration a call, finds the first
iteration k whose x differs from the JAX package's by more than 1e-6
relative (max |difference| over max |x|), and prints, at the JAX
package's states k - 1 and k, the relative error of each package's
float32 solve (one float32 factorization, six float64 refinement
rounds) against its own float64 solve, and the two packages' solves
against each other.  Prints one JSON object.
"""

import json
import os
import sys

import numpy as np


def rel(a, b):
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-300))


def main():
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch
    from opty_tpu_torch.models import swing_up_problem
    from opty_tpu_torch.nlp.collocation import make_collocation_nlp_functions

    ref = np.load(sys.argv[1])
    prob = swing_up_problem(num_nodes=501, device='cpu')
    prob.set_solver_options(kkt_method='cr', factor_dtype=torch.float32,
                            chunk_iters=1)
    free = torch.as_tensor(ref['free'])[None]
    _, run_cold, run_resume = prob._build_solver()
    xs = []
    _, state = run_cold(free)
    while True:
        xs.append(state.x[0].numpy().copy())
        if bool(state.done.all()) or len(xs) >= len(ref['x']) + 5:
            break
        _, state = run_resume(free, state)
    diffs = [rel(a, b) for a, b in zip(xs, ref['x'])]
    first = next((k for k, d in enumerate(diffs) if d > 1e-6), None)

    col = prob.collocator
    solves = {}
    for dt in (torch.float32, torch.float64):
        fns, _ = make_collocation_nlp_functions(
            col, prob._obj_fn, prob._obj_grad_fn, scale_from=free,
            factor_dtype=dt, kkt_method='cr')
        solves[dt] = fns

    def port_solve(k, dt):
        f = solves[dt]
        t = lambda a: torch.as_tensor(a)[None]
        fac = f.kkt_factor(f.kkt_prepare(t(ref['x'][k]), t(ref['y'][k])),
                           t(ref['sigma_x'][k]),
                           torch.zeros(1, prob.num_constraints,
                                       dtype=torch.float64))
        dx, dy, _ = f.kkt_apply(fac, t(ref['rx']), t(ref['rc']))
        return np.concatenate([dx[0].numpy(), dy[0].numpy()])

    at = {}
    for k in sorted({max(first - 1, 0), first} if first is not None
                    else {len(ref['x']) - 1}):
        jax32 = np.concatenate([ref['dx32'][k], ref['dy32'][k]])
        jax64 = np.concatenate([ref['dx64'][k], ref['dy64'][k]])
        port32, port64 = port_solve(k, torch.float32), \
            port_solve(k, torch.float64)
        at[k] = dict(
            mu=float(ref['mu'][k]), delta_w=float(ref['delta_w'][k]),
            mono=bool(ref['mono'][k]),
            jax_f32_vs_f64=rel(jax32, jax64), port_f32_vs_f64=rel(port32,
                                                                  port64),
            port_f32_vs_jax_f32=rel(port32, jax32),
            port_f64_vs_jax_f64=rel(port64, jax64))
    print(json.dumps(dict(
        jax_iterations=int(ref['iterations']),
        jax_status=int(ref['status']),
        port_iterations=int(state.it[0]), port_status=int(state.status[0]),
        port_mono=bool(state.mono[0]), jax_mono=bool(ref['mono'][-1]),
        first_iteration_apart=first,
        x_rel_diff_by_iteration=diffs, solves_at=at)))


if __name__ == '__main__':
    main()
