#!/usr/bin/env python
"""The JAX package's reference for chip_smoke.py's phase 5c: the first
64 rows of bench.py's queue (default_rng(7), pendulum swing-up,
N = 501) through opty_tpu's ``Problem.solve_queue`` on 32 refilled
lanes, ``kkt_method='cr'``, a float32 factorization, ``max_iter=200``,
``chunk_iters=20`` and every other option at its default (adaptive mu,
second-order correction, restoration).  Runs JAX on the CPU:

    JAX_PLATFORMS=cpu python scripts/jax_default_queue.py

Prints one JSON object: converged share, iterations (mean, p50, p90,
max), the lanes that fell back to monotone mu, the lanes that entered
restoration with their restoration iterations, the statuses and the
wall time (a CPU time, not a figure of any accelerator).
"""

import json
import os
import sys
import time

import numpy as np

ROWS, LANES, NODES = 64, 32, 501


def main():
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax
    import jax.numpy as jnp
    import opty_tpu  # noqa: F401  (enables x64)
    from opty_tpu.models import swing_up_problem

    prob = swing_up_problem(num_nodes=NODES)
    prob.set_solver_options(max_iter=200, chunk_iters=20, kkt_method='cr',
                            factor_dtype=jnp.float32)
    queue = np.random.default_rng(7).standard_normal((ROWS, prob.num_free))
    t0 = time.time()
    res = prob.solve_queue(queue, batch_size=LANES)
    wall = time.time() - t0
    status = np.asarray(res.status)
    iters = np.asarray(res.iterations)
    rest = np.asarray(res.rest_total)
    mono = np.asarray(res.mono)
    print(json.dumps({
        'platform': jax.devices()[0].platform,
        'rows': ROWS, 'lanes': LANES, 'nodes': NODES,
        'converged': int(np.sum((status == 0) | (status == 1))),
        'iterations_mean': float(iters.mean()),
        'iterations_p50': float(np.percentile(iters, 50)),
        'iterations_p90': float(np.percentile(iters, 90)),
        'iterations_max': int(iters.max()),
        'mono_rows': [int(i) for i in np.where(mono)[0]],
        'rest_rows': {int(i): int(rest[i]) for i in np.where(rest > 0)[0]},
        'statuses': {int(s): int(np.sum(status == s))
                     for s in np.unique(status)},
        'iterations': [int(i) for i in iters],
        'wall_s_cpu': wall}))


if __name__ == '__main__':
    main()
