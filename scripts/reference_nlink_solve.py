#!/usr/bin/env python
"""The JAX package's nlink-9 solve at N = 60 with the options of
chip_smoke.py's phase 7 (benchmarks/gait_scale.py --small-program's:
max_iter=1500, mu_init=1e-5, no second-order correction, no
restoration, dw_decay='hold') and a chosen KKT method and factor dtype.
Runs JAX on the CPU:

    JAX_PLATFORMS=cpu python scripts/reference_nlink_solve.py cr float64

Prints one JSON object: status, iterations, objective, inf_pr and the
solve's wall time (a CPU time, not a figure of any accelerator; the
first solve includes JAX's compile).
"""

import json
import os
import sys
import time


def main():
    method, dtype = sys.argv[1], sys.argv[2]
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax.numpy as jnp
    import opty_tpu  # noqa: F401  (enables x64)
    from opty_tpu.models.nlink import (n_link_cart_problem,
                                       n_link_initial_guess)

    prob, q_start = n_link_cart_problem(num_links=9, num_nodes=60)
    prob.set_solver_options(max_iter=1500, mu_init=1e-5, use_soc=False,
                            max_rest_visit=0, dw_decay='hold',
                            kkt_method=method,
                            factor_dtype=getattr(jnp, dtype))
    guess = n_link_initial_guess(prob, q_start)
    t0 = time.time()
    _, info = prob.solve(guess)
    print(json.dumps(dict(
        kkt_method=method, factor_dtype=dtype, status=info['status'],
        iterations=info['iterations'], obj=info['obj_val'],
        inf_pr=float(info['inf_pr']), wall_s_cpu=time.time() - t0)))


if __name__ == '__main__':
    main()
