#!/usr/bin/env python3
"""The JAX package's half of the float32-factor crossovers (scripts/
f32_crossover.py holds the port's half): a gallery problem's cold solve
(benchmarks/cold_gallery.py's guess and budget, ``use_soc=False``,
kkt_method='cr') with a float32 factorization and six float64
refinement rounds, one iteration a call, on the CPU:

    JAX_PLATFORMS=cpu python3 scripts/reference_f32_states.py \
        sliding_block build/sliding_block_f32.npz [--phase 2]

For every iteration k it saves the solver state and, from that state,
the next state with the float32 factor (the path itself) and with a
float64 factor (one round): how far the JAX package's own two
factorizations move apart from one state is the yardstick of a
crossover.  ``betts_10_47 --phase 2`` runs phase 1 first (float32, the
same options) and records phase 2 from phase 1's solution, as
``run_phases`` chains them.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'scripts'))

FIELDS = ('x', 'y', 'zL', 'zU')


def betts_phase2(options):
    """(phase 2 problem, its guess, its budget) of betts_10_47's
    run_phases, phase 1 solved first with ``options``."""
    sys.path.insert(0, os.path.join(ROOT, 'examples', 'gallery'))
    import betts_10_47 as mod
    captured = {}

    class Stop(Exception):
        pass

    from opty_tpu import Problem
    real = Problem.solve

    def solve(prob, *args, **kwargs):
        prob.set_solver_options(**options)
        if 'p1' in captured:
            captured['p2'] = (prob, np.array(args[0], dtype=float))
            raise Stop
        out = real(prob, *args, **kwargs)
        captured['p1'] = out
        return out

    Problem.solve = solve
    try:
        mod.run_phases(verbose=False)
    except Stop:
        pass
    finally:
        Problem.solve = real
    prob, guess = captured['p2']
    return prob, guess, prob._ipm_options.max_iter, captured['p1'][0]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('name')
    parser.add_argument('out')
    parser.add_argument('--phase', type=int, default=None)
    parser.add_argument('--max-states', type=int, default=None)
    args = parser.parse_args()
    os.environ.setdefault('JAX_PLATFORMS', 'cpu')
    import jax.numpy as jnp
    import opty_tpu  # noqa: F401  (enables x64)
    import reference_gallery as rg

    rec = {}
    if args.phase == 2:
        # run_phases's options: the card's default factor, nothing else
        options = dict(kkt_method='cr', factor_dtype=jnp.float32)
        prob, guess, max_iter, rec['phase1'] = betts_phase2(options)
    else:
        options = dict(kkt_method='cr', factor_dtype=jnp.float32,
                       use_soc=False)
        prob, guess, max_iter = rg.jax_cold_problem(args.name)
    limit = args.max_states or max_iter
    fj = jnp.asarray(guess)
    # a solver reads the factor dtype when it is traced (its first
    # call), so each is built and traced right after its options
    solvers = {}
    for tag, fd in (('64', jnp.float64), ('32', jnp.float32)):
        prob.set_solver_options(max_iter=max_iter, chunk_iters=1, **dict(
            options, factor_dtype=fd))
        solvers[tag] = prob._build_solver()
        _, state = solvers[tag][1](fj)
        solvers[tag][2](fj, state)
    rec['free'] = np.asarray(guess)
    t0 = time.time()
    k = 0
    while not bool(state.done) and k < limit:
        for f, v in state._asdict().items():
            rec['s%d_%s' % (k, f)] = np.asarray(v)
        nxt = {}
        for tag in ('32', '64'):
            _, st = solvers[tag][2](fj, state)
            nxt[tag] = st
            for f in FIELDS:
                rec['n%s_%d_%s' % (tag, k, f)] = np.asarray(getattr(st, f))
        state = nxt['32']
        k += 1
    rec['count'] = np.asarray(k)
    rec['status'] = np.asarray(state.status)
    np.savez_compressed(args.out, **rec)
    print('%s: %d states, status %d, %.1f s' % (
        args.name, k, int(state.status), time.time() - t0))


if __name__ == '__main__':
    main()
