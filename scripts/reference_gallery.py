#!/usr/bin/env python3
"""The JAX package's cold gallery solves and its pendulum swing-up
example on the CPU, for chip_smoke.py's records (JAX_GALLERY,
JAX_GALLERY_F32, JAX_SWING_UP).

    JAX_PLATFORMS=cpu python3 scripts/reference_gallery.py
    JAX_PLATFORMS=cpu python3 scripts/reference_gallery.py --factor float32
    JAX_PLATFORMS=cpu python3 scripts/reference_gallery.py crane_load swing_up

A gallery problem is built by examples/gallery/<name>.py's
``build_problem`` at its defaults and solved once from
benchmarks/cold_gallery.py's documented guess (park2004 and
non_contiguous_id: their ``build_problem`` guesses, as that file's special
runners take them) with that file's configuration (``use_soc=False``
and its ``max_iter``) and ``kkt_method='cr'`` with a ``--factor``
factorization (float64: chip_smoke.py's phase 9b; float32: the card's
default factor with the JAX package's default refinement).
betts_10_47 runs its three phases (``run_phases``); its phase 3 needs
the reference's CSV, absent here, so phase 3 starts from phase 2's
end state and is solved from the port's ``guess_phase3``, as the
port's ``run_phases`` does without the CSV.  ``swing_up`` runs
examples/pendulum_swing_up.py's ``main`` with the JAX package's CPU
defaults: N = 501, then ``--batch 4 --nodes 301``.  One JSON line
each: status, iterations, objective and wall time.

With no names it runs COLD_CANDIDATES (the problems whose cold solve
took at most 100 iterations in COLD_GALLERY_r05.json), betts_10_47 and
swing_up (float64 only).
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
sys.path.insert(0, os.path.join(ROOT, 'examples', 'gallery'))

COLD_CANDIDATES = (
    'betts2003', 'non_contiguous_id', 'park2004', 'betts_10_50',
    'path_constraints', 'betts_10_103_104', 'betts_10_7',
    'particle_in_tube', 'crane_load', 'countersteer', 'sliding_block',
)
# benchmarks/cold_gallery.py's special runners: the guess edit and the
# iteration budget
_FROM_BUILD = {'park2004': (lambda g: g.__setitem__(slice(-8, None), 0.25),
                            2000),
               'non_contiguous_id': (None, 1000)}


def _options(factor):
    import jax.numpy as jnp
    return dict(kkt_method='cr', factor_dtype=getattr(jnp, factor))


def jax_cold_problem(name):
    """(problem, guess, max_iter) of cold_gallery.py's run of ``name``."""
    import cold_gallery
    mod = __import__(name)
    if name in _FROM_BUILD:
        edit, max_iter = _FROM_BUILD[name]
        out = mod.build_problem()
        prob, guess = out[0], np.array(out[1], dtype=float)
        if edit:
            edit(guess)
        return prob, guess, max_iter
    module, kwargs, guess_fn, max_iter = cold_gallery.PORTS[name]
    out = mod.build_problem(**kwargs)
    prob = out[0] if isinstance(out, tuple) else out
    N = prob.collocator.num_collocation_nodes
    return prob, guess_fn(prob, N), max_iter


class _Recorder:
    """Wraps ``opty_tpu.Problem``'s solve methods: every result is kept
    and ``options`` are set on each problem before it solves."""

    def __init__(self, options=None):
        from opty_tpu import Problem
        self.cls, self.options, self.results = Problem, options or {}, []

    def __enter__(self):
        self.solve, self.batch = self.cls.solve, self.cls.solve_batch
        rec = self

        def solve(prob, *args, **kwargs):
            if rec.options:
                prob.set_solver_options(**rec.options)
            out = rec.solve(prob, *args, **kwargs)
            rec.results.append(out)
            return out

        def solve_batch(prob, *args, **kwargs):
            if rec.options:
                prob.set_solver_options(**rec.options)
            out = rec.batch(prob, *args, **kwargs)
            rec.results.append(out)
            return out

        self.cls.solve, self.cls.solve_batch = solve, solve_batch
        return self

    def __exit__(self, *exc):
        self.cls.solve, self.cls.solve_batch = self.solve, self.batch


def jax_betts_10_47(options):
    """examples/gallery/betts_10_47.py's ``run_phases`` with ``options``
    on every phase; phase 3 from phase 2's end state (a CSV written for
    ``build_problem`` to read its initial state from) and solved from
    the port's ``guess_phase3`` instead of certified.  Returns the three
    (solution, info)."""
    import betts_10_47 as mod
    from opty_tpu_torch.examples.gallery.betts_10_47 import guess_phase3
    n = mod.NUM_NODES
    rec = _Recorder(options)
    tmp = tempfile.NamedTemporaryFile('w', suffix='.csv', delete=False)
    tmp.close()

    def end_state_csv(_path):
        sol2 = rec.results[-1][0]
        start = np.zeros(3 * n + 1)
        start[[0, n, 2 * n]] = sol2[n - 1], sol2[2 * n - 1], sol2[3 * n - 1]
        np.savetxt(tmp.name, start)
        return tmp.name

    def solve_phase3(prob, _csv, verbose=False, **_kw):
        h2, v2, m2 = np.loadtxt(tmp.name)[[0, n, 2 * n]]
        prob.set_solver_options(max_iter=1000)
        return prob.solve(guess_phase3(h2, v2, m2))

    saved = mod.csv, mod.certify
    mod.csv, mod.certify = end_state_csv, solve_phase3
    try:
        with rec:
            out = mod.run_phases(verbose=False)
    finally:
        mod.csv, mod.certify = saved
        os.unlink(tmp.name)
    return out


def run_example_main(path, argv, options=None, errors=()):
    """Runs the ``main`` of the script at ``path`` with ``argv`` and
    returns what its problems' solve and solve_batch calls returned
    (``options`` set on each problem just before it solves); an
    exception of a type in ``errors`` that ``main`` raises after them is
    caught."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('reference_example', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = [path] + list(argv)
    try:
        with _Recorder(options) as rec:
            mod.main()
    except errors:
        pass
    finally:
        sys.argv = saved
    return rec.results


def _line(**kw):
    print(json.dumps(kw), flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('names', nargs='*')
    parser.add_argument('--factor', default='float64',
                        choices=('float64', 'float32'))
    args = parser.parse_args()
    names = args.names or (list(COLD_CANDIDATES) + ['betts_10_47']
                           + (['swing_up'] if args.factor == 'float64'
                              else []))
    options = _options(args.factor)
    for name in names:
        t0 = time.time()
        if name == 'swing_up':
            path = os.path.join(ROOT, 'examples', 'pendulum_swing_up.py')
            (_, info), = run_example_main(path, [])
            _line(name='swing_up', nodes=501, status=info['status'],
                  iterations=info['iterations'], obj=info['obj_val'],
                  wall_s=time.time() - t0)
            t0 = time.time()
            res, = run_example_main(path, ['--batch', '4', '--nodes', '301'])
            _line(name='swing_up --batch 4', nodes=301,
                  status=np.asarray(res.status).tolist(),
                  iterations=np.asarray(res.iterations).tolist(),
                  obj=np.asarray(res.obj_val).tolist(),
                  wall_s=time.time() - t0)
        elif name == 'betts_10_47':
            phases = jax_betts_10_47(options)
            _line(name=name, factor=args.factor,
                  status=[int(i['status']) for _, i in phases],
                  iterations=[int(i['iterations']) for _, i in phases],
                  obj=[float(i['obj_val']) for _, i in phases],
                  wall_s=time.time() - t0)
        else:
            prob, guess, max_iter = jax_cold_problem(name)
            prob.set_solver_options(max_iter=max_iter, use_soc=False,
                                    **options)
            _, info = prob.solve(guess)
            _line(name=name, factor=args.factor, status=info['status'],
                  iterations=info['iterations'], obj=info['obj_val'],
                  wall_s=time.time() - t0)


if __name__ == '__main__':
    main()
