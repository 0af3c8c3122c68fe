"""Full solves of gallery problems, opty_tpu_torch against the JAX
package, on the CPU in float64: each problem built by both packages'
``build_problem`` at a small size and solved cold from the port's
``initial_guess`` (benchmarks/cold_gallery.py's documented start) with
that file's configuration (``use_soc=False`` and the problem's
``COLD_MAX_ITER``) and both packages' CPU defaults (kkt_method='scan',
a float64 factorization).  The same status and iteration count, and
objectives within 1e-8 relative.

The cases: a narrow block with a free node interval (sliding_block,
d = 5), a midpoint identification with unknown parameters
(non_contiguous_id), a free-interval DAE with dependent coordinates
(crane_load) and ``eom_bounds`` path constraints (path_constraints).
Round-off amplified along a solve's cold phase can send the two
packages to different iteration counts from some sizes (ROADMAP.md §3,
"Round-off amplification"; sliding_block at 11 and 15 nodes ends
55 / 65 and 118 / 115 iterations); the sizes below are ones where it
does not, chosen as the existing parity tests choose their seeds.
crane_load's first step from its documented start amplifies round-off
about 1e12-fold (from one state the JAX package's own scan and cr
steps differ by 5.9e-4 relative in x, the port's scan step from the
JAX package's by 7.9e-5), so its iteration count differs at every
size and seed tried (11-21 nodes; seeded perturbations of the start):
there the status and the objective are compared, and the iteration
counts only printed.
"""

import importlib
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'examples', 'gallery'))

OBJ_TOL = 1e-8
# the iteration counts are compared for these
SAME_PATH = ('sliding_block', 'non_contiguous_id', 'path_constraints')
CASES = {
    'sliding_block': dict(num_nodes=13),
    'non_contiguous_id': dict(num_nodes=21),
    'crane_load': dict(num_nodes=15),
    'path_constraints': dict(num_nodes=15),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_cold_solve(name):
    port = importlib.import_module('opty_tpu_torch.examples.gallery.'
                                   + name)
    jout = importlib.import_module(name).build_problem(**CASES[name])
    tout = port.build_problem(device='cpu', **CASES[name])
    jp = jout[0] if isinstance(jout, tuple) else jout
    tp = tout[0] if isinstance(tout, tuple) else tout
    guess = port.initial_guess(tp)
    results = []
    for prob in (jp, tp):
        prob.set_solver_options(max_iter=port.COLD_MAX_ITER, use_soc=False)
        results.append(prob.solve(guess)[1])
    want, got = results
    print('{}: iterations {} (the JAX package {})'.format(
        name, got['iterations'], want['iterations']))
    assert got['status'] == want['status']
    assert want['status'] in (0, 1)
    if name in SAME_PATH:
        assert got['iterations'] == want['iterations']
    assert abs(got['obj_val'] - want['obj_val']) <= OBJ_TOL * max(
        abs(want['obj_val']), 1e-300)
