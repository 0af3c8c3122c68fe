"""The JAX package's two identification examples, ported
(opty_tpu_torch/examples/), against the JAX package's own problems
(built as the examples' ``main`` builds them, by
scripts/reference_identification.py) at small sizes on the CPU: the
same data from the same seeds, then solves by both packages with the
CPU default (kkt_method='scan', float64) — the same status, iterations
within ITER_SLACK and the identified values within 1e-8 relative — and
through kkt_method='cr' with a float32 factorization and refinement,
the port against the JAX package's cr twin, within 1e-6 relative.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opty_tpu_torch.examples import inverted_pendulum_id, vyasarayani2011

ROOT = Path(__file__).resolve().parents[1]
ITER_SLACK = 2
REL = {'scan': 1e-8, 'cr': 1e-6}
# the examples cut to CPU-test size (their defaults: N = 501 over 5 s
# and N = 5,000): the pendulum keeps its node interval, 0.01 s, over a
# 1 s horizon (over 5 s, N <= 101 leaves cr with a float32 factor
# short of convergence in both packages)
PENDULUM = dict(links=1, nodes=101, duration=1.0)
VYASARAYANI_NODES = 200


def _reference():
    spec = importlib.util.spec_from_file_location(
        'reference_identification',
        ROOT / 'scripts' / 'reference_identification.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference()


@pytest.fixture(scope='module')
def pendulum():
    return (inverted_pendulum_id.build_problem(device='cpu', **PENDULUM),
            REF.jax_pendulum_id(**PENDULUM))


@pytest.fixture(scope='module')
def vyasarayani():
    return (vyasarayani2011.build_problem(nodes=VYASARAYANI_NODES,
                                          device='cpu'),
            REF.jax_vyasarayani(nodes=VYASARAYANI_NODES))


def test_pendulum_data(pendulum):
    """The same measurements, guess and true gains from the same seeds,
    and the same problem layout."""
    (tprob, tguess, tK), (jprob, jguess, jK) = pendulum
    np.testing.assert_array_equal(tguess, jguess)
    np.testing.assert_array_equal(tK, jK)
    assert (tprob.num_free, tprob.num_constraints) == \
        (jprob.num_free, jprob.num_constraints)
    np.testing.assert_allclose(tprob.constraints(tguess),
                               jprob.constraints(jguess), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(tprob.objective(tguess),
                               jprob.objective(jguess), rtol=1e-13)


def test_vyasarayani_data(vyasarayani):
    (tprob, tguess, tp), (jprob, jguess, jp) = vyasarayani
    np.testing.assert_array_equal(tguess, jguess)
    assert tp == jp
    np.testing.assert_allclose(tprob.constraints(tguess),
                               jprob.constraints(jguess), rtol=0,
                               atol=1e-12)


def solve_both(pair, count, method):
    (tprob, tguess, _), (jprob, jguess, _) = pair
    if method == 'cr':
        tprob.set_solver_options(kkt_method='cr', factor_dtype=torch.float32)
        jprob.set_solver_options(kkt_method='cr', factor_dtype=jnp.float32)
    else:
        tprob.set_solver_options(kkt_method='scan',
                                 factor_dtype=torch.float64)
        jprob.set_solver_options(kkt_method='scan',
                                 factor_dtype=jnp.float64)
    tx, tinfo = tprob.solve(tguess)
    jx, jinfo = jprob.solve(jguess)
    return tx[-count:], tinfo, jx[-count:], jinfo


@pytest.mark.parametrize('method', ['scan', 'cr'])
@pytest.mark.parametrize('example', ['pendulum', 'vyasarayani'])
def test_identification_solves(example, method, request):
    pair = request.getfixturevalue(example)
    count = np.atleast_1d(pair[0][2]).size
    got, tinfo, want, jinfo = solve_both(pair, count, method)
    assert tinfo['status'] == jinfo['status'] == 0
    assert abs(tinfo['iterations'] - jinfo['iterations']) <= ITER_SLACK
    rel = np.max(np.abs(got - want) / np.abs(want))
    assert rel <= REL[method], (got, want)
    np.testing.assert_allclose(tinfo['obj_val'], jinfo['obj_val'],
                               rtol=REL[method])
