"""opty_tpu_torch's interior-point solver against opty_tpu's on the
pendulum swing-up (N = 101, torque bound 20), both set to
kkt_method='cr', a float64 factorization, monotone mu and no
second-order correction.

* One iteration from an identical state: the JAX solver runs k
  iterations, its state crosses over through interop.state_from_numpy,
  and both solvers take one more iteration.
* Full solves from seeds whose reference solve never enters the
  restoration phase: same status and iteration count (the default
  options, restoration included, are in test_torch_solver_default.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opty_tpu_torch import interop
from opty_tpu_torch.models import swing_up_problem
from opty_tpu_torch.nlp.status import (MAXIMUM_ITERATIONS_EXCEEDED,
                                      STATUS_MESSAGES)
from test_problem import build_pendulum

N = 101
TMAX = 20.0
OPTIONS = dict(kkt_method='cr', mu_strategy='monotone', use_soc=False)
SOLVE_SEEDS = (29, 39)


def _x0(seed, nfree):
    return np.random.default_rng(seed).normal(size=nfree)


@pytest.fixture(scope='module')
def jax_problem():
    """One compiled JAX solver pair (cold, resume) at one iteration per
    call serves both the iteration and the full-solve tests."""
    prob = build_pendulum(num_nodes=N, tmax=TMAX)
    prob.set_solver_options(factor_dtype=jnp.float64, chunk_iters=1,
                            **OPTIONS)
    prob._solver = prob._build_solver()      # compiled once, shared
    return prob


@pytest.fixture(scope='module')
def torch_problem():
    prob = swing_up_problem(num_nodes=N, torque_bound=TMAX, device='cpu')
    prob.set_solver_options(factor_dtype=torch.float64, **OPTIONS)
    return prob


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize('k', [3, 12])
def test_one_iteration_from_identical_state(jax_problem, k):
    _, run_cold, run_resume = jax_problem._solver
    free = _x0(SOLVE_SEEDS[0], jax_problem.num_free)
    fj = jnp.asarray(free)
    _, state = run_cold(fj)
    for _ in range(k - 1):
        _, state = run_resume(fj, state)
    _, want = run_resume(fj, state)
    assert int(want.it) == k + 1

    tprob = swing_up_problem(num_nodes=N, torque_bound=TMAX, device='cpu')
    tprob.set_solver_options(factor_dtype=torch.float64, chunk_iters=1,
                             **OPTIONS)
    _, _, t_resume = tprob._build_solver()
    start = interop.state_from_numpy(
        {f: np.asarray(v) for f, v in state._asdict().items()}, 'cpu')
    _, got = t_resume(torch.as_tensor(free)[None], start)
    assert int(got.it[0]) == k + 1
    for field in ('x', 's', 'y', 'zL', 'zU', 'wL', 'wU'):
        assert _rel(got._asdict()[field][0],
                    np.asarray(want._asdict()[field])) <= 1e-9, field
    for field in ('mu', 'delta_w', 'alpha_last', 'status', 'f_count'):
        np.testing.assert_allclose(
            got._asdict()[field][0].numpy(),
            np.asarray(want._asdict()[field]), rtol=1e-9, err_msg=field)


@pytest.mark.parametrize('seed', SOLVE_SEEDS)
def test_solve_matches_reference(jax_problem, torch_problem, seed):
    free = _x0(seed, jax_problem.num_free)
    xj, ij = jax_problem.solve(free)
    xt, it = torch_problem.solve(free)
    assert ij['rest_iterations'] == 0
    assert ij['status'] in (0, 1)
    assert it['status'] == ij['status']
    assert it['iterations'] == ij['iterations']
    assert abs(it['obj_val'] - ij['obj_val']) <= 1e-8 * abs(ij['obj_val'])
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
    assert len(torch_problem.obj_value) == it['iterations']


def test_result_round_trip():
    prob = swing_up_problem(num_nodes=11, device='cpu')
    prob.set_solver_options(factor_dtype=torch.float64, max_iter=3,
                            **OPTIONS)
    res = prob.solve_batch(_x0(0, prob.num_free)[None])
    out = interop.result_to_numpy(res)
    assert out['x'].shape == (1, prob.num_free)
    assert out['iterations'][0] <= 3
    assert set(out) >= {'x', 'status', 'iterations', 'obj_history'}
    assert out['status'][0] == MAXIMUM_ITERATIONS_EXCEEDED
    assert 'Maximum number of iterations exceeded' in \
        STATUS_MESSAGES[int(out['status'][0])].decode()
