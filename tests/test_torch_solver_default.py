"""opty_tpu_torch's solver with the library's default options (adaptive
mu with the stall fallback, second-order correction, restoration)
against opty_tpu's on the pendulum swing-up (N = 101, torque bound 20),
kkt_method='cr' and a float64 factorization, on the CPU:

* one iteration from an identical state (the JAX solver's state crossed
  over through interop.state_from_numpy) while the probe runs, and one
  iteration that enters restoration: fields within 1e-9;
* full solves from the starts of chip_smoke.py's phase 4c, whose
  reference solves enter restoration and converge: the same status,
  iterations and restoration iterations, objective within 1e-8
  relative (and x within 1e-6 where solved to tol).

Adaptive mu amplifies round-off in the cold phase: from 6 of the 19
starts compared (seeds 8, 11, 12, 18, 25 and 50 of 1, 2, 5, 8, 9,
11-15, 17, 18, 23-27, 50 and 57) the two packages, every step equal to
~1e-15 from a shared state, drift apart about tenfold an iteration and
end in different basins, as the JAX package does between
kkt_method='cr' and 'scan'.  The starts below are two of the 13 whose
solves agree; their JAX solves with 'scan' restore too (seed 14: status
0, 143 iterations, 1 restoration iteration; seed 57: 0, 108, 2).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opty_tpu_torch import interop
from opty_tpu_torch.models import swing_up_problem
from test_problem import build_pendulum

N = 101
TMAX = 20.0
# default_rng(seed).normal(size=num_free) starts and the JAX package's
# solves from them (kkt_method='cr', float64 factorization, default
# options): status, iterations, restoration iterations, objective
REFERENCE = {14: (0, 147, 3, 60.722762013799354),
             57: (0, 108, 2, 49.66247313397147)}
FIELDS = ('x', 's', 'y', 'zL', 'zU', 'wL', 'wU')
SCALARS = ('mu', 'delta_w', 'alpha_last', 'status', 'f_count', 'mono',
           'free_stall', 'rest_total', 'rest_depth', 'last_rest_it')


def _x0(seed, nfree):
    return np.random.default_rng(seed).normal(size=nfree)


@pytest.fixture(scope='module')
def jax_problem():
    """One compiled JAX solver pair (cold, resume) at one iteration per
    call serves both the iteration and the full-solve tests."""
    prob = build_pendulum(num_nodes=N, tmax=TMAX)
    prob.set_solver_options(factor_dtype=jnp.float64, chunk_iters=1,
                            kkt_method='cr')
    prob._solver = prob._build_solver()      # compiled once, shared
    return prob


@pytest.fixture(scope='module')
def torch_problem():
    prob = swing_up_problem(num_nodes=N, torque_bound=TMAX, device='cpu')
    prob.set_solver_options(factor_dtype=torch.float64, kkt_method='cr')
    return prob


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _one_iteration(jax_problem, seed, stop):
    """Run the JAX solver from ``seed`` until ``stop(state, next)``;
    return (the state before, the JAX next state, the port's next state
    from the crossed-over state before)."""
    _, run_cold, run_resume = jax_problem._solver
    free = _x0(seed, jax_problem.num_free)
    fj = jnp.asarray(free)
    _, state = run_cold(fj)
    while True:
        _, nxt = run_resume(fj, state)
        if stop(state, nxt):
            break
        assert not bool(nxt.done)
        state = nxt
    tprob = swing_up_problem(num_nodes=N, torque_bound=TMAX, device='cpu')
    tprob.set_solver_options(factor_dtype=torch.float64, chunk_iters=1,
                             kkt_method='cr')
    _, _, t_resume = tprob._build_solver()
    start = interop.state_from_numpy(
        {f: np.asarray(v) for f, v in state._asdict().items()}, 'cpu')
    _, got = t_resume(torch.as_tensor(free)[None], start)
    return state, nxt, got


def _assert_same_step(got, want):
    assert int(got.it[0]) == int(want.it)
    for field in FIELDS:
        assert _rel(got._asdict()[field][0],
                    np.asarray(want._asdict()[field])) <= 1e-9, field
    for field in SCALARS:
        np.testing.assert_allclose(
            got._asdict()[field][0].numpy().astype(np.float64),
            np.asarray(want._asdict()[field], np.float64), rtol=1e-9,
            err_msg=field)


def test_one_adaptive_iteration(jax_problem):
    """An iteration of a probing lane: affine predictor, Mehrotra mu,
    centered corrector on the same factorization, filter reset on the
    mu move."""
    state, want, got = _one_iteration(
        jax_problem, 14,
        lambda st, nxt: not bool(nxt.mono) and float(nxt.mu) < float(st.mu))
    assert not bool(state.mono)
    _assert_same_step(got, want)


def test_one_iteration_entering_restoration(jax_problem):
    state, want, got = _one_iteration(
        jax_problem, 14, lambda st, nxt: int(nxt.rest_total) > 0)
    assert int(state.rest_total) == 0 and int(want.rest_total) > 0
    assert bool(want.mono)
    _assert_same_step(got, want)


@pytest.mark.parametrize('seed', sorted(REFERENCE))
def test_default_solve_matches_reference(jax_problem, torch_problem, seed):
    free = _x0(seed, jax_problem.num_free)
    xj, ij = jax_problem.solve(free)
    status, iters, rest, obj = REFERENCE[seed]
    assert (ij['status'], ij['iterations'], ij['rest_iterations']) == \
        (status, iters, rest)
    assert abs(ij['obj_val'] - obj) <= 1e-10 * abs(obj)
    xt, it = torch_problem.solve(free)
    assert it['status'] == ij['status']
    assert it['iterations'] == ij['iterations']
    assert it['rest_iterations'] == ij['rest_iterations']
    assert it['mono_fallback'] == ij['mono_fallback']
    assert abs(it['obj_val'] - ij['obj_val']) <= 1e-8 * abs(ij['obj_val'])
    if status == 0:      # solved to tol (status 1 stops at 1e-6)
        np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
