"""opty_tpu_torch transcription against opty_tpu on the pendulum
swing-up (N = 31, float64, same numpy inputs on both sides)."""

import numpy as np
import pytest
import sympy as sm
import torch

import jax.numpy as jnp

from opty_tpu.transcribe.collocator import ConstraintCollocator as JaxCol
from opty_tpu.transcribe.hessian import structured_scalar_hessian as jax_sh
from opty_tpu.utils import create_objective_function as jax_objective
from opty_tpu_torch.transcribe.collocator import \
    ConstraintCollocator as TorchCol
from opty_tpu_torch.transcribe.hessian import (
    check_structured_hessian, structured_scalar_hessian as torch_sh)
from opty_tpu_torch.utils import create_objective_function as torch_objective

N = 31
DURATION = 10.0
RTOL = 1e-12


def _pendulum_symbols():
    I, m, g, d, t = sm.symbols('I, m, g, d, t')
    theta, omega, T = sm.symbols('theta, omega, T', cls=sm.Function)
    states = (theta(t), omega(t))
    eom = sm.Matrix([theta(t).diff(t) - omega(t),
                     I * omega(t).diff(t) + m * g * d * sm.sin(theta(t))
                     - T(t)])
    par_map = {I: 1.0, m: 1.0, g: 9.81, d: 1.0}
    inst = (theta(0.0), theta(DURATION) - np.pi, omega(0.0),
            omega(DURATION))
    return t, T, states, eom, par_map, inst


@pytest.fixture(scope='module')
def pair():
    t, T, states, eom, par_map, inst = _pendulum_symbols()
    h = DURATION / (N - 1)
    jc = JaxCol(eom, states, N, h, par_map, instance_constraints=inst,
                time_symbol=t)
    tc = TorchCol(eom, states, N, h, par_map, instance_constraints=inst,
                  time_symbol=t, device='cpu')
    jo, _ = jax_objective(sm.Integral(T(t) ** 2, t), states, (T(t),), (),
                          N, h, time_symbol=t)
    to, _ = torch_objective(sm.Integral(T(t) ** 2, t), states, (T(t),), (),
                            N, h, time_symbol=t)
    return jc, tc, jo, to


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _free(seed, nfree):
    return np.random.default_rng(seed).standard_normal(nfree)


@pytest.mark.parametrize('seed', [0, 1])
def test_constraints(pair, seed):
    jc, tc, _, _ = pair
    x = _free(seed, jc.num_free)
    want = jc.constraints(jnp.asarray(x))
    assert _rel(tc.constraints(torch.as_tensor(x)), want) <= RTOL
    res_t, inst_t = tc.constraints_nodewise(torch.as_tensor(x))
    res_j, inst_j = jc.constraints_nodewise(jnp.asarray(x))
    assert _rel(res_t, res_j) <= RTOL
    assert _rel(inst_t, inst_j) <= RTOL


@pytest.mark.parametrize('seed', [0, 1])
def test_jacobian_blocks(pair, seed):
    jc, tc, _, _ = pair
    x = _free(seed, jc.num_free)
    got = tc.jacobian_blocks(torch.as_tensor(x))
    want = jc.jacobian_blocks(jnp.asarray(x))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_instance_jacobian(pair):
    jc, tc, _, _ = pair
    x = _free(2, jc.num_free)
    got = tc.eval_instance_constraints_jacobian(torch.as_tensor(x))
    want = jc.eval_instance_constraints_jacobian(jnp.asarray(x))
    assert _rel(got, want) <= RTOL
    assert tc._instance_touched_indices == jc._instance_touched_indices


def test_jacobian_sparsity_and_values(pair):
    jc, tc, _, _ = pair
    x = _free(3, jc.num_free)
    rows_t, cols_t = tc.jacobian_indices()
    rows_j, cols_j = jc.jacobian_indices()
    np.testing.assert_array_equal(rows_t, rows_j)
    np.testing.assert_array_equal(cols_t, cols_j)
    got = tc.generate_jacobian_function()(x)
    want = jc.generate_jacobian_function()(x)
    assert _rel(got, want) <= RTOL


@pytest.mark.parametrize('seed', [0, 1])
def test_hessian_blocks(pair, seed):
    jc, tc, _, _ = pair
    rng = np.random.default_rng(10 + seed)
    x = rng.standard_normal(jc.num_free)
    y = rng.standard_normal((N - 1, jc.num_eom))
    got = tc.hessian_blocks(torch.as_tensor(x), torch.as_tensor(y))
    want = jc.hessian_blocks(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_structured_objective_hessian(pair):
    jc, tc, jo, to = pair
    rng = np.random.default_rng(20)
    x = rng.standard_normal(jc.num_free)
    yi = rng.standard_normal(jc.num_instance_constraints)
    assert _rel(to(torch.as_tensor(x)), jo(jnp.asarray(x))) <= RTOL

    def phi_j(f):
        return jo(f) + jnp.dot(jnp.asarray(yi),
                               jc.eval_instance_constraints(f))

    def phi_t(f):
        return to(f) + torch.dot(torch.as_tensor(yi),
                                 tc.eval_instance_constraints(f))

    got = torch_sh(phi_t, torch.as_tensor(x), N, 2, 1, 0)
    want = jax_sh(phi_j, jnp.asarray(x), N, 2, 1, 0)
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL
    # the structure is exact for this objective: no aliasing
    assert check_structured_hessian(phi_t, torch.as_tensor(x), N, 2, 1,
                                    0) < 1e-12


def test_vmapped_lanes_equal_single(pair):
    """The solver vmaps the transcription over lanes; each lane must
    equal its single evaluation."""
    _, tc, _, _ = pair
    rng = np.random.default_rng(30)
    X = torch.as_tensor(rng.standard_normal((3, tc.num_free)))
    Y = torch.as_tensor(rng.standard_normal((3, N - 1, tc.num_eom)))
    hb = torch.func.vmap(tc.hessian_blocks)(X, Y)
    jb = torch.func.vmap(tc.jacobian_blocks)(X)
    for lane in range(3):
        for g, w in zip(hb, tc.hessian_blocks(X[lane], Y[lane])):
            assert torch.equal(g[lane], w)
        for g, w in zip(jb, tc.jacobian_blocks(X[lane])):
            assert torch.equal(g[lane], w)


def test_unported_features_raise():
    """The features that raised before they were ported (midpoint, a
    variable node interval, unknown parameters) now transcribe as the
    JAX package does; an implicit unknown function still raises in
    both."""
    t, T, states, eom, par_map, inst = _pendulum_symbols()
    h = sm.Symbol('h', real=True)
    inst_h = (states[0].func(0 * h), states[0].func((N - 1) * h) - np.pi)
    cases = (dict(node_time_interval=0.1, known_parameter_map=par_map,
                  instance_constraints=inst,
                  integration_method='midpoint'),
             dict(node_time_interval=h, known_parameter_map=par_map,
                  instance_constraints=inst_h),
             dict(node_time_interval=0.1, known_parameter_map={},
                  instance_constraints=inst))
    for kw in cases:
        jc = JaxCol(eom, states, N, time_symbol=t, **kw)
        tc = TorchCol(eom, states, N, time_symbol=t, device='cpu', **kw)
        x = _free(7, jc.num_free)
        x[-1] = abs(x[-1]) + 0.1
        assert tc.num_free == jc.num_free
        assert _rel(tc.constraints(torch.as_tensor(x)),
                    jc.constraints(jnp.asarray(x))) <= RTOL
    f = sm.Function('f')(states[0])
    with pytest.raises(NotImplementedError, match='known trajectory map'):
        TorchCol(sm.Matrix([eom[0], eom[1] + f]), states, N, 0.1, par_map,
                 time_symbol=t, device='cpu')


def test_problem_callbacks_match_reference():
    """Problem.objective/gradient/constraints/jacobian and parse_free
    against opty_tpu's Problem on the same swing-up."""
    from opty_tpu.models import swing_up_problem as jax_swing_up
    from opty_tpu_torch.models import swing_up_problem as torch_swing_up
    jp = jax_swing_up(num_nodes=N)
    tp = torch_swing_up(num_nodes=N, device='cpu')
    x = _free(40, jp.num_free)
    assert tp.num_free == jp.num_free
    assert tp.num_constraints == jp.num_constraints
    np.testing.assert_array_equal(tp.lower_bound, jp.lower_bound)
    np.testing.assert_array_equal(tp.upper_bound, jp.upper_bound)
    assert abs(tp.objective(x) - jp.objective(x)) <= RTOL * abs(
        jp.objective(x))
    assert _rel(tp.gradient(x), jp.gradient(x)) <= RTOL
    assert _rel(tp.constraints(x), jp.constraints(x)) <= RTOL
    assert _rel(tp.jacobian(x), jp.jacobian(x)) <= RTOL
    for got, want in zip(tp.parse_free(x), jp.parse_free(x)):
        np.testing.assert_array_equal(got, want)
