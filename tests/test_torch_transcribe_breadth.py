"""opty_tpu_torch's transcription breadth against opty_tpu, on the CPU
in float64 with the same numpy inputs: midpoint integration, a variable
node interval, unknown parameters, known trajectories as arrays,
callables of the free vector and implicit functions of a state (given
pointwise, or as data with their derivative values), the symbolic
discretization, ``eom_bounds``, bounds on unknown parameters and h,
and solves of the JAX package's oracle problems
(tests/test_transcribe.py, tests/test_implicit_traj.py,
tests/test_problem.py).

Transcription agrees to round-off (RTOL, relative to the largest
entry: the two packages evaluate the same lowered expressions with
differently fused operations); solves give the same status and
iteration count and objectives within 1e-8 relative.
"""

import numpy as np
import pytest
import sympy as sm
import sympy.physics.mechanics as me
import torch

import jax.numpy as jnp

from opty_tpu import Problem as JaxProblem
from opty_tpu import create_objective_function as jax_objective
from opty_tpu.models import swing_up_problem as jax_swing_up
from opty_tpu.transcribe.collocator import ConstraintCollocator as JaxCol
from opty_tpu_torch import Problem as TorchProblem
from opty_tpu_torch import create_objective_function as torch_objective
from opty_tpu_torch.models import swing_up_problem as torch_swing_up
from opty_tpu_torch.transcribe.collocator import \
    ConstraintCollocator as TorchCol

RTOL = 1e-12

t = sm.Symbol('t')
x, v, F = [sm.Function(s)(t) for s in 'xvF']
m, c, k = sm.symbols('m, c, k')
h_sym = sm.Symbol('h', real=True)
EOM = sm.Matrix([x.diff(t) - v, m * v.diff(t) + c * v + k * x - F])
N = 4
H = 0.01
F_VALS = np.random.default_rng(42).normal(size=N)

# tests/test_implicit_traj.py's system: theta(x) a known implicit
# function of the state x, s a known trajectory, f an unknown input
ti = me.dynamicsymbols._t
mi, gi = sm.symbols('m, g', real=True)
xi_, vi_, fi_, si_ = me.dynamicsymbols('x, v, f, s', real=True)
theta_of_x = sm.Function('theta', real=True)(xi_)
EOM_IMPLICIT = sm.Matrix([xi_.diff() - vi_ - si_,
                          mi * vi_.diff() - fi_
                          + mi * gi * sm.sin(theta_of_x)])
N_IMPLICIT = 5
S_VALS = np.linspace(121.0, 124.0, N_IMPLICIT)


def theta_fn(xv):
    return 0.3 * xv ** 2 + 0.1 * xv


def dtheta_fn(xv):
    return 0.6 * xv + 0.1


def _theta_of_free(free):
    return theta_fn(free[:N_IMPLICIT])


def _dtheta_of_free(free):
    return dtheta_fn(free[:N_IMPLICIT])


def _implicit(method='backward euler', data=False):
    tmap = {si_: S_VALS, theta_of_x: theta_fn}
    if data:
        tmap = {si_: S_VALS, theta_of_x: _theta_of_free,
                theta_of_x.diff(xi_): _dtheta_of_free}
    return (EOM_IMPLICIT, (xi_, vi_), N_IMPLICIT, 0.1), dict(
        known_parameter_map={mi: 3.3, gi: 10.2}, known_trajectory_map=tmap,
        time_symbol=ti, integration_method=method)


KNOWN = {m: 1.5, c: 0.3, k: 2.0}
CASES = {
    # tests/test_transcribe.py::TestMidpoint
    'midpoint': lambda: ((EOM, (x, v), N, H), dict(
        known_parameter_map=KNOWN, known_trajectory_map={F: F_VALS},
        time_symbol=t, integration_method='midpoint')),
    # TestUnknowns: m unknown, F unknown, variable duration
    'unknowns': lambda: ((EOM, (x, v), N, h_sym), dict(
        known_parameter_map={c: 0.3, k: 2.0}, time_symbol=t)),
    'unknowns midpoint': lambda: ((EOM, (x, v), N, h_sym), dict(
        known_parameter_map={c: 0.3, k: 2.0}, time_symbol=t,
        integration_method='midpoint')),
    # instance constraints at multiples of h, one depending on h itself
    'instance at multiples of h': lambda: ((EOM, (x, v), N, h_sym), dict(
        known_parameter_map={c: 0.3, k: 2.0}, time_symbol=t,
        instance_constraints=(x.func(0 * h_sym) - 1.0,
                              v.func(3 * h_sym) + h_sym,
                              F.func(2 * h_sym) * x.func(h_sym)))),
    # a known trajectory as a callable of the free vector (detached)
    'known callable': lambda: ((EOM, (x, v), N, H), dict(
        known_parameter_map=KNOWN,
        known_trajectory_map={F: lambda f: 0.5 * f[:N] ** 2 + f[N:2 * N]},
        time_symbol=t)),
    # TestImplicitKnownTrajectory and tests/test_implicit_traj.py
    'implicit pointwise': lambda: _implicit(),
    'implicit data': lambda: _implicit(data=True),
    'implicit pointwise midpoint': lambda: _implicit('midpoint'),
    'implicit data midpoint': lambda: _implicit('midpoint', data=True),
    'implicit arrays': lambda: ((EOM_IMPLICIT, (xi_, vi_), N_IMPLICIT, 0.1),
                                dict(known_parameter_map={mi: 3.3, gi: 10.2},
                                     known_trajectory_map={
                                         si_: S_VALS,
                                         theta_of_x: theta_fn(S_VALS / 100),
                                         theta_of_x.diff(xi_):
                                             dtheta_fn(S_VALS / 100)},
                                     time_symbol=ti)),
}


@pytest.fixture(scope='module', params=sorted(CASES))
def pair(request):
    args, kw = CASES[request.param]()
    return request.param, JaxCol(*args, **kw), TorchCol(*args, device='cpu',
                                                        **kw)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _free(col, seed):
    free = np.random.default_rng(seed).normal(size=col.num_free)
    if col.variable_duration:
        free[-1] = 0.013
    return free


def test_sizes_and_classification(pair):
    _, jc, tc = pair
    for name in ('num_free', 'num_constraints', 'num_states', 'num_eom',
                 'unknown_parameters', 'known_parameters', 'parameters',
                 'num_parameters', 'num_known_parameters',
                 'num_unknown_parameters', 'known_input_trajectories',
                 'unknown_input_trajectories', 'input_trajectories',
                 'num_input_trajectories', 'num_known_input_trajectories',
                 'num_unknown_input_trajectories', 'variable_duration',
                 'integration_method', 'time_interval_symbol',
                 'num_instance_constraints', '_nz', '_bw'):
        assert getattr(tc, name) == getattr(jc, name), name
    for got, want in zip(tc.jacobian_indices(), jc.jacobian_indices()):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('seed', [0, 1])
def test_constraints_and_jacobian(pair, seed):
    _, jc, tc = pair
    free = _free(jc, seed)
    assert _rel(tc.generate_constraint_function()(free),
                jc.generate_constraint_function()(free)) <= RTOL
    assert _rel(tc.generate_jacobian_function()(free),
                jc.generate_jacobian_function()(free)) <= RTOL
    got = tc.jacobian_blocks(torch.as_tensor(free))
    want = jc.jacobian_blocks(jnp.asarray(free))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_hessian_blocks(pair):
    _, jc, tc = pair
    free = _free(jc, 3)
    y = np.random.default_rng(4).normal(size=(jc.num_collocation_nodes - 1,
                                              jc.num_eom))
    got = tc.hessian_blocks(torch.as_tensor(free), torch.as_tensor(y))
    want = jc.hessian_blocks(jnp.asarray(free), jnp.asarray(y))
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_lane_batches(pair):
    """The evaluators compose with torch.func.vmap over lanes, as the
    solver runs them."""
    _, jc, tc = pair
    X = torch.as_tensor(np.stack([_free(jc, s) for s in (5, 6)]))
    res, inst = torch.func.vmap(tc.constraints_nodewise)(X)
    for lane in range(2):
        r1, i1 = tc.constraints_nodewise(X[lane])
        assert torch.equal(res[lane], r1) and torch.equal(inst[lane], i1)


@pytest.mark.parametrize('method', ['backward euler', 'midpoint'])
def test_discrete_symbols_and_eom(method):
    """TestDiscreteSymbolIntrospection: the per-node symbols and the
    symbolically discretized EoMs, with a known implicit function
    among the inputs."""
    args, kw = _implicit(method)
    jc, tc = JaxCol(*args, **kw), TorchCol(*args, device='cpu', **kw)
    for name in ('previous_discrete_state_symbols',
                 'current_discrete_state_symbols',
                 'next_discrete_state_symbols',
                 'current_known_discrete_specified_symbols',
                 'next_known_discrete_specified_symbols',
                 'current_unknown_discrete_specified_symbols',
                 'next_unknown_discrete_specified_symbols',
                 'current_discrete_specified_symbols',
                 'next_discrete_specified_symbols'):
        assert getattr(tc, name) == getattr(jc, name), name
    assert sm.simplify(tc.discrete_eom - jc.discrete_eom) == sm.zeros(2, 1)


def test_errors_as_the_reference():
    def both(exc, match, *args, **kw):
        with pytest.raises(exc, match=match):
            JaxCol(*args, **kw)
        with pytest.raises(exc, match=match):
            TorchCol(*args, device='cpu', **kw)

    both(ValueError, 'integration_method', EOM, (x, v), N, H,
         time_symbol=t, integration_method='rk4')
    both(ValueError, 'not length', EOM, (x, v), N, H,
         known_parameter_map=KNOWN,
         known_trajectory_map={F: np.zeros(N + 1)}, time_symbol=t)
    both(ValueError, 'Derivative', EOM_IMPLICIT, (xi_, vi_), N_IMPLICIT, 0.1,
         known_parameter_map={mi: 3.3, gi: 10.2},
         known_trajectory_map={si_: S_VALS, theta_of_x: np.zeros(N_IMPLICIT)},
         time_symbol=ti)
    both(TypeError, 'integer multiple', EOM, (x, v), N, h_sym,
         known_parameter_map=KNOWN, known_trajectory_map={F: F_VALS},
         instance_constraints=(x.func(0.5 * h_sym),), time_symbol=t)
    both(ValueError, 'between 0 and', EOM, (x, v), N, h_sym,
         known_parameter_map=KNOWN, known_trajectory_map={F: F_VALS},
         instance_constraints=(x.func(7 * h_sym),), time_symbol=t)


# ---------------------------------------------------------------------------
# Problem: eom_bounds, bounds on unknown parameters and h, solves
# ---------------------------------------------------------------------------

def _same_solve(jp, tp, x0, obj_tol=1e-8):
    _, want = jp.solve(x0)
    sol, got = tp.solve(x0)
    assert got['status'] == want['status'] == 0
    assert got['iterations'] == want['iterations']
    assert abs(got['obj_val'] - want['obj_val']) <= obj_tol * abs(
        want['obj_val'])
    return sol


def _eom_bounds_problems():
    """TestEomBounds: a double integrator whose third EoM row x - 0.5 is
    held in [0, inf)."""
    xs, vs, us = [sm.Function(s)(t) for s in 'xvu']
    eom = sm.Matrix([xs.diff(t) - vs, vs.diff(t) - us, xs - 0.5])
    n_nodes, duration = 51, 2.0
    interval = duration / (n_nodes - 1)
    inst = (xs.subs(t, 0.0) - 2.0, xs.subs(t, duration) - 2.0,
            vs.subs(t, 0.0) + 3.0)
    out = []
    for Prob, objective, extra in ((JaxProblem, jax_objective, {}),
                                   (TorchProblem, torch_objective,
                                    dict(device='cpu'))):
        obj, grad = objective(sm.Integral(us ** 2, t), (xs, vs), (us,), (),
                              n_nodes, interval, time_symbol=t)
        out.append(Prob(obj, grad, eom, (xs, vs), n_nodes, interval,
                        instance_constraints=inst,
                        eom_bounds={2: (0.0, np.inf)}, time_symbol=t,
                        **extra))
    return out, n_nodes


def test_eom_bounds():
    (jp, tp), n_nodes = _eom_bounds_problems()
    assert tp.eom_bounds == jp.eom_bounds
    np.testing.assert_array_equal(tp._low_con_bounds, jp._low_con_bounds)
    np.testing.assert_array_equal(tp._upp_con_bounds, jp._upp_con_bounds)
    x0 = np.random.default_rng(3).standard_normal(jp.num_free) * 0.1
    x0[:n_nodes] = 2.0
    sol = _same_solve(jp, tp, x0)
    assert np.min(sol[:n_nodes]) >= 0.5 - 1e-6
    with pytest.raises(ValueError, match='eom_bounds'):
        TorchProblem(lambda f: f.sum(), None, EOM, (x, v), N, H,
                     known_parameter_map=KNOWN,
                     known_trajectory_map={F: F_VALS}, time_symbol=t,
                     eom_bounds={5: (0.0, 1.0)}, device='cpu')


def test_bounds_on_parameters_and_h():
    """Bounds on an unknown parameter, an unknown input and the node
    interval land on the same free entries in both packages."""
    bounds = {m: (0.5, 3.0), F: (-2.0, 2.0), h_sym: (0.001, 0.1)}
    probs = [Prob(lambda f: f[-1], None, EOM, (x, v), N, h_sym,
                  known_parameter_map={c: 0.3, k: 2.0}, bounds=bounds,
                  time_symbol=t, **extra)
             for Prob, extra in ((JaxProblem, {}),
                                 (TorchProblem, dict(device='cpu')))]
    jp, tp = probs
    np.testing.assert_array_equal(tp.lower_bound, jp.lower_bound)
    np.testing.assert_array_equal(tp.upper_bound, jp.upper_bound)
    assert tp.lower_bound[-1] == 0.001 and tp.upper_bound[-2] == 3.0
    free = _free(jp.collocator, 8)
    for got, want in zip(tp.parse_free(free), jp.parse_free(free)):
        np.testing.assert_array_equal(got, want)


def test_variable_duration_solve():
    """TestVariableDuration's swing-up with a free node interval, at
    N = 51 and a torque bound of 20 (the reference's N = 501 with a
    bound of 2 takes minutes on the CPU), through both packages'
    ``swing_up_problem(variable_duration=True)``."""
    n_nodes = 51
    jp = jax_swing_up(num_nodes=n_nodes, torque_bound=20.0,
                      variable_duration=True)
    tp = torch_swing_up(num_nodes=n_nodes, torque_bound=20.0,
                        variable_duration=True, device='cpu')
    np.testing.assert_array_equal(tp.lower_bound, jp.lower_bound)
    np.testing.assert_array_equal(tp.upper_bound, jp.upper_bound)
    x0 = np.random.default_rng(3).normal(size=jp.num_free) * 0.1
    x0[-1] = 0.05
    assert abs(tp.objective(x0) - jp.objective(x0)) <= RTOL * abs(
        jp.objective(x0))
    sol = _same_solve(jp, tp, x0)
    assert 0.0 < sol[-1] < 0.5
    np.testing.assert_allclose(sol[n_nodes - 1], np.pi, atol=1e-6)


def test_parameter_identification():
    """TestParameterIdentification: midpoint integration with an
    unknown parameter p identified from noisy data, at N = 200 over
    10 s (the reference's 1,000 nodes over 25 s)."""
    from scipy.integrate import odeint
    p = sm.Symbol('p')
    y1, y2 = [f(t) for f in sm.symbols('y1, y2', cls=sm.Function)]
    eom = sm.Matrix([y1.diff(t) - y2, y2.diff(t) + p * sm.sin(y1)])
    n_nodes, duration = 200, 10.0
    interval = duration / (n_nodes - 1)
    tv = np.linspace(0.0, duration, num=n_nodes)
    y_meas = odeint(lambda yy, tt: np.array([yy[1], -10.0 * np.sin(yy[0])]),
                    [np.pi / 6, 0.0], tv)
    y1_meas = y_meas[:, 0] + np.random.default_rng(11).normal(
        scale=0.02, size=n_nodes)
    y1j, y1t = jnp.asarray(y1_meas), torch.as_tensor(y1_meas)
    jp = JaxProblem(
        lambda f: interval * jnp.sum((y1j - f[:n_nodes]) ** 2), None, eom,
        (y1, y2), n_nodes, interval, time_symbol=t,
        integration_method='midpoint')
    tp = TorchProblem(
        lambda f: interval * torch.sum((y1t - f[:n_nodes]) ** 2), None, eom,
        (y1, y2), n_nodes, interval, time_symbol=t,
        integration_method='midpoint', device='cpu')
    x0 = np.hstack([y1_meas, np.gradient(y1_meas, interval), 30.0])
    sol = _same_solve(jp, tp, x0)
    np.testing.assert_allclose(sol[-1], 10.0, rtol=1e-2)
