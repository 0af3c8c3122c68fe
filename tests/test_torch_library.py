"""opty_tpu_torch's utilities, parameter-identification helpers and
Problem helpers against opty_tpu's, on the CPU with the same inputs:
the utilities of utils.py (lambdify_matrix evaluated on the same
points), every function of parameter_identification.py (the tracking
objective's gradient to 1e-12 relative), and the Problem helpers on the
N = 11 problem of tests/test_problem_api.py: the same values, the same
errors with the same messages.
"""

import numpy as np
import pytest
import sympy as sm
import torch

import jax.numpy as jnp

import opty_tpu.parameter_identification as jpi
import opty_tpu.utils as ju
import opty_tpu_torch.parameter_identification as tpi
import opty_tpu_torch.utils as tu
from opty_tpu import Problem as JaxProblem
from opty_tpu_torch import Problem as TorchProblem

t = sm.Symbol('t')
x, v, F = [sm.Function(s)(t) for s in 'xvF']
m, c, k = sm.symbols('m, c, k')
EOM = sm.Matrix([x.diff(t) - v, m * v.diff(t) + c * v + k * x - F])
N = 11
H = 0.1
DUR = H * (N - 1)
PAR = {m: 1.0, c: 0.5, k: 2.0}


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------

def test_state_derivatives_and_f_minus_ma():
    assert tu.state_derivatives((x, v)) == ju.state_derivatives((x, v))
    mm = sm.Matrix([[1, 0], [0, 2]])
    fo = sm.Matrix([v, F])
    assert tu.f_minus_ma(mm, fo, (x, v)) == ju.f_minus_ma(mm, fo, (x, v))


@pytest.mark.parametrize('seed', [4, 11])
def test_sum_of_sines(seed):
    tv = np.linspace(0.0, 5.0, 37)
    freqs = [1.0, 2.3, 3.7, 5.1, 7.3]
    np.random.seed(seed)
    want = ju.sum_of_sines(4.0, freqs, tv)
    np.random.seed(seed)
    got = tu.sum_of_sines(4.0, freqs, tv)
    for g, w in zip(got, want):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('a, b', [
    ([[0.0, 1.0], [-2.0, -3.0]], [0.0, 1.0]),
    (np.eye(2), [1.0, 0.0]),
    ([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 2.0, 3.0]],
     [[0.0], [0.0], [1.0]])])
def test_controllable(a, b):
    assert tu.controllable(a, b) == ju.controllable(a, b)


def test_substitute_matrix():
    rng = np.random.default_rng(2)
    base = rng.normal(size=(5, 6))
    sub = rng.normal(size=(2, 3))
    got = tu.substitute_matrix(base.copy(), [1, 3], [0, 2, 5], sub)
    want = ju.substitute_matrix(base.copy(), [1, 3], [0, 2, 5], sub)
    np.testing.assert_array_equal(got, want)
    for mod in (tu, ju):
        with pytest.raises(ValueError, match='not compatible'):
            mod.substitute_matrix(base.copy(), [1], [0, 2], sub)


def test_mathjax_repr_and_building_docs(monkeypatch):
    expr = sm.sin(x) ** 2 + F
    assert repr(tu.MathJaxRepr(expr)) == repr(ju.MathJaxRepr(expr))
    assert tu.MathJaxRepr(expr)._repr_latex_() == \
        ju.MathJaxRepr(expr)._repr_latex_()
    for var in ('READTHEDOCS', 'SPHINX_BUILD'):
        monkeypatch.delenv(var, raising=False)
    assert tu.building_docs() is ju.building_docs() is False
    monkeypatch.setenv('SPHINX_BUILD', '1')
    assert tu.building_docs() is ju.building_docs() is True


def test_lambdify_matrix():
    a, b, p = sm.symbols('a, b, p')
    mat = sm.Matrix([[sm.sin(a) * b + p, sm.tanh(30 * a) - b ** 2],
                     [sm.exp(-a * p) * sm.cos(b), a / (1 + b ** 2)],
                     [sm.sqrt(1 + a ** 2), 2.5]])
    jfn = ju.lambdify_matrix((a, b, p), mat)
    tfn = tu.lambdify_matrix((a, b, p), mat)
    for vals in np.random.default_rng(5).normal(size=(6, 3)):
        want = np.asarray(jfn(*[jnp.asarray(val) for val in vals]))
        got = tfn(*[torch.tensor(val, dtype=torch.float64) for val in vals])
        assert got.shape == (6,)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-14, atol=0)


# ---------------------------------------------------------------------------
# parameter identification
# ---------------------------------------------------------------------------

def ident_data(seed, n_meas=37, n=4, o=2, span=2.0):
    rng = np.random.default_rng(seed)
    tm = np.sort(np.concatenate([[0.0, span], rng.uniform(0, span,
                                                          n_meas - 2)]))
    y = rng.normal(size=(n_meas, o))
    Nd = 21
    h = span / (Nd - 1)
    free = rng.normal(size=n * Nd + 3)
    return Nd, n, h, tm, y, free


def test_output_equations():
    xs = np.random.default_rng(0).normal(size=(7, 6))
    np.testing.assert_array_equal(tpi.output_equations(xs),
                                  jpi.output_equations(xs))
    got = tpi.output_equations(torch.as_tensor(xs))
    np.testing.assert_array_equal(got.numpy(), xs[:, :3])


def test_resample_and_its_range():
    tm = np.linspace(0.0, 1.0, 11)
    ym = np.random.default_rng(1).normal(size=(11, 2))
    grid = np.linspace(0.0, 1.0, 7)
    np.testing.assert_array_equal(tpi._resample(tm, ym, grid),
                                  jpi._resample(tm, ym, grid))
    for mod in (tpi, jpi):
        with pytest.raises(ValueError, match='outside the measured'):
            mod._resample(tm, ym, np.linspace(0.0, 1.5, 5))
        with pytest.raises(ValueError, match='outside the measured'):
            mod._resample(tm, ym, np.linspace(-0.1, 1.0, 5))


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_objective_and_gradient(seed):
    Nd, n, h, tm, y, free = ident_data(seed)
    args = (Nd, n, h, tm, y)
    assert tpi.objective_function(free, *args) == \
        jpi.objective_function(free, *args)
    np.testing.assert_array_equal(
        tpi.objective_function_gradient(free, *args),
        jpi.objective_function_gradient(free, *args))
    wrapped = tpi.wrap_objective(tpi.objective_function, *args)
    assert wrapped(free) == jpi.wrap_objective(jpi.objective_function,
                                               *args)(free)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_tracking_objective(seed):
    """make_tracking_objective: the value against the JAX package's and
    the numpy objective, the torch.func gradient against jax.grad to
    1e-12 relative and against the closed form."""
    Nd, n, h, tm, y, free = ident_data(seed)
    jobj, jgrad = jpi.make_tracking_objective(Nd, n, h, tm, y)
    tobj, tgrad = tpi.make_tracking_objective(Nd, n, h, tm, y,
                                              device='cpu')
    ft = torch.as_tensor(free)
    want = float(jobj(jnp.asarray(free)))
    np.testing.assert_allclose(float(tobj(ft)), want, rtol=1e-12)
    np.testing.assert_allclose(float(tobj(ft)),
                               tpi.objective_function(free, Nd, n, h, tm, y),
                               rtol=1e-12)
    g_want = np.asarray(jgrad(jnp.asarray(free)))
    g_got = tgrad(ft).numpy()
    err = np.max(np.abs(g_got - g_want)) / np.max(np.abs(g_want))
    assert err <= 1e-12
    np.testing.assert_allclose(
        g_got, tpi.objective_function_gradient(free, Nd, n, h, tm, y),
        rtol=1e-12, atol=1e-14)
    batch = torch.as_tensor(np.stack([free, 2.0 * free]))
    np.testing.assert_allclose(torch.func.vmap(tobj)(batch)[1].item(),
                               float(jobj(jnp.asarray(2.0 * free))),
                               rtol=1e-12)


# ---------------------------------------------------------------------------
# Problem helpers (tests/test_problem_api.py's problem)
# ---------------------------------------------------------------------------

def problems(**kwargs):
    """The same problem in both packages: {'jax': ..., 'torch': ...}."""
    out = {}
    for name, P, mod in (('jax', JaxProblem, ju), ('torch', TorchProblem,
                                                   tu)):
        obj, obj_grad = mod.create_objective_function(
            sm.Integral(F ** 2, t), (x, v), (F,), tuple(), N, H,
            time_symbol=t)
        kw = dict(known_parameter_map=PAR, time_symbol=t)
        kw.update(kwargs)
        if name == 'torch':
            kw['device'] = 'cpu'
        out[name] = P(obj, obj_grad, EOM, (x, v), N, H, **kw)
    return out


def same_outcome(probs, call):
    """Run ``call(problem)`` on both packages' ``probs``: both raise
    ValueError with the same message, or both return equal values.
    Returns ('error', message) or ('value', the JAX package's)."""
    results = {}
    for name, prob in probs.items():
        try:
            results[name] = ('value', call(prob))
        except ValueError as err:
            results[name] = ('error', str(err))
    (kj, vj), (kt, vt) = results['jax'], results['torch']
    assert kj == kt, results
    if kj == 'error':
        assert vt == vj
    else:
        np.testing.assert_array_equal(np.asarray(vt), np.asarray(vj))
    return kj, vj


BAD_GUESS = np.zeros(3 * N)
BAD_GUESS[2 * N] = 5.0


@pytest.mark.parametrize('kwargs, guess, raises', [
    (dict(bounds={F: (-1.0, 1.0)}), np.zeros(3 * N), False),
    (dict(bounds={F: (-1.0, 1.0)}), BAD_GUESS, 'violates'),
    (dict(bounds={F: (1.0, -1.0)}), np.zeros(3 * N), 'greater'),
    (dict(bounds={x: (-1.0, 1.0), F: (0.5, 2.0)}), BAD_GUESS, 'violates'),
    (dict(eom_bounds={1: (2.0, -2.0)}), np.zeros(3 * N), 'greater'),
    (dict(bounds={F: (np.linspace(-1.0, -2.0, N), 3.0)}), BAD_GUESS,
     'violates')])
def test_check_bounds_conflict(kwargs, guess, raises):
    kind, msg = same_outcome(problems(**kwargs),
                             lambda prob: prob.check_bounds_conflict(guess))
    assert kind == ('error' if raises else 'value')
    if raises:
        assert raises in msg


def test_solve_respect_bounds():
    """respect_bounds=True raises before solving where the JAX package
    raises, with its message; without it, the port solves."""
    probs = problems(bounds={F: (-1.0, 1.0)})
    msgs = []
    for prob in probs.values():
        with pytest.raises(ValueError, match='violates') as err:
            prob.solve(BAD_GUESS, respect_bounds=True)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    probs['torch'].set_solver_options(max_iter=2)
    _, info = probs['torch'].solve(BAD_GUESS)
    assert info['iterations'] == 2


def test_extract_and_fill():
    probs = problems()
    free = np.arange(3 * N, dtype=float)
    for var in ((x,), (F,), (x, F), (v, x)):
        np.testing.assert_array_equal(
            probs['torch'].extract_values(free, *var),
            probs['jax'].extract_values(free, *var))
    filled = {}
    for name, prob in probs.items():
        filled[name] = free.copy()
        prob.fill_free(filled[name], np.linspace(0, 1, N), F)
        prob.fill_free(filled[name], -np.ones(2 * N), v, x)
    np.testing.assert_array_equal(filled['torch'], filled['jax'])
    for call in (lambda prob: prob.extract_values(free, sm.Symbol('zz')),
                 lambda prob: prob.fill_free(free.copy(), 0.0, x,
                                             sm.Function('q')(t))):
        assert same_outcome(probs, call)[0] == 'error'


def test_time_vector():
    probs = problems()
    np.testing.assert_array_equal(probs['torch'].time_vector(),
                                  probs['jax'].time_vector())
    np.testing.assert_array_equal(
        probs['torch'].time_vector(start_time=2.5),
        probs['jax'].time_vector(start_time=2.5))


def variable_duration_problems(**kwargs):
    h = sm.Symbol('h', real=True)
    out = {}
    for name, P, mod in (('jax', JaxProblem, ju), ('torch', TorchProblem,
                                                   tu)):
        obj, obj_grad = mod.create_objective_function(
            sm.Integral(F ** 2, t), (x, v), (F,), tuple(), N, h,
            time_symbol=t)
        kw = dict(known_parameter_map=PAR, time_symbol=t,
                  instance_constraints=(x.subs(t, 0 * h) - 1.0,
                                        x.subs(t, (N - 1) * h) - 3.0,
                                        v.subs(t, 4 * h) + 0.5))
        kw.update(kwargs)
        if name == 'torch':
            kw['device'] = 'cpu'
        out[name] = P(obj, obj_grad, EOM, (x, v), N, h, **kw)
    return out


@pytest.mark.parametrize('solution, start', [
    (None, 0.0), ('h=0.2', 0.0), ('h=0.2', 1.0), ('h=0.2', 2.5),
    ('h=-0.1', 0.0), ('h=0', 0.0)])
def test_time_vector_variable_duration(solution, start):
    sol = None
    if solution is not None:
        sol = np.zeros(3 * N + 1)
        sol[-1] = float(solution.split('=')[1])
    kind, _ = same_outcome(
        variable_duration_problems(),
        lambda prob: prob.time_vector(solution=sol, start_time=start))
    assert kind == ('value' if solution == 'h=0.2' and start < 2.0
                    else 'error')


@pytest.mark.parametrize('kwargs', [
    dict(instance_constraints=(x.subs(t, 0.0) - 1.0, x.subs(t, DUR) - 3.0,
                               v.subs(t, 0.0))),
    dict(instance_constraints=(x.subs(t, 0.0) - 1.0, x.subs(t, 0.5) + 2.0,
                               x.subs(t, DUR) - 3.0,
                               x.subs(t, 0.0) - v.subs(t, DUR))),
    dict(bounds={F: (-2.0, 6.0)}),
    dict(bounds={F: (1.0, np.inf)}),
    dict(bounds={F: (-np.inf, -0.5)}),
    dict(bounds={F: (np.linspace(-1.0, 1.0, N), np.full(N, 4.0))})])
def test_create_linear_initial_guess(kwargs):
    probs = problems(**kwargs)
    np.testing.assert_array_equal(
        probs['torch'].create_linear_initial_guess(),
        probs['jax'].create_linear_initial_guess())


@pytest.mark.parametrize('end_time', [1.0, 4.0])
def test_linear_initial_guess_variable_duration(end_time):
    for kwargs in ({}, dict(bounds={sm.Symbol('h', real=True): (0.1, 0.3)})):
        probs = variable_duration_problems(**kwargs)
        np.testing.assert_array_equal(
            probs['torch'].create_linear_initial_guess(end_time),
            probs['jax'].create_linear_initial_guess(end_time))
