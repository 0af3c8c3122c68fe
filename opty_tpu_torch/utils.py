"""User-facing utilities, the counterparts of opty_tpu/utils.py:
``parse_free``, ``create_objective_function`` (torch functions of the
free vector), ``state_derivatives``, ``f_minus_ma``, ``sum_of_sines``,
``controllable``, ``substitute_matrix``, ``MathJaxRepr``,
``building_docs`` and ``lambdify_matrix`` (a torch function)."""

import os

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch
from sympy.printing.pytorch import TorchPrinter

from .config import default_dtype
from .symbolics.classify import sort_sympy

__all__ = ['state_derivatives', 'f_minus_ma', 'parse_free', 'MathJaxRepr',
           'building_docs', 'lambdify_matrix', 'create_objective_function',
           'sort_sympy', 'sum_of_sines', 'controllable',
           'substitute_matrix']


class _CallPrinter(TorchPrinter):
    """SymPy's torch printer refuses functions it has no torch name
    for; print those as plain calls resolved in the lambdify namespace
    (the integral placeholder below)."""

    def _print_Function(self, expr):
        if type(expr) in self.mapping:
            return super()._print_Function(expr)
        return '{}({})'.format(expr.func.__name__,
                               ', '.join(self._print(a) for a in expr.args))


def state_derivatives(states):
    """Returns functions of time which represent the time derivatives
    of the states."""
    return [state.diff() for state in states]


def f_minus_ma(mass_matrix, forcing_vector, states):
    """Returns Fr + Fr* from the mass_matrix and forcing vector."""
    xdot = sm.Matrix(state_derivatives(states))
    return mass_matrix * xdot - forcing_vector


def parse_free(free, n, q, N, variable_duration=False):
    """Parses the free vector into (states (n, N), specified (q, N) or
    (N,) or None, constants (r,)[, h]); works on NumPy arrays and torch
    tensors alike (plain slicing/reshape)."""
    state_cut, input_cut = n * N, (n + q) * N
    states = free[:state_cut].reshape((n, N))
    # a single unknown input comes back 1-D, several as (q, N)
    if q == 0:
        specified = None
    elif q == 1:
        specified = free[state_cut:input_cut]
    else:
        specified = free[state_cut:input_cut].reshape((q, N))
    tail = free[input_cut:]
    if variable_duration:
        return states, specified, tail[:-1], tail[-1]
    return states, specified, tail


def create_objective_function(objective, state_symbols,
                              unknown_input_trajectories,
                              unknown_parameters,
                              num_collocation_nodes, node_time_interval,
                              integration_method='backward euler',
                              time_symbol=None):
    """Creates torch functions to evaluate the objective and its
    gradient from a SymPy expression that may hold non-nested
    indefinite time integrals ``Integral(expr, t)``.

    Returns ``(obj, obj_grad)``, both functions of one free vector;
    ``obj_grad`` is ``torch.func.grad(obj)``.  Both compose with
    ``torch.func.vmap`` for batches of free vectors.
    """
    if time_symbol is None:
        time_symbol = me.dynamicsymbols._t
    if integration_method not in ('backward euler', 'midpoint'):
        raise NotImplementedError(
            "Integration method '{}' is not implemented.".format(
                integration_method))

    states = list(state_symbols)
    inputs = sort_sympy(unknown_input_trajectories)
    params = sort_sympy(unknown_parameters)
    n, nq = len(states), len(inputs)
    N = num_collocation_nodes
    h = node_time_interval
    i_idx = n * N
    r_idx = (n + nq) * N
    dtype = default_dtype()

    int_placeholder = sm.Function('_IntegralFunction')

    def parse_expr(expr, in_integral=False):
        if not expr.args:
            return expr
        if isinstance(expr, sm.Integral):
            if in_integral:
                raise NotImplementedError('Nested integrals are not '
                                          'supported.')
            if expr.limits != ((time_symbol,),):
                raise NotImplementedError(
                    'Only indefinite integrals of time are supported.')
            return int_placeholder(parse_expr(expr.function, True))
        return expr.func(*(parse_expr(arg) for arg in expr.args))

    parsed = parse_expr(sm.sympify(objective))

    atoms = states + inputs + params
    dummies = [sm.Dummy('o{}'.format(i)) for i in range(len(atoms))]
    parsed = parsed.xreplace(dict(zip(atoms, dummies)))

    if integration_method == 'backward euler':
        # backward Euler quadrature: weights [0, 1, ..., 1] * h
        # (built on the device from vals: no host copy per call)
        def integrate(vals):
            weights = torch.cat([torch.zeros_like(vals[:1]),
                                 torch.ones_like(vals[1:])])
            return h * torch.sum(vals * weights)
    else:
        def integrate(vals):
            return h * torch.sum(vals)

    raw = sm.lambdify(dummies, parsed, modules=[
        {'_IntegralFunction': integrate}, 'torch'],
        printer=_CallPrinter(), docstring_limit=0)

    midpoint = integration_method == 'midpoint'

    def obj(free):
        free = free.to(dtype)
        X = free[:i_idx].reshape(n, N)
        U = free[i_idx:r_idx].reshape(nq, N)
        P = free[r_idx:]
        if midpoint:
            X = 0.5 * (X[:, :-1] + X[:, 1:])
            U = 0.5 * (U[:, :-1] + U[:, 1:])
        args = [X[i] for i in range(n)] + [U[i] for i in range(nq)] + \
            [P[i] for i in range(len(params))]
        val = raw(*args)
        if not isinstance(val, torch.Tensor):
            val = torch.full((), float(val), dtype=dtype,
                             device=free.device)
        return val.to(dtype)

    obj_grad = torch.func.grad(obj)
    return obj, obj_grad


def sum_of_sines(sigma, frequencies, time):
    """Returns a sum of sines centered at zero along with its first and
    second derivatives, numpy arrays of shape (n,): sigma / 2 times the
    sum over ``frequencies`` of sin(w t + phase), the phases drawn from
    numpy's global generator (``np.random.seed`` makes them
    repeatable)."""
    w = np.atleast_1d(np.asarray(frequencies, dtype=float))
    t = np.asarray(time, dtype=float)
    # random_sample is the generator's ranf: the same draws
    phase = 2.0 * np.pi * np.random.random_sample(w.shape)
    amplitude = sigma / 2.0
    arg = np.outer(w, t) + phase[:, None]
    sin_a, cos_a = np.sin(arg), np.cos(arg)
    return (amplitude * sin_a.sum(axis=0),
            amplitude * (w[:, None] * cos_a).sum(axis=0),
            -amplitude * (w[:, None] ** 2 * sin_a).sum(axis=0))


def controllable(a, b):
    """Returns True if the system is controllable, where ``a`` is the
    state matrix and ``b`` the input matrix (the Kalman rank
    condition)."""
    a = np.asarray(a)
    b = np.asarray(b)
    n = a.shape[0]
    if b.ndim == 1:
        b = b[:, None]
    cols = [b]
    for _ in range(n - 1):
        cols.append(a @ cols[-1])
    return np.linalg.matrix_rank(np.hstack(cols)) == n


def substitute_matrix(matrix, row_idxs, col_idxs, sub_matrix):
    """Returns the matrix with the values given by row/column indices
    replaced by the sub matrix (in place)."""
    if sub_matrix.shape != (len(row_idxs), len(col_idxs)):
        raise ValueError('The sub matrix is not compatible with the '
                         'provided indices.')
    for i, ri in enumerate(row_idxs):
        for j, cj in enumerate(col_idxs):
            matrix[ri, cj] = sub_matrix[i, j]
    return matrix


class MathJaxRepr:
    """Display object for SymPy expressions in notebooks and docs."""

    def __init__(self, expr):
        self.expr = expr

    def _repr_latex_(self):
        return '$${}$$'.format(sm.latex(self.expr))

    def __repr__(self):
        return sm.srepr(self.expr)


def building_docs():
    """True when running inside a documentation build."""
    return 'READTHEDOCS' in os.environ or 'SPHINX_BUILD' in os.environ


def lambdify_matrix(args, expr):
    """A SymPy matrix lowered to a torch function of scalar arguments:
    ``fn(*values)`` returns a tensor of shape (len(expr),), the entries
    in row-major order: symbolics/lower.py's lowering (the JAX
    package's CSE and overrides), printed by ``_CallPrinter``, so that
    an applied function with no torch name is a call resolved in the
    namespace."""
    from .symbolics.lower import _TORCH_OVERRIDES, lambdify_torch
    printer = _CallPrinter({
        'fully_qualified_modules': False, 'inline': True,
        'allow_unknown_functions': True,
        'user_functions': {k: k for k in _TORCH_OVERRIDES}})
    return lambdify_torch(args, list(expr), printer=printer)
