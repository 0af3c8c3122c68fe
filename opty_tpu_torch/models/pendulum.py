"""Torque-driven compound pendulum swing-up, the canonical benchmark
(the counterpart of opty_tpu/models/pendulum.py)."""

import numpy as np
import sympy as sm
import torch

from ..problem import Problem
from ..utils import create_objective_function

__all__ = ['swing_up_problem']


def swing_up_problem(num_nodes=501, duration=10.0, torque_bound=2.0,
                     variable_duration=False, device=None,
                     **problem_kwargs):
    """Builds the swing-up Problem on ``device`` (None: the card).

    Dynamics:  theta' = omega ;  I omega' + m g d sin(theta) = T
    Objective: integral of T^2 (minimum effort), |T| <= torque_bound,
    boundary conditions hanging-down -> inverted at rest.
    """
    I, m, g, d, t = sm.symbols('I, m, g, d, t')
    theta, omega, T = sm.symbols('theta, omega, T', cls=sm.Function)
    state_symbols = (theta(t), omega(t))
    eom = sm.Matrix([theta(t).diff(t) - omega(t),
                     I * omega(t).diff(t) + m * g * d * sm.sin(theta(t))
                     - T(t)])
    par_map = {I: 1.0, m: 1.0, g: 9.81, d: 1.0}
    target = np.pi

    if variable_duration:
        h = sm.Symbol('h', real=True)

        def obj(prob, free):
            _, T_vals, _, h_val = prob.parse_free(free)
            return h_val * torch.sum(T_vals ** 2)

        instance_constraints = (theta(0 * h),
                                theta((num_nodes - 1) * h) - target,
                                omega(0 * h),
                                omega((num_nodes - 1) * h))
        bounds = {T(t): (-torque_bound, torque_bound), h: (0.0, 0.5)}
        return Problem(obj, None, eom, state_symbols, num_nodes, h,
                       known_parameter_map=par_map,
                       instance_constraints=instance_constraints,
                       bounds=bounds, time_symbol=t, device=device,
                       **problem_kwargs)

    interval = duration / (num_nodes - 1)
    obj, obj_grad = create_objective_function(
        sm.Integral(T(t) ** 2, t), state_symbols, (T(t),), tuple(),
        num_nodes, interval, time_symbol=t)
    instance_constraints = (theta(0.0), theta(duration) - target,
                            omega(0.0), omega(duration))
    return Problem(obj, obj_grad, eom, state_symbols, num_nodes, interval,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds={T(t): (-torque_bound, torque_bound)},
                   time_symbol=t, device=device, **problem_kwargs)
