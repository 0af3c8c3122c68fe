"""Linear spring-mass-damper, m v' + c v + k x = F(t): the counterpart
of opty_tpu/models/spring_damper.py (the system of the hand-checked
Jacobian tests)."""

import sympy as sm

from ..problem import Problem
from ..utils import create_objective_function

__all__ = ['spring_damper_problem']


def spring_damper_problem(num_nodes=101, duration=1.0,
                          integration_method='backward euler',
                          **problem_kwargs):
    """Minimum-effort move of a damped oscillator from rest at 0 to
    rest at 1.  ``problem_kwargs`` go to ``Problem`` (``device='cpu'``
    for the CPU)."""
    m, c, k, t = sm.symbols('m, c, k, t')
    x, v, F = [sm.Function(s)(t) for s in 'xvF']
    eom = sm.Matrix([x.diff(t) - v,
                     m * v.diff(t) + c * v + k * x - F])
    interval = duration / (num_nodes - 1)
    obj, obj_grad = create_objective_function(
        sm.Integral(F ** 2, t), (x, v), (F,), tuple(), num_nodes,
        interval, integration_method=integration_method, time_symbol=t)
    instance_constraints = (x.subs(t, 0.0), v.subs(t, 0.0),
                            x.subs(t, duration) - 1.0,
                            v.subs(t, duration))
    return Problem(obj, obj_grad, eom, (x, v), num_nodes, interval,
                   known_parameter_map={m: 1.0, c: 2.0, k: 10.0},
                   instance_constraints=instance_constraints,
                   integration_method=integration_method,
                   time_symbol=t, **problem_kwargs)
