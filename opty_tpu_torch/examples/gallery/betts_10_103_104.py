"""DAE vs ODE formulation (Betts 10.103/10.104) — Cartesian pendulum.

Port of the reference gallery problem
(examples-gallery/beginner/plot_betts_10_103_104.py, test problems
10.103/10.104 of Betts 2010): the same minimum-effort Cartesian
pendulum solved twice — once with the algebraic constraint row
``y2^2 + y3^2 - 2 y4 - g y1 = 0`` kept as a DAE, once with its time
derivative (an ODE row containing *products of state derivatives*,
exercising the discretizer on nonlinear derivative terms).  The book's
objective value is 12.8738850 (reference script lines 128-133).

Run:  python -m opty_tpu_torch.examples.gallery.betts_10_103_104
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function

BOOK_OBJ = 12.8738850
G = 9.81


def build_problem(formulation='dae', num_nodes=751, device=None):

    t = me.dynamicsymbols._t
    y = me.dynamicsymbols('y0, y1, y2, y3, y4')
    u = me.dynamicsymbols('u')

    t0, tf = 0.0, 3.0
    interval = (tf - t0) / (num_nodes - 1)

    obj, obj_grad = create_objective_function(
        sm.Integral(u ** 2, t), y, (u,), tuple(), num_nodes,
        node_time_interval=interval, time_symbol=t)

    instance_constraints = (
        y[0].func(t0) - 1,
        *[y[i].func(t0) - 0 for i in range(1, 5)],
        y[0].func(tf) - 0,
        y[2].func(tf) - 0,
    )
    bounds = {y[0]: (-5, 5), y[1]: (-5, 5), y[2]: (-5, 5),
              y[3]: (-5, 5), y[4]: (-1, 15)}

    common = [
        -y[0].diff(t) + y[2],
        -y[1].diff(t) + y[3],
        -y[2].diff(t) - 2 * y[4] * y[0] + u * y[1],
        -y[3].diff(t) - G - 2 * y[4] * y[1] - u * y[0],
    ]
    if formulation == 'dae':
        last = y[2] ** 2 + y[3] ** 2 - 2 * y[4] - G * y[1]
    else:                       # d/dt of the algebraic row (10.104)
        last = (-y[4].diff(t) + y[2] * y[2].diff(t)
                + y[3] * y[3].diff(t) - G * y[1].diff(t) / 2)
    eom = sm.Matrix(common + [last])

    prob = Problem(obj, obj_grad, eom, y, num_nodes, interval,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:302-303


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:136-138,
    after plot_betts_10_103_104.py:124)."""
    return np.zeros(prob.num_free)


def main():
    results = {}
    for formulation in ('dae', 'ode'):
        prob = build_problem(formulation)
        solution, info = prob.solve(initial_guess(prob))
        print('{}: status={} iters={} obj={:.6f} (book: {})'.format(
            formulation, info['status'], info['iterations'],
            info['obj_val'], BOOK_OBJ))
        assert info['status'] in (0, 1), info['status_msg']
        # the reference's own run lands BELOW the book value on the
        # DAE form ("opty with DAE gets a better result", script line
        # 128-133) — backward Euler at this N resolves a slightly
        # different discrete optimum.  Match that semantic: close to
        # the book value, never much above it.
        rel = (info['obj_val'] - BOOK_OBJ) / BOOK_OBJ
        print('  objective relative difference vs book: {:+.3%}'.format(rel))
        assert -0.10 < rel < 0.02, rel
        results[formulation] = (solution, info)
    return results


if __name__ == '__main__':
    main()
