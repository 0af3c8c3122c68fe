"""Hypersensitive Control (Betts 10.7) — single ODE, long horizon.

Port of the reference gallery problem
(examples-gallery/beginner/plot_betts_10_7.py, example 10.7 of Betts'
"Practical Methods for Optimal Control", 2010): minimize
``Integral(y^2 + u^2)`` subject to ``y' = -y^3 + u`` with y(0) = 1,
y(tf) = 1.5.  The problem is hypersensitive: the state rides y ~ 0 for
almost the whole horizon and all the action is in two boundary layers.
The book's objective value is 6.7241 (reference script line 94, with
the tf = 8 refinement it recommends at lines 109-115).

Run:  python -m opty_tpu_torch.examples.gallery.betts_10_7
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function

BOOK_OBJ = 6.7241


def build_problem(num_nodes=2001, tf=8.0, device=None):

    t = me.dynamicsymbols._t
    y, u = me.dynamicsymbols('y u')

    eom = sm.Matrix([-y.diff(t) - y ** 3 + u])

    t0 = 0.0
    interval = (tf - t0) / (num_nodes - 1)
    obj, obj_grad = create_objective_function(
        sm.Integral(y ** 2 + u ** 2, t), (y,), (u,), tuple(), num_nodes,
        node_time_interval=interval, time_symbol=t)

    instance_constraints = (y.func(t0) - 1.0, y.func(tf) - 1.5)

    prob = Problem(obj, obj_grad, eom, (y,), num_nodes, interval,
                   instance_constraints=instance_constraints,
                   time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:304


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:141-143,
    after plot_betts_10_7.py:79)."""
    return np.zeros(prob.num_free)


def main():
    prob = build_problem()
    solution, info = prob.solve(initial_guess(prob))
    print('status={} iters={} obj={:.4f} (book: {})'.format(
        info['status'], info['iterations'], info['obj_val'], BOOK_OBJ))
    assert info['status'] in (0, 1), info['status_msg']
    # backward Euler at this N sits within a percent of the book value
    rel_err = abs(info['obj_val'] - BOOK_OBJ) / BOOK_OBJ
    print('objective relative error vs book: {:.3%}'.format(rel_err))
    assert rel_err < 0.02, rel_err
    return solution, info


if __name__ == '__main__':
    main()
