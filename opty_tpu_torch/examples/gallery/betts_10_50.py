"""Delay Equation (Betts 10.50, Göllmann/Kern/Maurer).

Port of the reference gallery problem
(examples-gallery/beginner/plot_betts_10_50.py, example 10.50 of
Betts' "Practical Methods for Optimal Control", 2010): the delayed
system is unrolled into six states/controls coupled by *cross-time
instance constraints* (x2(t0) = x1(tf), ...) and six one-sided
``eom_bounds`` path inequalities u_k + x_k >= 0.3.  The book's
objective value is 3.10812211 (reference script line 164).

Run:  python -m opty_tpu_torch.examples.gallery.betts_10_50
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function

BOOK_OBJ = 3.10812211


def build_problem(num_nodes=501, device=None):

    t = me.dynamicsymbols._t
    xs = me.dynamicsymbols('x1, x2, x3, x4, x5, x6')
    us = me.dynamicsymbols('u1, u2, u3, u4, u5, u6')
    x1, x2, x3, x4, x5, x6 = xs
    u1, u2, u3, u4, u5, u6 = us

    x0 = 1.0
    u_minus_1, u0 = 0.0, 0.0

    eom = sm.Matrix([
        -x1.diff(t) + x0 * u_minus_1,
        -x2.diff(t) + x1 * u0,
        -x3.diff(t) + x2 * u1,
        -x4.diff(t) + x3 * u2,
        -x5.diff(t) + x4 * u3,
        -x6.diff(t) + x5 * u4,
        # inequality rows (eom_bounds below)
        u1 + x1, u2 + x2, u3 + x3, u4 + x4, u5 + x5, u6 + x6,
    ])

    t0, tf = 0.0, 1.0
    interval = (tf - t0) / (num_nodes - 1)

    obj, obj_grad = create_objective_function(
        sm.Integral(sum(x ** 2 for x in xs) + sum(u ** 2 for u in us), t),
        xs, us, tuple(), num_nodes, interval, time_symbol=t)

    # the delay structure: each state starts where the previous one
    # ended (instance constraints couple different states at different
    # time instances)
    instance_constraints = (
        x1.func(t0) - 1.0,
        x2.func(t0) - x1.func(tf),
        x3.func(t0) - x2.func(tf),
        x4.func(t0) - x3.func(tf),
        x5.func(t0) - x4.func(tf),
        x6.func(t0) - x5.func(tf),
        u1.func(t0) + x1.func(t0) - 0.5,
        u2.func(t0) + x2.func(t0) - 0.5,
        u3.func(t0) + x3.func(t0) - 0.5,
        u4.func(t0) + x4.func(t0) - 0.5,
        u5.func(t0) + x5.func(t0) - 0.5,
        u6.func(t0) + x6.func(t0) - 0.5,
    )

    eom_bounds = {k: (0.3, np.inf) for k in range(6, 12)}

    prob = Problem(obj, obj_grad, eom, xs, num_nodes, interval,
                   instance_constraints=instance_constraints,
                   eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:311


def initial_guess(prob):
    """The documented cold start, the original's ``main``
    (benchmarks/cold_gallery.py:193-195)."""
    return np.random.default_rng(4).random(prob.num_free) * 0.1


def main():
    prob = build_problem()
    prob.set_solver_options(max_iter=1000)
    solution, info = prob.solve(initial_guess(prob))
    print('status={} iters={} obj={:.6f} (book: {})'.format(
        info['status'], info['iterations'], info['obj_val'], BOOK_OBJ))
    assert info['status'] in (0, 1), info['status_msg']
    rel_err = abs(info['obj_val'] - BOOK_OBJ) / BOOK_OBJ
    print('objective relative error vs book: {:.3%}'.format(rel_err))
    assert rel_err < 0.02, rel_err
    return solution, info


if __name__ == '__main__':
    main()
