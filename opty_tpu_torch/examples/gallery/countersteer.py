"""Bicycle Countersteering — minimum-time 90-degree turn.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_countersteer.py): a single-DoF
roll model of a bicycle at constant forward speed; the steer angle is
a pseudo-state tied to the steer-rate input by an added differential
equation, and the solver must discover the countersteering maneuver
(steer left to turn right) that changes heading 90 degrees in minimum
(variable) time.

Run:  python -m opty_tpu_torch.examples.gallery.countersteer
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem


def build_problem(num_nodes=201, device=None):

    h, a, b, v, g = sm.symbols('h a, b, v, g', real=True)
    m, I1, I2, I3 = sm.symbols('m, I1, I2, I3', real=True)
    theta, omega = me.dynamicsymbols('theta, omega', real=True)
    x, y, psi = me.dynamicsymbols('x, y, psi', real=True)
    delta, beta = me.dynamicsymbols('delta, beta', real=True)
    t = me.dynamicsymbols._t

    eom = sm.Matrix([
        theta.diff(t) - omega,
        (I1 + m * h ** 2) * omega.diff(t)
        + (I3 - I2 - m * h ** 2) * (v * sm.tan(delta) / b) ** 2
        * sm.sin(theta) * sm.cos(theta)
        - m * g * h * sm.sin(theta)
        + m * h * sm.cos(theta) * (a * v / b / sm.cos(delta) ** 2 * beta
                                   + v ** 2 / v * sm.tan(delta)),
        x.diff(t) - v * sm.cos(psi),
        y.diff(t) - v * sm.sin(psi),
        psi.diff(t) - v / b * sm.tan(delta),
        delta.diff(t) - beta,
    ])

    states = (theta, omega, x, y, psi, delta)
    par_map = {I1: 9.2, I2: 11.0, I3: 2.8, a: 0.5, b: 1.0, g: 9.81,
               h: 1.0, m: 87.0, v: 5.0}

    dt = sm.symbols('Delta_t', real=True)
    end = (num_nodes - 1) * dt

    instance_constraints = (
        theta.func(0 * dt), omega.func(0 * dt), x.func(0 * dt),
        y.func(0 * dt), psi.func(0 * dt), delta.func(0 * dt),
        theta.func(end), omega.func(end),
        psi.func(end) - np.deg2rad(90.0), delta.func(end),
    )

    def objective(free):
        return free[-1]

    bounds = {
        psi: (np.deg2rad(-360.0), np.deg2rad(360.0)),
        theta: (np.deg2rad(-90.0), np.deg2rad(90.0)),
        delta: (np.deg2rad(-90.0), np.deg2rad(90.0)),
        beta: (np.deg2rad(-200.0), np.deg2rad(200.0)),
        omega: (np.deg2rad(-100.0), np.deg2rad(100.0)),
        dt: (0.001, 0.5),
    }

    prob = Problem(objective, None, eom, states, num_nodes, dt,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:295


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:91-93,
    after plot_countersteer.py:175)."""
    return 0.01 * np.ones(prob.num_free)


def main():
    prob = build_problem()
    solution, info = prob.solve(initial_guess(prob))
    dur = float(solution[-1]) * (prob.collocator.num_collocation_nodes - 1)
    print('status={} iters={} turn duration={:.3f}s'.format(
        info['status'], info['iterations'], dur))
    assert info['status'] in (0, 1), info['status_msg']
    # countersteer signature: the initial steer moves OPPOSITE to the
    # turn direction
    xs, us = prob.parse_free(solution)[:2]
    steer = xs[5]
    assert steer[1:10].mean() < 0.0   # right turn begins by steering left
    return solution, info


if __name__ == '__main__':
    main()
