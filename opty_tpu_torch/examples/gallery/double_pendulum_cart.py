"""Upright a Double Pendulum on a Cart — minimum time, variable h.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_two_link_pendulum_on_a_cart.py):
a double pendulum (two rigid rods) on a cart must reach the upright
configuration in minimum free time under a bounded cart force, with
terminal accelerations pinned to zero through auxiliary input
trajectories h1..h3.

Run:  python -m opty_tpu_torch.examples.gallery.double_pendulum_cart
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify_or_solve, csv


def build_problem(num_nodes=300, device=None):

    t = me.dynamicsymbols._t
    q1, q2, q3 = me.dynamicsymbols('q1 q2 q3')
    u1, u2, u3 = me.dynamicsymbols('u1 u2 u3')
    F = me.dynamicsymbols('F')
    h1, h2, h3 = me.dynamicsymbols('h1 h2 h3')
    lx, m1, m2, m3, g = sm.symbols('lx, m1, m2, m3 g')
    iZZ1, iZZ2 = sm.symbols('iZZ1, iZZ2')

    inertial = me.ReferenceFrame('N')
    A1 = inertial.orientnew('A1', 'Axis', [q2, inertial.z])
    A1.set_ang_vel(inertial, u2 * inertial.z)
    A2 = inertial.orientnew('A2', 'Axis', [q3, inertial.z])
    A2.set_ang_vel(inertial, u3 * inertial.z)

    origin = me.Point('O')
    origin.set_vel(inertial, 0)
    cart = origin.locatenew('P1', q1 * inertial.x)
    cart.set_vel(inertial, u1 * inertial.x)
    joint1 = cart.locatenew('P2', lx * A1.x)
    joint1.v2pt_theory(cart, inertial, A1)
    tip = joint1.locatenew('P3', lx * A2.x)
    tip.v2pt_theory(joint1, inertial, A2)

    bodies = [
        me.Particle('cart', cart, m1),
        me.RigidBody('rod1', joint1, A1, m2,
                     (me.inertia(A1, 0, 0, iZZ1), joint1)),
        me.RigidBody('rod2', tip, A2, m3,
                     (me.inertia(A2, 0, 0, iZZ2), tip)),
    ]
    loads = [(cart, F * inertial.x - m1 * g * inertial.y),
             (joint1, -m2 * g * inertial.y),
             (tip, -m3 * g * inertial.y)]
    kd = sm.Matrix([q1.diff(t) - u1, q2.diff(t) - u2, q3.diff(t) - u3])
    kane = me.KanesMethod(inertial, q_ind=[q1, q2, q3],
                          u_ind=[u1, u2, u3], kd_eqs=kd)
    fr, frstar = kane.kanes_equations(bodies, loads=loads)
    eom = kd.col_join(fr + frstar)
    eom = eom.col_join(sm.Matrix([h1 - u1.diff(t), h2 - u2.diff(t),
                                  h3 - u3.diff(t)]))
    eom = sm.simplify(eom)

    state_symbols = (q1, q2, q3, u1, u2, u3)
    par_map = {lx: 2.0, m1: 1.0, m2: 1.0, m3: 1.0, g: 9.81,
               iZZ1: 2.0, iZZ2: 2.0}
    h = sm.Symbol('h')
    duration = (num_nodes - 1) * h
    target_angle = np.pi / 2.0

    def obj(free):
        return free[-1]

    instance_constraints = (
        q1.func(0.0), q2.func(0.0) + np.pi / 2.0,
        q3.func(0.0) + np.pi / 2.0,
        u1.func(0.0), u2.func(0.0), u3.func(0.0),
        q2.func(duration) - target_angle,
        q3.func(duration) - target_angle,
        u1.func(duration), u2.func(duration), u3.func(duration),
        h1.func(duration), h2.func(duration), h3.func(duration),
    )
    bounds = {F: (-50.0, 50.0), q1: (-5.0, 5.0), h: (0.0, 1.0)}
    prob = Problem(obj, None, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob, csv(
        'intermediate/double_pendulum_on_a_cart_300_nodes_solution.csv')


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:286-287


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:48-56,
    after plot_two_link_pendulum_on_a_cart.py:210-218)."""
    N = prob.collocator.num_collocation_nodes
    ta = np.pi / 2.0
    g = np.zeros(prob.num_free)
    g[N:2 * N] = np.linspace(-ta, ta, N)
    g[2 * N:3 * N] = np.linspace(-ta, ta, N)
    g[6 * N:7 * N] = 50.0
    g[-1] = 0.01
    return g


def main():
    prob, ref_csv = build_problem()
    # min-time bang-bang arcs leave the interior weakly determined, so
    # polishing the Ipopt CSV takes a few more iterations here
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER,
                            max_certify_iters=60)


if __name__ == '__main__':
    main()
