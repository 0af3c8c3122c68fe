"""Parallel Park a Car — nonholonomic vehicle, minimum effort.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_parallel_park.py): a planar
bicycle-model car (Kane's equations with two nonholonomic rolling
constraints kept as algebraic EoM rows, M = 14 > n = 8) must
translate 2 m sideways in 30 s, stationary at both ends, minimizing
steering-torque + drive-force effort, with steering-angle and
actuator bounds.

SOLVED in round 5 (previously KNOWN_HARD): the reference formulation
is doubly degenerate — the two final-node nonholonomic rows are
linear combinations of the instance rows pinning every state at
``tf`` (the constraint Jacobian has exactly two zero singular
values), and the effort objective leaves the reduced Hessian near
zero.  Rounds 2-4 reliably parked the car only HALFWAY (y(tf) ~
0.85-0.91 of the 2 m target, pr ~ 1.1 in the y(tf) instance row).
The round-5 solver — multiplier-step cap routing rank-deficient
directions to the delta_c cure (nlp/steps.py dir_quality) plus the
full inner restoration phase (steps.restoration_solve) — completes
the maneuver from the documented straight-line guess: status 0 in
~490 iterations, y(tf) = 2.0000.  ``main()`` asserts convergence.

Run:  python -m opty_tpu_torch.examples.gallery.parallel_park
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function


def _derive_eom():
    m, I, a, b = sm.symbols('m, I, a, b', real=True)
    x, y, vx, vy = me.dynamicsymbols('x, y, v_x, v_y', real=True)
    theta, omega = me.dynamicsymbols('theta, omega', real=True)
    delta, beta = me.dynamicsymbols('delta, beta', real=True)
    T, F = me.dynamicsymbols('T, F', real=True)
    t = me.dynamicsymbols._t

    O, Ao, Pr, Pf = sm.symbols('O, A_o, P_r, P_F', cls=me.Point)
    N, A, B = sm.symbols('N, A, B', cls=me.ReferenceFrame)

    A.orient_axis(N, theta, N.z)
    B.orient_axis(A, delta, A.z)

    Ao.set_pos(O, x * N.x + y * N.y)
    Pr.set_pos(Ao, -b * A.x)
    Pf.set_pos(Ao, a * A.x)

    A.set_ang_vel(N, omega * N.z)

    kinematical = [
        vx - (x.diff() * N.x + y.diff() * N.y).dot(A.x),
        vy - (x.diff() * N.x + y.diff() * N.y).dot(A.y),
        omega - theta.diff(),
        beta - delta.diff(),
    ]

    O.set_vel(N, 0)
    Ao.set_vel(N, vx * A.x + vy * A.y)
    Pr.v2pt_theory(Ao, N, A)
    Pf.v2pt_theory(Ao, N, A)

    nonholonomic = [Pr.vel(N).dot(A.y), Pf.vel(N).dot(B.y)]

    IA = me.inertia(A, 0, 0, I)
    car = me.RigidBody('A', Ao, A, m, (IA, Ao))
    IB = me.inertia(B, 0, 0, I / 32)
    wheel = me.RigidBody('B', Pf, B, m / 6, (IB, Pf))

    loads = [(Pr, F * A.x), (A, -T * B.z), (B, T * B.z)]

    kane = me.KanesMethod(
        N, [x, y, theta, delta], [vx, beta], kd_eqs=kinematical,
        u_dependent=[vy, omega], velocity_constraints=nonholonomic)
    fr, frstar = kane.kanes_equations([car, wheel], loads)

    eom = (fr + frstar).col_join(sm.Matrix(nonholonomic)).col_join(
        sm.Matrix(kinematical))
    states = (x, y, theta, delta, vx, vy, omega, beta)
    return eom, states, (T, F), (m, I, a, b), t


def build_problem(num_nodes=501, duration=30.0, device=None):

    eom, states, (T, F), (m, I, a, b), t = _derive_eom()
    x, y, theta, delta, vx, vy, omega, beta = states
    interval = duration / (num_nodes - 1)

    par_map = {I: 1 / 12 * 1200 * (2 ** 2 + 3 ** 2), m: 1200,
               a: 1.5, b: 1.5}

    obj, obj_grad = create_objective_function(
        sm.Integral(F ** 2 + T ** 2, t), states, (T, F), tuple(),
        num_nodes, interval, time_symbol=t)

    instance_constraints = tuple(
        s.func(0.0) for s in states) + (
        x.func(duration), y.func(duration) - 2.0, theta.func(duration),
        delta.func(duration), vx.func(duration), vy.func(duration),
        omega.func(duration), beta.func(duration))

    bounds = {delta: (np.deg2rad(-45.0), np.deg2rad(45.0)),
              T: (-50.0, 50.0), F: (-300.0, 300.0)}

    prob = Problem(obj, obj_grad, eom, states, num_nodes, interval,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:308


def initial_guess(prob):
    """The documented straight-line cold start, the original's
    ``main`` (benchmarks/cold_gallery.py:165-174, after
    plot_parallel_park.py:125-131)."""
    num_nodes = prob.collocator.num_collocation_nodes
    duration = 30.0
    time = np.asarray(prob.time_vector())
    x_guess = 3.0 / duration * 2.0 * time
    x_guess[num_nodes // 2:] = 6.0 - 3.0 / duration * 2.0 * \
        time[num_nodes // 2:]
    y_guess = 2.0 / duration * time
    guess = np.ones(prob.num_free)
    guess[:num_nodes] = x_guess
    guess[num_nodes:2 * num_nodes] = y_guess
    return guess


def main():
    prob = build_problem()
    solution, info = prob.solve(initial_guess(prob))
    print('status={} iters={} obj={:.6f}'.format(
        info['status'], info['iterations'], info['obj_val']))
    xs = prob.parse_free(solution)[0]
    print('y(tf) = {:.4f} (target 2.0)'.format(float(xs[1, -1])))
    assert info['status'] in (0, 1), info['status_msg']
    assert abs(float(xs[1, -1]) - 2.0) < 1e-6
    return solution, info


if __name__ == '__main__':
    main()
