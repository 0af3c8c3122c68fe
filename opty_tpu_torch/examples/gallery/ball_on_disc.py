"""Ball Rolling on a Spinning Disc — rolling-contact DAE with torque
drive and a time-varying known trajectory.

Port of the reference gallery problem
(examples-gallery/advanced/plot_ball_rolling_on_spinning_disc.py): a
ball rolls without slip on a disc spinning up as
``Omega (1 - exp(-alpha T))``; internal torques must bring it to the
disc center at rest in (weighted) minimum time.  Kane's method with
dependent coordinates/speeds (rolling constraints), body-fixed Euler
angles, and the elapsed time fed in as a known trajectory ``T(t)``.

Run:  python -m opty_tpu_torch.examples.gallery.ball_on_disc
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...problem import Problem
from ._common import csv, solve_cold


def build_problem(num_nodes=250, device=None):

    t = me.dynamicsymbols._t
    q1, q2, q3 = me.dynamicsymbols('q1 q2 q3')
    u1, u2, u3 = me.dynamicsymbols('u1 u2 u3')
    x, y, ux, uy = me.dynamicsymbols('x, y, ux, uy')
    t1, t2, t3 = me.dynamicsymbols('t1 t2 t3')
    T = sm.Function('T')
    Tdot, Tdotdot = sm.symbols('Tdot Tdotdot')
    mb, mo, g, r = sm.symbols('mb, mo, g, r')
    Omega, alpha = sm.symbols('Omega, alpha')

    inertial = me.ReferenceFrame('N')
    disc = me.ReferenceFrame('A2')
    ball_frame = me.ReferenceFrame('A1')
    origin = me.Point('O')
    origin.set_vel(inertial, 0)

    udisc = Omega * (1 - sm.exp(-alpha * T(t)))
    qdisc = (Omega * T(t) + Omega * sm.exp(-alpha * T(t)) / alpha
             - Omega / alpha)
    disc.orient_axis(inertial, qdisc, inertial.z)
    disc.set_ang_vel(inertial, udisc * inertial.z)
    ball_frame.orient_body_fixed(disc, (q1, q2, q3), '123')
    rot = ball_frame.ang_vel_in(inertial)
    ball_frame.set_ang_vel(disc, u1 * ball_frame.x + u2 * ball_frame.y
                           + u3 * ball_frame.z)
    rot1 = ball_frame.ang_vel_in(inertial)

    contact = me.Point('CP')
    contact.set_pos(origin, x * disc.x + y * disc.y)
    contact.set_vel(disc, ux * disc.x + uy * disc.y)
    center = contact.locatenew('Ao1', r * inertial.z)
    center.set_vel(inertial, center.pos_from(origin).diff(t, inertial))
    observer = center.locatenew('obs', r * ball_frame.x)
    observer.v2pt_theory(center, inertial, ball_frame)

    iball = 2.0 / 5.0 * mb * r ** 2
    ball = me.RigidBody(
        'ball', center, ball_frame, mb,
        (me.inertia(ball_frame, iball, iball, iball), center))
    obs_p = me.Particle('observer', observer, mo)
    loads = [(center, -mb * g * inertial.z),
             (observer, -mo * g * inertial.z),
             (ball_frame, t1 * ball_frame.x + t2 * ball_frame.y
              + t3 * ball_frame.z)]
    kd = sm.Matrix([ux - x.diff(t), uy - y.diff(t),
                    *[(rot - rot1).dot(uv) for uv in inertial]])
    speed_constr = sm.Matrix([ux - r * u2, uy + r * u1])
    hol_constr = sm.Matrix([x - r * q2, y + r * q1])
    kane = me.KanesMethod(
        inertial, q_ind=[q1, q2, q3], q_dependent=[x, y],
        u_ind=[u1, u2, u3], u_dependent=[ux, uy], kd_eqs=kd,
        velocity_constraints=speed_constr,
        configuration_constraints=hol_constr)
    fr, frstar = kane.kanes_equations([ball, obs_p], loads)
    frfrstar_reduced = sm.Matrix([(fr + frstar)[j] for j in range(3)])
    eom = kd.col_join(frfrstar_reduced).col_join(hol_constr)
    eom = me.msubs(eom, {sm.Derivative(T(t), t): Tdot,
                         sm.Derivative(T(t), (t, 2)): Tdotdot})

    h = sm.Symbol('h')
    state_symbols = (q1, q2, q3, x, y, u1, u2, u3, ux, uy)
    ns = len(state_symbols)
    disc_time = 7.5
    par_map = {mb: 5.0, mo: 1.0, r: 1.0, Omega: 10.0, alpha: 0.5,
               g: 9.81, Tdot: disc_time / num_nodes, Tdotdot: 0.0}
    interval_fix = np.linspace(0, disc_time, num_nodes)
    weight = 2.5e5
    N = num_nodes

    def obj(free):
        torques = free[ns * N:(ns + 3) * N]
        return free[-1] * (torch.sum(torques ** 2) + weight)

    t0, tf = 0.0, (num_nodes - 1) * h
    x_start = y_start = 7.0
    start = {q1: -y_start / par_map[r], q2: x_start / par_map[r],
             q3: 0.0, u1: 0.0, u2: 0.0, u3: 0.0,
             x: x_start, y: y_start, ux: 0.0, uy: 0.0}
    instance_constraints = tuple(
        s.subs({t: t0}) - v for s, v in start.items()) + tuple(
        s.subs({t: tf}) for s in (x, y, ux, uy))
    tl = 10.0
    bounds = {t1: (-tl, tl), t2: (-tl, tl), t3: (-tl, tl),
              h: (0.0, 1.0)}
    prob = Problem(obj, None, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   known_trajectory_map={T(t): interval_fix},
                   instance_constraints=instance_constraints,
                   time_symbol=t, bounds=bounds,
                   device=device)
    return prob, csv(
        'advanced/ball_rolling_on_spinning_disc_250_nodes_solution.csv')


def check(prob, ref_csv, max_iter=300, verbose=True):
    """The committed CSV is feasible here (1.4e-8) but is not a tight
    KKT point of this NLP: warm-started from it, our solver improves
    the weighted-min-time objective (h 0.01576 vs the CSV's 0.01624).
    The parity assertion is therefore matches-or-beats."""
    ref = np.loadtxt(ref_csv)
    g = np.asarray(prob.con(ref))
    cl, cu = prob._low_con_bounds, prob._upp_con_bounds
    viol = float(np.max(np.maximum(np.maximum(cl - g, g - cu), 0.0)))
    assert viol < 1e-6, viol
    prob.set_solver_options(max_iter=max_iter, mu_init=1e-9,
                            bound_push=1e-10, slack_push=1e-10)
    sol, info = prob.solve(ref)
    if verbose:
        print('feasibility {:.1e}; status={} iters={} '
              'h={:.5f} (reference h={:.5f})'.format(
                  viol, info['status'], info['iterations'],
                  sol[-1], ref[-1]))
    assert info['status'] in (0, 1), info['status_msg']
    assert sol[-1] <= ref[-1] * (1 + 1e-6)
    return sol, info


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:310


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:183-190,
    after plot_ball_rolling_on_spinning_disc.py:373-382)."""
    N = prob.collocator.num_collocation_nodes
    i3 = np.linspace(7.0, 0.0, N)     # y
    i2 = np.linspace(7.0, 0.0, N)     # x
    i1 = -i3                          # q1 = -y/r, r = 1
    i1a = i2                          # q2 = x/r
    return np.hstack((i1, i1a, np.zeros(N), i2, i3,
                      np.zeros(8 * N), 0.01))


def main():
    prob, ref_csv = build_problem()
    if ref_csv is None:
        return solve_cold(prob, initial_guess(prob), COLD_MAX_ITER,
                          verbose=True)
    return check(prob, ref_csv)


if __name__ == '__main__':
    main()
