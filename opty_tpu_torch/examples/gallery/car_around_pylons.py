"""Drive a Car Around Pylons — minimum time, integral 'hit' counters.

Port of the reference gallery problem
(examples-gallery/advanced/plot_car_around_pylons.py): the same
nonholonomic car as ``car_in_garage`` must leave the origin, pass
close to two pylons at times of its own choosing, and return, in
minimum total time (variable step ``h`` is the only term in the
objective).  Closeness is encoded by integrator states
``punkt1/punkt2`` whose rates are smooth bump functions of the car's
position centered on each pylon, and auxiliary controls
``dist = punkt * h_i`` forced to 1 at the final time; path rows bound
the forward speed (no reversing) and both axles' lateral
acceleration via ``eom_bounds``.

The steep sigmoids are written through tanh (exact identity) so the
lowering stays finite on TPU's float-float f64 emulation — see
``car_in_garage`` for the details.

Run:  python -m opty_tpu_torch.examples.gallery.car_around_pylons
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify_or_solve, csv, unit_gradient


def _sigmoid(z):
    """1/(1 + exp(z)), written through tanh (exact, overflow-safe)."""
    return (1 - sm.tanh(z / 2)) / 2


def _hump(xx, a, b, steepness):
    """~1 inside [a, b], ~0 outside."""
    return 1.0 - (_sigmoid(steepness * (xx - a))
                  + _sigmoid(-steepness * (xx - b)))


def build_problem(num_nodes=401, device=None):

    t = me.dynamicsymbols._t
    N, A0, Ab, Af = sm.symbols('N A0 Ab Af', cls=me.ReferenceFrame)
    O, Pb, Dmc, Pf = sm.symbols('O Pb Dmc Pf', cls=me.Point)
    O.set_vel(N, 0)

    q0, qf = me.dynamicsymbols('q_0 q_f')
    u0, uf = me.dynamicsymbols('u_0 u_f')
    x, y = me.dynamicsymbols('x y')
    ux, uy = me.dynamicsymbols('u_x u_y')
    Tf, Fb = me.dynamicsymbols('T_f F_b')
    punkt1, punkt2 = me.dynamicsymbols('punkt1 punkt2')
    dist1, dist2 = me.dynamicsymbols('dist1 dist2')
    h1, h2 = me.dynamicsymbols('h1 h2')
    reibung = sm.symbols('reibung')
    l, m0, mb, mf, iZZ0, iZZb, iZZf = sm.symbols(
        'l m0 mb mf iZZ0, iZZb, iZZf')
    xb1, yb1, xb2, yb2 = sm.symbols('xb yb xb2 yb2')
    epsilon, steepness = sm.symbols('epsilon steepness')

    A0.orient_axis(N, q0, N.z)
    A0.set_ang_vel(N, u0 * N.z)
    Ab.orient_axis(A0, 0, N.z)
    Af.orient_axis(A0, qf, N.z)
    rot = Af.ang_vel_in(N)
    Af.set_ang_vel(N, uf * N.z)
    rot1 = Af.ang_vel_in(N)

    Pf.set_pos(O, x * N.x + y * N.y)
    Pf.set_vel(N, ux * N.x + uy * N.y)
    Pb.set_pos(Pf, -l * A0.y)
    Pb.v2pt_theory(Pf, N, A0)
    Dmc.set_pos(Pf, -l / 2 * A0.y)
    Dmc.v2pt_theory(Pf, N, A0)

    vel1 = me.dot(Pb.vel(N), Ab.x)
    vel2 = me.dot(Pf.vel(N), Af.x)

    I0 = me.inertia(A0, 0, 0, iZZ0)
    Ib = me.inertia(Ab, 0, 0, iZZb)
    If = me.inertia(Af, 0, 0, iZZf)
    bodies = [me.RigidBody('body0', Dmc, A0, m0, (I0, Dmc)),
              me.RigidBody('bodyb', Pb, Ab, mb, (Ib, Pb)),
              me.RigidBody('bodyf', Pf, Af, mf, (If, Pf))]
    forces = [(Pb, Fb * Ab.y), (Af, Tf * N.z),
              (Dmc, -reibung * Dmc.vel(N))]

    kd = sm.Matrix([ux - x.diff(t), uy - y.diff(t), u0 - q0.diff(t),
                    me.dot(rot1 - rot, N.z)])
    speed_constr = sm.Matrix([vel1, vel2])
    KM = me.KanesMethod(N, q_ind=[x, y, q0, qf], u_ind=[u0, uf],
                        kd_eqs=kd, u_dependent=[ux, uy],
                        velocity_constraints=speed_constr)
    fr, frstar = KM.kanes_equations(bodies, forces)
    eom = kd.col_join(fr + frstar).col_join(speed_constr)

    # pylon-hit integrators: punkt_i accumulates time spent inside the
    # bump around pylon i; dist_i = punkt_i * h_i lets the final-time
    # constraint demand a hit with a free scale h_i in [1, 5]
    treffer1 = (_hump(x, xb1 - epsilon, xb1 + epsilon, 5)
                * _hump(y, yb1 - epsilon, yb1 + epsilon, steepness))
    treffer2 = (_hump(x, xb2 - epsilon, xb2 + epsilon, 5)
                * _hump(y, yb2 - epsilon, yb2 + epsilon, steepness))
    eom = eom.col_join(sm.Matrix([
        -punkt1.diff(t) + treffer1,
        -punkt2.diff(t) + treffer2,
        -dist1 + punkt1 * h1,
        -dist2 + punkt2 * h2,
    ]))

    # path rows: forward-only motion, bounded lateral acceleration
    forward = Pb.vel(N).dot(Ab.y)
    accel_front = Pf.acc(N).dot(A0.x)
    accel_back = Pb.acc(N).dot(A0.x)
    eom = eom.col_join(sm.Matrix([forward, accel_front, accel_back]))

    h = sm.symbols('h')
    state_symbols = [x, y, q0, qf, ux, uy, u0, uf, punkt1, punkt2]
    t0, tf = 0.0, h * (num_nodes - 1)
    par_map = {m0: 1.0, mb: 0.5, mf: 0.5, iZZ0: 1.0, iZZb: 0.5,
               iZZf: 0.5, l: 3.0, reibung: 0.5,
               xb1: 10.0, yb1: 15.0, xb2: -5.0, yb2: 10.0,
               epsilon: 0.5, steepness: 5.0}

    def obj(free):
        return free[-1]

    def obj_grad(free):
        return unit_gradient(free, {-1: 1.0})

    instance_constraints = (
        x.func(t0), y.func(t0), q0.func(t0),
        ux.func(t0), uy.func(t0), u0.func(t0), uf.func(t0),
        punkt1.func(t0), punkt2.func(t0),
        dist1.func(t0), dist2.func(t0),
        x.func(tf), y.func(tf), ux.func(tf), uy.func(tf),
        dist1.func(tf) - 1.0, dist2.func(tf) - 1.0,
    )
    grenze = 20.0
    grenze1 = 5.0
    delta = np.pi / 4.0
    bounds = {Fb: (-grenze, grenze), Tf: (-grenze, grenze),
              qf: (-np.pi / 2 + delta - 1.0e-5,
                   np.pi / 2 - delta + 1.0e-5),
              x: (-20, 20), y: (-15, 30), h: (0.0, 0.5),
              h1: (1.0, 5.0), h2: (1.0, 5.0)}
    eom_bounds = {12: (0.0, np.inf),
                  13: (-grenze1, grenze1),
                  14: (-grenze1, grenze1)}

    prob = Problem(obj, obj_grad, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv('advanced/car_around_pylons_401_nodes_solution.csv')


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:296-297


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:96-111,
    after plot_car_around_pylons.py:349-362), the pylons at this
    module's par_map."""
    N = prob.collocator.num_collocation_nodes
    xb1, yb1, xb2, yb2 = 10.0, 15.0, -5.0, 10.0
    rng = np.random.default_rng(123)
    g = rng.standard_normal(prob.num_free)
    sec = N // 3
    xg = np.concatenate([np.linspace(0, xb1, sec),
                         np.linspace(xb1, xb2, sec),
                         np.linspace(xb2, 0, sec)])
    yg = np.concatenate([np.linspace(0, yb1, sec),
                         np.linspace(yb1, yb2, sec),
                         np.linspace(yb2, 0, sec)])
    g[:3 * sec] = xg
    g[3 * sec:6 * sec] = yg
    return g


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
