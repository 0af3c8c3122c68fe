"""Car on a Race Course — road-corridor rows + smoothed driving force.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_car_on_racecourse_smooth.py): the
nonholonomic car (see ``car_in_garage``) races between two sinusoidal
road edges in minimum time (variable step ``h``).  Four points along
the body get a pair of clearance rows each (above the lower edge,
below the upper edge, ``eom_bounds`` >= 0), both axles' lateral
accelerations are bounded, the driving force is smoothed by making it
a state driven through a second-order lag (``Fb' = Fbdt``,
``mh*Fbdt' = Fh``), and a final row keeps the car's front to the
right of its back.

Run:  python -m opty_tpu_torch.examples.gallery.car_on_racecourse
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify_or_solve, csv, unit_gradient


def build_problem(num_nodes=601, device=None):

    t = me.dynamicsymbols._t
    N, A0, Ab, Af = sm.symbols('N A0 Ab Af', cls=me.ReferenceFrame)
    O, Pb, Dmc, Pf = sm.symbols('O Pb Dmc Pf', cls=me.Point)
    O.set_vel(N, 0)

    q0, qf = me.dynamicsymbols('q_0 q_f')
    u0, uf = me.dynamicsymbols('u_0 u_f')
    x, y = me.dynamicsymbols('x y')
    ux, uy = me.dynamicsymbols('u_x u_y')
    Tf, Fb, Fbdt = me.dynamicsymbols('T_f F_b F_bdt')
    Fh = me.dynamicsymbols('F_h')
    reibung = sm.symbols('reibung')
    l, m0, mb, mf, iZZ0, iZZb, iZZf = sm.symbols(
        'l m0 mb mf iZZ0, iZZb, iZZf')
    mh, a, b, c, d = sm.symbols('mh a b c d')

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

    def street(XX, aa, bb, cc):
        return aa * sm.sin(bb * XX) + cc

    # road corridor: `number` points along the body must stay between
    # the lower edge street(x, a, b, c) and upper edge
    # street(x, a, b, c + d)
    number = 4
    park1x = me.dot(Pf.pos_from(O), N.x)
    park1y = me.dot(Pf.pos_from(O), N.y)
    park2x = me.dot(Pb.pos_from(O), N.x)
    park2y = me.dot(Pb.pos_from(O), N.y)
    delta_x = [park1x + (park2x - park1x) * i / (number - 1)
               for i in range(number)]
    delta_y = [park1y + (park2y - park1y) * i / (number - 1)
               for i in range(number)]
    delta_p_u = [delta_y[i] - street(delta_x[i], a, b, c)
                 for i in range(number)]
    delta_p_l = [-delta_y[i] + street(delta_x[i], a, b, c + d)
                 for i in range(number)]
    eom = eom.col_join(sm.Matrix(delta_p_u + delta_p_l))

    # bounded lateral accelerations; smoothed driving force; front
    # stays to the right of the back
    accel_front = Pf.acc(N).dot(A0.x)
    accel_back = Pb.acc(N).dot(A0.x)
    eom = eom.col_join(sm.Matrix([accel_front, accel_back]))
    eom = eom.col_join(sm.Matrix([Fb.diff(t) - Fbdt,
                                  mh * Fbdt.diff(t) - Fh]))
    front_x = me.dot(Pf.pos_from(O), N.x)
    back_x = me.dot(Pb.pos_from(O), N.x)
    eom = eom.col_join(sm.Matrix([front_x - back_x]))

    h = sm.symbols('h')
    state_symbols = [x, y, q0, qf, ux, uy, u0, uf, Fb, Fbdt]
    t0, tf = 0.0, h * (num_nodes - 1)
    par_map = {m0: 1.0, mb: 0.5, mf: 0.5, mh: 0.20, iZZ0: 1.0,
               iZZb: 0.5, iZZf: 0.5, l: 3.0, reibung: 0.5,
               a: 3.5, b: 0.5, c: 4.0, d: 3.5}

    def obj(free):
        return free[-1]

    def obj_grad(free):
        return unit_gradient(free, {-1: 1.0})

    instance_constraints = (
        x.func(t0) + 10.0,
        ux.func(t0), uy.func(t0), u0.func(t0), uf.func(t0),
        Fb.func(t0), Fbdt.func(t0),
        x.func(tf) - 10.0, ux.func(tf), uy.func(tf),
    )
    limit, limit1, limit2 = 20.0, 15.0, 30.0
    delta = np.pi / 4.0
    bounds = {Fh: (-limit2, limit2), Fb: (-limit, limit),
              Tf: (-limit, limit),
              qf: (-np.pi / 2 + delta, np.pi / 2 - delta),
              x: (-15, 15), y: (0.0, 25), h: (0.0, 0.5)}
    eom_bounds = {**{8 + i: (0.0, np.inf) for i in range(2 * number)},
                  16: (-limit1, limit1), 17: (-limit1, limit1),
                  20: (0.0, np.inf)}

    prob = Problem(obj, obj_grad, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv(
        'intermediate/car_on_racecourse_smooth_601_nodes_solution.csv')


# this 601-node min-time problem has a dual-infeasibility floor of
# ~1.5e-5 under our gradient-based row scaling (the committed solution
# is feasible to 7e-8 and first-order stationary at that level);
# certify at that floor
CERT_OPTIONS = {'acceptable_tol': 1e-4}


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:298-299


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:114-120,
    after plot_car_on_racecourse_smooth.py:345-349)."""
    N = prob.collocator.num_collocation_nodes
    rng = np.random.default_rng(123)
    g = rng.standard_normal(prob.num_free) * 0.001
    g[:N] = np.linspace(-10.0, 10.0, N)
    g[N:2 * N] = 6.0
    return g


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER,
                            solver_options=CERT_OPTIONS)


if __name__ == '__main__':
    main()
