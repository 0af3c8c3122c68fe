"""Park a Car in a Garage — eom_bounds obstacle rows + smooth min.

Port of the reference gallery problem
(examples-gallery/advanced/plot_car_in_garage.py): a kinematic car
(driven rear axle, steered front axle, no lateral wheel slip —
Kane's equations with two nonholonomic constraints) must drive into a
garage modeled as a differentiable trough without hitting the walls.
Four points along the car body get a clearance equation-of-motion row
bounded nonnegative via ``eom_bounds``, and an auxiliary control
``pmin`` tracks the car's lowest end through a smooth (logsumexp)
minimum so the final-time constraint can demand the car is fully
inside.

The smooth helpers are the reference's expressions rewritten in
overflow-safe form (exact identities, not approximations):

* ``1/(1 + exp(z))  ==  (1 - tanh(z/2))/2`` — the lowering clamps
  tanh, so steep (gr = 50) sigmoids stay finite on the TPU's
  float-float f64 emulation (range limit ~1e300 -> exp(50*x)
  overflows for |x| > ~14 already in plain f64);
* ``-log(exp(-g*a) + exp(-g*b))/g  ==
  (a+b)/2 - (|w| + log(1 + exp(-2|w|)))/g`` with ``w = g*(a-b)/2``
  (logsumexp pulled through cosh; the remaining exp argument is
  always <= 0).

Run:  python -m opty_tpu_torch.examples.gallery.car_in_garage
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function
from ._common import certify_or_solve, csv


def _sigmoid(z):
    """1/(1 + exp(z)), written through tanh (exact, overflow-safe)."""
    return (1 - sm.tanh(z / 2)) / 2


def _min_diff(a, b, gr):
    """-log(exp(-gr*a) + exp(-gr*b))/gr, stable logsumexp form."""
    w = gr * (a - b) / 2
    return (a + b) / 2 - (sm.Abs(w) + sm.log(1 + sm.exp(-2 * sm.Abs(w)))) / gr


def _trough(xx, a, b, gr):
    """~0 inside [a, b], ~1 outside (sum of two sigmoids)."""
    return _sigmoid(gr * (xx - a)) + _sigmoid(-gr * (xx - b))


def build_problem(num_nodes=301, device=None):

    t = me.dynamicsymbols._t
    N, A0, Ab, Af = sm.symbols('N A0 Ab Af', cls=me.ReferenceFrame)
    O, Pb, Dmc, Pf = sm.symbols('O Pb Dmc Pf', cls=me.Point)
    O.set_vel(N, 0)

    q0, qf = me.dynamicsymbols('q_0 q_f')
    u0, uf = me.dynamicsymbols('u_0 u_f')
    x, y = me.dynamicsymbols('x y')
    ux, uy = me.dynamicsymbols('u_x u_y')
    Tf, Fb = me.dynamicsymbols('T_f F_b')
    pmin = me.dynamicsymbols('pmin')
    reibung = sm.symbols('reibung')
    l, m0, mb, mf, iZZ0, iZZb, iZZf = sm.symbols(
        'l m0 mb mf iZZ0, iZZb, iZZf')
    x1, x2, y12 = sm.symbols('x1 x2 y12')

    # car body A0, rear axle Ab (fixed to the body), steered front
    # axle Af; front of the car Pf carries the (x, y) coordinates
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

    # nonholonomic: no speed perpendicular to either axle's wheels
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

    # garage clearance rows: `number` points along the car body must
    # stay above the trough (rows bounded below by 0), and pmin must
    # equal the smooth minimum of the two car ends' heights
    number = 4
    park1x = me.dot(Pf.pos_from(O), N.x)
    park1y = me.dot(Pf.pos_from(O), N.y)
    park2x = me.dot(Pb.pos_from(O), N.x)
    park2y = me.dot(Pb.pos_from(O), N.y)
    delta_x = [park1x + (park2x - park1x) * i / (number - 1)
               for i in range(number)]
    delta_y = [park1y + (park2y - park1y) * i / (number - 1)
               for i in range(number)]
    delta_p = [delta_y[i] - _trough(delta_x[i], x1, x2, 50) * y12
               for i in range(number)]
    eom = eom.col_join(sm.Matrix(
        delta_p + [-pmin + _min_diff(park1y, park2y, 50)]))

    state_symbols = (x, y, q0, qf, ux, uy, u0, uf)
    specified = (Fb, Tf, pmin)
    t0, tf = 0.0, 5.0
    interval = (tf - t0) / (num_nodes - 1)
    par_map = {m0: 1.0, mb: 0.5, mf: 0.5, iZZ0: 1.0, iZZb: 0.5,
               iZZf: 0.5, l: 3.0, reibung: 0.5,
               x1: -0.75, x2: 0.75, y12: 5.0}

    obj, obj_grad = create_objective_function(
        sm.Integral(Fb ** 2 + Tf ** 2, t), state_symbols, specified,
        tuple(), num_nodes, interval, time_symbol=t)

    instance_constraints = (
        x.func(t0) - 7.5, y.func(t0) - 5.5,
        q0.func(t0) - np.pi / 2.0, qf.func(t0) - 0.5,
        ux.func(t0), uy.func(t0), u0.func(t0), uf.func(t0),
        pmin.func(tf) - 0.5,
        x.func(tf), ux.func(tf), uy.func(tf),
    )
    grenze = 25.0
    delta = np.pi / 4.0
    epsilon = 1.0e-5
    bounds = {Fb: (-grenze, grenze), Tf: (-grenze, grenze),
              qf: (-np.pi / 2 + delta - epsilon,
                   np.pi / 2 - delta + epsilon),
              x: (-10, 10), y: (0.0, 25)}
    eom_bounds = {8 + i: (0, np.inf) for i in range(number)}

    prob = Problem(obj, obj_grad, eom, state_symbols, num_nodes,
                   interval, known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv('advanced/car_in_garage_301_nodes_solution.csv')


COLD_MAX_ITER = 3000    # benchmarks/cold_gallery.py:294


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:86-88,
    after plot_car_in_garage.py:365)."""
    return np.ones(prob.num_free)


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
