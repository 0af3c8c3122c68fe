"""Quadcopter Drone Flip — quaternion attitude, holonomic constraint.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_drone.py): a quadrotor rigid body
with quaternion attitude (unit-norm holonomic constraint kept as an
algebraic EoM row, M = 15 > n = 14) flies from the origin to
(10, 10, 10) in 10 s, rolling 90 degrees about x at the midpoint
(interior-point instance constraints), minimizing propeller effort.

Run:  python -m opty_tpu_torch.examples.gallery.drone
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function


def _derive_eom():
    m, l, w, d, g, c = sm.symbols('m, l, w, d, g, c', real=True)
    x, y, z = me.dynamicsymbols('x, y, z', real=True)
    vx, vy, vz = me.dynamicsymbols('v_x, v_y v_z', real=True)
    q0, q1, q2, q3 = me.dynamicsymbols('q0, q1, q2, q3', real=True)
    u0, wx, wy, wz = me.dynamicsymbols('u0, omega_x, omega_y, omega_z',
                                       real=True)
    F1, F2, F3, F4 = me.dynamicsymbols('F1, F2, F3, F4', real=True)
    t = me.dynamicsymbols._t

    O, Ao, P1, P2, P3, P4 = sm.symbols('O, A_o, P1, P2, P3, P4',
                                       cls=me.Point)
    N, A = sm.symbols('N, A', cls=me.ReferenceFrame)

    A.orient_quaternion(N, (q0, q1, q2, q3))

    Ao.set_pos(O, x * N.x + y * N.y + z * N.z)
    P1.set_pos(Ao, l / 2 * A.x + w / 2 * A.y)
    P2.set_pos(Ao, -l / 2 * A.x + w / 2 * A.y)
    P3.set_pos(Ao, l / 2 * A.x - w / 2 * A.y)
    P4.set_pos(Ao, -l / 2 * A.x - w / 2 * A.y)

    N_w_A = A.ang_vel_in(N)
    N_v_P = Ao.pos_from(O).dt(N)

    kinematical = sm.Matrix([
        vx - N_v_P.dot(A.x),
        vy - N_v_P.dot(A.y),
        vz - N_v_P.dot(A.z),
        u0 - q0.diff(t),
        wx - N_w_A.dot(A.x),
        wy - N_w_A.dot(A.y),
        wz - N_w_A.dot(A.z),
    ])

    A.set_ang_vel(N, wx * A.x + wy * A.y + wz * A.z)

    O.set_vel(N, 0)
    Ao.set_vel(N, vx * A.x + vy * A.y + vz * A.z)
    for P in (P1, P2, P3, P4):
        P.v2pt_theory(Ao, N, A)

    IA = me.inertia(A, m * (w ** 2 + d ** 2) / 12,
                    m * (l ** 2 + d ** 2) / 12,
                    m * (l ** 2 + w ** 2) / 12)
    drone_body = me.RigidBody('A', Ao, A, m, (IA, Ao))

    loads = [(P1, F1 * A.z), (P2, F2 * A.z), (P3, F3 * A.z),
             (P4, F4 * A.z),
             (Ao, -m * g * N.z - c * Ao.vel(N))]   # linearized drag

    holonomic = sm.Matrix([q0 ** 2 + q1 ** 2 + q2 ** 2 + q3 ** 2 - 1])

    kane = me.KanesMethod(
        N, (x, y, z, q1, q2, q3), (vx, vy, vz, wx, wy, wz),
        kd_eqs=kinematical, q_dependent=(q0,), u_dependent=(u0,),
        configuration_constraints=holonomic,
        velocity_constraints=holonomic.diff(t))
    fr, frstar = kane.kanes_equations([drone_body], loads)

    eom = kinematical.col_join(fr + frstar).col_join(holonomic)
    states = (x, y, z, q0, q1, q2, q3, vx, vy, vz, u0, wx, wy, wz)
    return eom, states, (F1, F2, F3, F4), (m, l, w, d, g, c), t


def build_problem(num_nodes=301, duration=10.0, device=None):

    (eom, states, specifieds, (m, l, w, d, g, c), t) = _derive_eom()
    x, y, z, q0, q1, q2, q3, vx, vy, vz, u0, wx, wy, wz = states
    F1, F2, F3, F4 = specifieds
    interval = duration / (num_nodes - 1)

    par_map = {c: 0.5 * 0.1 * 1.2, d: 0.1, g: 9.81, l: 1.0, m: 2.0,
               w: 0.5}

    obj, obj_grad = create_objective_function(
        sm.Integral(F1 ** 2 + F2 ** 2 + F3 ** 2 + F4 ** 2, t), states,
        specifieds, tuple(), num_nodes, interval, time_symbol=t)

    instance_constraints = (
        x.func(0.0), y.func(0.0), z.func(0.0),
        x.func(duration) - 10.0, y.func(duration) - 10.0,
        z.func(duration) - 10.0,
        q0.func(0.0) - 1.0, q1.func(0.0), q2.func(0.0), q3.func(0.0),
        # rotate 90 degrees about x at the midpoint in time
        q0.func(duration / 2) - np.cos(np.pi / 4),
        q1.func(duration / 2) - np.sin(np.pi / 4),
        q2.func(duration / 2), q3.func(duration / 2),
        q0.func(duration) - 1.0, q1.func(duration), q2.func(duration),
        q3.func(duration),
        vx.func(0.0), vy.func(0.0), vz.func(0.0), u0.func(0.0),
        wx.func(0.0), wy.func(0.0), wz.func(0.0),
        vx.func(duration), vy.func(duration), vz.func(duration),
        u0.func(duration), wx.func(duration), wy.func(duration),
        wz.func(duration),
    )

    bounds = {F: (-100.0, 100.0) for F in specifieds}

    prob = Problem(obj, obj_grad, eom, states, num_nodes, interval,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:300


def initial_guess(prob):
    """The documented cold start, the original's ``main``
    (benchmarks/cold_gallery.py:123-128, after plot_drone.py:217-218):
    the linear guess with a constant thrust."""
    num_nodes = prob.collocator.num_collocation_nodes
    guess = np.array(prob.create_linear_initial_guess())
    guess[-4 * num_nodes:] = 10.0     # constant thrust
    return guess


def main():
    prob = build_problem()
    solution, info = prob.solve(initial_guess(prob))
    print('status={} iters={} obj={:.6f}'.format(
        info['status'], info['iterations'], info['obj_val']))
    assert info['status'] in (0, 1), info['status_msg']
    xs = prob.parse_free(solution)[0]
    assert abs(xs[2, -1] - 10.0) < 1e-6          # reached altitude
    qn = xs[3] ** 2 + xs[4] ** 2 + xs[5] ** 2 + xs[6] ** 2
    assert np.max(np.abs(qn - 1.0)) < 1e-6       # unit quaternion kept
    return solution, info


if __name__ == '__main__':
    main()
