"""Mississippi Steamboat — variable-duration maneuvering with
quadratic-drag hydrodynamics.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_mississippi_steamboat.py): a
rectangular boat driven by two independently-torqued water wheels must
translate to a target pose and come to rest, minimizing a weighted sum
of wheel effort and duration.  Quadratic drag with the smooth
``tanh(20 v)`` sign approximation acts on the hull (translation and
rotation) and on each wheel's thrust point; Kane's method with all
coordinates independent.

Run:  python -m opty_tpu_torch.examples.gallery.steamboat
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...problem import Problem
from ._common import certify_or_solve, csv


def build_problem(num_nodes=251, device=None):

    t = me.dynamicsymbols._t
    q, x, y, qLW, qRW = me.dynamicsymbols('q, x, y, qLW, qRW')
    u, ux, uy, uLW, uRW = me.dynamicsymbols('u, ux, uy, uLW, uRW')
    tLW, tRW = me.dynamicsymbols('tLW, tRW')
    mS, mW, rW, aS, bS, cS, cW = sm.symbols(
        'mS, mW, rW, aS, bS, cS, cW', real=True)

    inertial = me.ReferenceFrame('N')
    boat_frame = me.ReferenceFrame('AS')
    lw_frame = me.ReferenceFrame('ALW')
    rw_frame = me.ReferenceFrame('ARW')
    origin = me.Point('O')
    origin.set_vel(inertial, 0)

    boat_frame.orient_axis(inertial, q, inertial.z)
    boat_frame.set_ang_vel(inertial, u * inertial.z)
    lw_frame.orient_axis(boat_frame, qLW, boat_frame.x)
    lw_frame.set_ang_vel(boat_frame, uLW * boat_frame.x)
    rw_frame.orient_axis(boat_frame, qRW, boat_frame.x)
    rw_frame.set_ang_vel(boat_frame, uRW * boat_frame.x)

    boat_center = me.Point('AoS')
    boat_center.set_pos(origin, x * inertial.x + y * inertial.y)
    boat_center.set_vel(inertial, ux * inertial.x + uy * inertial.y)
    lw_center = boat_center.locatenew('AoLW', -1.1 * bS * boat_frame.x)
    lw_center.v2pt_theory(boat_center, inertial, boat_frame)
    rw_center = boat_center.locatenew('AoRW', 1.1 * bS * boat_frame.x)
    rw_center.v2pt_theory(boat_center, inertial, boat_frame)

    # thrust points at the bottom of each wheel; their velocity picks
    # up the wheel-spin surface speed uW * (x_hat cross -rW z_hat)
    lw_thrust = lw_center.locatenew('FPLW', -rW * inertial.z)
    lw_thrust.set_vel(inertial, lw_center.vel(inertial)
                      + uLW * boat_frame.x.cross(-rW * inertial.z))
    rw_thrust = rw_center.locatenew('FPRW', -rW * inertial.z)
    rw_thrust.set_vel(inertial, rw_center.vel(inertial)
                      + uRW * boat_frame.x.cross(-rW * inertial.z))

    def drag(coeff, area, speed, direction):
        # -c A |v|^2 sgn(v) with the smooth sgn ~ tanh(20 v)
        return -coeff * area * speed ** 2 * sm.tanh(20 * speed) * direction

    vx = boat_center.vel(inertial).dot(boat_frame.x)
    vy = boat_center.vel(inertial).dot(boat_frame.y)
    loads = [(boat_center, drag(cS, aS, vx, boat_frame.x)
              + drag(cS, bS, vy, boat_frame.y))]

    lw_slip = lw_thrust.vel(inertial).dot(boat_frame.y)
    rw_slip = rw_thrust.vel(inertial).dot(boat_frame.y)
    lw_force = drag(cW, rW, lw_slip, boat_frame.y)
    rw_force = drag(cW, rW, rw_slip, boat_frame.y)
    loads.append((lw_center, lw_force))
    loads.append((rw_center, rw_force))
    loads.append((lw_frame, tLW * boat_frame.x
                  + (-rW * inertial.z).cross(lw_force)))
    loads.append((rw_frame, tRW * boat_frame.x
                  + (-rW * inertial.z).cross(rw_force)))

    # rotational drag: torque from the hull sides sweeping the water
    # (integral of -cS (u r)^2 r dr over length and width) plus the
    # steering-resistance term -cS aS u y_hat x z_hat
    loads.append((boat_frame, -cS * aS * u * boat_frame.z.cross(
        boat_frame.y)))
    loads.append((boat_frame, -cS * u ** 2 * (aS ** 4 + bS ** 4) / 32
                  * sm.tanh(20 * u) * inertial.z))

    wheel_ixx = 0.5 * mW * rW ** 2
    wheel_iyy = 0.25 * mW * rW ** 2
    left_wheel = me.RigidBody(
        'left_wheel', lw_center, lw_frame, mW,
        (me.inertia(lw_frame, wheel_ixx, wheel_iyy, wheel_iyy),
         lw_center))
    right_wheel = me.RigidBody(
        'right_wheel', rw_center, rw_frame, mW,
        (me.inertia(rw_frame, wheel_ixx, wheel_iyy, wheel_iyy),
         rw_center))
    boat = me.RigidBody(
        'boat', boat_center, boat_frame, mS,
        (me.inertia(boat_frame, 0, 0, mS * (aS ** 2 + bS ** 2) / 12),
         boat_center))

    coords = [q, x, y, qLW, qRW]
    speeds = [u, ux, uy, uLW, uRW]
    kd = sm.Matrix([ui - qi.diff(t) for qi, ui in zip(coords, speeds)])
    kane = me.KanesMethod(inertial, q_ind=coords, u_ind=speeds,
                          kd_eqs=kd)
    fr, frstar = kane.kanes_equations(
        [boat, left_wheel, right_wheel], loads)
    eom = kd.col_join(fr + frstar)

    h = sm.Symbol('h')
    state_symbols = (q, x, y, qLW, qRW, u, ux, uy, uLW, uRW)
    ns = len(state_symbols)
    par_map = {mS: 10.0, mW: 1.0, rW: 1.0, aS: 5.0, bS: 1.0,
               cS: 0.75, cW: 0.75}
    weight = 1.0e7
    N = num_nodes

    def obj(free):
        torques = free[ns * N:(ns + 2) * N]
        return free[-1] * (torch.sum(torques ** 2) + weight)

    t0, tf = 0.0, (num_nodes - 1) * h
    start = {q: -np.pi / 2, x: 0.0, y: 0.0, qLW: 0.0, qRW: 0.0,
             u: 0.0, ux: 0.0, uy: 0.0, uLW: 0.0, uRW: 0.0}
    end = {q: -np.pi / 2, x: 10.0, y: 10.0, u: 0.0, ux: 0.0, uy: 0.0}
    instance_constraints = tuple(
        s.subs({t: t0}) - v for s, v in start.items()) + tuple(
        s.subs({t: tf}) - v for s, v in end.items())
    limit = 25.0
    bounds = {tLW: (-limit, limit), tRW: (-limit, limit), h: (0.0, 1.0)}
    prob = Problem(obj, None, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   time_symbol=t, bounds=bounds,
                   device=device)
    return prob, csv(
        'intermediate/mississippi_steamboat_251_nodes_solution.csv')


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:293


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:79-83,
    after plot_mississippi_steamboat.py:353-359)."""
    N = prob.collocator.num_collocation_nodes
    return np.array([0.0] * N + list(np.linspace(0, 10, N))
                    + list(np.linspace(0, 10, N)) + [0.0] * (9 * N)
                    + [0.01])


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
