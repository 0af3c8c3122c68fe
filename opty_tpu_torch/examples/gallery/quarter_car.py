"""Quarter Car on a Bumpy Road — simultaneous trajectory optimization
and parameter identification.

Port of the reference gallery problem
(examples-gallery/beginner/plot_wheel_on_bumpy_road.py): a sprung/
unsprung two-mass model driven over an analytic rough road; the
optimizer picks the suspension spring/damper constants (free
parameters) and the drive force to minimize body acceleration, with
eom_bounds keeping the tire on the road and the body within its
suspension travel.

Run:  python -m opty_tpu_torch.examples.gallery.quarter_car
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...problem import Problem
from ._common import certify_or_solve, csv


def build_problem(num_nodes=301, device=None):

    t = me.dynamicsymbols._t
    x_car, z_car, z_wheel = me.dynamicsymbols('x_car z_car, z_wheel')
    ux_car, uz_car, uz_wheel = me.dynamicsymbols(
        'ux_car uz_car uz_wheel')
    accel_body, accel_street = me.dynamicsymbols(
        'accel_body accel_street')
    fx = me.dynamicsymbols('fx')
    m_car, m_wheel, g = sm.symbols('m_car m_wheel g')
    r1, r2, r3, r4, r5 = sm.symbols('r1 r2 r3 r4 r5')
    l_0, k, c = sm.symbols('  l_0, k, c')
    l_GW, k1 = sm.symbols('l_GW, k1')

    def road(xx):
        omega = 0.75
        return sm.S(0.135) * (r1 * sm.sin(omega * xx) ** 2
                              + r2 * sm.sin(2 * omega * xx) ** 2
                              + r3 * sm.sin(3 * omega * xx) ** 2
                              + r4 * sm.sin(7 * omega * xx) ** 2
                              + r5 * sm.sin(9 * omega * xx) ** 2)

    inertial = me.ReferenceFrame('N')
    origin = me.Point('O')
    origin.set_vel(inertial, 0)
    p_car = origin.locatenew('P_car', x_car * inertial.x
                             + z_car * inertial.z)
    p_wheel = origin.locatenew('P_wheel', x_car * inertial.x
                               + z_wheel * inertial.z)
    p_car.set_vel(inertial, ux_car * inertial.x + uz_car * inertial.z)
    p_wheel.set_vel(inertial, ux_car * inertial.x
                    + uz_wheel * inertial.z)
    bodies = [me.Particle('car', p_car, m_car),
              me.Particle('wheel', p_wheel, m_wheel)]
    spring = k * (l_0 - (z_car - road(x_car)))
    damper = c * (uz_car - road(x_car).diff(t))
    loads = [
        (p_car, (-m_car * g - damper + spring) * inertial.z
         + fx * inertial.x),
        (p_wheel, (-m_wheel * g + damper - spring
                   + k1 * (l_GW - (z_wheel - road(x_car))))
         * inertial.z),
    ]
    kd = sm.Matrix([x_car.diff(t) - ux_car, uz_car - z_car.diff(t),
                    uz_wheel - z_wheel.diff(t)])
    kane = me.KanesMethod(inertial, q_ind=[x_car, z_car, z_wheel],
                          u_ind=[ux_car, uz_car, uz_wheel], kd_eqs=kd)
    fr, frstar = kane.kanes_equations(bodies, loads)
    eom = kd.col_join(fr + frstar)
    street_accel = road(x_car).diff(t).subs(
        {x_car.diff(t): ux_car}).diff(t)
    eom = eom.col_join(sm.Matrix([
        z_wheel - road(x_car),
        z_car - road(x_car),
        accel_body - uz_car.diff(t),
        accel_street - street_accel,
    ]))

    state_symbols = (x_car, z_car, z_wheel, ux_car, uz_car, uz_wheel)
    par_map = {m_car: 350.0, m_wheel: 5.0, g: 9.81, l_0: 1.0,
               r1: 0.56, r2: 0.1, r3: 0.1, r4: 0.025, r5: 0.025,
               k1: 250000.0}
    h = sm.Symbol('h')
    t0, tf = 0.0, (num_nodes - 1) * h
    weight = 1.0e9
    N = num_nodes

    def obj(free):
        accel = free[6 * N:7 * N]
        return torch.sum(accel ** 2) * free[-1] + weight * free[-1]

    instance_constraints = (
        x_car.func(t0) - 0.0, ux_car.func(t0) - 0.0,
        accel_street.func(t0) - 0.0, accel_body.func(t0) - 0.0,
        x_car.func(tf) - 10.0, ux_car.func(tf) - 0.0,
    )
    bounds = {h: (0.0, 1.0), x_car: (0.0, 10.0),
              z_wheel: (0.0, 2.0), ux_car: (0.0, np.inf),
              c: (0.0, np.inf), k: (15000, 500000),
              fx: (-50000, 50000), l_GW: (0.0, 1.0)}
    eom_bounds = {6: (0.0, 0.1), 7: (0.85, 1.0)}
    prob = Problem(obj, None, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv(
        'beginner/quarter_car_on_bumpy_road_301_nodes_solution.csv')


# converges cold to a better objective than the reference CSV, but
# needs ~2600 iterations (benchmarks/cold_gallery.py:288-290)
COLD_MAX_ITER = 4000


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:59-61,
    after plot_wheel_on_bumpy_road.py:267)."""
    return np.random.default_rng(123).random(prob.num_free)


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
