"""Crane Moving a Load — minimum-time transport with a DAE model.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_crane_moving_a_load.py): a mover
carries a pendulum load 15 m in minimum (free) time with a bounded
drive force.  The model is a Kane's-method DAE with dependent
coordinates (the load position is constrained to the rod tip), plus
two auxiliary input trajectories pinning the terminal accelerations —
the reference's technique for enforcing d2/dt2 terminal constraints.

Run:  python -m opty_tpu_torch.examples.gallery.crane_load
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify_or_solve, csv


def build_problem(num_nodes=150, device=None):

    t = me.dynamicsymbols._t
    xc, xl, yl, q = me.dynamicsymbols('xc, xl, yl, q')
    uxc, uxl, uyl, u = me.dynamicsymbols('uxc, uxl, uyl, uq')
    F, h1, h2 = me.dynamicsymbols('F, h1, h2')
    l, m1, m2, g = sm.symbols('l, m1, m2, g')

    inertial = me.ReferenceFrame('N')
    rod = inertial.orientnew('A', 'Axis', [q, inertial.z])
    rod.set_ang_vel(inertial, u * inertial.z)
    origin = me.Point('O')
    origin.set_vel(inertial, 0)
    mover = origin.locatenew('P1', xc * inertial.x)
    mover.set_vel(inertial, uxc * inertial.x)
    load = mover.locatenew('P2', -l * rod.y)
    load.v2pt_theory(mover, inertial, rod)

    bodies = [me.Particle('mover', mover, m1),
              me.Particle('load', load, m2)]
    loads = [(mover, F * inertial.x - m1 * g * inertial.y),
             (load, -m2 * g * inertial.y)]
    kd = sm.Matrix([uxc - xc.diff(t), u - q.diff(t),
                    uxl - xl.diff(t), uyl - yl.diff(t)])
    config = sm.Matrix([xl - xc - l * sm.sin(q), yl + l * sm.cos(q)])
    kane = me.KanesMethod(
        inertial, q_ind=[xc, q], q_dependent=[xl, yl],
        u_ind=[uxc, u], u_dependent=[uxl, uyl], kd_eqs=kd,
        configuration_constraints=config,
        velocity_constraints=config.diff(t))
    fr, frstar = kane.kanes_equations(bodies, loads)
    eom = kd.col_join(fr + frstar).col_join(config)
    eom = eom.col_join(sm.Matrix([h1 - u.diff(t), h2 - uxc.diff(t)]))

    state_symbols = (xc, q, xl, yl, uxc, u, uxl, uyl)
    par_map = {l: 5.0, m1: 1.0, m2: 10.0, g: 9.81}
    h = sm.Symbol('h')
    t0, tf = 0.0, (num_nodes - 1) * h
    x0v, xfv = 0.0, 15.0

    def obj(free):
        return free[-1]

    instance_constraints = (
        xc.func(t0) - x0v, xl.func(t0) - x0v,
        yl.func(t0) + par_map[l], q.func(t0),
        uxc.func(t0), uxl.func(t0), uyl.func(t0), u.func(t0),
        xc.func(tf) - xfv, xl.func(tf) - xfv,
        yl.func(tf) + par_map[l], q.func(tf),
        uxc.func(tf), uxl.func(tf), uyl.func(tf), u.func(tf),
        h1.func(tf), h2.func(tf),
    )
    bounds = {F: (-20.0, 20.0), xl: (x0v, xfv), xc: (x0v, xfv),
              h: (0.0, 1.0)}
    prob = Problem(obj, None, eom, state_symbols, num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, time_symbol=t,
                   device=device)
    return prob, csv(
        'intermediate/crane_moving_a_load_150_nodes_solution.csv')


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:285


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:41-45,
    after plot_crane_moving_a_load.py:222-230)."""
    N = prob.collocator.num_collocation_nodes
    i1 = [(15.0 - 0.0) / N * i for i in range(N)]
    return np.array(i1 + [0.0] * N + i1 + [-5.0] * N
                    + [0.0] * (5 * N) + [0.0] * (2 * N) + [0.01])


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
