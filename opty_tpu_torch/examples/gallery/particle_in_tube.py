"""Particle Flight in a Tube — path inequalities via eom_bounds.

Port of the reference gallery problem
(examples-gallery/advanced/plot_particle_in_tube.py): a particle flies
along a helical tube under gravity and viscous drag; an auxiliary
state holds the curve parameter of the closest centerline point
(defined by a nonlinear algebraic EoM row), the distance row is
bounded inside the tube radius via ``eom_bounds``, and a smooth hump
narrows the tube to a gate at one location.

Run:  python -m opty_tpu_torch.examples.gallery.particle_in_tube
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function
from ._common import certify_or_solve, csv


def build_problem(num_nodes=501, device=None):

    t = me.dynamicsymbols._t
    m, g, c = sm.symbols('m, g, c', real=True)
    x, y, z, vx, vy, vz = me.dynamicsymbols('x, y, z, v_x, v_y v_z',
                                            real=True)
    Fx, Fy, Fz = me.dynamicsymbols('F_x, F_y, F_z', real=True)
    cut_param = me.dynamicsymbols('cut_param', real=True)
    a1, a2, a3 = sm.symbols('a1, a2, a3', real=True)
    r, faktor, wo, epsilon = sm.symbols('r, faktor, wo, epsilon',
                                        real=True)
    radius, steepness = sm.symbols('radius, steepness', real=True)

    # point mass with drag and applied force (Newton directly)
    eom = sm.Matrix([
        vx - x.diff(t), vy - y.diff(t), vz - z.diff(t),
        m * vx.diff(t) - Fx + c * vx,
        m * vy.diff(t) - Fy + c * vy,
        m * vz.diff(t) - Fz + c * vz + m * g,
    ])

    # helical centerline and its closest-point geometry
    curve = sm.Matrix([a1 * sm.sin(2 * np.pi * r),
                       a2 * sm.cos(2 * np.pi * r), a3 * r])
    tangent = curve.diff(r)
    pos = sm.Matrix([x, y, z])
    # plane through the particle, normal to the curve tangent,
    # intersected with the curve: nonlinear equation for cut_param
    closest_eqn = tangent.dot(curve - pos).subs(r, cut_param)
    dist = (curve.subs(r, cut_param) - pos).norm()

    def hump(xx, a, b):
        return 0.5 * (sm.tanh(steepness * (xx - a))
                      - sm.tanh(steepness * (xx - b)))

    gate_term = (1 - faktor) * radius * hump(cut_param, wo - epsilon,
                                             wo + epsilon)
    eom = eom.col_join(sm.Matrix([
        closest_eqn,
        dist + gate_term - radius,
        cut_param.diff(t),
    ]))

    state_symbols = (x, y, z, vx, vy, vz, cut_param)
    specified = (Fx, Fy, Fz)
    duration = 5.0
    interval = duration / (num_nodes - 1)
    max_z = 12.0
    par_map = {c: 0.5 * 0.1 * 1.2, g: 9.81, m: 2.0,
               a1: 5.0, a2: 5.0, a3: 5.0, radius: 1.0,
               steepness: 50.0, faktor: 0.25, wo: 1.0, epsilon: 0.25}

    obj, obj_grad = create_objective_function(
        sm.Integral(Fx ** 2 + Fy ** 2 + Fz ** 2, t), state_symbols,
        specified, tuple(), num_nodes, interval, time_symbol=t)

    end_r = max_z / par_map[a3]
    end = [float(v) for v in
           curve.subs({r: end_r, a1: par_map[a1], a2: par_map[a2],
                       a3: par_map[a3]})]
    instance_constraints = (
        x.func(0.0), y.func(0.0) - par_map[a2], z.func(0.0),
        cut_param.func(0.0),
        x.func(duration) - end[0], y.func(duration) - end[1],
        z.func(duration) - max_z,
        vx.func(0.0), vy.func(0.0), vz.func(0.0),
        vx.func(duration), vy.func(duration), vz.func(duration),
    )
    grenze = 100.0
    bounds = {Fx: (-grenze, grenze), Fy: (-grenze, grenze),
              Fz: (-grenze, grenze), cut_param: (0.0, 3.0),
              z: (0.0, max_z)}
    eom_bounds = {7: (-np.inf, 0.0), 8: (0.0, np.inf)}
    prob = Problem(obj, obj_grad, eom, state_symbols, num_nodes,
                   interval, known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv(
        'advanced/particle_in_tube_501_nodes_solution.csv')


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:291-292


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:64-76,
    after plot_particle_in_tube.py:374-383): the curve x = a1 sin(2 pi
    r), y = a2 cos(2 pi r), z = a3 r with a1 = a2 = a3 = 5, max_z =
    12."""
    N = prob.collocator.num_collocation_nodes
    a1 = a2 = a3 = 5.0
    max_z = 12.0
    r = np.linspace(0.0, max_z / a3, N)
    g = np.ones(prob.num_free)
    g[0:N] = a1 * np.sin(2 * np.pi * r)
    g[N:2 * N] = a2 * np.cos(2 * np.pi * r)
    g[2 * N:3 * N] = a3 * r
    g[6 * N:7 * N] = r
    g[-3 * N:] = 50.0
    return g


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
