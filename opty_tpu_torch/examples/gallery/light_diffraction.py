"""Light Diffraction — minimum-time crossing of speed-limited regions.

Port of the reference gallery problem
(examples-gallery/beginner/plot_light_diffraction.py): a particle
moves from the origin to (10, 10) in minimum (free) time; smooth hump
functions gate its speed to different maxima in three x-regions via
``eom_bounds`` path inequalities, plus a force-magnitude limit row.

Run:  python -m opty_tpu_torch.examples.gallery.light_diffraction
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ._common import certify_or_solve, csv


def smooth_hump(xx, a, b, k):
    """~1 for a < xx < b, ~0 outside; steeper for larger k."""
    return 0.5 * (sm.tanh(k * (xx - a)) - sm.tanh(k * (xx - b)))


def build_problem(num_nodes=501, device=None):

    t = me.dynamicsymbols._t
    x, y, ux, uy = me.dynamicsymbols('x y u_x u_y')
    fx, fy = me.dynamicsymbols('f_x f_y')
    m, a1, a2, a3 = sm.symbols('m a_1 a_2 a_3')
    mu1, mu2, mu3 = sm.symbols('mu_1 mu_2 mu_3')
    steepness, friction = sm.symbols('steepness friction')

    # planar point mass with viscous friction, Newton's law written
    # directly (the reference uses an equivalent Kane derivation)
    eom = sm.Matrix([
        x.diff(t) - ux,
        y.diff(t) - uy,
        m * ux.diff(t) - fx + friction * ux,
        m * uy.diff(t) - fy + friction * uy,
    ])

    # speed-limit rows (gated per region) + force magnitude row
    speed = sm.sqrt(ux ** 2 + uy ** 2)
    eom = eom.col_join(sm.Matrix([
        speed * smooth_hump(x, -1.0, a1, steepness),
        speed * smooth_hump(x, a1, a2, steepness),
        speed * smooth_hump(x, a2, a3, steepness),
        sm.sqrt(fx ** 2 + fy ** 2),
    ]))

    par_map = {m: 1.0, a1: 3.0, a2: 7.0, a3: 11.0,
               mu1: 5.0, mu2: 1.0, mu3: 5.0,
               steepness: 80.0, friction: 1.0}

    h = sm.Symbol('h')
    t0, tf = 0.0, h * (num_nodes - 1)

    def obj(free):
        return free[-1]

    instance_constraints = (x.func(t0) - 0.0, y.func(t0) - 0.0,
                            x.func(tf) - 10.0, y.func(tf) - 10.0)
    bounds = {h: (0.0, 1.0), x: (0.0, 10.0), y: (0.0, 10.0),
              ux: (0.5, np.inf), uy: (0.1, np.inf)}
    eom_bounds = {4: (0.0, par_map[mu1]),
                  5: (0.0, par_map[mu2]),
                  6: (0.0, par_map[mu3]),
                  7: (0.0, 400.0)}

    prob = Problem(obj, None, eom, (x, y, ux, uy), num_nodes, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds=bounds, eom_bounds=eom_bounds, time_symbol=t,
                   device=device)
    return prob, csv('beginner/light_diffraction_501_nodes_solution.csv')


# light_diffraction descends into a better-than-reference basin but
# needs > 2000 iterations to polish (benchmarks/cold_gallery.py:281-284)
COLD_MAX_ITER = 3000


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:33-38,
    after plot_light_diffraction.py:223-228)."""
    N = prob.collocator.num_collocation_nodes
    g = np.ones(prob.num_free) * 0.5
    g[:N] = np.linspace(0, 10, N)
    g[N:2 * N] = np.linspace(0, 10, N)
    return g


def main():
    prob, ref_csv = build_problem()
    return certify_or_solve(prob, ref_csv, initial_guess(prob),
                            COLD_MAX_ITER)


if __name__ == '__main__':
    main()
