"""Path Constraints — particle forced to the surface of a cylinder.

Port of the reference gallery problem
(examples-gallery/beginner/plot_path_constraints.py): a point mass in
3-D space (6 ODEs) plus one *algebraic* path-constraint row
``x^2 + y^2 - r^2 = 0`` appended to the equations of motion (M = 7 >
n = 6), forced to climb half a turn around the cylinder, stationary at
both ends, minimizing the mean squared force.

Run:  python -m opty_tpu_torch.examples.gallery.path_constraints
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me

from ...problem import Problem
from ...utils import create_objective_function


def build_problem(num_nodes=101, dt=0.1, device=None):

    t = me.dynamicsymbols._t
    m, r = sm.symbols('m, r', real=True)
    x, y, z = me.dynamicsymbols('x, y, z', real=True)
    vx, vy, vz = me.dynamicsymbols('v_x, v_y, v_z', real=True)
    Fx, Fy, Fz = me.dynamicsymbols('F_x, F_y, F_z', real=True)

    states = (x, y, z, vx, vy, vz)
    specifieds = (Fx, Fy, Fz)

    eom = sm.Matrix([
        x.diff() - vx,
        y.diff() - vy,
        z.diff() - vz,
        m * vx.diff() - Fx,
        m * vy.diff() - Fy,
        m * vz.diff() - Fz,
        x ** 2 + y ** 2 - r ** 2,          # algebraic path constraint
    ])

    t0, tf = 0.0, dt * (num_nodes - 1)
    par_map = {m: 1.0, r: 1.0}

    obj, obj_grad = create_objective_function(
        sm.Integral(Fx ** 2 + Fy ** 2 + Fz ** 2, t), states, specifieds,
        tuple(), num_nodes, dt, time_symbol=t)

    instance_constraints = (
        x.func(t0), y.func(t0) + r, z.func(t0),
        vx.func(t0), vy.func(t0), vz.func(t0),
        x.func(tf), y.func(tf) - r, z.func(tf) - 4 * r,
        vx.func(tf), vy.func(tf), vz.func(tf),
    )

    prob = Problem(obj, obj_grad, eom, states, num_nodes, dt,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   time_symbol=t,
                   device=device)
    return prob


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:312-313


def initial_guess(prob):
    """The documented cold start, the original's ``main``
    (benchmarks/cold_gallery.py:198-200)."""
    return np.random.default_rng(0).random(prob.num_free)


def main():
    prob = build_problem()
    solution, info = prob.solve(initial_guess(prob))
    print('status={} iters={} obj={:.6f}'.format(
        info['status'], info['iterations'], info['obj_val']))
    assert info['status'] in (0, 1), info['status_msg']
    # the particle must end diametrically opposite, 4r up
    xs = prob.parse_free(solution)[0]
    assert abs(xs[1, -1] - 1.0) < 1e-6 and abs(xs[2, -1] - 4.0) < 1e-6
    return solution, info


if __name__ == '__main__':
    main()
