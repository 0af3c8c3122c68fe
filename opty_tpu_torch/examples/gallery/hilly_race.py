"""Hilly Race — implicit known trajectories from measured data (C17).

Port of the reference gallery problem
(examples-gallery/beginner/plot_hilly_race.py): a rider crosses a
measured elevation profile in minimum time; the slope angle
``theta(x)`` and its derivative are supplied as *data* through
``known_trajectory_map`` callables of the free vector — the
reference-style implicit-trajectory input surface
(opty/direct_collocation.py:2284-2302).  The callables interpolate
the tables with ``_common.interp``, the torch counterpart of the JAX
package's ``jnp.interp``.

No reference CSV exists for this config; the script solves end-to-end
from the reference's documented initial guess and reports the outcome.

Known-hard: the power term ``p/v`` is singular at the pinned initial
condition ``v(0) = 0``, and the minimum-time objective interacts with
that singular row; our filter IPM currently makes slow progress on the
duration (the C17 implicit-data machinery itself is oracle-tested in
tests/test_implicit_traj.py and tests/test_gallery_parity.py).
Round-4 diagnosis (see COVERAGE.md "Known limitations"): the regular
phase grinds with tiny accepted steps while the equality multipliers
blow up (|y| -> 1e8 with theta ~ 3e3), then restoration cycles its
budget away; measured-and-rejected remedies this round were
exact-Hessian elastic restoration (worse on this stiff family) and
dual step caps (no effect).  The structural remedy is an Ipopt-grade
restoration phase (its own filter + multiple inner iterations).

Run:  python -m opty_tpu_torch.examples.gallery.hilly_race
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...config import resolve_device
from ...problem import Problem
from ._common import interp


def build_problem(num_nodes=201, device=None):

    m, g, h = sm.symbols('m, g, h', real=True)
    s, v, x, y, p, e = me.dynamicsymbols('s, v, x, y, p, e', real=True)
    theta = sm.Function('theta')(x)
    t = me.dynamicsymbols._t

    states = (x, y, s, v, e)
    eom = sm.Matrix([
        x.diff() - v * sm.cos(theta),
        y.diff() - v * sm.sin(theta),
        s.diff() - v,
        m * v.diff() - p / v + m * g * sm.sin(theta) + v ** 2 / 3,
        e.diff() - p,
    ])

    # measured elevation profile -> slope angle tables
    amp = 50.0
    omega = 2 * np.pi / 500.0
    x_meas = np.linspace(-250.0, 1250.0, num=3001)
    theta_meas = np.arctan(amp * omega * np.cos(omega * x_meas))
    dthetadx_meas = -amp * omega ** 2 * np.sin(omega * x_meas) / (
        amp ** 2 * omega ** 2 * np.cos(omega * x_meas) ** 2 + 1)
    dev = resolve_device(device)
    x_measj = torch.as_tensor(x_meas, device=dev)
    theta_measj = torch.as_tensor(theta_meas, device=dev)
    dthetadxj = torch.as_tensor(dthetadx_meas, device=dev)
    N = num_nodes

    def calc_theta(free):
        return interp(free[0:N], x_measj, theta_measj)

    def calc_dthetadx(free):
        return interp(free[0:N], x_measj, dthetadxj)

    def obj(free):
        return free[-1]

    t0, tf = 0 * h, (N - 1) * h
    sf, ef = 1000.0, 120000.0
    instance_constraints = (x.func(t0), y.func(t0), s.func(t0),
                            v.func(t0), e.func(t0), s.func(tf) - sf)
    bounds = {h: (0.0, 10.0), p: (0.0, 1000.0), v: (0.0, np.inf),
              e: (0.0, ef)}
    prob = Problem(
        obj, None, eom, states, N, h,
        known_parameter_map={m: 100.0, g: 9.81},
        known_trajectory_map={theta.diff(x): calc_dthetadx,
                              theta: calc_theta},
        time_symbol=t, instance_constraints=instance_constraints,
        bounds=bounds, integration_method='midpoint',
        device=device)
    return prob, None


def reference_initial_guess(prob, seed=0):
    N = prob.collocator.num_collocation_nodes
    rng = np.random.default_rng(seed)
    guess = rng.random(prob.num_free)
    sf, ef = 1000.0, 120000.0
    cols = prob.collocator
    sym = {str(k): k for k in (list(cols.state_symbols)
                               + list(cols.unknown_input_trajectories))}
    prob.fill_free(guess, np.linspace(0.0, sf, num=N), sym['x(t)'])
    prob.fill_free(guess, np.zeros(N), sym['y(t)'])
    prob.fill_free(guess, np.linspace(0.0, sf, num=N), sym['s(t)'])
    prob.fill_free(guess, 10.0 * np.ones(N), sym['v(t)'])
    prob.fill_free(guess, np.linspace(0.0, ef, num=N), sym['e(t)'])
    prob.fill_free(guess, 500.0 * np.ones(N), sym['p(t)'])
    guess[-1] = 0.1
    return guess


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:309


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:177-180,
    after plot_hilly_race.py:199-210): ``reference_initial_guess``."""
    return reference_initial_guess(prob)


def main():
    prob, _ = build_problem()
    guess = reference_initial_guess(prob)
    sol, info = prob.solve(guess)
    print(info['status_msg'])
    N = prob.collocator.num_collocation_nodes
    print('h = {:.4f} -> total time {:.1f} s, iterations {}'.format(
        sol[-1], sol[-1] * (N - 1), info['iterations']))
    return sol, info


if __name__ == '__main__':
    main()
