"""Non-contiguous parameter identification — four trials, one NLP.

Port of the reference gallery problem
(examples-gallery/intermediate/plot_non_contiguous_parameter_identification.py):
four independent measurement trials of the same damped spring-mass
system are stacked as four state copies in ONE set of equations of
motion, so a single collocation NLP identifies the shared damping c
and stiffness k from all trials simultaneously (midpoint rule,
N = 500).  True values: c = 0.25, k = 1.0.

Run:  python -m opty_tpu_torch.examples.gallery.non_contiguous_id
"""

import numpy as np
import sympy as sm
import sympy.physics.mechanics as me
import torch

from ...config import resolve_device
from ...problem import Problem

TRUE_C, TRUE_K = 0.25, 1.0


def build_problem(num_nodes=500, seed=123, device=None):
    from scipy.integrate import solve_ivp

    t = me.dynamicsymbols._t
    xs = me.dynamicsymbols('x1, x2, x3, x4')
    us = me.dynamicsymbols('u1, u2, u3, u4')
    m, c, k, l0 = sm.symbols('m, c, k, l0')

    eom = sm.Matrix(
        [x.diff(t) - u for x, u in zip(xs, us)] +
        [m * u.diff(t) + c * u + k * (x - l0) for x, u in zip(xs, us)])

    par_vals = [1.0, 0.25, 1.0, 1.0]            # m, c, k, l0

    def rhs(_, y, p):
        mm, cc, kk, ll = p
        return np.hstack([y[4:], (-cc * y[4:] - kk * (y[:4] - ll)) / mm])

    t0, tf = 0.0, 20.0
    times = np.linspace(t0, tf, num=num_nodes)
    rng = np.random.RandomState(seed)
    measurements = []
    for _ in range(4):
        x0 = 4.0 * rng.randn(8)
        sol = solve_ivp(rhs, (t0, tf), x0[:8], t_eval=times,
                        args=(par_vals,))
        measurements.append(sol.y[0, :] + 2.0 * rng.randn(len(sol.t)))
    measurements = np.array(measurements)

    interval = (tf - t0) / (num_nodes - 1)
    meas_flat = measurements.ravel()
    meas_t = torch.as_tensor(meas_flat, device=resolve_device(device))

    def obj(free):
        d = free[:4 * num_nodes] - meas_t
        return interval * (d ** 2).sum()

    par_map = {m: par_vals[0], l0: par_vals[3]}
    bounds = {c: (0.01, 2.0), k: (0.1, 10.0)}

    prob = Problem(obj, None, eom, tuple(xs) + tuple(us), num_nodes,
                   interval, known_parameter_map=par_map,
                   integration_method='midpoint', bounds=bounds,
                   time_symbol=t,
                   device=device)
    guess = np.hstack((meas_flat, np.zeros(4 * num_nodes), [0.1, 3.0]))
    prob.documented_guess = guess.copy()
    return prob, guess


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:242-246


def initial_guess(prob):
    """The documented cold start, ``build_problem``'s guess: the
    measured sections, zero speeds and c, k = 0.1, 3.0
    (benchmarks/cold_gallery.py:242-246, after
    plot_non_contiguous_parameter_identification.py)."""
    return prob.documented_guess.copy()


def main():
    prob, guess = build_problem()
    solution, info = prob.solve(guess)
    c_id, k_id = float(solution[-2]), float(solution[-1])
    print('status={} iters={} c={:.4f} (true {}) k={:.4f} (true {})'.format(
        info['status'], info['iterations'], c_id, TRUE_C, k_id, TRUE_K))
    assert info['status'] in (0, 1), info['status_msg']
    # same tolerance the reference example demonstrates (noisy data)
    assert abs(c_id - TRUE_C) / TRUE_C < 0.1
    assert abs(k_id - TRUE_K) / TRUE_K < 0.1
    return solution, info


if __name__ == '__main__':
    main()
