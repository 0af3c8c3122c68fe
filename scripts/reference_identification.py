#!/usr/bin/env python3
"""The JAX package's two identification examples solved on the CPU at
their default sizes, for chip_smoke.py's records (JAX_PENDULUM_ID,
JAX_VYASARAYANI).

    JAX_PLATFORMS=cpu python3 scripts/reference_identification.py
    JAX_PLATFORMS=cpu python3 scripts/reference_identification.py vyasarayani

Each problem is built as the example's ``main`` builds it
(examples/inverted_pendulum_id.py: 1 link, N = 501, duration 5, noise
0.01; examples/vyasarayani2011.py: N = 5,000, noise 0.05), with the JAX
package's CPU defaults (kkt_method='scan', a float64 factorization, the
default solver options), and solved once; one JSON line each: status,
iterations, objective, the identified values to full precision and the
wall time.  ``jax_pendulum_id`` and ``jax_vyasarayani`` are the
builders; tests/test_torch_identification.py builds its reference
problems with them at smaller sizes.
"""

import importlib.util
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _example(name):
    """The module of examples/<name>.py (its ``main`` does not run)."""
    spec = importlib.util.spec_from_file_location(
        'reference_' + name, os.path.join(ROOT, 'examples', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_pendulum_id(links=1, nodes=501, duration=5.0, noise=0.01):
    """examples/inverted_pendulum_id.py's problem, guess and true gains,
    built as its ``main`` builds them."""
    import sympy as sm
    import jax.numpy as jnp
    from scipy.integrate import odeint
    from scipy.linalg import solve_continuous_are
    from opty_tpu import Problem, sum_of_sines
    ex = _example('inverted_pendulum_id')
    n = links
    kane, states, F, par_syms, t = ex.n_link_pendulum_on_cart(n)
    num_states = len(states)
    par_vals = [1.0] * (n + 1) + [1.0] * n + [9.81]
    par_map = dict(zip(par_syms, par_vals))
    eq_point = {s: 0.0 for s in states}
    A_op, B_op = kane.to_linearizer().linearize(
        op_point=[eq_point, {F: 0.0}], A_and_B=True)
    A_num = np.asarray(A_op.subs(par_map), dtype=float)
    B_num = np.asarray(B_op.subs(par_map), dtype=float).reshape(-1, 1)
    S = solve_continuous_are(A_num, B_num, np.eye(num_states), np.eye(1))
    K = (np.linalg.solve(np.eye(1), B_num.T @ S)).flatten()
    rhs_fn = sm.lambdify((states, F, par_syms),
                         kane.mass_matrix_full.LUsolve(kane.forcing_full),
                         cse=True)
    N = nodes
    tv = np.linspace(0.0, duration, N)
    np.random.seed(4)
    w_traj, _, _ = sum_of_sines(4.0, [1.0, 2.3, 3.7, 5.1, 7.3], tv)

    def rhs(x, t_now):
        force = -float(K @ x) + np.interp(t_now, tv, w_traj)
        return np.asarray(rhs_fn(x, force, par_vals), dtype=float).ravel()

    rng = np.random.default_rng(4)
    x_traj = odeint(rhs, np.zeros(num_states), tv)
    x_meas = x_traj + rng.normal(scale=noise, size=x_traj.shape)
    k = sm.symbols('k:{}'.format(num_states))
    w = sm.Function('w')(t)
    controller = -sum(ki * si for ki, si in zip(k, states)) + w
    eom = (kane.mass_matrix_full *
           sm.Matrix([s.diff(t) for s in states]) -
           kane.forcing_full).subs({F: controller})
    interval = duration / (N - 1)
    x_meas_j = jnp.asarray(x_meas.T)

    def obj(free):
        X = free[:num_states * N].reshape(num_states, N)
        return interval * jnp.sum((X - x_meas_j) ** 2)

    prob = Problem(obj, None, eom, states, N, interval,
                   known_parameter_map=par_map,
                   known_trajectory_map={w: w_traj}, time_symbol=t)
    return prob, np.hstack([x_meas.T.flatten(), np.zeros(len(k))]), K


def jax_vyasarayani(nodes=5000, noise=0.05):
    """examples/vyasarayani2011.py's problem, guess and true p, built as
    its ``main`` builds them."""
    import sympy as sym
    import jax.numpy as jnp
    from scipy.integrate import odeint
    from opty_tpu import Problem
    p, t = sym.symbols('p, t')
    y1, y2 = [f(t) for f in sym.symbols('y1, y2', cls=sym.Function)]
    eom = sym.Matrix([y1.diff(t) - y2, y2.diff(t) + p * sym.sin(y1)])
    duration = 50.0
    interval = duration / (nodes - 1)
    tv = np.linspace(0.0, duration, num=nodes)
    p_true = 10.0
    y_meas = odeint(lambda y, _t, pp: np.array(
        [y[1], -pp * np.sin(y[0])]), [np.pi / 6.0, 0.0], tv,
        args=(p_true,))
    rng = np.random.default_rng(11)
    y1_meas = y_meas[:, 0] + rng.normal(scale=noise, size=nodes)
    y1j = jnp.asarray(y1_meas)

    def obj(free):
        return interval * jnp.sum((y1j - free[:nodes]) ** 2)

    prob = Problem(obj, None, eom, (y1, y2), nodes, interval,
                   time_symbol=t, integration_method='midpoint')
    x0 = np.hstack([y1_meas, np.gradient(y1_meas, interval), 30.0])
    return prob, x0, p_true


def main():
    which = sys.argv[1:] or ['pendulum_id', 'vyasarayani']
    for name in which:
        t0 = time.time()
        if name == 'pendulum_id':
            prob, guess, truth = jax_pendulum_id()
            count = len(truth)
        elif name == 'vyasarayani':
            prob, guess, truth = jax_vyasarayani()
            count = 1
        else:
            sys.exit('unknown example {!r}'.format(name))
        built = time.time() - t0
        t0 = time.time()
        x, info = prob.solve(guess)
        print(json.dumps(dict(
            example=name, status=info['status'],
            iterations=info['iterations'], obj=info['obj_val'],
            identified=[float(v) for v in x[-count:]],
            truth=np.atleast_1d(truth).tolist(), build_s=built,
            solve_s=time.time() - t0)), flush=True)


if __name__ == '__main__':
    main()
