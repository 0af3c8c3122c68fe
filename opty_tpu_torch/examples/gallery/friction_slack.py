"""Coulomb Friction via Linear Complementarity Slacks — minimum time.

Port of the reference gallery problem
(examples-gallery/advanced/plot_friction_slack.py, after Posa 2013):
discontinuous Coulomb friction is reformulated with positive friction
components, a |v| slack psi and three complementarity slack
trajectories (alpha, beta, gamma), the products turned into one-sided
``eom_bounds`` inequality rows.  Minimum-time push of a block 10 m out
and back to rest, variable ``h``.

Run:  python -m opty_tpu_torch.examples.gallery.friction_slack
"""

import numpy as np
import sympy as sm

from ...problem import Problem


def build_problem(N=40, device=None):

    m, mu, g, t, h = sm.symbols('m, mu, g, t, h', real=True)
    epsilon = sm.symbols('epsilon', real=True)
    x, v, F = sm.symbols('x, v, F', cls=sm.Function)
    psi, Ffp, Ffn = sm.symbols('psi, F_{fp}, F_{fn}', cls=sm.Function)
    alpha, beta, gamma = sm.symbols('alpha, beta, gamma', cls=sm.Function)

    eom = sm.Matrix([
        x(t).diff(t) - v(t),
        m * v(t).diff(t) - Ffp(t) + Ffn(t) - F(t),
        alpha(t) - psi(t) - v(t),
        beta(t) - psi(t) + v(t),
        gamma(t) - mu * m * g + Ffp(t) + Ffn(t),
        Ffp(t) * alpha(t) - epsilon,    # complementarity rows, <= 0
        Ffn(t) * beta(t) - epsilon,
        gamma(t) * psi(t) - epsilon,
    ])
    eom_bounds = {5: (-np.inf, 0.0), 6: (-np.inf, 0.0),
                  7: (-np.inf, 0.0)}

    def obj(free):
        return free[-1]

    t0, tm, tf = 0 * h, (N // 2) * h, (N - 1) * h
    instance_constraints = (
        x(t0) - 0.0, v(t0) - 0.0,
        x(tm) - 10.0, v(tm) - 0.0,
        x(tf) + 0.0, v(tf) - 0.0,
    )

    bounds = {
        h: (0.0, 0.2),
        x(t): (0.0, 10.0),
        v(t): (-100.0, 100.0),
        F(t): (-400.0, 400.0),
        Ffp(t): (0.0, np.inf),
        Ffn(t): (0.0, np.inf),
        alpha(t): (0.0, np.inf),
        beta(t): (0.0, np.inf),
        gamma(t): (0.0, np.inf),
        psi(t): (0.0, np.inf),
    }
    par_map = {m: 1.0, mu: 0.6, g: 9.81, epsilon: 0.0}

    prob = Problem(obj, None, eom, (x(t), v(t)), N, h,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   time_symbol=t, bounds=bounds, eom_bounds=eom_bounds,
                   device=device)

    # reference's structured guess (unknown trajectories sorted by
    # name: F, F_{fn}, F_{fp}, alpha, beta, gamma, psi)
    half = N // 2
    guess = np.zeros(prob.num_free)
    guess[0 * N:1 * N - half] = np.linspace(0.0, 10.0, num=half)
    guess[1 * N - half:1 * N] = np.linspace(10.0, 0.0, num=half)
    guess[1 * N:2 * N - half] = 10.0
    guess[2 * N - half:2 * N] = -10.0
    guess[2 * N:3 * N - half] = 100.0
    guess[3 * N - half:3 * N] = -100.0
    guess[3 * N:4 * N - half] = 5.0
    guess[4 * N:5 * N - half] = 0.0
    guess[5 * N - half:5 * N] = 5.0
    guess[-1] = 0.1
    return prob, guess


COLD_MAX_ITER = 2000    # benchmarks/cold_gallery.py:305


def initial_guess(prob):
    """The documented cold start (benchmarks/cold_gallery.py:146-162,
    after plot_friction_slack.py:216-236); ``build_problem``'s own
    guess is the original's ``main``'s."""
    N = prob.collocator.num_collocation_nodes
    half = N // 2
    g = np.zeros(prob.num_free)
    g[0:N - half] = np.linspace(0.0, 10.0, N - half)
    g[N - half:N] = np.linspace(10.0, 0.0, half)
    g[N:2 * N - half] = 10.0
    g[2 * N - half:2 * N] = -10.0
    g[2 * N:3 * N - half] = 100.0
    g[3 * N - half:3 * N] = -100.0
    g[3 * N:4 * N - half] = 5.0
    g[4 * N:5 * N - half] = 0.0
    g[5 * N - half:5 * N] = 5.0
    g[8 * N:9 * N - half] = 10.0
    g[9 * N - half:9 * N] = 10.0
    g[-1] = 0.05
    return g


def main():
    prob, guess = build_problem()
    # the complementarity structure converges through many short
    # elastic-restoration episodes; give it room
    prob.set_solver_options(max_iter=1000)
    solution, info = prob.solve(guess)
    print('status={} iters={} h={:.6f}'.format(
        info['status'], info['iterations'], float(solution[-1])))
    assert info['status'] in (0, 1), info['status_msg']
    xs = prob.parse_free(solution)[0]
    N = prob.collocator.num_collocation_nodes
    assert abs(xs[0, N // 2] - 10.0) < 1e-6     # out 10 m at midpoint
    assert abs(xs[0, -1]) < 1e-6                # and back
    return solution, info


if __name__ == '__main__':
    main()
