"""Fixed-duration pendulum swing-up (the reference gallery's beginner
example, examples-gallery/beginner/
plot_pendulum_swing_up_fixed_duration.py), the counterpart of the JAX
package's examples/pendulum_swing_up.py: the same three runs, the
problem built as its ``main`` builds it.

Run:  python -m opty_tpu_torch.examples.pendulum_swing_up [--batch B]
      [--nodes N] [--variable-duration] [--plot]
"""

import argparse
import time

import numpy as np
import sympy as sm

from ..models import swing_up_problem
from ..problem import Problem
from ..utils import create_objective_function

__all__ = ['build_problem', 'main']

DURATION = 10.0


def build_problem(num_nodes=501, device=None):
    """The fixed-duration swing-up of the original's ``main``: 10 s,
    minimum integrated squared torque, |T| <= 2.  ``device`` is the
    problem's (the card when None)."""
    interval_value = DURATION / (num_nodes - 1)

    I, m, g, d, t = sm.symbols('I, m, g, d, t')
    theta, omega, T = sm.symbols('theta, omega, T', cls=sm.Function)

    state_symbols = (theta(t), omega(t))
    eom = sm.Matrix([theta(t).diff() - omega(t),
                     I * omega(t).diff() + m * g * d * sm.sin(theta(t))
                     - T(t)])
    par_map = {I: 1.0, m: 1.0, g: 9.81, d: 1.0}

    obj, obj_grad = create_objective_function(
        sm.Integral(T(t) ** 2, t), state_symbols, (T(t),), tuple(),
        num_nodes, interval_value, time_symbol=t)

    target_angle = np.pi
    instance_constraints = (
        theta(0.0),
        theta(DURATION) - target_angle,
        omega(0.0),
        omega(DURATION),
    )

    return Problem(obj, obj_grad, eom, state_symbols, num_nodes,
                   interval_value,
                   known_parameter_map=par_map,
                   instance_constraints=instance_constraints,
                   bounds={T(t): (-2.0, 2.0)},
                   time_symbol=t, device=device)


def main(argv=None, device=None):
    """The original's command line; returns (solution, info), or the
    batch's IPMResult with ``--batch``."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=0,
                        help='solve B multi-start instances as lanes')
    parser.add_argument('--nodes', type=int, default=501)
    parser.add_argument('--plot', action='store_true')
    parser.add_argument('--variable-duration', action='store_true',
                        help='free time interval h (reference: '
                        'plot_pendulum_swing_up_variable_duration.py)')
    args = parser.parse_args(argv)

    if args.variable_duration:
        prob = swing_up_problem(num_nodes=args.nodes,
                                variable_duration=True, device=device)
        np.random.seed(2)
        x0 = np.random.randn(prob.num_free) * 0.01
        x0[-1] = 0.01
        prob.set_solver_options(max_iter=2000)
        t0 = time.time()
        solution, info = prob.solve(x0)
        print(info['status_msg'])
        print('objective: {:.6f}  h: {:.6f}  iterations: {}  '
              'wall: {:.1f}s'.format(info['obj_val'], solution[-1],
                                     info['iterations'],
                                     time.time() - t0))
        if args.plot:
            import matplotlib.pyplot as plt
            prob.plot_trajectories(solution)
            plt.show()
        return solution, info

    prob = build_problem(args.nodes, device=device)

    rng = np.random.default_rng(7)
    if args.batch:
        batch = rng.standard_normal((args.batch, prob.num_free))
        t0 = time.time()
        res = prob.solve_batch(batch)
        wall = time.time() - t0
        status = res.status.cpu().numpy()
        obj = res.obj_val.cpu().numpy()
        best = float(np.min(obj[status == 0])) if np.any(status == 0) \
            else float('nan')
        print('batch of {}: {} converged, best obj {:.4f}, {:.1f}s'.format(
            args.batch, int(np.sum(status == 0)), best, wall))
        return res

    initial_guess = rng.standard_normal(prob.num_free)
    t0 = time.time()
    solution, info = prob.solve(initial_guess)
    print(info['status_msg'])
    print('objective:', info['obj_val'], ' iterations:',
          info['iterations'], ' wall: {:.1f}s'.format(time.time() - t0))
    if args.plot:
        import matplotlib.pyplot as plt
        prob.plot_trajectories(solution)
        prob.plot_constraint_violations(solution)
        prob.plot_objective_value()
        plt.show()
    return solution, info


if __name__ == '__main__':
    main()
