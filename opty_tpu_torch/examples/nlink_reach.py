"""Gait2d-scale problem: 9-link chain on a cart, variable duration, the
counterpart of the JAX package's examples/nlink_reach.py.

The reference's advanced gallery exercises opty on human-movement
models (sit-to-stand, human gait: 19 states, ~100k-op EoMs, variable
h, many instance constraints — examples-gallery/advanced/
plot_sit_to_stand.py:36-202) that require the uninstallable pygait2d
package.  This script reproduces the problem *scale* self-contained:
20 states, 477k-op Kane's-method EoMs, 40 instance constraints, free
duration, bounded actuators at every joint.

Its default run (9 links, 60 nodes, the card's default solver
options) is chip_smoke.py's phase 7b solve, so that script does not
run it again.

Run:  python -m opty_tpu_torch.examples.nlink_reach [--links 9]
      [--nodes 60] [--plot]
"""

import argparse
import time

import sympy as sm

from ..models.nlink import n_link_cart_problem, n_link_initial_guess

__all__ = ['main']


def main(argv=None, device=None):
    """The original's command line; returns (solution, info)."""
    parser = argparse.ArgumentParser()
    parser.add_argument('--links', type=int, default=9)
    parser.add_argument('--nodes', type=int, default=60)
    parser.add_argument('--plot', action='store_true')
    args = parser.parse_args(argv)

    t0 = time.time()
    prob, q_start = n_link_cart_problem(num_links=args.links,
                                        num_nodes=args.nodes, device=device)
    n_ops = sm.count_ops(prob.collocator.eom)
    t_build = time.time() - t0
    print('model: {} links, {} states, {} EoM ops; transcribed in '
          '{:.1f}s (nfree={}, ncon={}, o={})'.format(
              args.links, prob.collocator.num_states, n_ops, t_build,
              prob.num_free, prob.num_constraints,
              prob.collocator.num_instance_constraints))

    guess = n_link_initial_guess(prob, q_start)
    t0 = time.time()
    sol, info = prob.solve(guess)
    wall = time.time() - t0
    print(info['status_msg'])
    print('objective: {:.6f}  iterations: {}  inf_pr: {:.1e}  '
          'h: {:.4f}  wall: {:.1f}s'.format(
              info['obj_val'], info['iterations'], info['inf_pr'],
              sol[-1], wall))

    if args.plot:
        prob.plot_trajectories(sol)
        import matplotlib.pyplot as plt
        plt.show()
    return sol, info


if __name__ == '__main__':
    main()
