"""Parameter identification of a pendulum from noisy measurements, the
counterpart of examples/vyasarayani2011.py: p in y'' + p sin(y) = 0
from noisy observations of y, with the states estimated on a midpoint
collocation grid.

Run:  python -m opty_tpu_torch.examples.vyasarayani2011 [--nodes 5000]
      [--noise 0.05]
"""

import argparse
import time

import numpy as np
import sympy as sym
import torch
from scipy.integrate import odeint

from opty_tpu_torch import Problem
from opty_tpu_torch.config import resolve_device

__all__ = ['build_problem', 'main', 'P_TRUE']

P_TRUE = 10.0
DURATION = 50.0


def build_problem(nodes=5000, noise=0.05, device=None):
    """The identification problem of the original's ``main`` with its
    data: returns (problem, initial guess, the true p).  ``device`` is
    the problem's (the card when None)."""
    p, t = sym.symbols('p, t')
    y1, y2 = [f(t) for f in sym.symbols('y1, y2', cls=sym.Function)]
    eom = sym.Matrix([y1.diff(t) - y2, y2.diff(t) + p * sym.sin(y1)])

    num_nodes = nodes
    interval = DURATION / (num_nodes - 1)
    tv = np.linspace(0.0, DURATION, num=num_nodes)

    y_meas = odeint(lambda y, _t, pp: np.array(
        [y[1], -pp * np.sin(y[0])]), [np.pi / 6.0, 0.0], tv,
        args=(P_TRUE,))
    rng = np.random.default_rng(11)
    y1_meas = y_meas[:, 0] + rng.normal(scale=noise, size=num_nodes)
    y1_t = torch.as_tensor(y1_meas, device=resolve_device(device))

    def obj(free):
        return interval * torch.sum((y1_t - free[:num_nodes]) ** 2)

    prob = Problem(obj, None, eom, (y1, y2), num_nodes, interval,
                   time_symbol=t, integration_method='midpoint',
                   device=device)
    guess = np.hstack([y1_meas, np.gradient(y1_meas, interval), 30.0])
    return prob, guess, P_TRUE


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--nodes', type=int, default=5000)
    parser.add_argument('--noise', type=float, default=0.05)
    args = parser.parse_args()

    prob, x0, p_true = build_problem(args.nodes, args.noise)
    t0 = time.time()
    sol, info = prob.solve(x0)
    print(info['status_msg'])
    print('identified p = {:.6f} (true {})  iters {}  wall {:.1f}s'.format(
        sol[-1], p_true, info['iterations'], time.time() - t0))


if __name__ == '__main__':
    main()
