"""Betts 2003 parameter identification — known trajectory + midpoint.

Port of the reference gallery problem
(examples-gallery/beginner/plot_betts2003.py, after Betts'
"Exploiting Sparsity in the Direct Transcription Method for Optimal
Control", 2003): identify the parameter p of a forced oscillator from
noisy measurements of both states; true value p = pi.

Run:  python -m opty_tpu_torch.examples.gallery.betts2003
"""

import numpy as np
import sympy as sm
import torch

from ...config import resolve_device
from ...problem import Problem


def build_problem(num_nodes=100, seed=1234, device=None):

    duration = 1.0
    interval = duration / (num_nodes - 1)
    mu, p, t = sm.symbols('mu, p, t')
    y1, y2, T = [sm.Function(s)(t) for s in ('y1', 'y2', 'T')]

    eom = sm.Matrix([
        y1.diff(t) - y2,
        y2.diff(t) - mu ** 2 * y1 + (mu ** 2 + p ** 2)
        * sm.sin(p * T),
    ])
    par_map = {mu: 60.0}
    time = np.linspace(0.0, duration, num=num_nodes)
    rng = np.random.default_rng(seed)
    y1_m = np.sin(np.pi * time) + rng.normal(scale=0.05, size=num_nodes)
    y1_j = torch.as_tensor(y1_m, device=resolve_device(device))

    def obj(free):
        return interval * torch.sum((y1_j - free[:num_nodes]) ** 2)

    prob = Problem(obj, None, eom, (y1, y2), num_nodes, interval,
                   known_parameter_map=par_map,
                   known_trajectory_map={T: time},
                   instance_constraints=(y1.subs(t, 0.0),
                                         y2.subs(t, 0.0) - np.pi),
                   time_symbol=t, integration_method='midpoint',
                   device=device)
    return prob, None


COLD_MAX_ITER = 1000    # benchmarks/cold_gallery.py:314


def initial_guess(prob):
    """The documented cold start, the original's ``__main__``
    (benchmarks/cold_gallery.py:203-205)."""
    return np.random.default_rng(0).standard_normal(prob.num_free)


def main():
    prob, _ = build_problem()
    sol, info = prob.solve(initial_guess(prob))
    print(info['status_msg'])
    print('Known value of p      =', np.pi)
    print('Identified value of p =', sol[-1])
    return sol, info


if __name__ == '__main__':
    main()
