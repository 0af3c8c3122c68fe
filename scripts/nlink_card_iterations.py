#!/usr/bin/env python3
"""What the CUDA graphs of nlp/collocation.py buy the nlink-9 solve on
the card: the chain at N = 60 with chip_smoke.py's phase-7 options and a
float64 factorization, solved for a few iterations with the wide
models' derivative passes replayed from graphs, then with them run
eagerly (collocation._graphed patched to call its function).
Needs a CUDA card:

    python3 scripts/nlink_card_iterations.py

Prints one JSON object: the wall of each run (the first graphed run
includes the captures), the captures' cost, the steady wall an
iteration of each mode, and the largest difference between the two
modes' iterates after 3 iterations.
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    from opty_tpu_torch.nlp import collocation

    prob, guess = chip_smoke.nlink_problem('cuda')

    def run(iters):
        prob.set_solver_options(kkt_method='cr', factor_dtype=torch.float64,
                                **dict(chip_smoke.NLINK_OPTIONS,
                                       max_iter=iters))
        torch.cuda.synchronize()
        t0 = time.time()
        x, info = prob.solve(guess)
        torch.cuda.synchronize()
        return time.time() - t0, x, info['iterations']

    # the first run captures the graphs; the next two replay them
    graphed = [run(k) for k in (3, 3, 23)]
    replay = collocation._graphed.__call__
    collocation._graphed.__call__ = lambda self, *args: self.fn(*args)
    try:
        eager = [run(k) for k in (3, 5)]
    finally:
        collocation._graphed.__call__ = replay
    print(json.dumps(dict(
        device=torch.cuda.get_device_name(0),
        graphed_walls_s=[(it, w) for w, _, it in graphed],
        eager_walls_s=[(it, w) for w, _, it in eager],
        capture_s=graphed[0][0] - graphed[1][0],
        graphed_s_per_iteration=(graphed[2][0] - graphed[1][0]) / 20,
        eager_s_per_iteration=(eager[1][0] - eager[0][0]) / 2,
        max_abs_dx_at_3=float(np.max(np.abs(graphed[0][1] - eager[0][1]))))))


if __name__ == '__main__':
    main()
