#!/usr/bin/env python3
"""Card against CPU on the nlink-9 solve of chip_smoke.py's phase 7a
(or 7c), one iteration at a time from a shared state: the card solves
the chain at N = 60 (phase-7 options, ``kkt_method='cr'`` or
``'scan'``, a float64 factorization) to the last of a few iteration
counts k, in chunks that end at each; there its state is handed to the
CPU (chip_smoke.py's step server, a child process), both take one
iteration from it, and the two next iterates are compared
(chip_smoke.py's ``solve_with_crossovers``).  Needs a CUDA card:

    python3 scripts/nlink_crossover.py [--method cr|scan] [k ...]

Prints one JSON object: for each k, the largest difference of the two
next x, y, zL and zU relative to the largest entry, the card's mu, and
whether both took the same branch (mono).  A step
that agrees to round-off at every k means the card and the CPU compute
the same iteration, and any difference between their full solves is
round-off amplified along the path.
"""

import argparse
import json
import os
import sys


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke

    ap = argparse.ArgumentParser()
    ap.add_argument('--method', default='cr', choices=('cr', 'scan'))
    # iterations of the shared state (the first call takes one)
    ap.add_argument('ks', nargs='*', type=int,
                    default=[1, 2, 5, 10, 20, 50, 100, 200, 300])
    args = ap.parse_args()
    server = chip_smoke.start_step_server([chip_smoke.NLINK_NAME])
    try:
        prob, guess = chip_smoke.nlink_problem('cuda')
        _, _, steps = chip_smoke.solve_with_crossovers(
            prob, guess, torch.float64, args.method, sorted(args.ks),
            chip_smoke.CPUSteps.of(server), max_iter=max(args.ks) + 1)
    finally:
        chip_smoke.stop_children({'steps': server})
    print(json.dumps(dict(device=torch.cuda.get_device_name(0),
                          method=args.method, crossovers=steps)))


if __name__ == '__main__':
    main()
