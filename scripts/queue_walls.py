#!/usr/bin/env python3
"""The pendulum's walls from chip_smoke.py, for one tree: the three
queues of 64 on 32 lanes (phases 5, 5b and 5c) and the cr, scan and
default iteration profiles of phase 6, run with that tree's own
chip_smoke.py and kernels.  Needs a CUDA card:

    python3 scripts/queue_walls.py [ROOT]

ROOT (default: this checkout) holds chip_smoke.py and opty_tpu_torch/;
its kernels are built into ROOT/build/kernels.  Run it for two trees
one after the other in one session on one card (parent, change,
change, parent) to compare their walls on the same host.  Prints
chip_smoke.py's lines, then one JSON object: each queue's wall and
mean iterations, and each profile's wall per iteration of its plain
(unprofiled) run.
"""

import json
import os
import re
import sys
import time


def main():
    root = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                           os.path.dirname(os.path.dirname(
                               os.path.abspath(__file__))))
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    import chip_smoke as cs
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    from opty_tpu_torch.ops import scan_kernels as sk
    assert os.path.dirname(os.path.abspath(cs.__file__)) == root
    lines = []
    log = cs.log
    cs.log = lambda *a: (lines.append(' '.join(map(str, a))), log(*a))
    counters = (pk, bk, sk)
    t0 = time.time()
    pk.build_kernels()
    log('build: {:.1f} s'.format(time.time() - t0))
    out = {'root': root}
    for label, options, required, forbidden, limit in (
            ('main path', dict(kkt_method='cr', factor_dtype=torch.float32,
                               use_soc=False, mu_strategy='monotone'),
             ('pcr_factor_levels',), (), 52.0),
            ('scan path', dict(kkt_method='scan', factor_dtype=torch.float64,
                               use_soc=False, mu_strategy='monotone'),
             ('scan_factor',), (), 52.0),
            ('default path', {}, ('pcr_factor_levels',), (),
             cs.DEFAULT_MEAN_FACTOR * cs.JAX_DEFAULT_MEAN)):
        _, wall, iters = cs.queue_path(counters, label, options, required,
                                       forbidden, limit)
        out[label] = dict(wall_s=wall, mean_iterations=iters)
    for label, iters, options in (
            ('cr', 8, dict(kkt_method='cr', factor_dtype=torch.float32,
                           use_soc=False, mu_strategy='monotone')),
            ('scan', 4, dict(kkt_method='scan', factor_dtype=torch.float64,
                             use_soc=False, mu_strategy='monotone')),
            ('default', 8, {})):
        del lines[:]
        cs.iteration_profile(counters, label, cs.BATCH, iters, options)
        wall = [float(m.group(1)) for m in
                (re.search(r'wall_s=([0-9.]+) \(plain run\)', s)
                 for s in lines) if m]
        out['profile ' + label] = dict(
            wall_s=wall[0], ms_per_iteration=wall[0] / iters * 1e3)
    print(json.dumps(out), flush=True)


if __name__ == '__main__':
    main()
