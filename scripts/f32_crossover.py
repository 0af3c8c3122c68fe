#!/usr/bin/env python3
"""The port's half of the float32-factor crossovers, after the JAX
package's half (scripts/reference_f32_states.py) has written a
problem's states:

    python3 scripts/f32_crossover.py build/sliding_block_f32.npz \
        sliding_block [--phase 2]

From each of the JAX package's states k the port takes one iteration
with the float32 factor (six float64 refinement rounds) and one with a
float64 factor, on the CPU, and prints per k the largest relative
difference of x, y, zL and zU (max |difference| / max |JAX value|):

* ``port32``: the port's float32 step against the JAX package's;
* ``port64``: the port's float64 step against the JAX package's;
* ``jax32_64``: the JAX package's own float32 step against its float64
  step from the same state, the yardstick: a port step that differs
  from the JAX package's by much less than this is round-off.

Prints one JSON object (the per-k lists and their maxima) and writes it
to ``--out``.  Imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
FIELDS = ('x', 'y', 'zL', 'zU')


def rel(a, b):
    return float(max(np.max(np.abs(a[f] - b[f]))
                     / max(np.max(np.abs(b[f])), 1e-300) for f in FIELDS))


def port_problem(name, ref, phase):
    from opty_tpu_torch.examples import gallery
    if phase == 2:
        from opty_tpu_torch.examples.gallery import betts_10_47 as mod
        n = mod.NUM_NODES
        sol1 = ref['phase1']
        return mod.build_phase2(sol1[n - 1], sol1[2 * n - 1],
                                sol1[3 * n - 1], device='cpu')
    return gallery.build(name, device='cpu')[0]


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('states')
    parser.add_argument('name')
    parser.add_argument('--phase', type=int, default=None)
    parser.add_argument('--out', default=None)
    args = parser.parse_args()
    import torch
    from opty_tpu_torch import interop
    from opty_tpu_torch.nlp.ipm_types import IPMState

    ref = np.load(args.states)
    prob = port_problem(args.name, ref, args.phase)
    free = torch.as_tensor(ref['free'])[None]
    dtypes = {'32': torch.float32, '64': torch.float64}
    options = dict(kkt_method='cr', chunk_iters=1,
                   **({} if args.phase else {'use_soc': False}))
    # the solver takes the IPM options when it is built and the factor
    # dtype at each call
    prob.set_solver_options(**options)
    resume = prob._build_solver()[2]
    out = {'port32': [], 'port64': [], 'jax32_64': []}
    for k in range(int(ref['count'])):
        state = interop.state_from_numpy(
            {f: ref['s%d_%s' % (k, f)] for f in IPMState._fields}, 'cpu')
        want = {tag: {f: ref['n%s_%d_%s' % (tag, k, f)] for f in FIELDS}
                for tag in ('32', '64')}
        for tag in ('32', '64'):
            prob.set_solver_options(factor_dtype=dtypes[tag])
            _, nxt = resume(free, state)
            got = {f: getattr(nxt, f)[0].numpy() for f in FIELDS}
            out['port' + tag].append(rel(got, want[tag]))
        out['jax32_64'].append(rel(want['32'], want['64']))
        print(k, out['port32'][-1], out['port64'][-1], out['jax32_64'][-1],
              flush=True)
    out['max'] = {key: max(v) for key, v in out.items() if v}
    out['port32_over_yardstick'] = max(
        a / max(b, 1e-300) for a, b in zip(out['port32'], out['jax32_64']))
    line = json.dumps(dict(name=args.name, phase=args.phase, **out))
    print(line)
    if args.out:
        with open(args.out, 'w') as fh:
            fh.write(line + '\n')


if __name__ == '__main__':
    main()
