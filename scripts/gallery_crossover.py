#!/usr/bin/env python3
"""Where a gallery problem's cold solve on the card parts from the
CPU's, one iteration at a time from shared states, with the
configuration of chip_smoke.py's phase 9b (the documented start,
``use_soc=False``, a float64 factorization).  Needs a CUDA card:

    python3 scripts/gallery_crossover.py [--name particle_in_tube]
        [--max-iter 120] [--out FILE] [k ...]

1. The start: the first iteration from the documented start on the
   card with kkt_method='cr' and 'scan', and on the CPU with 'cr' and
   'scan' (chip_smoke.py's step server); the next iterates compared.
   Beside them the EoM Jacobian's blocks at the start
   (``jacobian_blocks``), card against CPU: the largest difference and
   the number of nodes whose rows differ.
2. The paths: the card's cr and scan solves and their objective
   histories, with the first iteration at which they part.
3. The crossovers: the card's cr solve to the last k, in chunks that
   end at each k (chip_smoke.py's ``solve_with_crossovers``; every chunk
   builds the NLP functions again: at particle_in_tube's size 15 ks up
   to 80 did not end within 600 s, so keep the ks few); from the
   card's state at k, the card's cr and scan steps and the CPU's cr and
   scan steps.
   For each k: card cr against CPU cr, card scan against card cr, CPU
   scan against CPU cr (the largest relative difference of x, y, zL
   and zU), and the card's objective and mu there.

Prints one JSON object and writes it to ``--out``.  A step that departs
card against CPU where the two devices' own cr and scan steps agree
is a difference of the card's arithmetic; a step whose cr and scan
steps part on both devices alike is one that amplifies round-off
wherever it runs.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

FIELDS = ('x', 'y', 'zL', 'zU')


def rel(a, b):
    return float(max(np.max(np.abs(a[f] - b[f]))
                     / max(np.max(np.abs(b[f])), 1e-300) for f in FIELDS))


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit('needs a CUDA card')
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from opty_tpu_torch import interop
    from opty_tpu_torch.examples import gallery

    ap = argparse.ArgumentParser()
    ap.add_argument('--name', default='particle_in_tube')
    ap.add_argument('--max-iter', type=int, default=120)
    ap.add_argument('--out', default=os.path.join(
        root, 'chiprun_out', 'gallery_crossover.json'))
    ap.add_argument('ks', nargs='*', type=int,
                    default=[5, 10, 15, 16, 17, 20])
    args = ap.parse_args()
    ks = sorted(args.ks)
    t_start = time.time()
    server = cs.start_step_server([args.name])
    cpu = cs.CPUSteps.of(server)
    out = dict(device=torch.cuda.get_device_name(0), smi=cs.device_line(),
               name=args.name, max_iter=args.max_iter)
    base = dict(use_soc=False, max_iter=args.max_iter)
    try:
        prob, guess = gallery.build(args.name, device='cuda')
        cpu_prob, _ = gallery.build(args.name, device='cpu')
        x0 = prob._as_tensor(guess)[None]

        # 1. the start
        blocks = [b.detach().cpu().numpy() for b in
                  prob.collocator.jacobian_blocks(x0[0])]
        cpu_blocks = [b.numpy() for b in
                      cpu_prob.collocator.jacobian_blocks(
                          cpu_prob._as_tensor(guess))]
        del cpu_prob
        diff = [np.abs(a - b) for a, b in zip(blocks, cpu_blocks) if a.size]
        out['jacobian_at_start'] = dict(
            largest_difference=float(max(np.max(d) for d in diff)),
            nodes_differing=int(np.sum(np.any(
                diff[0].reshape(diff[0].shape[0], -1) > 1e-12, axis=1))),
            nodes=int(blocks[0].shape[0]))
        first = {}
        for method in ('cr', 'scan'):
            prob.set_solver_options(kkt_method=method, chunk_iters=1,
                                    factor_dtype=torch.float64, **base)
            _, st = prob._build_solver()[1](x0)
            first['card ' + method] = {f: getattr(st, f).cpu().numpy()
                                       for f in FIELDS}
            cpu.submit('cpu ' + method, args.name,
                       dict(base, kkt_method=method))
        prob.set_solver_options(chunk_iters=None)
        first.update(cpu.collect())
        out['first_iteration'] = {
            'card cr vs cpu cr': rel(first['card cr'], first['cpu cr']),
            'card scan vs card cr': rel(first['card scan'],
                                        first['card cr']),
            'cpu scan vs cpu cr': rel(first['cpu scan'], first['cpu cr']),
            'card scan vs cpu scan': rel(first['card scan'],
                                         first['cpu scan'])}
        print('start:', json.dumps(out['jacobian_at_start']),
              json.dumps(out['first_iteration']), flush=True)

        # 2. the card's two paths
        paths = {}
        for method in ('cr', 'scan'):
            prob.set_solver_options(kkt_method=method,
                                    factor_dtype=torch.float64, **base)
            t0 = time.time()
            _, info = prob.solve(guess)
            paths[method] = dict(status=info['status'],
                                 iterations=info['iterations'],
                                 obj=info['obj_val'],
                                 wall_s=time.time() - t0,
                                 history=[float(v) for v in prob.obj_value])
        a, b = paths['cr']['history'], paths['scan']['history']
        parted = next((k for k in range(min(len(a), len(b)))
                       if abs(a[k] - b[k]) > 1e-8 * max(1.0, abs(b[k]))),
                      None)
        out['card_paths'] = dict(paths, objective_parts_at=parted)
        print('card paths:', json.dumps({m: {k: v for k, v in p.items()
                                             if k != 'history'}
                                         for m, p in paths.items()}),
              'objectives part at iteration', parted, flush=True)

        # 3. crossovers from the card's cr path
        states = {}
        _, rec, steps = cs.solve_with_crossovers(
            prob, guess, torch.float64, 'cr', ks, cpu, name=args.name,
            base=dict(base, max_iter=ks[-1] + 1), states=states)
        for k, s in states.items():
            for method in ('cr', 'scan'):
                cpu.submit((k, method), args.name,
                           dict(base, kkt_method=method), s['state'])
        cpu_steps = cpu.collect()
        prob.set_solver_options(kkt_method='scan', chunk_iters=1,
                                factor_dtype=torch.float64, **base)
        resume = prob._build_solver()[2]
        history = prob.obj_value
        table = {}
        for k, s in sorted(states.items()):
            _, nxt = resume(x0, interop.state_from_numpy(s['state'], 'cuda'))
            card_scan = {f: getattr(nxt, f).cpu().numpy() for f in FIELDS}
            cpu_cr, cpu_scan = cpu_steps[k, 'cr'], cpu_steps[k, 'scan']
            table[k] = {
                'card cr vs cpu cr': rel(s['card'], cpu_cr),
                'card scan vs card cr': rel(card_scan, s['card']),
                'cpu scan vs cpu cr': rel(cpu_scan, cpu_cr),
                'card scan vs cpu scan': rel(card_scan, cpu_scan),
                'mono_equal': steps[k]['mono_equal'], 'mu': steps[k]['mu'],
                'obj': history[k - 1] if k <= len(history) else None}
        prob.set_solver_options(chunk_iters=None)
        out['crossovers'] = dict(status=rec['status'],
                                 iterations=rec['iterations'],
                                 obj=rec['obj'], steps=table)
        out['wall_s'] = time.time() - t_start
        for k, row in table.items():
            print('k={}: {}'.format(k, json.dumps(row)), flush=True)
    finally:
        cs.stop_children({'steps': server})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(out, f)
    print(json.dumps({k: v for k, v in out.items() if k != 'card_paths'}))


if __name__ == '__main__':
    main()
