#!/usr/bin/env python3
"""This tree's wide factor and inverse (csrc/wide.cu with its
csrc/wide.cuh) against other trees' builds of them, on one card in one
process: which change of the pivot step moved the nlink-9 cr float64
solve, and where?

    python3 scripts/wide_tree_compare.py TREE [TREE ...]

Each TREE is an unpacked checkout of another commit (``git archive``
into a directory under build/), named by its directory.  Its
csrc/wide.cu (with its own wide.cuh) is built by nvcc with this tree's
flags into TREE/build/kernels/, and its ``pcr_wide_factor`` and
``block_inv_wide`` entries (whose C signatures have not changed since
they were written) take the place of this tree's in the loaded library,
the rest (the downsweep) staying this tree's.  Then, build by build:

* chip_smoke.py phase 7f's division check (``division_check``): the
  wide inverse of 1 x 1 and diagonal 2 x 2 blocks whose reciprocals lie
  next to a midpoint, against IEEE division;
* the pivot step's edge cases (phase 7f's ``pivot_edge_blocks``): how
  many outputs differ from this tree's, bitwise;
* phase 7a's kept factorizations (``capture_trials``), bitwise;
* side by side: phase 7a's first SIDE_ITERS iterations with this tree's
  kernels, every call of the wide factor and the border inverse run
  again by the other builds on the same inputs; the first call where a
  build's outputs differ is printed (which outputs, how many entries,
  by how many units in the last place, at which nodes and levels, each
  build's error against the plain version), its level-0 inverses
  (each node's D) compared build by build, and its inputs saved to
  OUT_DIR/wide_first_difference.pt;
* phase 7a's solve (nlink-9, N = 60, cr, float64 factor) to its end
  with every step fingerprinted (``fingerprinted_solve``, phase 7d's
  hooks): status, iterations and objective, and the first hooked call
  whose outputs differ from this tree's run (iteration, step, call).

Prints one line a comparison, the card's name and power limit first.
Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

SIDE_ITERS = 2
# where the first differing call's inputs go (torch.save)
OUT_DIR = os.path.join(ROOT, 'build', 'wide_tree_compare')
SWAPPED = ('pcr_wide_factor_f32', 'pcr_wide_factor_f64',
           'block_inv_wide_f32', 'block_inv_wide_f64')


class Mixed:
    """This tree's wide library with the SWAPPED entries of another."""

    def __init__(self, this, other):
        self._this, self._other = this, other

    def __getattr__(self, name):
        return getattr(self._other if name in SWAPPED else self._this, name)


def build_trees(trees):
    """{name: library} of each tree's csrc/wide.cu, the nvcc runs
    started together."""
    from opty_tpu_torch.ops import cuda_build as cb
    from opty_tpu_torch.ops.pcr_kernels import _WIDE_SIGNATURES
    procs = {}
    for name, tree in trees.items():
        out = os.path.join(tree, 'build', 'kernels')
        os.makedirs(out, exist_ok=True)
        lib = os.path.join(out, 'wide-{}.so'.format(name))
        src = os.path.join(tree, 'opty_tpu_torch', 'csrc', 'wide.cu')
        procs[name] = (lib, subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, '-o', lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            sys.exit('nvcc failed on {}\'s wide.cu:\n{}'.format(name, text))
        libs[name] = ctypes.CDLL(lib)
        for entry in SWAPPED:
            fn = getattr(libs[name], entry)
            fn.argtypes = _WIDE_SIGNATURES[entry]
            fn.restype = ctypes.c_int
    return libs


def ulps(a, b):
    """The largest distance in units in the last place between two
    float tensors' finite entries (their bit patterns as integers)."""
    import torch
    bits = torch.int64 if a.element_size() == 8 else torch.int32
    ok = torch.isfinite(a) & torch.isfinite(b)
    if not ok.any():
        return 0
    key = lambda t: torch.where(t.view(bits) < 0,
                                torch.iinfo(bits).min - t.view(bits),
                                t.view(bits)).to(torch.int64)
    return int((key(a) - key(b)).abs()[ok].max())


def main():
    import numpy as np
    import torch
    if len(sys.argv) < 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit('wide_tree_compare.py: needs a CUDA card')
    import chip_smoke as cs
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import cuda_build as cb
    from opty_tpu_torch.ops import pcr_kernels as pk
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print('device: {} torch={} cuda={}'.format(smi, torch.__version__,
                                              torch.version.cuda), flush=True)
    t0 = time.time()
    pk.build_kernels()
    this = cb.load('wide', pk._WIDE_SIGNATURES)
    others = build_trees({os.path.basename(os.path.normpath(tree)): tree
                          for tree in sys.argv[1:]})
    builds = {'this': this}
    builds.update({k: Mixed(this, v) for k, v in others.items()})
    print('builds: {:.1f} s'.format(time.time() - t0), flush=True)

    def use(which):
        cb._libs['wide'] = builds[which]

    def outputs(out):
        return out if isinstance(out, tuple) else (out,)

    for which in builds:
        use(which)
        print('division check, {} build: {}'.format(
            which, cs.division_check(gate=False)), flush=True)

    # the edge cases: outputs that differ from this tree's, bitwise
    edges = {}
    for which in builds:
        use(which)
        edges[which] = cs.pivot_edge_inverses(bk) + cs.pivot_edge_factors(pk)
    use('this')
    for which in builds:
        if which == 'this':
            continue
        differ = [(r['dtype'], r['n'], r['cls'])
                  for r, o in zip(edges['this'], edges[which])
                  if not all(cs.same_bits(x, y) for x, y in
                             zip(outputs(r['out']), outputs(o['out'])))]
        print('edge cases, {} build against this tree\'s: {} of {} differ '
              'bitwise {}'.format(which, len(differ), len(edges['this']),
                                  differ[:20]), flush=True)
    del edges

    prob, guess = cs.nlink_problem('cuda')
    trials = cs.capture_trials(prob, guess)
    for kind, inputs in trials.items():
        for i, args in enumerate(inputs):
            outs = {}
            for which in builds:
                use(which)
                outs[which] = outputs(pk.pcr_factor_levels(*args)
                                      if kind == 'factor'
                                      else bk.block_inv(*args))
            use('this')
            print('7a kept call {} {}: bitwise equal to this tree\'s: {}'
                  .format(kind, i, {w: all(cs.same_bits(x, y) for x, y in
                                           zip(outs['this'], o))
                                    for w, o in outs.items()}), flush=True)

    side_by_side(cs, pk, bk, builds, use, prob, guess)

    logs = {}
    for which in builds:
        use(which)
        t0 = time.time()
        x, rec, logs[which] = cs.fingerprinted_solve(
            prob, guess, cs.NLINK_OPTIONS['max_iter'])
        print('7a with the {} build\'s wide factor and inverse: status={} '
              'iterations={} obj={:.12g} ({} hooked calls, {:.1f} s)'.format(
                  which, rec['status'], rec['iterations'], rec['obj'],
                  len(logs[which]), time.time() - t0), flush=True)
        if which != 'this':
            first = cs.first_difference(logs['this'], logs[which])
            print('7a, this build against the {} build: {}'.format(
                which, 'every hooked call bitwise equal' if first is None
                else 'the first hooked call that differs: {} in iteration '
                '{} (call {} of the run)'.format(first[1], first[0],
                                                 first[2])), flush=True)
    use('this')


def side_by_side(cs, pk, bk, builds, use, prob, guess):
    """Phase 7a's first SIDE_ITERS iterations with this tree's kernels,
    each call of the wide factor and the border inverse repeated by the
    other builds; the first call where one differs is described."""
    import torch
    fac0, inv0 = pk.pcr_factor_levels, bk.block_inv
    state = {'call': 0, 'done': False}
    names = {'factor': ('A', 'B', 'Dinv', 'Fp', 'Z'), 'border': ('X',)}

    def compare(kind, fn, args):
        use('this')
        out = fn(*args)
        if state['done']:
            return out
        state['call'] += 1
        mine = out if isinstance(out, tuple) else (out,)
        differs = {}
        for which in builds:
            if which == 'this':
                continue
            use(which)
            theirs = fn(*args)
            theirs = theirs if isinstance(theirs, tuple) else (theirs,)
            if not all(cs.same_bits(x, y) for x, y in zip(mine, theirs)):
                differs[which] = theirs
        use('this')
        if differs:
            state['done'] = True
            describe(cs, pk, bk, builds, use, kind, state['call'], args,
                     mine, differs, names[kind])
        return out

    def factor(D, E, F):
        return compare('factor', fac0, (D, E, F))

    def border(A, out=None):
        return compare('border', inv0, (A,))

    pk.pcr_factor_levels, bk.block_inv = factor, border
    try:
        cs.nlink_solve(prob, guess, torch.float64, max_iter=SIDE_ITERS)
    finally:
        pk.pcr_factor_levels, bk.block_inv = fac0, inv0
        use('this')
    if not state['done']:
        print('side by side: {} calls in {} iterations, every build bitwise '
              'equal to this tree\'s'.format(state['call'], SIDE_ITERS),
              flush=True)


def describe(cs, pk, bk, builds, use, kind, call, args, mine, differs,
             names):
    import torch
    plain = pk.pcr_factor_levels_plain(*args) if kind == 'factor' \
        else (bk.block_inv_plain(*args),)
    print('side by side: the first {} call whose outputs differ between the '
          'builds is call {} of this run ({})'.format(
              kind, call, sorted(differs)), flush=True)
    err = lambda g, w: cs.kinds_and_error(g, w)[2]
    print('  against the plain version, largest error per output: this {}; '
          '{}'.format(
              ['{:.3e}'.format(err(g, w)) for g, w in zip(mine, plain)],
              '; '.join('{} {}'.format(k, ['{:.3e}'.format(err(g, w))
                                            for g, w in zip(v, plain)])
                        for k, v in differs.items())), flush=True)
    for which, theirs in differs.items():
        for name, x, y in zip(names, mine, theirs):
            if cs.same_bits(x, y):
                continue
            diff = (x != y) & ~(torch.isnan(x) & torch.isnan(y))
            where = diff.nonzero().tolist()
            print('  {} against this: {} differs in {} of {} entries, by up '
                  'to {} units in the last place; first indices {}'.format(
                      which, name, len(where), x.numel(), ulps(x, y),
                      where[:8]), flush=True)
    if kind == 'factor':
        D = args[0]
        n, N = D.shape[-3], D.shape[-1]
        blocks = D[0].permute(2, 0, 1).contiguous()        # (N, n, n)
        inv = {}
        for which in builds:
            use(which)
            inv[which] = cs.wide_inverse(blocks)
        use('this')
        for which in differs:
            nodes = [k for k in range(N)
                     if not cs.same_bits(inv['this'][k], inv[which][k])]
            print('  level-0 inverses (each node\'s D): {} against this '
                  'differ at nodes {}'.format(which, nodes), flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    torch.save({'kind': kind, 'args': [a.cpu() for a in args]},
               os.path.join(OUT_DIR, 'wide_first_difference.pt'))


if __name__ == '__main__':
    main()
