#!/usr/bin/env python3
"""The PCR downsweep kernels of this tree against another tree's, on one
card in one process.

    python3 scripts/sweep_compare.py OTHER_TREE

OTHER_TREE is an unpacked checkout of another commit (for example the
parent, by ``git archive`` into a directory under build/).  Its
csrc/wide.cu and csrc/pcr.cu are built by nvcc with this tree's flags
into OTHER_TREE/build/kernels/ and loaded by ctypes with the C entries
as they were before the wide downsweep took a plan of its own (the
narrow kernel's plan and eight int arguments).  Then:

* bits: the other tree's wide downsweep against this tree's
  ``pcr_downsweep_in_order`` and against this tree's kernel, at
  nlink-9's block (d = 50, N = 60) at 1, 8 and 32 lanes, at d = 1, 9
  and 64, an odd N and, in float64, the route gate's edge, float32 and
  float64: bitwise equal or not;
* times: the wide downsweep at nlink-9's block at 1, 8 and 32 lanes and
  the narrow downsweep at the pendulum's shapes (chip_smoke.py's
  PCR_SHAPES at d = 5), L2-warm and L2-cold as chip_smoke.py times
  them, in turns: other, this, this, other.

Prints one line a comparison, the card's name and power limit first.
Needs a CUDA card.
"""

import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)


def build_other(tree):
    from opty_tpu_torch.ops import cuda_build as cb
    out = os.path.join(tree, 'build', 'kernels')
    os.makedirs(out, exist_ok=True)
    procs = {}
    for stem in ('wide', 'pcr'):
        src = os.path.join(tree, 'opty_tpu_torch', 'csrc', stem + '.cu')
        lib = os.path.join(out, stem + '-other.so')
        procs[stem] = (lib, subprocess.Popen(
            [cb._nvcc(), *cb.NVCC_FLAGS, '-o', lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for stem, (lib, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            sys.exit('nvcc failed on the other tree\'s {}.cu:\n{}'.format(
                stem, text))
        libs[stem] = ctypes.CDLL(lib)
    return libs


def main():
    import numpy as np
    import torch
    if len(sys.argv) != 2:
        sys.exit(__doc__)
    if not torch.cuda.is_available():
        sys.exit('sweep_compare.py: needs a CUDA card')
    import chip_smoke as cs
    from opty_tpu_torch.ops import pcr_kernels as pk
    from opty_tpu_torch.ops.tridiag import num_levels
    pk.build_kernels()
    libs = build_other(sys.argv[1])
    VP, CI = ctypes.c_void_p, ctypes.c_int
    entries = {}
    for stem, name in (('wide', 'pcr_wide_downsweep'),
                       ('pcr', 'pcr_downsweep')):
        for sfx in ('f32', 'f64'):
            fn = getattr(libs[stem], '{}_{}'.format(name, sfx))
            fn.argtypes = [VP] * 4 + [CI] * 8 + [VP]
            fn.restype = CI
            entries[stem, sfx] = fn

    def other(A, B, r):
        nb, L, d, _, N = A.shape
        plan = pk.launch_plan('downsweep', nb, d, 0, N, r.dtype)
        out = torch.empty_like(r)
        stem = 'pcr' if d in pk.SUPPORTED_D else 'wide'
        sfx = 'f32' if r.dtype == torch.float32 else 'f64'
        err = entries[stem, sfx](
            A.data_ptr(), B.data_ptr(), r.data_ptr(), out.data_ptr(), nb, d,
            N, L, plan.cluster, plan.nodes_per_block, plan.threads,
            plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError('the other tree\'s downsweep: cudaError '
                               '{}'.format(err))
        return out

    def levels(B, d, N, dtype, seed=0):
        gen = torch.Generator(device='cuda').manual_seed(seed)
        draw = lambda *shape: torch.randn(*shape, generator=gen,
                                          device='cuda', dtype=dtype)
        L = num_levels(N)
        return draw(B, L, d, d, N) / d, draw(B, L, d, d, N) / d, \
            draw(B, d, N)

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print('card: {}'.format(smi), flush=True)
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        cases = [(50, 60, 1), (50, 60, 8), (50, 60, 32), (1, 60, 1),
                 (9, 60, 1), (64, 60, 1), (50, 37, 1)]
        if dtype == torch.float64:
            cases.append((50, 4640, 1))
        for d, N, B in cases:
            A, Bm, r = levels(B, d, N, dtype, seed=d + N + B)
            theirs = other(A, Bm, r)
            want = pk.pcr_downsweep_in_order(A, Bm, r)
            mine = pk.pcr_downsweep(A, Bm, r)
            verdict = lambda a, b: 'equals' if cs.same_bits(a, b) \
                else 'DIFFERS FROM'
            print('bits {} d={} N={} B={}: the other tree\'s kernel {} '
                  'pcr_downsweep_in_order, this tree\'s {} the other\'s'
                  .format(tag, d, N, B, verdict(theirs, want),
                          verdict(mine, theirs)), flush=True)
            del A, Bm, r, theirs, want, mine
    flush = torch.ones(cs.FLUSH_BYTES // 4, dtype=torch.float32,
                       device='cuda')
    flush.sum()                  # loads the reduction before any timing
    torch.cuda.synchronize()

    def turns(label, A, B, r):
        times = []
        for name, fn in (('other', lambda: other(A, B, r)),
                         ('this', lambda: pk.pcr_downsweep(A, B, r)),
                         ('this', lambda: pk.pcr_downsweep(A, B, r)),
                         ('other', lambda: other(A, B, r))):
            times.append((name, cs.device_ms(fn, reps=20,
                                             sleep_cycles=cs.WIDE_SLEEP)[0],
                          cs.cold_ms(fn, flush, reps=10,
                                     sleep_cycles=cs.WIDE_SLEEP)))
        mean = lambda who, k: np.mean([t[k] for t in times if t[0] == who])
        print('time {}: {}; mean warm other {:.5f} this {:.5f} ({:+.1f} %), '
              'cold other {:.5f} this {:.5f} ({:+.1f} %)'.format(
                  label, ' '.join('{} {:.5f}/{:.5f}'.format(*t)
                                  for t in times),
                  mean('other', 1), mean('this', 1),
                  100 * (mean('this', 1) / mean('other', 1) - 1),
                  mean('other', 2), mean('this', 2),
                  100 * (mean('this', 2) / mean('other', 2) - 1)),
              flush=True)

    for B in (1, 8, 32):
        for dtype in (torch.float32, torch.float64):
            plan = pk.launch_plan('wide_downsweep', B, 50, 0, 60, dtype)
            turns('wide {} B={} d=50 N=60 (cluster {}, {} stages); ms '
                  'warm/cold'.format(str(dtype).split('.')[-1], B,
                                     plan.cluster, plan.stages),
                  *levels(B, 50, 60, dtype))
    for B, N in cs.PCR_SHAPES:
        for dtype in (torch.float32, torch.float64):
            Dm, E, F, r = cs.random_system(dtype, B, N)
            A, Bm = pk.pcr_factor_levels(Dm, E, F)[:2]
            turns('narrow {} B={} d=5 N={}; ms warm/cold'.format(
                str(dtype).split('.')[-1], B, N), A, Bm, r)


if __name__ == '__main__':
    main()
