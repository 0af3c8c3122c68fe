#!/usr/bin/env python3
"""Drive opty_tpu_torch's paths on one CUDA card and hold its kernels
against their plain PyTorch versions.

    python3 chip_smoke.py
    python3 chip_smoke.py --gallery-process OUT.json   # 9a-9c and 10
    python3 chip_smoke.py --spike-phase                # 10 alone

Phases, each reported on its own line(s) with its wall time:

1. device: the card's name, the device count, its power limit;
2. build: compile csrc/*.cu (one nvcc per source, in parallel), print
   what ptxas reports (registers, shared memory, spills) and count the
   FP64 tensor-core instructions (DMMA) of the wide kernels in their
   SASS (cuobjdump);
3. kernels: each CUDA kernel against its plain version on the card,
   float32 and float64, timed with CUDA events: the PCR kernels at the
   main path's shapes (B = 32, d = 5, b = 4, N = 501), at B = 8 and 128,
   at N = 101 and at one instance of N = 4,000 (the factor's state in
   its global scratch), each with its launch plan (grid, cluster,
   shared memory), L2-warm and L2-cold, and the host's time to make a
   call; the scan factorization and solve kernels at B = 32, 8 and 128
   lanes (N = 501) and at B = 32, N = 101, L2-warm and L2-cold, with
   their time per node; an empty kernel's launch; the block inverse and
   product at 8 and 32 matrices (d = 5), at a whole node axis
   (16,032) and at the border's d = 4, beside torch.linalg.inv_ex and
   torch.bmm as yardsticks;
3w. wide kernels: the wide variants (csrc/wide.cu) of the PCR factor
   and downsweep at the nlink-9 chain's block (d = 50, b = 41, N = 60)
   and of the block inverse at b = 1, 41 and 64, each at 1, 8 and 32
   lanes, float32 and float64, against their plain versions within
   stated tolerances, and the float64 wide solve against the dense
   system, timed L2-warm and L2-cold beside their bounds (the inverse
   beside torch.linalg.inv_ex); the downsweep also bitwise equal to
   pcr_downsweep_in_order in both of its branches, there and at
   WIDE_SWEEP_SHAPES, the gate's edge and a lane with a NaN, each call
   printed with its plan (cluster, stages, shared memory, threads) and
   beside its zero-stage branch's time;
3w (identification shapes). the wide factor and downsweep and the
   border inverse at the blocks of phases 8a and 8b (IDENT_SHAPES: d = 8,
   b = 4, N = 501 and d = 4, b = 1, N = 5,000) at one lane, float32 and
   float64, against their plain versions (the downsweep bitwise equal to
   pcr_downsweep_in_order), timed L2-warm and L2-cold beside their
   bounds, the downsweep with its plan;
3w (gallery shapes). the same at the gallery's blocks (GALLERY_SHAPES:
   the widest block, the widest border, the longest identification
   chain, and the register kernels of csrc/pcr.cu at d = 3, whose
   factor is held bitwise to its plain version and downsweep to
   TOL_REL);
3ws. wide scan kernels: the scan factor and solve of csrc/scan_wide.cu
   at (d, b) = (50, 41), (9, 0) and (64, the widest border that fits),
   1, 8 and 32 lanes, N = 60, float32 and float64, against their plain
   versions, timed L2-warm and L2-cold beside their bounds, each with
   the thread block cluster size the wrappers chose; at (50, 41) every
   cluster size each kernel is built for, checked and timed L2-cold;
4. reference: a small solve (N = 101, float64 factorization, monotone
   mu, no second-order correction) on the card against the same solve
   on the CPU (the plain versions, in the child processes of 4c, which
   solve it first), once with kkt_method='cr' (4) and once with 'scan'
   (4b, through the scan kernels, by their counters);
4c. restoration: N = 101 swing-up solves with the library's default
   options (adaptive mu, second-order correction, restoration) from
   starts that enter restoration (REST_SEEDS), float64 factorization,
   kkt_method='cr' and 'scan', on the card against the CPU (the CPU
   solves run in two child processes started at the beginning); the
   kernels' launches inside the restoration visits are counted apart;
5. main path: the pendulum swing-up at N = 501 through
   ``swing_up_problem`` -> ``set_solver_options`` -> ``solve_queue``,
   64 instances on 32 refilled lanes, kkt_method='cr', monotone mu, no
   second-order correction, launch counters reset just before and read
   just after;
5b. scan path: the same queue, the same way, with kkt_method='scan', a
   float64 factorization and 1 refinement round; counters reset just
   before and read just after; its wall beside phase 5's;
5c. default path: the same queue with only ``max_iter`` and
   ``chunk_iters`` set, so the card's defaults (kkt_method='cr',
   float32 factor + 6 rounds) and the library's (adaptive mu,
   second-order correction, restoration); counters reset just before
   and read just after; held to the JAX package's mean iterations on
   the same rows (JAX_DEFAULT_MEAN);
6. profile: a few iterations of each path at 32 lanes, once counting
   host syncs and once under torch.profiler (device busy time, kernel
   launches, the per-launch time of each hand-written kernel); the
   nlink-9 chain at N = 60 on 8 lanes for 2 iterations, with the cr
   path's float32 factor and with the scan path's float64 factor;
7a. nlink: the nlink-9 chain at N = 60 through ``n_link_cart_problem``
   -> ``n_link_initial_guess`` -> ``Problem.solve`` with the options of
   benchmarks/gait_scale.py --small-program, kkt_method='cr', a float64
   factorization: it must converge; it is compared with the port's
   recorded CPU run of the same solve (NLINK_CPU), and one iteration
   from its state at a few iteration counts, taken by the card and by
   the CPU (in a child process started at the beginning, while the
   card's solve goes on), must agree to NLINK_STEP_TOL; counters reset
   just before and read just after, the wide kernels required; after
   it, the wide
   downsweep's launches an iteration and its device time a call in the
   solve (its first iterations again under torch.profiler), their
   product its device time an iteration;
7d. reproducibility: 7a's solve for REPRO_ITERS iterations twice in one
   process from the same start, every step fingerprinted: whether the
   iterates are bitwise equal and, where not, the first iteration and
   step that differ (printed, not gated);
7f. pivot edges: the wide inverse and factor (csrc/wide.cuh's pivot
   step) against their plain versions on inputs at the pivot step's
   edges (PIVOT_SIZES; ties, zero columns, singular, subnormal and
   non-finite blocks) and on the factorizations of 7a's first
   PIVOT_TRIAL_ITERS iterations, each entry's kind (finite, NaN, +inf,
   -inf) and the finite entries' error compared;
7c. the same solve with kkt_method='scan' and a float64 factorization
   (the JAX package's own gait-scale configuration) through the wide
   scan kernels: it must converge, no PCR kernel may launch, and one
   iteration from its state at iterations 20, 100, 300 and 800, card
   against CPU, must agree to NLINK_STEP_TOL, at iteration 1 (where
   round-off in the factorization is amplified ~1e9-fold) to
   NLINK_SCAN_STEP_TOL; printed beside the JAX package's run
   (JAX_GAIT_CPU);
7b. the cr solve with the card's default factorization (float32 + 6
   float64 refinement rounds) for NLINK_DEFAULT_MAX_ITER iterations of
   its stall, printed beside the JAX package's stall;
8a. identification: the JAX package's examples/inverted_pendulum_id.py
   ported (opty_tpu_torch/examples/), 1 link, N = 501, through its
   builder and ``Problem.solve`` with the card's default options: status
   0 or 1, the identified gains within IDENT_REL of the JAX package's
   recorded CPU run (JAX_PENDULUM_ID), the gain error under
   GAIN_ERROR_LIMIT, the cr kernels at its block launched; counters
   reset just before and read just after;
8b. the same for examples/vyasarayani2011.py at N = 5,000
   (JAX_VYASARAYANI);
8a and 8b run right after 7a; 9a-9c and 10 run in a second process on
the card (``--gallery-process``), started after 8b and beside 7d, 7f,
7c and 7b, whose gates are numerical and which report no device time;
its output is printed after 7b.
9a. gallery: each of the JAX package's 25 gallery problems ported
   (opty_tpu_torch/examples/gallery/) built on the card at its own
   defaults, its (d, b, N) and ``kernel_supported`` printed (failing
   where refused), one IPM iteration from its documented start with the
   card's defaults (the cr kernels must launch), then one iteration
   from that state with a float64 factorization, card against CPU (a
   step server started at the beginning builds the problems on the CPU
   and takes the CPU's steps), to NLINK_STEP_TOL (GALLERY_STEP_TOL
   where a problem has its own);
9b. the cold-solve set (gallery.COLD_SET) solved from the documented
   starts with the cold configuration, kkt_method='cr' and a float64
   factorization: status 0 or 1, constraints within GALLERY_VIOLATION,
   objectives within GALLERY_OBJ_TOL of the JAX package's recorded CPU
   runs (JAX_GALLERY), iterations printed beside; the same solves with
   the card's default factorization printed, not gated; betts_10_47's
   three phases, gated on phases 1 and 3; particle_in_tube (ROADMAP.md
   §3, fault 3) printed, not gated;
9c. the JAX package's examples/pendulum_swing_up.py ported: its default
   run at N = 501 (status 0, the objective within SWING_UP_OBJ_TOL of
   JAX_SWING_UP) and ``--batch 4 --nodes 301``;
10. spike (parallel/spike.py, the node axis split into slabs on the one
   card): the local factorization's kernels (scan_factor with the spike
   columns as its border, scan_solve with none) against the plain
   ``_local_factor`` / ``_local_solve`` at 10c's slabs; 10a
   ``spike_solve`` on SPIKE_SLABS slabs of a random symmetric system at
   the main path's blocks and N = SPIKE_NODES against the card's scan
   solve of it, float64 and float32 (SPIKE_TOL), its scan_factor
   launch's device time beside; 10b ``spike_factor`` + ``spike_apply``
   against ``spike_solve``; 10c bench.py's queue row 0 at N = 501 solved
   with kkt_method='spike' on SPIKE_PATH_SLABS slabs, a float64 factor
   and monotone mu, against the same row's scan solve: the same status,
   iterations within SPIKE_ITER_SLACK, the objective within
   SPIKE_OBJ_TOL; counters reset just before and read just after, the
   spike kernels (SPIKE_KERNELS) required and no PCR kernel.

The line before last holds the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.  Any failure exits non-zero without
that line.  Needs a CUDA card; imports no JAX and nothing of opty_tpu.
"""

import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# main-path shapes of the KKT factorization (pendulum, bench queue)
BATCH, D, B_BORDER, NODES = 32, 5, 4, 501
# the block kernels' shapes (d, batch): 8 and 32 matrices, a whole node
# axis of the main path, the border's d = 4 (the cr path's call)
BLOCK_SHAPES = ((D, 8), (D, BATCH), (D, BATCH * NODES), (B_BORDER, BATCH))
# the scan kernels' shapes (lanes, N): the scan path's first
SCAN_SHAPES = ((BATCH, NODES), (8, NODES), (128, NODES), (BATCH, 101))
# the PCR kernels' shapes (batch, N) at d = 5, b = 4: the main path's
# first, then fewer and more lanes, the reference solve's N, and an
# instance beyond a cluster's shared memory
PCR_SHAPES = ((BATCH, NODES), (8, NODES), (128, NODES), (BATCH, 101),
              (1, 4000))
# read between L2-cold calls: five times the H100's 50 MB L2
FLUSH_BYTES = 256 * 2 ** 20
# peak rates (NVIDIA data sheets): device memory bytes/s and FLOP/s of
# float32 outside the tensor cores, which is also the FP64 tensor cores'
# rate (DMMA), by card variant
PEAKS = {'H100 PCIe': (2.0e12, 51e12), 'H100 NVL': (3.9e12, 60e12),
         'H100': (3.35e12, 67e12), 'H200': (4.8e12, 67e12)}
# stated tolerances, kernel against plain version on the same inputs:
# float64 runs the same operation order (nvcc -fmad=false), so only the
# order of torch's small reductions differs; float32 PCR amplifies
# roundoff through the levels (tests/test_pallas_pcr.py uses 1e-5 on
# level 0 and 5e-2 on the final state for two float32 versions)
TOL_REL = {'float64': 1e-9, 'float32': 5e-2}
TOL_LEVEL0_F32 = 1e-5
# the block kernels run their plain versions' operations in the same
# order: 0 expected on finite inputs, these bounds absorb any order
# difference
TOL_BLOCK = {'float64': 1e-12, 'float32': 1e-5}
# the scan kernels against their plain versions, max |diff| / max |ref|
# per output: the kernel inverts by Gauss-Jordan, the plain version by
# elimination and back substitution, and the plain solve's products go
# through cuBLAS, so the two agree to round-off amplified by the
# systems' condition (scan_system keeps it small)
TOL_SCAN = {'float64': 1e-11, 'float32': 1e-4}
# phase 4c: default_rng(seed) starts of the N = 101 swing-up (torque
# bound 20) whose JAX-package solves with the default options enter
# restoration and converge with kkt_method='cr' and 'scan' alike, and
# the port's CPU solves from them equal the JAX package's
# (tests/test_torch_solver_default.py); card against CPU: the same
# status, iterations within REST_ITER_SLACK, restoration on both,
# objectives within REST_OBJ_TOL relative
REST_SEEDS = (14, 57)
REST_ITER_SLACK = 2
REST_OBJ_TOL = 1e-6
# phase 5c's limit: the JAX package's mean iterations on the same 64
# rows, 32 lanes, kkt_method='cr', float32 factor, default options
# (scripts/jax_default_queue.py, JAX on the CPU), times 1.25
JAX_DEFAULT_MEAN = 38.40625
DEFAULT_MEAN_FACTOR = 1.25
# phase 3w: the wide variants (csrc/wide.cu) at the nlink-9 chain's KKT
# block, d = 50, b = 41, N = 60 (models/nlink.py), at B lanes
WIDE_D, WIDE_B, WIDE_NODES = 50, 41, 60
WIDE_BATCHES = (1, 8, 32)
WIDE_BORDERS = (1, 41, 64)
WIDE_SLEEP = 5 * 10 ** 8          # cycles of the sleep kernel, ~250 ms
# the wide factor and inverse against their plain versions, max |diff| /
# max |ref| per output: they sum in another order (FP64 tensor cores,
# fused multiply-adds, the inverse's elimination and back substitution
# blocked in panels), so round-off apart, no longer bitwise; the wide
# downsweep sums each row in order where the plain version's matvec_nl
# lets torch reduce in its own
TOL_WIDE = {'float64': 1e-11, 'float32': 1e-4}
TOL_WIDE_SWEEP = {'float64': 1e-11, 'float32': 1e-4}
# the wide downsweep is held bitwise to pcr_downsweep_in_order (its sums
# in the kernel's order, in torch) at nlink-9's block and at these
# (d, N, B) besides: the smallest and largest blocks, an odd N, and the
# route gate's edge (WIDE_SWEEP_EDGE, by dtype), where the plan takes
# zero stages
WIDE_SWEEP_SHAPES = ((1, 60, 1), (9, 60, 1), (64, 60, 1), (50, 37, 1))
WIDE_SWEEP_EDGE = {'float32': (50, 9296, 1), 'float64': (50, 4640, 1)}
# the float64 factor + downsweep + border solve (ops/tridiag.py) against
# torch.linalg.solve of the dense bordered system, relative
TOL_WIDE_RESIDUAL = 1e-10
# phase 3ws: the wide scan kernels (csrc/scan_wide.cu) at nlink-9's
# block, at d = 9 without a border (the smallest wide block), and at
# d = 64 with the widest border its shared memory takes in the dtype
WIDE_SCAN_BLOCKS = ((50, 41), (9, 0), (64, None))
# phases 8a and 8b: the JAX package's two identification examples at
# their own default sizes through the port's builders
# (opty_tpu_torch/examples/) and ``Problem.solve`` with the card's
# default options; their KKT blocks, (d, b, N): the 1-link pendulum's 4
# states and 4 unknown gains at N = 501, vyasarayani2011's 2 states and
# 1 parameter at N = 5,000 (midpoint)
IDENT_SHAPES = {'8a': (8, 4, 501), '8b': (4, 1, 5000)}
# the JAX package's runs of the same problems on the CPU with its CPU
# defaults (kkt_method='scan', float64 factor):
# JAX_PLATFORMS=cpu python3 scripts/reference_identification.py; the
# identified values are gated to IDENT_REL relative, iterations printed
# beside the card's
JAX_PENDULUM_ID = dict(status=0, iterations=4, obj=0.0026204977797186753,
                       identified=[-0.9920993137591028, 50.751176002455594,
                                   -2.680179415285389, 12.602633847686933],
                       solve_s=20.36)
JAX_VYASARAYANI = dict(status=0, iterations=5, obj=0.1246571219558233,
                       identified=[9.99852434191126], solve_s=17.65)
IDENT_REL = 1e-5
# the JAX package's own bound on the gain error of this example
# (tests/test_inverted_pendulum_id.py)
GAIN_ERROR_LIMIT = 1.0
# the status an identification solve may end with, and the raw
# constraint violation it may leave (as NLINK_VIOLATION)
IDENT_VIOLATION = {0: 1e-6, 1: 1e-5}
# phase 7: the nlink-9 chain at N = 60 solved with the options of
# benchmarks/gait_scale.py --small-program, kkt_method='cr'.  7a, with a
# float64 factorization, must converge, and is compared with the port's
# CPU run of the same solve (the plain versions: ``python3 chip_smoke.py
# --cpu-reference nlink``, 2,900 s on this repository's sandbox CPU, so
# recorded here rather than run beside the card): the same status,
# iterations within NLINK_ITER_SLACK, objectives within NLINK_OBJ_TOL
# relative, printed met or not.  The two end apart: every iteration
# agrees to round-off from a shared state, but along this path a
# difference grows until the solves settle in different local minima
# (PERF.md §6; the JAX package's own cr and scan runs end apart too).
# So the phase fails where one iteration from the card's state at the
# iteration counts NLINK_CROSSOVERS, taken by the card and by the CPU,
# differs by more than NLINK_STEP_TOL relative.
NLINK_LINKS, NLINK_NODES = 9, 60
NLINK_OPTIONS = dict(max_iter=1500, mu_init=1e-5, use_soc=False,
                     max_rest_visit=0, dw_decay='hold')
NLINK_CPU = dict(status=0, iterations=321, obj=1.4428157973956592,
                 inf_pr=5.073824049383369e-13, wall_s=2899.6, threads=4)
NLINK_ITER_SLACK = 2
NLINK_OBJ_TOL = 1e-6
NLINK_CROSSOVERS = (1, 20, 100, 300)
NLINK_STEP_TOL = 1e-8
# the JAX package's own run of the same solve on the CPU (its default
# kkt_method='scan' with a float64 factorization):
# JAX_PLATFORMS=cpu python benchmarks/gait_scale.py --small-program, a
# CPU run of this repository's sandbox, printed beside phase 7
JAX_GAIT_CPU = dict(status=0, iterations=245, obj=1.8000567542274934,
                    warm_solve_s=109.82, first_solve_s=299.1)
# 7c: that configuration on the card, kkt_method='scan' with a float64
# factorization through the wide scan kernels; printed beside
# JAX_GAIT_CPU, not gated (the path amplifies round-off into different
# minima); one iteration from the card's state at these counts, card
# against the port's CPU plain versions, must agree to NLINK_STEP_TOL,
# except at iteration 1: there the scan step amplifies round-off in the
# factorization ~1e9-fold, so that the port's own CPU plain versions
# move by 2.55e-7 when only their block products are summed through
# BLAS instead of in order, and by 5.5e-8 with a Gauss-Jordan inverse
# (scripts/nlink_scan_sensitivity.py scan; cr at the same state: 1.0e-12);
# a kernel summing in another order is held there to about four times
# that sensitivity; 300 and 800 lie in the solve's long tail, where the
# Schur complements come nearest to singular
NLINK_SCAN_CROSSOVERS = (1, 20, 100, 300, 800)
NLINK_SCAN_STEP_TOL = {1: 1e-6}
# the largest raw constraint violation (Problem.constraints) that a
# phase-7 solve may leave: 1e-6 at status 0; at status 1 (the solver's
# acceptable level, judged in its own scaling) 1e-5, where 7c's
# status-1 end on an H100 reads 2.9e-6 (PERF.md §6)
NLINK_VIOLATION = {0: 1e-6, 1: 1e-5}
# 7b: the card's default factorization (float32 + 6 float64 rounds)
# stalls on this solve, its objective stuck near 38,582 from iteration
# 30 on, as the JAX package's cr float32 run on the CPU stalls
# (scripts/reference_nlink_solve.py cr float32: status -1 after 1,500
# iterations, objective 38,575.39); its first 60 iterations show the
# stall (30 to 60 at one objective)
NLINK_DEFAULT_MAX_ITER = 60
JAX_CR_F32_STALL = dict(status=-1, iterations=1500, obj=38575.39)
# phase 3w (gallery shapes): the gallery's KKT blocks (d, b, N) that
# stretch the kernels most (d = states + unknown inputs + EoM rows, b =
# unknown parameters + a variable node interval + instance
# constraints): the widest block (car_on_racecourse), the widest border
# (drone), the longest chain at an identification block (park2004) and
# the register kernels' d = 3 at the longest chain (betts_10_7)
GALLERY_SHAPES = {'car_on_racecourse': (33, 11, 601), 'drone': (32, 32, 301),
                  'park2004': (8, 8, 4000), 'betts_10_7': (3, 2, 2001)}
# the CPU's one-iteration steps from the card's states (7a's and 7c's
# crossovers, 9a): torch threads of each step server (``step_server``;
# 8 cores on the card's machine)
STEP_THREADS = 2
# phase 9a: one iteration from a shared state, card against CPU, is held
# to NLINK_STEP_TOL, but for a step that amplifies round-off by itself,
# held to GALLERY_STEP_TOL: double_pendulum_cart's second step (the
# card's differs from the CPU's by 8.010e-08 in two recorded runs on the
# H100, PERF.md §6; from that state the CPU's own scan and cr steps
# differ by 2.964e-08), to four times the CPU's own move, as 7c's first
# step (NLINK_SCAN_STEP_TOL)
GALLERY_STEP_TOL = {'double_pendulum_cart': 1.2e-7}
# phase 9b: a cold solve must end at status 0 or 1 with its constraints
# within GALLERY_VIOLATION of [cl, cu] and its objective no more than
# GALLERY_OBJ_TOL * max(1, |objective|) above the JAX package's run of
# the same problem from the same guess on the CPU: JAX_GALLERY (the
# cold configuration, kkt_method='cr', a float64 factorization) and,
# printed beside the card's default factorization, JAX_GALLERY_F32
# (float32): JAX_PLATFORMS=cpu python3 scripts/reference_gallery.py
# [--factor float32], run on 2026-10-18 on an 8-core x86 CPU;
# betts_10_47: its three phases (phase 3 from phase 2's end state).
# The cold-solve set (opty_tpu_torch/examples/gallery: COLD_SET) is the
# problems that converge there within 100 iterations: not betts2003
# (status -1 after 1,000) nor crane_load (113 iterations)
GALLERY_VIOLATION = 1e-6
GALLERY_OBJ_TOL = 1e-6
# particle_in_tube (ROADMAP.md §3, port fault 3): its documented start
# puts the particle on the tube's centreline, where the distance row has
# no derivative; there the card's EoM Jacobian differs from the CPU's by
# up to 1.98 at 119 of 500 nodes, so the card's first iteration differs
# from the CPU's by 0.10 relative, while the card's cr and scan first
# iterations agree to 1.8e-15 (scripts/gallery_crossover.py on the
# H100).  The card's cr and scan paths' objectives agree to 1e-8 for 16
# iterations, then part; the scan path converges in 93, the cr path ends
# at status -1 (objective 54,892.58, where it settles by iteration 75,
# after reaching 39,069.749 at iteration 52).  From the card's states
# at 50-86 the CPU's steps equal the card's to round-off (ROADMAP.md §3,
# "Reference-side behaviour"), so the criterion stays unmet and its cold
# solve runs for GALLERY_UNGATED_MAX_ITER iterations, printed, not
# gated; 9a holds its step, card against CPU, from the card's state
GALLERY_UNGATED = ('particle_in_tube',)
GALLERY_UNGATED_MAX_ITER = 120
JAX_GALLERY = {
    'betts2003': dict(status=-1, iterations=1000,
                      obj=0.0031944420584169085),
    'non_contiguous_id': dict(status=0, iterations=5, obj=305.1586167161242),
    'park2004': dict(status=0, iterations=10, obj=0.04486567897508234),
    'betts_10_50': dict(status=0, iterations=16, obj=3.1072807122782202),
    'path_constraints': dict(status=0, iterations=27,
                             obj=0.4792382265435349),
    'betts_10_103_104': dict(status=0, iterations=30,
                             obj=12.043401729630864),
    'betts_10_7': dict(status=0, iterations=40, obj=6.777634180269945),
    'particle_in_tube': dict(status=0, iterations=95,
                             obj=39069.74862636591),
    'crane_load': dict(status=0, iterations=113, obj=0.039559979434395445),
    'countersteer': dict(status=0, iterations=86, obj=0.006566607807183354),
    'sliding_block': dict(status=0, iterations=88, obj=0.026518674160190433),
    'betts_10_47': dict(status=[0, 0, 0], iterations=[7, 120, 16],
                        obj=[-625.7078217388945, -924.4570754931646,
                             1.901789232492869e-09]),
}
JAX_GALLERY_F32 = {
    'non_contiguous_id': dict(status=0, iterations=5, obj=305.1586167161242),
    'park2004': dict(status=0, iterations=30, obj=0.04486567897508267),
    'betts_10_50': dict(status=0, iterations=16, obj=3.107280712278221),
    'path_constraints': dict(status=0, iterations=27,
                             obj=0.4792382270651139),
    'betts_10_103_104': dict(status=0, iterations=25,
                             obj=12.043401729847922),
    'betts_10_7': dict(status=0, iterations=40, obj=6.777634180269944),
    'particle_in_tube': dict(status=-1, iterations=2000,
                             obj=39069.748650356254),
    'countersteer': dict(status=0, iterations=202,
                         obj=0.006565357350978718),
    'sliding_block': dict(status=0, iterations=99,
                          obj=0.026518674160190433),
}
# phase 9c: examples/pendulum_swing_up.py's runs on the CPU with the JAX
# package's CPU defaults (the same script): N = 501, then --batch 4
# --nodes 301; the card's N = 501 objective is gated to SWING_UP_OBJ_TOL
# relative
JAX_SWING_UP = dict(status=0, iterations=38, obj=15.64155366296566)
JAX_SWING_UP_BATCH = dict(status=[0, 0, 0, 0], iterations=[44, 50, 46, 43])
SWING_UP_OBJ_TOL = 1e-6
# phase 10: SPIKE on the card (parallel/spike.py): 10a spike_solve of a
# random system at the main path's blocks (d = 5, b = 4) and N = 65,536
# on SPIKE_SLABS slabs against the card's scan solve of the same system
# (relative difference within SPIKE_TOL), 10b spike_factor + spike_apply
# against spike_solve, 10c the swing-up at N = 501 with kkt_method=
# 'spike' on SPIKE_PATH_SLABS slabs against the scan solve of the same
# queue row (the same status, iterations within SPIKE_ITER_SLACK, the
# objective within SPIKE_OBJ_TOL relative)
SPIKE_SLABS = 8
SPIKE_NODES = 65536
SPIKE_TOL = {'float64': 1e-10, 'float32': 1e-4}
SPIKE_PATH_SLABS = 4
SPIKE_ITER_SLACK = 2
SPIKE_OBJ_TOL = 1e-6
SPIKE_KERNELS = ('scan_factor_wide', 'scan_solve')


def log(*args):
    print(*args, flush=True)


def fail(msg):
    print('FAILED: ' + msg, file=sys.stderr, flush=True)
    sys.exit(1)


def peaks(name):
    for key, val in PEAKS.items():
        if key in name:
            return key, val
    return 'H100', PEAKS['H100']


def timed(fn, reps, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps=50, sleep_cycles=10 ** 8):
    """(device ms, host ms) per call of ``fn``.  The calls are queued
    behind a sleep kernel (about 50 ms at the H100's clocks), so the
    events around them time the device running them back to back and
    none of the host's time to make them, which bounds a loop of
    microsecond kernels, and the host's clock times the calls alone;
    the function fails if the host did not stay ahead."""
    import torch
    fn()
    torch.cuda.synchronize()
    slept, start, stop = (torch.cuda.Event(enable_timing=True)
                          for _ in range(3))
    slept.record()
    torch.cuda._sleep(sleep_cycles)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    stop.record()
    torch.cuda.synchronize()
    if host_ms >= slept.elapsed_time(start):
        fail('device timing: the host took {:.2f} ms to queue the calls, '
             'the sleep only {:.2f} ms'.format(
                 host_ms, slept.elapsed_time(start)))
    return start.elapsed_time(stop) / reps, host_ms / reps


def cold_ms(fn, flush, reps=20, sleep_cycles=10 ** 8):
    """Device time of one call of ``fn`` with the L2 cache cold (median
    of ``reps``).  Before each call a reduction reads ``flush``, five
    times the H100's 50 MB L2, so the call finds none of its inputs
    there; a read leaves clean lines, where a write would leave up to
    50 MB of dirty ones for the timed call to write back.  Each call
    has its own pair of events, so the flush is not counted; all are
    queued behind a sleep kernel, as in ``device_ms``, so the device
    never waits for the host between a start event and its call."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    slept = torch.cuda.Event(enable_timing=True)
    slept.record()
    torch.cuda._sleep(sleep_cycles)
    t0 = time.perf_counter()
    for start, stop in pairs:
        flush.sum()
        start.record()
        fn()
        stop.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    if host_ms >= slept.elapsed_time(pairs[0][0]):
        fail('cold timing: the host took {:.2f} ms to queue the calls, the '
             'sleep only {:.2f} ms'.format(
                 host_ms, slept.elapsed_time(pairs[0][0])))
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def random_system(dtype, batch=BATCH, nodes=NODES, seed=0):
    """Inputs made like tests/test_pallas_pcr.py's."""
    import torch
    rng = np.random.default_rng(seed)
    Dm = rng.standard_normal((batch, D, D, nodes)) \
        + 4.0 * np.eye(D)[:, :, None]
    E = rng.standard_normal((batch, D, D, nodes))
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((batch, D, B_BORDER, nodes))
    r = rng.standard_normal((batch, D, nodes))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    return to(Dm), to(E), to(F), to(r)


def rel_err(got, want):
    import torch
    err = torch.max(torch.abs(got.double() - want.double())).item()
    scale = max(torch.max(torch.abs(want.double())).item(), 1e-300)
    return err, err / scale


def inv_flops(d):
    """FLOPs a d x d pivoted inverse needs, done in place (Gauss-Jordan,
    the least of the pivoted methods' counts, 2 d^3 - d^2 + d):
    at each of d pivots one reciprocal, d products for the pivot row and
    a multiply and an add for each of the d entries of the other d - 1
    rows (the pivot search and swaps counted as none)."""
    return d * (1 + d + 2 * d * (d - 1))


def flop_counts(d, b, N, L, batch):
    """FLOPs the two PCR functions need on these shapes: a level's
    inverse, A and B, the D and F updates, and Lb' and Ub' except at
    the last level (nothing reads them there); then the final inverse
    and Z = Dinv^T F."""
    inv = inv_flops(d)
    mm = d * d * (2 * d - 1)
    level = inv + 4 * mm + 2 * d * d + 2 * d * b * (2 * d - 1) + 2 * d * b
    factor = batch * N * (L * level + (L - 1) * 2 * mm + inv
                          + d * b * (2 * d - 1))
    sweep = batch * N * L * (2 * d * (2 * d - 1) + 2 * d)
    return factor, sweep


def pcr_bytes(es, batch, N, L, d=D, b=B_BORDER):
    """Bytes the PCR kernels must move: each input read once, each
    output written once (factor: D, E, F in, A, B, Dinv, Fp, Z out;
    downsweep: A, B, r in, r out)."""
    n_dd = batch * d * d * N
    n_db = batch * d * b * N
    return (es * (2 * n_dd + n_db + 2 * L * n_dd + n_dd + 2 * n_db),
            es * (2 * L * n_dd + 2 * batch * d * N))


def check_pcr_shape(pk, name, dtype, batch, nodes, flush, plain):
    """Both PCR kernels at one shape: the factor bitwise equal to its
    plain version, the downsweep within TOL_REL; timed L2-warm
    (``device_ms``, back to back on the same inputs), L2-cold
    (``cold_ms``) and as calls in a host loop (``timed``); the plain
    versions timed where ``plain``."""
    import torch
    from opty_tpu_torch.ops.tridiag import num_levels
    tag = str(dtype).split('.')[-1]
    L = num_levels(nodes)
    Dm, E, F, r = random_system(dtype, batch, nodes)
    got = pk.pcr_factor_levels(Dm, E, F)
    want = pk.pcr_factor_levels_plain(Dm, E, F)
    torch.cuda.synchronize()
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    ferr = max(e[1] for e in errs)
    fabs = max(e[0] for e in errs)
    where = '{} B={} N={}'.format(tag, batch, nodes)
    if not all(torch.isfinite(g).all().item() for g in got):
        fail('pcr_factor_levels {}: non-finite output'.format(where))
    if fabs != 0.0:
        fail('pcr_factor_levels {}: not bitwise equal to its plain version '
             '(max abs err {:.3e})'.format(where, fabs))
    if tag == 'float32':
        l0 = max(rel_err(got[0][:, 0], want[0][:, 0])[1],
                 rel_err(got[1][:, 0], want[1][:, 0])[1])
        if l0 > TOL_LEVEL0_F32:
            fail('pcr_factor_levels level 0 rel err {:.3e}'.format(l0))
    A, Bm = got[0], got[1]
    s_got = pk.pcr_downsweep(A, Bm, r)
    s_want = pk.pcr_downsweep_plain(A, Bm, r)
    torch.cuda.synchronize()
    sabs, serr = rel_err(s_got, s_want)
    if not torch.isfinite(s_got).all().item() or serr > TOL_REL[tag]:
        fail('pcr_downsweep {}: rel err {:.3e}'.format(where, serr))

    f_bytes, s_bytes = pcr_bytes(Dm.element_size(), batch, nodes, L)
    f_ops, s_ops = flop_counts(D, B_BORDER, nodes, L, batch)
    out = {}
    for kname, kind, fn, plain_fn, err, aerr, nbytes, ops in (
            ('pcr_factor_levels', 'factor',
             lambda: pk.pcr_factor_levels(Dm, E, F),
             lambda: pk.pcr_factor_levels_plain(Dm, E, F), ferr, fabs,
             f_bytes, f_ops),
            ('pcr_downsweep', 'downsweep', lambda: pk.pcr_downsweep(A, Bm, r),
             lambda: pk.pcr_downsweep_plain(A, Bm, r), serr, sabs, s_bytes,
             s_ops)):
        plan = pk.launch_plan(kind, batch, D, B_BORDER, nodes, dtype)
        ms, host_ms = device_ms(fn)
        cold = cold_ms(fn, flush)
        call_ms = timed(fn, 50)
        plain_ms = timed(plain_fn, 5, 1) if plain else None
        bms, by = bound(nbytes, ops, name, tag)
        out[kname] = dict(
            dtype=tag, batch=batch, nodes=nodes, max_abs_err=aerr,
            max_rel_err=err, ms=ms, cold_ms=cold, call_ms=call_ms,
            host_ms=host_ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            bytes=nbytes, flops=ops, grid=plan.blocks, cluster=plan.cluster,
            threads=plan.threads, nodes_per_block=plan.nodes_per_block,
            smem_bytes=plan.smem_bytes, scratch=plan.scratch)
        log('kernel {} {}: grid={} blocks (cluster {} x {} instances, {} '
            'threads, {} nodes each) smem={} B scratch={} values a block; '
            'max_rel_err={:.3e} max_abs_err={:.3e}; ms warm={:.5f} '
            'cold={:.5f} (a call in a host loop {:.5f}, host {:.2f} us a '
            'call) plain_ms={} bound_us={:.2f} ({}; {:.1f} MB, {:.3f} '
            'GFLOP) cold/bound={:.2f}'.format(
                kname, where, plan.blocks, plan.cluster, batch, plan.threads,
                plan.nodes_per_block, plan.smem_bytes, plan.scratch, err,
                aerr, ms, cold, call_ms, host_ms * 1e3,
                'not timed' if plain_ms is None else '{:.4f}'.format(
                    plain_ms),
                bms * 1e3, by, nbytes / 1e6, ops / 1e9, cold / bms))
    return out


def check_kernels(pk, name):
    """The PCR kernels against their plain versions at every shape of
    PCR_SHAPES, both dtypes; returns {kernel: [records]}, the main
    path's shape first."""
    import torch
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    rec = {'pcr_factor_levels': [], 'pcr_downsweep': []}
    for batch, nodes in PCR_SHAPES:
        for dtype in (torch.float32, torch.float64):
            main = (batch, nodes) == (BATCH, NODES)
            for kname, r in check_pcr_shape(pk, name, dtype, batch, nodes,
                                            flush, main).items():
                rec[kname].append(r)
    del flush
    return rec


def wide_system(dtype, batch, d=WIDE_D, b=WIDE_B, nodes=WIDE_NODES,
                seed=0):
    """A diagonally dominant system at the wide block (the off-diagonal
    blocks scaled by 1/d), so that every level stays well conditioned."""
    import torch
    rng = np.random.default_rng(seed)
    Dm = rng.standard_normal((batch, d, d, nodes)) \
        + 2.0 * d * np.eye(d)[:, :, None]
    E = rng.standard_normal((batch, d, d, nodes)) / d
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((batch, d, b, nodes))
    r = rng.standard_normal((batch, d, nodes))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    return to(Dm), to(E), to(F), to(r)


def same_bits(got, want):
    """Whether two float tensors hold the same bits (the sign of a zero
    included), NaN in the same places."""
    import torch
    nan = torch.isnan(got)
    bits = torch.int64 if got.element_size() == 8 else torch.int32
    return bool(got.shape == want.shape and got.dtype == want.dtype
                and torch.equal(nan, torch.isnan(want))
                and torch.equal(torch.where(nan, 0, got).view(bits),
                                torch.where(nan, 0, want).view(bits)))


def check_wide_sweep_shapes(pk):
    """Phase 3w: the wide downsweep bitwise equal to
    pcr_downsweep_in_order, and within TOL_WIDE_SWEEP of its plain
    version, at WIDE_SWEEP_SHAPES and the gate's edge in both of
    its branches (the plan's, and the zero-stage branch on the narrow
    kernel's node split), and at nlink-9's block on four lanes with a
    NaN in one lane's levels and an infinite multiplier at a boundary
    node; levels drawn on the card from a seed, scaled as a diagonally
    dominant system's."""
    import torch
    from opty_tpu_torch.ops.tridiag import num_levels
    gen = torch.Generator(device='cuda')
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        shapes = list(WIDE_SWEEP_SHAPES) + [WIDE_SWEEP_EDGE[tag]]
        for d, N, batch in shapes + [(WIDE_D, WIDE_NODES, 4)]:
            gen.manual_seed(d * N + batch)
            L = num_levels(N)
            draw = lambda *shape: torch.randn(*shape, generator=gen,
                                              device='cuda', dtype=dtype)
            A, Bm = draw(batch, L, d, d, N) / d, draw(batch, L, d, d, N) / d
            r = draw(batch, d, N)
            poisoned = batch == 4
            if poisoned:
                A[2, 1, 3, 4, 10] = float('nan')
                Bm[1, 0, 0, 0, N - 1] = float('inf')
            plan = pk.launch_plan('wide_downsweep', batch, d, 0, N, dtype)
            pk.reset_launch_counts()
            got = pk.pcr_downsweep(A, Bm, r)
            zero = pk.launch_wide_downsweep(
                A, Bm, r, pk.wide_direct_plan(batch, d, N, dtype))
            torch.cuda.synchronize()
            counts = (pk.wide_downsweep_launches,
                      pk.wide_downsweep_direct_launches)
            if counts != (2, 1 if plan.stages else 2):
                fail('phase 3w: wide downsweep launches {} at d={} N={}'
                     .format(counts, d, N))
            want = pk.pcr_downsweep_in_order(A, Bm, r)
            where = '{} d={} N={} B={}{}'.format(
                tag, d, N, batch, ' (a NaN and an inf in the levels)'
                if poisoned else '')
            if not (same_bits(got, want) and same_bits(zero, want)):
                fail('wide pcr_downsweep {}: not bitwise equal to '
                     'pcr_downsweep_in_order (plan {}, zero-stage branch '
                     '{})'.format(where, same_bits(got, want),
                                  same_bits(zero, want)))
            if poisoned:
                note = '{} NaN'.format(int(torch.isnan(got).sum()))
            else:
                err = rel_err(got, pk.pcr_downsweep_plain(A, Bm, r))[1]
                if not err <= TOL_WIDE_SWEEP[tag]:
                    fail('wide pcr_downsweep {}: rel err {:.3e} > {:.0e}'
                         .format(where, err, TOL_WIDE_SWEEP[tag]))
                note = 'rel err {:.3e} against the plain version'.format(err)
            log('kernel pcr_downsweep_wide {}: plan cluster {}, {} stages, '
                '{} B, {} threads; both branches bitwise equal to '
                'pcr_downsweep_in_order; {}'.format(
                    where, plan.cluster, plan.stages, plan.smem_bytes,
                    plan.threads, note))
            del A, Bm, r, got, zero, want


def wide_residual(batch):
    """The float64 wide PCR path end to end (ops/tridiag.py: the factor,
    the border Schur inverse, the downsweep and the back substitution)
    on ``batch`` bordered systems at the nlink-9 block against
    torch.linalg.solve of each dense system: max |x - x_dense| /
    max |x_dense| over the batch."""
    import torch
    from opty_tpu_torch.ops import tridiag
    d, b, N = WIDE_D, WIDE_B, WIDE_NODES
    Dm, E, F, r = wide_system(torch.float64, batch, d, b, N)
    rng = np.random.default_rng(11)
    Kbb = torch.as_tensor(rng.standard_normal((batch, b, b))
                          + 5.0 * np.eye(b), device='cuda')
    rb = torch.as_tensor(rng.standard_normal((batch, b)), device='cuda')
    fac = tridiag.pcr_factor(Dm, E, F, Kbb)
    u, beta = tridiag.pcr_solve(fac, r, rb)
    # equation k: E_k u_{k-1} + D_k u_k + E_{k+1}^T u_{k+1} + F_k beta =
    # r_k; border: sum_k F_k^T u_k + Kbb beta = rb
    n = N * d + b
    K = torch.zeros((batch, n, n), dtype=torch.float64, device='cuda')
    for k in range(N):
        rows = slice(k * d, (k + 1) * d)
        K[:, rows, rows] = Dm[..., k]
        if k:
            K[:, rows, (k - 1) * d:k * d] = E[..., k]
            K[:, (k - 1) * d:k * d, rows] = E[..., k].transpose(-1, -2)
        K[:, rows, N * d:] = F[..., k]
        K[:, N * d:, rows] = F[..., k].transpose(-1, -2)
    K[:, N * d:, N * d:] = Kbb
    rhs = torch.cat([r.transpose(-1, -2).reshape(batch, N * d), rb], dim=-1)
    want = torch.linalg.solve(K, rhs)
    got = torch.cat([u.transpose(-1, -2).reshape(batch, N * d), beta], dim=-1)
    return rel_err(got, want)[1]


def check_wide_kernels(pk, bk, name):
    """Phase 3w: the wide variants against their plain versions: the
    PCR factor (TOL_WIDE per output) and downsweep (TOL_WIDE_SWEEP) at
    d = 50, b = 41, N = 60 and B in WIDE_BATCHES, the inverse (TOL_WIDE)
    at b in WIDE_BORDERS and the same B, float32 and float64, and the
    float64 path through ops/tridiag.py against the dense solve
    (TOL_WIDE_RESIDUAL); each timed L2-warm and L2-cold beside its
    bound, its plain version and (the inverse) torch.linalg.inv_ex.  Fails unless each call went through its wide
    counter.  Returns {kernel: [records]}."""
    import torch
    from opty_tpu_torch.ops.tridiag import num_levels
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    rec = {'pcr_factor_levels_wide': [], 'pcr_downsweep_wide': [],
           'block_inv_wide': []}
    L = num_levels(WIDE_NODES)
    for batch in WIDE_BATCHES:
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split('.')[-1]
            where = '{} B={} d={} b={} N={}'.format(tag, batch, WIDE_D,
                                                    WIDE_B, WIDE_NODES)
            Dm, E, F, r = wide_system(dtype, batch)
            pk.reset_launch_counts()
            got = pk.pcr_factor_levels(Dm, E, F)
            A, Bm = got[0], got[1]
            s_got = pk.pcr_downsweep(A, Bm, r)
            torch.cuda.synchronize()
            if (pk.wide_factor_launches, pk.wide_downsweep_launches) != (1, 1):
                fail('phase 3w {}: the wide kernels were not launched'.format(
                    where))
            want = pk.pcr_factor_levels_plain(Dm, E, F)
            s_want = pk.pcr_downsweep_plain(A, Bm, r)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            fabs = max(e[0] for e in errs)
            ferr = max(e[1] for e in errs)
            sabs, serr = rel_err(s_got, s_want)
            if not all(torch.isfinite(g).all().item() for g in got) \
                    or ferr > TOL_WIDE[tag]:
                fail('wide pcr_factor_levels {}: rel err {:.3e} > {:.0e} '
                     '(per output: {})'.format(
                         where, ferr, TOL_WIDE[tag],
                         ['{:.2e}'.format(e[1]) for e in errs]))
            if not torch.isfinite(s_got).all().item() \
                    or serr > TOL_WIDE_SWEEP[tag]:
                fail('wide pcr_downsweep {}: rel err {:.3e}'.format(where,
                                                                    serr))
            sweep_plan = pk.launch_plan('wide_downsweep', batch, WIDE_D, 0,
                                        WIDE_NODES, dtype)
            direct_plan = pk.wide_direct_plan(batch, WIDE_D, WIDE_NODES,
                                              dtype)
            in_order = pk.pcr_downsweep_in_order(A, Bm, r)
            direct = pk.launch_wide_downsweep(A, Bm, r, direct_plan)
            if not (same_bits(s_got, in_order) and same_bits(direct,
                                                              in_order)):
                fail('wide pcr_downsweep {}: not bitwise equal to '
                     'pcr_downsweep_in_order (plan {}, zero-stage branch '
                     '{})'.format(where, same_bits(s_got, in_order),
                                  same_bits(direct, in_order)))
            f_bytes, s_bytes = pcr_bytes(Dm.element_size(), batch,
                                         WIDE_NODES, L, WIDE_D, WIDE_B)
            f_ops, s_ops = flop_counts(WIDE_D, WIDE_B, WIDE_NODES, L, batch)
            for kname, fn, plain_fn, aerr, err, nbytes, ops in (
                    ('pcr_factor_levels_wide',
                     lambda: pk.pcr_factor_levels(Dm, E, F),
                     lambda: pk.pcr_factor_levels_plain(Dm, E, F), fabs,
                     ferr, f_bytes, f_ops),
                    ('pcr_downsweep_wide', lambda: pk.pcr_downsweep(A, Bm, r),
                     lambda: pk.pcr_downsweep_plain(A, Bm, r), sabs, serr,
                     s_bytes, s_ops)):
                # a wide factor call queues L + 1 launches and allocates
                # its scratch: a longer sleep keeps the device behind
                ms = device_ms(fn, reps=20, sleep_cycles=WIDE_SLEEP)[0]
                cold = cold_ms(fn, flush, reps=10, sleep_cycles=WIDE_SLEEP)
                plain_ms = timed(plain_fn, 1, 1)
                bms, by = bound(nbytes, ops, name, tag)
                extra, note = {}, ''
                if kname == 'pcr_downsweep_wide':
                    # the zero-stage branch on the narrow kernel's node
                    # split: the design before the ring, timed beside
                    zero = lambda: pk.launch_wide_downsweep(A, Bm, r,
                                                            direct_plan)
                    extra = dict(
                        bitwise_in_order=True, cluster=sweep_plan.cluster,
                        stages=sweep_plan.stages,
                        smem_bytes=sweep_plan.smem_bytes,
                        threads=sweep_plan.threads,
                        rows_per_block=sweep_plan.rows_per_block,
                        zero_stage_ms=device_ms(
                            zero, reps=20, sleep_cycles=WIDE_SLEEP)[0],
                        zero_stage_cold_ms=cold_ms(
                            zero, flush, reps=10, sleep_cycles=WIDE_SLEEP),
                        zero_stage_cluster=direct_plan.cluster)
                    note = ('; plan: cluster {} ({} rows a block), {} stages, '
                            '{} B of shared memory, {} threads; bitwise '
                            'equal to pcr_downsweep_in_order; the zero-stage '
                            'branch (cluster {}, A and B read in the sums) '
                            'warm={:.5f} cold={:.5f}'.format(
                                sweep_plan.cluster, sweep_plan.rows_per_block,
                                sweep_plan.stages, sweep_plan.smem_bytes,
                                sweep_plan.threads, direct_plan.cluster,
                                extra['zero_stage_ms'],
                                extra['zero_stage_cold_ms']))
                rec[kname].append(dict(
                    dtype=tag, batch=batch, d=WIDE_D, b=WIDE_B,
                    nodes=WIDE_NODES, max_abs_err=aerr, max_rel_err=err,
                    ms=ms, cold_ms=cold, plain_ms=plain_ms, bound_ms=bms,
                    bound_by=by, bytes=nbytes, flops=ops, library_ms=None,
                    **extra))
                log('kernel {} {}: max_rel_err={:.3e} max_abs_err={:.3e}; ms '
                    'warm={:.5f} cold={:.5f} plain_ms={:.2f} bound_us={:.2f} '
                    '({}; {:.1f} MB, {:.3f} GFLOP) cold/bound={:.1f}{}'.format(
                        kname, where, err, aerr, ms, cold, plain_ms,
                        bms * 1e3, by, nbytes / 1e6, ops / 1e9, cold / bms,
                        note))
    check_wide_sweep_shapes(pk)
    for batch in (1, 8):
        resid = wide_residual(batch)
        log('wide pcr path float64 B={} d={} b={} N={}: factor + border '
            'inverse + downsweep + back substitution against the dense '
            'solve: rel err {:.3e} (limit {:.0e})'.format(
                batch, WIDE_D, WIDE_B, WIDE_NODES, resid, TOL_WIDE_RESIDUAL))
        if not resid <= TOL_WIDE_RESIDUAL:
            fail('phase 3w: the float64 wide PCR solve is {:.3e} from the '
                 'dense solve'.format(resid))
    for b in WIDE_BORDERS:
        for batch in WIDE_BATCHES:
            for dtype in (torch.float32, torch.float64):
                tag = str(dtype).split('.')[-1]
                rng = np.random.default_rng(batch + b)
                A = torch.as_tensor(rng.standard_normal((batch, b, b))
                                    + 2.0 * b * np.eye(b), dtype=dtype,
                                    device='cuda')
                bk.reset_launch_counts()
                got = bk.block_inv(A)
                torch.cuda.synchronize()
                aerr, err = rel_err(got, bk.block_inv_plain(A))
                where = '{} b={} B={}'.format(tag, b, batch)
                if bk.wide_inv_launches != 1:
                    fail('phase 3w {}: block_inv did not launch its wide '
                         'variant'.format(where))
                if not torch.isfinite(got).all().item() \
                        or err > TOL_WIDE[tag]:
                    fail('wide block_inv {}: rel err {:.3e} > {:.0e}'.format(
                        where, err, TOL_WIDE[tag]))
                ms = device_ms(lambda: bk.block_inv(A),
                               sleep_cycles=WIDE_SLEEP)[0]
                cold = cold_ms(lambda: bk.block_inv(A), flush, reps=10,
                               sleep_cycles=WIDE_SLEEP)
                plain_ms = timed(lambda: bk.block_inv_plain(A), 5, 1)
                # inv_ex waits on the device inside a call at b = 41, so
                # no sleep can keep it queued: CUDA events around calls
                # in a host loop instead
                library_ms = timed(lambda: torch.linalg.inv_ex(A)[0], 20)
                nbytes = 2 * batch * b * b * A.element_size()
                bms, by = bound(nbytes, batch * inv_flops(b), name, tag)
                rec['block_inv_wide'].append(dict(
                    dtype=tag, batch=batch, d=b, max_abs_err=aerr,
                    max_rel_err=err, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                    library_ms=library_ms, bound_ms=bms, bound_by=by))
                log('kernel block_inv_wide {}: max_rel_err={:.3e} '
                    'max_abs_err={:.3e}; ms warm={:.5f} cold={:.5f} '
                    'plain_ms={:.3f} library_ms '
                    '(torch.linalg.inv_ex)={:.5f} bound_us={:.4f} ({})'
                    .format(where, err, aerr, ms, cold, plain_ms, library_ms, bms * 1e3, by))
    del flush
    return rec


def check_shapes(pk, bk, name, shapes, title):
    """Phase 3w at the blocks ``shapes`` ({label: (d, b, N)}; one lane,
    float32 and float64): the wide factor against its plain version
    (TOL_WIDE), the wide downsweep bitwise equal to
    pcr_downsweep_in_order and within TOL_WIDE_SWEEP of its plain
    version; where the register kernels take the block (csrc/pcr.cu,
    d = 3 or 5), the factor bitwise equal to its plain version and the
    downsweep within phase 3's TOL_REL (whether it also equals
    pcr_downsweep_in_order bitwise is printed); the border inverse at b
    (blocks.cu up to 8, the wide variant beyond) against its plain
    version (TOL_BLOCK / TOL_WIDE); each must launch through the kernel
    the solve takes, timed L2-warm and L2-cold beside its bound and its
    plain version, the downsweep with its plan.  Returns {kernel:
    [records]}."""
    import torch
    from opty_tpu_torch.ops.tridiag import num_levels
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    rec = {'pcr_factor_levels_wide': [], 'pcr_downsweep_wide': [],
           'pcr_factor_levels': [], 'pcr_downsweep': [],
           'block_inv': [], 'block_inv_wide': []}
    for label, (d, b, N) in shapes.items():
        L = num_levels(N)
        narrow = pk._narrow(d, b)
        fname, sname = (('pcr_factor_levels', 'pcr_downsweep') if narrow
                        else ('pcr_factor_levels_wide', 'pcr_downsweep_wide'))
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split('.')[-1]
            where = '{} {} B=1 d={} b={} N={}'.format(label, tag, d, b, N)
            if not pk.kernel_supported(d, b, N, dtype):
                fail('phase {}: kernel_supported refuses {}'.format(title,
                                                                    where))
            Dm, E, F, r = wide_system(dtype, 1, d, b, N)
            pk.reset_launch_counts()
            got = pk.pcr_factor_levels(Dm, E, F)
            A, Bm = got[0], got[1]
            s_got = pk.pcr_downsweep(A, Bm, r)
            torch.cuda.synchronize()
            if (pk.factor_launches, pk.downsweep_launches,
                    pk.wide_factor_launches,
                    pk.wide_downsweep_launches) != (
                        (1, 1, 0, 0) if narrow else (0, 0, 1, 1)):
                fail('phase {} {}: the {} kernels were not launched'.format(
                    title, where, 'register' if narrow else 'wide'))
            want = pk.pcr_factor_levels_plain(Dm, E, F)
            errs = [rel_err(g, w) for g, w in zip(got, want)]
            fabs, ferr = max(e[0] for e in errs), max(e[1] for e in errs)
            if not all(torch.isfinite(g).all().item() for g in got) \
                    or (fabs != 0.0 if narrow else ferr > TOL_WIDE[tag]):
                fail('{} {}: rel err {:.3e}, abs err {:.3e} ({})'.format(
                    fname, where, ferr, fabs, 'bitwise expected' if narrow
                    else 'limit {:.0e}'.format(TOL_WIDE[tag])))
            in_order = same_bits(s_got, pk.pcr_downsweep_in_order(A, Bm, r))
            sabs, serr = rel_err(s_got, pk.pcr_downsweep_plain(A, Bm, r))
            if not narrow and not in_order:
                fail('wide pcr_downsweep {}: not bitwise equal to '
                     'pcr_downsweep_in_order'.format(where))
            stol = (TOL_REL if narrow else TOL_WIDE_SWEEP)[tag]
            if not torch.isfinite(s_got).all().item() or serr > stol:
                fail('{} {}: rel err {:.3e} > {:.0e}'.format(sname, where,
                                                              serr, stol))
            plan = pk.launch_plan('downsweep' if narrow else 'wide_downsweep',
                                  1, d, b if narrow else 0, N, dtype)
            f_bytes, s_bytes = pcr_bytes(Dm.element_size(), 1, N, L, d, b)
            f_ops, s_ops = flop_counts(d, b, N, L, 1)
            for kname, fn, plain_fn, aerr, err, nbytes, ops in (
                    (fname,
                     lambda: pk.pcr_factor_levels(Dm, E, F),
                     lambda: pk.pcr_factor_levels_plain(Dm, E, F), fabs,
                     ferr, f_bytes, f_ops),
                    (sname, lambda: pk.pcr_downsweep(A, Bm, r),
                     lambda: pk.pcr_downsweep_plain(A, Bm, r), sabs, serr,
                     s_bytes, s_ops)):
                ms = device_ms(fn, reps=20, sleep_cycles=WIDE_SLEEP)[0]
                cold = cold_ms(fn, flush, reps=10, sleep_cycles=WIDE_SLEEP)
                plain_ms = timed(plain_fn, 1, 1)
                bms, by = bound(nbytes, ops, name, tag)
                extra, note = {}, ''
                if kname == 'pcr_downsweep':
                    extra = dict(bitwise_in_order=in_order,
                                 cluster=plan.cluster, grid=plan.blocks,
                                 threads=plan.threads,
                                 nodes_per_block=plan.nodes_per_block)
                    note = ('; plan: grid {}, cluster {}, {} threads, {} '
                            'nodes a block; bitwise equal to '
                            'pcr_downsweep_in_order: {}'.format(
                                plan.blocks, plan.cluster, plan.threads,
                                plan.nodes_per_block, in_order))
                if kname == 'pcr_downsweep_wide':
                    extra = dict(bitwise_in_order=True, cluster=plan.cluster,
                                 stages=plan.stages,
                                 smem_bytes=plan.smem_bytes,
                                 threads=plan.threads,
                                 rows_per_block=plan.rows_per_block,
                                 nodes_per_block=plan.nodes_per_block)
                    note = ('; plan: cluster {} ({} rows, {} nodes a block), '
                            '{} stages, {} B of shared memory, {} threads; '
                            'bitwise equal to pcr_downsweep_in_order'.format(
                                plan.cluster, plan.rows_per_block,
                                plan.nodes_per_block, plan.stages,
                                plan.smem_bytes, plan.threads))
                rec[kname].append(dict(
                    example=label, dtype=tag, batch=1, d=d, b=b, nodes=N,
                    max_abs_err=aerr, max_rel_err=err, ms=ms, cold_ms=cold,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    bytes=nbytes, flops=ops, library_ms=None, **extra))
                log('kernel {} {}: max_rel_err={:.3e} max_abs_err={:.3e}; ms '
                    'warm={:.5f} cold={:.5f} plain_ms={:.2f} bound_us={:.3f} '
                    '({}) cold/bound={:.1f}{}'.format(
                        kname, where, err, aerr, ms, cold, plain_ms,
                        bms * 1e3, by, cold / bms, note))
            # the border inverse as the solve calls it: one b x b matrix
            rng = np.random.default_rng(b)
            K = torch.as_tensor(rng.standard_normal((1, b, b))
                                + 2.0 * b * np.eye(b), dtype=dtype,
                                device='cuda')
            bk.reset_launch_counts()
            got = bk.block_inv(K)
            torch.cuda.synchronize()
            kname = 'block_inv_wide' if b not in bk.SUPPORTED_D \
                else 'block_inv'
            launched = bk.wide_inv_launches if kname == 'block_inv_wide' \
                else bk.inv_launches
            if launched != 1:
                fail('phase {} {}: the border inverse did not launch {}'
                     .format(title, where, kname))
            aerr, err = rel_err(got, bk.block_inv_plain(K))
            tol = (TOL_WIDE if kname == 'block_inv_wide' else TOL_BLOCK)[tag]
            if not torch.isfinite(got).all().item() or err > tol:
                fail('{} {}: rel err {:.3e} > {:.0e}'.format(kname, where,
                                                              err, tol))
            ms = device_ms(lambda: bk.block_inv(K),
                           sleep_cycles=WIDE_SLEEP)[0]
            cold = cold_ms(lambda: bk.block_inv(K), flush, reps=10,
                           sleep_cycles=WIDE_SLEEP)
            plain_ms = timed(lambda: bk.block_inv_plain(K), 5, 1)
            library_ms = timed(lambda: torch.linalg.inv_ex(K)[0], 20)
            bms, by = bound(2 * b * b * K.element_size(), inv_flops(b), name,
                            tag)
            rec[kname].append(dict(
                example=label, dtype=tag, batch=1, d=b, max_abs_err=aerr,
                max_rel_err=err, ms=ms, cold_ms=cold, plain_ms=plain_ms,
                library_ms=library_ms, bound_ms=bms, bound_by=by))
            log('kernel {} {} (the border, one {} x {} matrix): '
                'max_rel_err={:.3e}; ms warm={:.5f} cold={:.5f} '
                'plain_ms={:.3f} library_ms (torch.linalg.inv_ex)={:.5f} '
                'bound_us={:.4f} ({})'.format(kname, where, b, b, err, ms,
                                              cold, plain_ms, library_ms,
                                              bms * 1e3, by))
    del flush
    return rec


def ident_solve(counters, label, smi):
    """Phase 8a or 8b: the example's builder at its default size on the
    card, ``Problem.solve`` with the card's default options from the
    builder's guess; counters reset just before and read just after.
    Fails unless the status is 0 or 1 with the constraints within
    IDENT_VIOLATION of it, the identified values lie within IDENT_REL
    relative of the JAX package's recorded run, the kernels of the cr
    path at the example's blocks launched (the wide factor and
    downsweep; the border inverse of blocks.cu at b = 4, the wide one at
    b = 1) and no scan kernel, and (8a) the largest gain error is under
    GAIN_ERROR_LIMIT.  Returns (launches, record)."""
    import torch
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    d, b, N = IDENT_SHAPES[label]
    for dtype in (torch.float32, torch.float64):
        if not pk.kernel_supported(d, b, N, dtype):
            fail('{}: kernel_supported refuses (d, b, N) = ({}, {}, {}) in '
                 '{}'.format(label, d, b, N, dtype))
    t0 = time.time()
    if label == '8a':
        from opty_tpu_torch.examples import inverted_pendulum_id as ex
        prob, guess, truth = ex.build_problem(links=1, nodes=N)
        jax_rec, name = JAX_PENDULUM_ID, 'inverted_pendulum_id'
    else:
        from opty_tpu_torch.examples import vyasarayani2011 as ex
        prob, guess, truth = ex.build_problem(nodes=N)
        jax_rec, name = JAX_VYASARAYANI, 'vyasarayani2011'
    build_s = time.time() - t0
    truth = np.atleast_1d(truth)
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.time()
    x, info = prob.solve(guess)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(*counters)
    if x.shape != (prob.num_free,) or not np.all(np.isfinite(x)):
        fail('{}: the solution has the wrong shape or is not finite'.format(
            label))
    found = x[-truth.size:]
    worst = float(np.max(np.abs(prob.constraints(x))))
    want = np.asarray(jax_rec['identified'])
    rel = float(np.max(np.abs(found - want) / np.abs(want)))
    per_iter = {k: v / max(info['iterations'], 1)
                for k, v in launches.items() if v}
    rec = dict(example=name, status=info['status'],
               iterations=info['iterations'], obj=info['obj_val'],
               identified=found.tolist(), truth=truth.tolist(),
               rel_to_jax=rel, worst_constraint=worst, wall_s=wall,
               build_s=build_s, launches_per_iteration=per_iter)
    log('{} {}: (d, b, N) = ({}, {}, {}), default options: status={} '
        'iterations={} obj={:.12g} identified={} (true {}) wall_s={:.2f} '
        '(build {:.1f} s) worst constraint={:.3e}; the JAX package on the CPU '
        '(recorded): status={} iterations={} obj={:.12g} identified={}; '
        'largest relative difference {:.3e} (limit {:.0e}); launches={}; per '
        'iteration {} ({})'.format(
            label, name, d, b, N, info['status'], info['iterations'],
            info['obj_val'], found.tolist(), truth.tolist(), wall, build_s,
            worst, jax_rec['status'], jax_rec['iterations'], jax_rec['obj'],
            jax_rec['identified'], rel, IDENT_REL, json.dumps(launches),
            json.dumps({k: round(v, 3) for k, v in per_iter.items()}), smi))
    if info['status'] not in IDENT_VIOLATION:
        fail('{}: status {}'.format(label, info['status']))
    if not worst <= IDENT_VIOLATION[info['status']]:
        fail('{}: the status-{} solution violates its constraints by {:.3e}'
             .format(label, info['status'], worst))
    if not rel <= IDENT_REL:
        fail('{}: the identified values are {:.3e} from the JAX package\'s '
             '(limit {:.0e})'.format(label, rel, IDENT_REL))
    if label == '8a':
        gain_err = float(np.max(np.abs(found - truth)))
        rec['gain_error'] = gain_err
        log('8a: max |gain - true gain| = {:.4f} (limit {})'.format(
            gain_err, GAIN_ERROR_LIMIT))
        if not gain_err < GAIN_ERROR_LIMIT:
            fail('8a: the gain error {:.3e} is not under {}'.format(
                gain_err, GAIN_ERROR_LIMIT))
    # the same solve again under torch.profiler (the device only): each
    # hand-written kernel's device time a call in the solve
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prob.solve(guess)
        torch.cuda.synchronize()
    rec['in_solve_ms'] = {k: v for k, v in in_solve_times(
        device_events(prof)).items() if not k.startswith('launch ')}
    log('{}: device ms a call in the solve (profiler): {}'.format(
        label, json.dumps({k: round(v, 5)
                           for k, v in rec['in_solve_ms'].items()})))
    border = 'block_inv' if b in bk.SUPPORTED_D else 'block_inv_wide'
    for kname in ('pcr_factor_levels_wide', 'pcr_downsweep_wide', border):
        if launches[kname] == 0:
            fail('{} was not launched in {}'.format(kname, label))
    for kname in ('scan_factor', 'scan_solve', 'scan_factor_wide',
                  'scan_solve_wide', 'pcr_factor_levels', 'pcr_downsweep'):
        if launches[kname]:
            fail('{} was launched {} times in {}'.format(
                kname, launches[kname], label))
    return launches, rec


def wide_scan_blocks(dtype):
    """Phase 3ws's (d, b) in ``dtype``: WIDE_SCAN_BLOCKS with d = 64's
    widest border that the shared memory takes."""
    from opty_tpu_torch.ops import scan_kernels as sk
    out = []
    for d, b in WIDE_SCAN_BLOCKS:
        if b is None:
            b = max(c for c in range(sk.WIDE_MAX_B + 1)
                    if sk.kernel_supported(d, c, WIDE_NODES, dtype))
        out.append((d, b))
    return out


def check_wide_scan_kernels(sk, name):
    """Phase 3ws: the wide scan factor and solve (csrc/scan_wide.cu)
    against their plain versions (TOL_SCAN per output) at the blocks of
    ``wide_scan_blocks``, B in WIDE_BATCHES, N = 60, float32 and
    float64; each call must move the wide counters alone.  Timed L2-warm
    and L2-cold beside the bound and the dependent chain of N node
    steps (its time a node), the plain versions at nlink-9's block and
    B = 1.  Each record names the cluster size the wrappers chose
    (``sk.cluster_size``); at nlink-9's block every cluster size each
    kernel is built for is also checked against the plain version and
    timed L2-cold (``candidates_cold_ms``), so the choice can be
    checked.  Returns {kernel: [records]}."""
    import torch
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    rec = {'scan_factor_wide': [], 'scan_solve_wide': []}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for d, b in wide_scan_blocks(dtype):
            for batch in WIDE_BATCHES:
                where = '{} B={} d={} b={} N={}'.format(tag, batch, d, b,
                                                        WIDE_NODES)
                Dm, E, F, Kbb, r, rb = scan_system(dtype, batch, WIDE_NODES,
                                                   d, b)
                sk.reset_launch_counts()
                fac = sk.scan_factor(Dm, E, F, Kbb)
                sol = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
                torch.cuda.synchronize()
                counts = (sk.factor_launches, sk.solve_launches,
                          sk.wide_factor_launches, sk.wide_solve_launches)
                if counts != (0, 0, 1, 1):
                    fail('phase 3ws {}: launches (narrow factor, solve, wide '
                         'factor, solve) {}'.format(where, counts))
                want = sk.scan_factor_plain(Dm, E, F, Kbb)
                sol_want = sk.scan_solve_plain(*fac[:3], E, fac[3], r, rb)
                main = (d, b, batch) == (WIDE_D, WIDE_B, 1)
                chosen = dict(zip(('scan_factor_wide', 'scan_solve_wide'),
                                  sk.cluster_size(batch, d, b, dtype)))
                candidates = {'scan_factor_wide': {}, 'scan_solve_wide': {}}
                if (d, b) == (WIDE_D, WIDE_B):
                    for kname, sizes, launch, ref in (
                            ('scan_factor_wide', sk.FACTOR_CLUSTERS,
                             lambda c: sk.launch_wide_factor(Dm, E, F, Kbb,
                                                             c), want),
                            ('scan_solve_wide', sk.SOLVE_CLUSTERS,
                             lambda c: sk.launch_wide_solve(
                                 *fac[:3], E, fac[3], r, rb, c), sol_want)):
                        for c in sizes:
                            got = launch(c)
                            torch.cuda.synchronize()
                            err = max(rel_err(g, w)[1]
                                      for g, w in zip(got, ref) if w.numel())
                            if not all(torch.isfinite(g).all().item()
                                       for g in got) or err > TOL_SCAN[tag]:
                                fail('{} {} cluster {}: rel err {:.3e} > '
                                     '{:.0e}'.format(kname, where, c, err,
                                                     TOL_SCAN[tag]))
                            candidates[kname][c] = cold_ms(
                                lambda: launch(c), flush, reps=5,
                                sleep_cycles=WIDE_SLEEP)
                counts = scan_counts(d, b, WIDE_NODES, batch,
                                     Dm.element_size())
                for kname, got, ref, fn, plain_fn, (nbytes, ops) in (
                        ('scan_factor_wide', fac, want,
                         lambda: sk.scan_factor(Dm, E, F, Kbb),
                         lambda: sk.scan_factor_plain(Dm, E, F, Kbb),
                         counts[0]),
                        ('scan_solve_wide', sol, sol_want,
                         lambda: sk.scan_solve(*fac[:3], E, fac[3], r, rb),
                         lambda: sk.scan_solve_plain(*fac[:3], E, fac[3], r,
                                                     rb), counts[1])):
                    errs = [rel_err(g, w) for g, w in zip(got, ref)
                            if w.numel()]
                    aerr = max(e[0] for e in errs)
                    err = max(e[1] for e in errs)
                    if not all(torch.isfinite(g).all().item() for g in got) \
                            or err > TOL_SCAN[tag]:
                        fail('{} {}: rel err {:.3e} > {:.0e}'.format(
                            kname, where, err, TOL_SCAN[tag]))
                    ms = device_ms(fn, reps=10, sleep_cycles=WIDE_SLEEP)[0]
                    cold = cold_ms(fn, flush, reps=5,
                                   sleep_cycles=WIDE_SLEEP)
                    plain_ms = timed(plain_fn, 1, 1) if main else None
                    bms, by = bound(nbytes, ops, name, tag)
                    rec[kname].append(dict(
                        dtype=tag, batch=batch, d=d, b=b, nodes=WIDE_NODES,
                        cluster=chosen[kname],
                        candidates_cold_ms=candidates[kname] or None,
                        max_abs_err=aerr, max_rel_err=err, ms=ms,
                        cold_ms=cold, us_per_node=cold / WIDE_NODES * 1e3,
                        plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                        bytes=nbytes, flops=ops, library_ms=None))
                    log('kernel {} {} cluster={}: max_rel_err={:.3e} '
                        'max_abs_err={:.3e} ms warm={:.5f} cold={:.5f} '
                        '({:.3f} us a node of the chain) plain_ms={} '
                        'bound_us={:.2f} ({}; {:.2f} MB, {:.4f} GFLOP) '
                        'cold/bound={:.1f}{}'.format(
                            kname, where, chosen[kname], err, aerr, ms, cold,
                            cold / WIDE_NODES * 1e3,
                            'not timed' if plain_ms is None
                            else '{:.2f}'.format(plain_ms), bms * 1e3, by,
                            nbytes / 1e6, ops / 1e9, cold / bms,
                            '; cold ms by cluster size {}'.format(
                                ' '.join('{}: {:.4f}'.format(c, t) for c, t
                                         in candidates[kname].items()))
                            if candidates[kname] else ''))
    # past the factor's threshold (2 B > 132 SMs) one block a lane
    # should win: both sizes at B = 132, float64
    batch = sk.SMS
    Dm, E, F, Kbb, _, _ = scan_system(torch.float64, batch, WIDE_NODES,
                                      WIDE_D, WIDE_B)
    want = sk.scan_factor_plain(Dm, E, F, Kbb)
    times = {}
    for c in sk.FACTOR_CLUSTERS:
        got = sk.launch_wide_factor(Dm, E, F, Kbb, c)
        err = max(rel_err(g, w)[1] for g, w in zip(got, want))
        if err > TOL_SCAN['float64']:
            fail('scan_factor_wide float64 B={} cluster {}: rel err '
                 '{:.3e}'.format(batch, c, err))
        times[c] = cold_ms(lambda: sk.launch_wide_factor(Dm, E, F, Kbb, c),
                           flush, reps=5, sleep_cycles=WIDE_SLEEP)
    log('kernel scan_factor_wide float64 B={} d={} b={} N={}: cold ms by '
        'cluster size {} (cluster_size chose {})'.format(
            batch, WIDE_D, WIDE_B, WIDE_NODES,
            ' '.join('{}: {:.4f}'.format(c, t) for c, t in times.items()),
            sk.cluster_size(batch, WIDE_D, WIDE_B, torch.float64)[0]))
    rec['scan_factor_wide_full_card'] = dict(batch=batch, cold_ms=times)
    del flush
    return rec


def bound(nbytes, ops, name, tag):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type: float32 on the CUDA
    cores, float64 on the FP64 tensor cores (the same rate on an H100:
    the least time the card could take, whichever units a kernel
    uses)."""
    _, (bw, fl) = peaks(name)
    t_bytes = nbytes / bw * 1e3
    t_ops = ops / fl * 1e3
    return max(t_bytes, t_ops), 'bytes' if t_bytes >= t_ops else 'operations'


def check_block_kernels(bk, name):
    """The block inverse and product against their plain versions, and
    beside one library call each; returns per-kernel lists of records.
    ``ms`` and ``library_ms`` are device times (``device_ms``): at these
    sizes a call's host-side time exceeds the kernel's, and is
    reported beside as ``call_ms`` (CUDA events around a host loop)."""
    import torch
    rec = {'block_inv': [], 'block_matmul': []}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for d, nb in BLOCK_SHAPES:
            rng = np.random.default_rng(nb + d)
            to = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
            A = to(rng.standard_normal((nb, d, d)) + 2.0 * d * np.eye(d))
            Bm = to(rng.standard_normal((nb, d, d)))
            for kname, kernel, plain, library, args, n_io, ops in (
                    ('block_inv', bk.block_inv, bk.block_inv_plain,
                     lambda a: torch.linalg.inv_ex(a)[0], (A,), 2,
                     inv_flops(d)),
                    ('block_matmul', bk.block_matmul, bk.block_matmul_plain,
                     torch.bmm, (A, Bm), 3, d * d * (2 * d - 1))):
                got = kernel(*args)
                want = plain(*args)
                torch.cuda.synchronize()
                aerr, err = rel_err(got, want)
                if not torch.isfinite(got).all().item() \
                        or err > TOL_BLOCK[tag]:
                    fail('{} {} d={} B={}: rel err {:.3e} > {:.0e}'.format(
                        kname, tag, d, nb, err, TOL_BLOCK[tag]))
                ms = device_ms(lambda: kernel(*args))[0]
                call_ms = timed(lambda: kernel(*args), 200)
                plain_ms = timed(lambda: plain(*args), 20, 2)
                library_ms = device_ms(lambda: library(*args))[0]
                library_call_ms = timed(lambda: library(*args), 200)
                nbytes = n_io * nb * d * d * A.element_size()
                bms, by = bound(nbytes, nb * ops, name, tag)
                rec[kname].append(dict(
                    dtype=tag, d=d, batch=nb, max_abs_err=aerr,
                    max_rel_err=err, ms=ms, call_ms=call_ms,
                    plain_ms=plain_ms, library_ms=library_ms,
                    library_call_ms=library_call_ms, bound_ms=bms,
                    bound_by=by, bytes=nbytes, flops=nb * ops))
                log('kernel {} {} d={} B={}: max_rel_err={:.3e} '
                    'max_abs_err={:.3e} ms={:.5f} (device; {:.5f} a call '
                    'in a host loop) plain_ms={:.4f} library_ms={:.5f} '
                    '(device; {:.5f} a call) bound_us={:.3f} ({})'.format(
                        kname, tag, d, nb, err, aerr, ms, call_ms, plain_ms,
                        library_ms, library_call_ms, bms * 1e3, by))
    return rec


def scan_system(dtype, batch, nodes, d=D, b=B_BORDER, seed=0):
    """Lanes-first inputs of the scan kernels in random_system's style,
    scaled so that every Schur pivot stays well conditioned: D = 4 I
    plus noise and E of norm about 1 / 2, F = 0.1 noise, and a border
    Kbb about -4 I that the eliminated terms push further from zero."""
    import torch
    rng = np.random.default_rng(seed)
    s = 0.5 / np.sqrt(d)
    Dm = s * rng.standard_normal((batch, nodes, d, d)) + 4.0 * np.eye(d)
    E = s * rng.standard_normal((batch, nodes, d, d))
    E[:, 0] = 0.0
    F = 0.1 * rng.standard_normal((batch, nodes, d, b))
    Kbb = 0.5 / np.sqrt(max(b, 1)) * rng.standard_normal((batch, b, b)) \
        - 4.0 * np.eye(b)
    r = rng.standard_normal((batch, nodes, d))
    rb = rng.standard_normal((batch, b))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device='cuda')
    return to(Dm), to(E), to(F), to(Kbb), to(r), to(rb)


def scan_counts(d, b, N, batch, es):
    """(bytes, FLOPs) of scan_factor and of scan_solve: each input read
    once, each output written once; each inverse counted as the pivoted
    inverse needs (``inv_flops``)."""
    mm = lambda m, n, q: m * n * (2 * q - 1)        # (m x q) @ (q x n)
    gj = inv_flops
    f_node = (2 * mm(d, d, d) + d * d + gj(d) + mm(d, b, d) + d * b
              + mm(d, b, d) + mm(b, b, d) + b * b)
    s_node = (2 * (mm(d, 1, d) + d) + mm(d, 1, d) + mm(b, 1, d) + b
              + mm(d, 1, b) + d + mm(d, 1, d))
    f_ops = batch * (N * f_node + (gj(b) + b * b if b else 0))
    s_ops = batch * (N * s_node + mm(b, 1, b) + b)
    f_bytes = es * batch * (2 * N * (2 * d * d + d * b) + 2 * b * b)
    s_bytes = es * batch * (N * (3 * d * d + d * b + 2 * d) + b * b + 2 * b)
    return (f_bytes, f_ops), (s_bytes, s_ops)


def check_scan_kernels(sk, name):
    """The scan factorization and solve kernels against their plain
    versions at every shape of SCAN_SHAPES, both dtypes (the solve on
    the kernel's factorization on both sides); timed L2-warm
    (``device_ms``) and L2-cold (``cold_ms``), the plain versions at the
    scan path's shape.  Returns {kernel: [records]}."""
    import torch
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device='cuda')
    rec = {'scan_factor': [], 'scan_solve': []}
    for batch, nodes in SCAN_SHAPES:
        for dtype in (torch.float32, torch.float64):
            tag = str(dtype).split('.')[-1]
            where = '{} B={} N={}'.format(tag, batch, nodes)
            Dm, E, F, Kbb, r, rb = scan_system(dtype, batch, nodes)
            fac = sk.scan_factor(Dm, E, F, Kbb)
            want = sk.scan_factor_plain(Dm, E, F, Kbb)
            sol = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
            sol_want = sk.scan_solve_plain(*fac[:3], E, fac[3], r, rb)
            torch.cuda.synchronize()
            main = (batch, nodes) == (BATCH, NODES)
            counts = scan_counts(D, B_BORDER, nodes, batch,
                                 Dm.element_size())
            for kname, got, ref, fn, plain_fn, (nbytes, ops) in (
                    ('scan_factor', fac, want,
                     lambda: sk.scan_factor(Dm, E, F, Kbb),
                     lambda: sk.scan_factor_plain(Dm, E, F, Kbb), counts[0]),
                    ('scan_solve', sol, sol_want,
                     lambda: sk.scan_solve(*fac[:3], E, fac[3], r, rb),
                     lambda: sk.scan_solve_plain(*fac[:3], E, fac[3], r, rb),
                     counts[1])):
                errs = [rel_err(g, w) for g, w in zip(got, ref)]
                aerr = max(e[0] for e in errs)
                err = max(e[1] for e in errs)
                if not all(torch.isfinite(g).all().item() for g in got) \
                        or err > TOL_SCAN[tag]:
                    fail('{} {}: rel err {:.3e} > {:.0e}'.format(
                        kname, where, err, TOL_SCAN[tag]))
                ms = device_ms(fn)[0]
                cold = cold_ms(fn, flush)
                plain_ms = timed(plain_fn, 2, 1) if main else None
                bms, by = bound(nbytes, ops, name, tag)
                rec[kname].append(dict(
                    dtype=tag, batch=batch, nodes=nodes, max_abs_err=aerr,
                    max_rel_err=err, ms=ms, cold_ms=cold,
                    us_per_node=cold / nodes * 1e3, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, bytes=nbytes, flops=ops))
                log('kernel {} {}: max_rel_err={:.3e} max_abs_err={:.3e} '
                    'ms warm={:.5f} cold={:.5f} ({:.4f} us a node) '
                    'plain_ms={} bound_us={:.2f} ({}; {:.2f} MB, {:.4f} '
                    'GFLOP) cold/bound={:.1f}'.format(
                        kname, where, err, aerr, ms, cold,
                        cold / nodes * 1e3,
                        'not timed' if plain_ms is None
                        else '{:.4f}'.format(plain_ms), bms * 1e3, by,
                        nbytes / 1e6, ops / 1e9, cold / bms))
    del flush
    return rec


def empty_kernel_ms(bk):
    """Device time of an empty kernel's launch, back to back, and of a
    call in a host loop: the floor any single launch pays."""
    import torch
    dev = torch.device('cuda')
    ms, host_ms = device_ms(lambda: bk.empty_launch(dev), reps=200)
    call_ms = timed(lambda: bk.empty_launch(dev), 200)
    log('kernel empty_launch: ms={:.5f} (device, back to back) {:.5f} (a '
        'call in a host loop; host {:.2f} us a call)'.format(
            ms, call_ms, host_ms * 1e3))
    return dict(ms=ms, call_ms=call_ms, host_ms=host_ms)


def reference_setup(dev, kkt_method):
    """Phase 4's problem (N = 101 swing-up, torque bound 20, float64
    factorization, monotone mu, no second-order correction) on ``dev``
    and its start."""
    import torch
    from opty_tpu_torch.models import swing_up_problem
    prob = swing_up_problem(num_nodes=101, torque_bound=20.0, device=dev)
    prob.set_solver_options(kkt_method=kkt_method,
                            factor_dtype=torch.float64,
                            mu_strategy='monotone', use_soc=False)
    return prob, np.random.default_rng(29).normal(size=prob.num_free)


def reference_solve(kkt_method, counters, child):
    """N = 101 swing-up, float64 factorization: the card (kernels)
    against the CPU (plain versions; the first line of ``child``, the
    CPU reference process of ``kkt_method``, started at the beginning).
    Returns the card solve's launch counts (``counters``: the kernel
    modules)."""
    import torch
    prob, x0 = reference_setup('cuda', kkt_method)
    torch.cuda.synchronize()
    reset_counts(*counters)
    xg, ig = prob.solve(x0)
    torch.cuda.synchronize()
    launches = launch_counts(*counters)
    line = child.stdout.readline()
    if not line:
        child.wait(timeout=60)
        fail('the CPU reference of phase 4 ({}) failed:\n{}'.format(
            kkt_method, child.stderr.read()[-2000:]))
    ic = json.loads(line)
    xc = np.asarray(ic['x'])
    rel = abs(ig['obj_val'] - ic['obj_val']) / abs(ic['obj_val'])
    dx = float(np.max(np.abs(xg - xc)))
    log('reference N=101 {}: card status={} iters={} obj={:.10g}; cpu '
        'status={} iters={} obj={:.10g}; obj rel diff={:.2e} max|dx|={:.2e}; '
        'card launches={}'.format(
            kkt_method, ig['status'], ig['iterations'], ig['obj_val'],
            ic['status'], ic['iterations'], ic['obj_val'], rel, dx,
            json.dumps(launches)))
    if ig['status'] not in (0, 1) or ig['status'] != ic['status'] \
            or ig['iterations'] != ic['iterations'] or rel > 1e-8 \
            or dx > 1e-6:
        fail('card and CPU {} solves disagree on the reference problem'
             .format(kkt_method))
    return launches


def launch_counts(pk, bk, sk):
    """The kernels' launch counters."""
    return {'pcr_factor_levels': pk.factor_launches,
            'pcr_downsweep': pk.downsweep_launches,
            'block_inv': bk.inv_launches,
            'block_matmul': bk.matmul_launches,
            'scan_factor': sk.factor_launches,
            'scan_solve': sk.solve_launches,
            'pcr_factor_levels_wide': pk.wide_factor_launches,
            'pcr_downsweep_wide': pk.wide_downsweep_launches,
            'block_inv_wide': bk.wide_inv_launches,
            'scan_factor_wide': sk.wide_factor_launches,
            'scan_solve_wide': sk.wide_solve_launches}


def reset_counts(pk, bk, sk):
    pk.reset_launch_counts()
    bk.reset_launch_counts()
    sk.reset_launch_counts()


def check_solutions(prob, x, ok, n):
    """Finite solutions of the right shape that satisfy the torque
    bound; returns the worst violation of the dynamics and the boundary
    conditions over the converged lanes."""
    if x.shape != (n, prob.num_free) or not np.all(np.isfinite(x[ok])):
        fail('solutions have the wrong shape or are not finite')
    N = prob.collocator.num_collocation_nodes
    worst = 0.0
    for lane in np.where(ok)[0]:
        con = prob.constraints(x[lane])
        worst = max(worst, float(np.max(np.abs(con))),
                    abs(x[lane][N - 1] - np.pi), abs(x[lane][0]))
        if np.max(np.abs(x[lane][2 * N:])) > 2.0 + 1e-8:
            fail('torque bound violated on lane {}'.format(lane))
    return worst


def queue_path(counters, label, options, required, forbidden=(),
               mean_limit=52.0):
    """The first 64 rows of bench.py's queue (default_rng(7), N = 501)
    through ``solve_queue`` on 32 refilled lanes with ``options``
    (``set_solver_options``; ``max_iter=200`` and ``chunk_iters=20``
    always); launch counters reset just before and read just after.
    Holds the queue to PERF.md's limits (>= 60/64 converged, mean
    iterations <= ``mean_limit``, converged solutions within 1e-6 of
    their constraints) and fails unless every kernel of ``required`` was
    launched and none of ``forbidden``.  Returns (launches, wall
    seconds, mean iterations)."""
    import torch
    from opty_tpu_torch.models import swing_up_problem
    prob = swing_up_problem(num_nodes=NODES)          # the card by default
    prob.set_solver_options(max_iter=200, chunk_iters=20, **options)
    queue = np.random.default_rng(7).standard_normal((64, prob.num_free))
    chunks = []
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.time()
    res = prob.solve_queue(queue, batch_size=BATCH,
                           progress=lambda d, n, dt: chunks.append(dt))
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts(*counters)

    status = np.asarray(res.status)
    iters = np.asarray(res.iterations)
    rest = np.asarray(res.rest_total)
    ok = (status == 0) | (status == 1)
    restored = {int(i): int(rest[i]) for i in np.where(rest > 0)[0]}
    mono = [int(i) for i in np.where(np.asarray(res.mono))[0]]
    log('{}: {}: converged {}/64 (status 0/1), iterations mean={:.2f} '
        'p50={} p90={} max={}, wall_s={:.2f} ({:.3f} solves/s), chunks={}, '
        'launches={}'.format(
            label, describe(options),
            int(ok.sum()), float(iters.mean()),
            int(np.percentile(iters, 50)), int(np.percentile(iters, 90)),
            int(iters.max()), wall, 64 / wall, len(chunks),
            json.dumps(launches)))
    log('{} statuses: {}; fell back to monotone mu: {} rows {}; entered '
        'restoration: {} rows, restoration iterations {}'.format(
            label, json.dumps({int(s): int(np.sum(status == s))
                               for s in np.unique(status)}),
            len(mono), mono, len(restored), json.dumps(restored)))
    worst = check_solutions(prob, np.asarray(res.x), ok, 64)
    log('{}: worst constraint / boundary violation over converged lanes = '
        '{:.3e}'.format(label, worst))
    if worst > 1e-6:
        fail('{}: converged solutions violate their constraints'.format(
            label))
    for kname in required:
        if launches[kname] == 0:
            fail('{} was not launched on the {}'.format(kname, label))
    for kname in forbidden:
        if launches[kname] != 0:
            fail('{} was launched {} times on the {}'.format(
                kname, launches[kname], label))
    if ok.sum() < 60:
        fail('{}: only {}/64 lanes converged'.format(label, int(ok.sum())))
    if iters.mean() > mean_limit:
        fail('{}: mean iterations {:.2f} > {:.2f}'.format(
            label, float(iters.mean()), mean_limit))
    return launches, wall, float(iters.mean())


def describe(options):
    return json.dumps({k: str(v).split('.')[-1] for k, v in
                       options.items()}) if options else 'default options'


def rest_solve(dev, kkt_method, seed):
    """One phase-4c solve: N = 101, torque bound 20, float64
    factorization, every other option at its default."""
    import torch
    from opty_tpu_torch.models import swing_up_problem
    prob = swing_up_problem(num_nodes=101, torque_bound=20.0, device=dev)
    prob.set_solver_options(kkt_method=kkt_method,
                            factor_dtype=torch.float64)
    x0 = np.random.default_rng(seed).normal(size=prob.num_free)
    t0 = time.time()
    _, info = prob.solve(x0)
    return dict(status=info['status'], iterations=info['iterations'],
                rest=info['rest_iterations'], mono=info['mono_fallback'],
                obj=info['obj_val'], wall_s=time.time() - t0)


def cpu_reference(kkt_method):
    """``--cpu-reference METHOD``: phase 4's and then phase 4c's CPU
    solves (the plain versions), one JSON line each, in a child process;
    ``nlink``: phase 7a's solve on the CPU (NLINK_CPU records it)."""
    import torch
    sys.path.insert(0, HERE)
    if kkt_method == 'nlink':
        prob, guess = nlink_problem('cpu')
        _, rec = nlink_solve(prob, guess, torch.float64)
        print(json.dumps(dict(rec, threads=torch.get_num_threads())),
              flush=True)
        return
    torch.set_num_threads(1)
    prob, x0 = reference_setup('cpu', kkt_method)
    x, info = prob.solve(x0)
    print(json.dumps(dict(x=x.tolist(), status=info['status'],
                          iterations=info['iterations'],
                          obj_val=info['obj_val'])), flush=True)
    for seed in REST_SEEDS:
        print(json.dumps(dict(seed=seed, **rest_solve('cpu', kkt_method,
                                                      seed))), flush=True)


def nlink_problem(dev):
    """The nlink-9 chain's reach at N = 60 (models/nlink.py) on ``dev``
    and its inverse-dynamics initial guess."""
    from opty_tpu_torch.models.nlink import (n_link_cart_problem,
                                             n_link_initial_guess)
    prob, q_start = n_link_cart_problem(NLINK_LINKS, NLINK_NODES,
                                        device=dev)
    return prob, n_link_initial_guess(prob, q_start)


def nlink_solve(prob, guess, factor_dtype, kkt_method='cr',
                base=NLINK_OPTIONS, **options):
    """One phase-7 solve: ``base`` (NLINK_OPTIONS; ``options`` override
    them), ``kkt_method``, a ``factor_dtype`` factorization.  Returns
    (x, record)."""
    import torch
    prob.set_solver_options(kkt_method=kkt_method, factor_dtype=factor_dtype,
                            **dict(base, **options))
    t0 = time.time()
    x, info = prob.solve(guess)
    if prob.device.type == 'cuda':
        torch.cuda.synchronize()
    return x, dict(status=info['status'], iterations=info['iterations'],
                   obj=info['obj_val'], inf_pr=info['inf_pr'],
                   inf_du=info['inf_du'], delta_w=info['delta_w'],
                   wall_s=time.time() - t0)


def start_cpu_references(methods):
    """The CPU sides of phases 4 and 4c, one child process per KKT
    method, started before the card's phases so that they overlap
    them."""
    children = {}
    for method in methods:
        children[method] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), '--cpu-reference',
             method], cwd=HERE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        children[method].log_file = None
    return children


def restoration_phase(counters, kkt_method, child, required):
    """Phase 4c for one KKT method: the card's default-option solves
    from REST_SEEDS against the CPU's (``child``); the launches inside
    restoration visits are counted by wrapping
    ``steps.restoration_solve``.  Returns the card's launches inside
    the visits."""
    import torch
    from opty_tpu_torch.nlp import steps
    inner = {k: 0 for k in launch_counts(*counters)}
    visits = [0]
    solve_visit = steps.restoration_solve

    def counted(*args, **kwargs):
        before = launch_counts(*counters)
        out = solve_visit(*args, **kwargs)
        torch.cuda.synchronize()
        for k, v in launch_counts(*counters).items():
            inner[k] += v - before[k]
        visits[0] += 1
        return out

    card = {}
    torch.cuda.synchronize()
    reset_counts(*counters)
    steps.restoration_solve = counted
    try:
        for seed in REST_SEEDS:
            card[seed] = rest_solve('cuda', kkt_method, seed)
    finally:
        steps.restoration_solve = solve_visit
    torch.cuda.synchronize()
    launches = launch_counts(*counters)
    # the rest of the child's lines (phase 4 read its first)
    out = child.stdout.read()
    err = child.stderr.read()
    child.wait(timeout=900)
    if child.returncode != 0:
        fail('the CPU reference of phase 4c ({}) failed:\n{}'.format(
            kkt_method, err[-2000:]))
    cpu = {}
    for line in out.splitlines():
        rec = json.loads(line)
        cpu[rec.pop('seed')] = rec
    for seed in REST_SEEDS:
        g, c = card[seed], cpu[seed]
        rel = abs(g['obj'] - c['obj']) / abs(c['obj'])
        log('restoration N=101 {} seed {}: card status={} iters={} rest={} '
            'mono={} obj={:.12g} wall_s={:.1f}; cpu status={} iters={} '
            'rest={} mono={} obj={:.12g} wall_s={:.1f}; obj rel diff={:.2e}'
            .format(kkt_method, seed, g['status'], g['iterations'],
                    g['rest'], g['mono'], g['obj'], g['wall_s'],
                    c['status'], c['iterations'], c['rest'], c['mono'],
                    c['obj'], c['wall_s'], rel))
        if g['status'] not in (0, 1) or g['status'] != c['status'] \
                or abs(g['iterations'] - c['iterations']) > REST_ITER_SLACK \
                or g['rest'] == 0 or c['rest'] == 0 or rel > REST_OBJ_TOL:
            fail('card and CPU default-option {} solves disagree from seed '
                 '{}'.format(kkt_method, seed))
    log('restoration N=101 {}: card launches {} in all, {} inside {} '
        'restoration visits'.format(kkt_method, json.dumps(launches),
                                    json.dumps(inner), visits[0]))
    for kname in required:
        if inner[kname] == 0:
            fail('{} was not launched inside the {} restoration visits'
                 .format(kname, kkt_method))
    return inner


def iteration_profile(counters, label, lanes, iters, options, setup=None):
    """Where an iteration's time goes: one cold batch of ``lanes`` lanes
    for ``iters`` iterations (the initialization included) with
    ``options``, once counting host syncs (torch's sync debug mode warns
    on each) and once under torch.profiler, tracing the device only, for
    its busy time.  The problem is the swing-up at N = NODES from rows
    of bench.py's queue, or ``setup(lanes)`` -> (problem, starts).
    Returns ({kernel: device ms per call in the solve} of the
    hand-written kernels the profile saw, {kernel: launches per
    iteration})."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    from opty_tpu_torch.models import swing_up_problem
    if setup is None:
        prob = swing_up_problem(num_nodes=NODES)
        free = np.random.default_rng(7).standard_normal((lanes,
                                                         prob.num_free))
    else:
        prob, free = setup(lanes)
    prob.set_solver_options(**dict(options, max_iter=iters))
    prob.solve_batch(free)                       # warm caches and allocator
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.time()
    prob.solve_batch(free)
    torch.cuda.synchronize()
    plain_wall = time.time() - t0
    launched = launch_counts(*counters)
    per_iter = {k: n / iters for k, n in launched.items()}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            prob.solve_batch(free)
        finally:
            torch.cuda.set_sync_debug_mode('default')
    syncs = sum('synchroniz' in str(w.message) for w in caught)

    torch.cuda.synchronize()
    t0 = time.time()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prob.solve_batch(free)
        torch.cuda.synchronize()
    wall = time.time() - t0
    events = device_events(prof)
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        fail('profile {}: the profiler recorded no device time'.format(label))
    launches = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    log('profile {}: {} lanes x {} iterations (init included): wall_s={:.3f} '
        '(plain run) {:.3f} (under the profiler) device_busy_s={:.4f} '
        'idle_share={:.4f} (of the profiled wall) device_kernels={} '
        'host_syncs={} (per iteration: {:.1f} kernels, {:.1f} syncs, '
        '{:.1f} ms wall)'.format(
            label, lanes, iters, plain_wall, wall, busy_us / 1e6,
            1.0 - busy_us / 1e6 / wall, launches, syncs, launches / iters,
            syncs / iters, plain_wall / iters * 1e3))
    log('profile {}: counted launches per iteration: {}'.format(
        label, json.dumps(per_iter)))
    for e in top:
        log('profile {} top: {:.3f} ms in {} launches of {} ({:.2f} us '
            'each)'.format(label, e.self_device_time_total / 1e3, e.count,
                           e.key[:90], e.self_device_time_total / e.count))
    in_solve = in_solve_times(events)
    for kname, ms in in_solve.items():
        log('profile {} {}: {:.2f} us per call in the solve'.format(
            label, kname, ms * 1e3))
    return in_solve, per_iter


def dmma_in_sass():
    """The FP64 tensor-core instructions (DMMA) in each double-precision
    kernel of csrc/wide.cu and csrc/scan_wide.cu, read from the built
    libraries by cuobjdump -sass; fails where a kernel that multiplies
    d x d blocks in float64 has none."""
    import glob
    import shutil
    from opty_tpu_torch.ops.cuda_build import BUILD_DIR
    tool = shutil.which('cuobjdump') or os.path.join(
        os.environ.get('CUDA_HOME', '/usr/local/cuda'), 'bin', 'cuobjdump')
    if not os.path.exists(tool):
        fail('sass: cuobjdump not found (PATH, CUDA_HOME/bin): the DMMA '
             'of the float64 wide kernels cannot be checked')
    counts = {}
    for stem in ('wide', 'scan_wide'):
        for lib in glob.glob(str(BUILD_DIR / (stem + '-*.so'))):
            fn = None
            sass = subprocess.run([tool, '-sass', lib], capture_output=True,
                                  text=True, check=True).stdout
            for line in sass.splitlines():
                if 'Function :' in line:
                    fn = line.split('Function :')[1].strip()
                    counts.setdefault(fn, 0)
                elif fn is not None and 'DMMA' in line:
                    counts[fn] += 1
    for fn, n in sorted(counts.items()):
        log('sass: {} DMMA instructions in {}'.format(n, fn))
    for kernel in ('pcr_wide_levelId', 'pcr_wide_initId',
                   'block_inv_wide_kernelId', 'scan_wide_factorId'):
        if not any(kernel in fn and n for fn, n in counts.items()):
            fail('sass: no DMMA in {}'.format(kernel))


def phase(title, fn, *args, **kwargs):
    t0 = time.time()
    out = fn(*args, **kwargs)
    log('phase {}: {:.1f} s'.format(title, time.time() - t0))
    return out


# (name, source, the TPU kernel it replaces, its device functions: the
# first launches once per call)
KERNELS = (
    ('pcr_factor_levels', 'opty_tpu_torch/csrc/pcr.cu',
     'opty_tpu/ops/pallas_pcr.py:216', ('pcr_factor_kernel',)),
    ('pcr_downsweep', 'opty_tpu_torch/csrc/pcr.cu',
     'opty_tpu/ops/pallas_pcr.py:250', ('pcr_downsweep_kernel',)),
    ('block_inv', 'opty_tpu_torch/csrc/blocks.cu',
     'opty_tpu/ops/pallas_blocks.py:42', ('block_inv_kernel',)),
    ('block_matmul', 'opty_tpu_torch/csrc/blocks.cu',
     'opty_tpu/ops/pallas_blocks.py:84', ('block_matmul_kernel',)),
    ('scan_factor', 'opty_tpu_torch/csrc/scan.cu',
     'opty_tpu/ops/pallas_blocks.py:42,84', ('scan_factor_kernel',)),
    ('scan_solve', 'opty_tpu_torch/csrc/scan.cu',
     'opty_tpu/ops/pallas_blocks.py:42,84', ('scan_solve_kernel',)),
    ('pcr_factor_levels_wide', 'opty_tpu_torch/csrc/wide.cu',
     'opty_tpu/ops/pallas_pcr.py:216', ('pcr_wide_init', 'pcr_wide_level')),
    ('pcr_downsweep_wide', 'opty_tpu_torch/csrc/wide.cu',
     'opty_tpu/ops/pallas_pcr.py:250', ('pcr_wide_downsweep',)),
    ('block_inv_wide', 'opty_tpu_torch/csrc/wide.cu',
     'opty_tpu/ops/pallas_blocks.py:42', ('block_inv_wide_kernel',)),
    ('scan_factor_wide', 'opty_tpu_torch/csrc/scan_wide.cu',
     'opty_tpu/ops/pallas_blocks.py:42,84', ('scan_wide_factor',)),
    ('scan_solve_wide', 'opty_tpu_torch/csrc/scan_wide.cu',
     'opty_tpu/ops/pallas_blocks.py:42,84', ('scan_wide_solve',)),
)
WIDE_KERNELS = ('pcr_factor_levels_wide', 'pcr_downsweep_wide',
                'block_inv_wide')
WIDE_SCAN_KERNELS = ('scan_factor_wide', 'scan_solve_wide')
PCR_KERNELS = ('pcr_factor_levels', 'pcr_downsweep',
               'pcr_factor_levels_wide', 'pcr_downsweep_wide')


class DeviceEvent(NamedTuple):
    """A device function's time in a torch.profiler run, as an entry of
    ``key_averages()`` gives it (the fields the phases read)."""
    key: str                        # the demangled kernel name
    count: int                      # launches
    self_device_time_total: float   # microseconds in all


def device_events(prof):
    """The device's events of a finished torch.profiler run summed by
    name, read from the raw trace: ``key_averages()`` builds every event
    of the host's too and took 30-42 s on a two-iteration nlink-9 profile
    of 8 lanes (H100 80GB HBM3, 700.00 W; the same sums)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    total, count = {}, {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            name = e.name()
            total[name] = total.get(name, 0.0) + e.duration_ns() / 1e3
            count[name] = count.get(name, 0) + 1
    demangle = lambda n: torch._C._demangle(n) if len(n) > 1 else n
    return [DeviceEvent(demangle(n), count[n], total[n]) for n in total]


def in_solve_times(events):
    """{kernel: device ms per call} over the profiler's events of the
    hand-written kernels (every instantiation of a kernel together; a
    call of the wide factor is one pcr_wide_init and L pcr_wide_level
    launches), and {device function: device ms per launch}."""
    total, calls, per_launch = {}, {}, {}
    for e in events:
        for kname, _, _, symbols in KERNELS:
            for i, symbol in enumerate(symbols):
                if symbol + '<' not in e.key:
                    continue
                total[kname] = total.get(kname, 0.0) \
                    + e.self_device_time_total
                if i == 0:
                    calls[kname] = calls.get(kname, 0) + e.count
                t, c = per_launch.get(symbol, (0.0, 0))
                per_launch[symbol] = (t + e.self_device_time_total,
                                      c + e.count)
    out = {k: total[k] / calls[k] / 1e3 for k in total if calls.get(k)}
    out.update({'launch ' + s: t / c / 1e3
                for s, (t, c) in per_launch.items()})
    return out


def pick(records, **where):
    return next(r for r in records
                if all(r[k] == v for k, v in where.items()))


STEP_FIELDS = ('x', 'y', 'zL', 'zU', 'mono', 'mu')


class CPUSteps:
    """The client of a step server (``step_server``), a child process
    that takes the CPU's one-iteration steps from the card's states
    while the card goes on.  ``submit(key, name, options, state)``
    hands it an IPMState (numpy arrays) of problem ``name`` (None: the
    first iteration from the problem's start); ``collect()`` waits for
    every step submitted and returns {key: the next iterate's
    STEP_FIELDS}.  ``of(child)`` is the client of a child this process
    started; another process gets the child's pipes as file objects."""

    def __init__(self, stdin, stdout, log_file=None):
        import tempfile
        self.stdin, self.stdout, self.log_file = stdin, stdout, log_file
        self.tmp = tempfile.mkdtemp(prefix='chip_smoke_steps_')
        self.pending, self.seconds = {}, 0.0

    @classmethod
    def of(cls, child):
        return cls(child.stdin, child.stdout, child.log_file)

    def submit(self, key, name, options, state=None):
        path = os.path.join(self.tmp, '{}.npz'.format(len(self.pending)))
        req = dict(name=name, path=path, options=options)
        if state is not None:
            np.savez(path, **state)
            req['state'] = True
        self.stdin.write(json.dumps(req) + '\n')
        self.stdin.flush()
        self.pending[key] = path

    def collect(self):
        out = {}
        for key, path in self.pending.items():
            line = self.stdout.readline()
            if not line:
                log_text = ''
                if self.log_file is not None:
                    self.log_file.seek(0)
                    log_text = self.log_file.read()[-3000:]
                fail('the CPU step server failed: {}'.format(log_text))
            self.seconds += json.loads(line)['seconds']
            with np.load(path + '.cpu.npz') as z:
                out[key] = {f: z[f] for f in STEP_FIELDS}
        self.pending = {}
        return out


NLINK_NAME = 'nlink-9'


def step_server(names):
    """``--step-server NAME ...``: the CPU side of ``CPUSteps``.  Builds
    each named problem on the CPU when it starts (NLINK_NAME: phase 7's
    chain and its guess; any other name: the gallery problem at its
    defaults and its documented start), then for each request on stdin
    ({"name", "path", "options", "state"}) takes one iteration, with a
    float64 factorization (the plain versions) and ``options``
    (kkt_method and IPM options on top of the problem's defaults), from
    the IPMState saved at ``path`` (without "state": the first iteration
    from the problem's start), saves the next iterate's STEP_FIELDS
    beside it (path + '.cpu.npz') and prints one JSON line."""
    import torch
    sys.path.insert(0, HERE)
    from opty_tpu_torch import interop
    from opty_tpu_torch.examples import gallery
    torch.set_num_threads(STEP_THREADS)
    built = {name: nlink_problem('cpu') if name == NLINK_NAME
             else gallery.build(name, device='cpu') for name in names}
    for line in sys.stdin:
        req = json.loads(line)
        t0 = time.time()
        prob, guess = built[req['name']]
        prob.set_solver_options(factor_dtype=torch.float64, chunk_iters=1,
                                **req['options'])
        _, run_cold, run_resume = prob._build_solver()
        free = prob._as_tensor(guess)[None]
        if req.get('state'):
            with np.load(req['path']) as z:
                state = interop.state_from_numpy(
                    {k: z[k] for k in z.files}, 'cpu')
            _, nxt = run_resume(free, state)
        else:
            _, nxt = run_cold(free)
        np.savez(req['path'] + '.cpu.npz',
                 **{f: getattr(nxt, f).numpy() for f in STEP_FIELDS})
        print(json.dumps(dict(name=req['name'], seconds=time.time() - t0)),
              flush=True)


def start_step_server(names):
    """Starts ``step_server`` for ``names`` in a child process (its
    stdin and stdout pipes, its stderr in a temporary file)."""
    import tempfile
    log_file = tempfile.TemporaryFile('w+')
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--step-server']
        + list(names), cwd=HERE, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=log_file, text=True)
    child.log_file = log_file
    return child


def solve_with_crossovers(prob, guess, factor_dtype, kkt_method, ks, cpu,
                          name=NLINK_NAME, base=NLINK_OPTIONS, states=None,
                          **options):
    """``nlink_solve`` (``base`` with ``options``) through
    ``Problem.solve`` in chunks that end at the iteration counts ``ks``
    (the first chunk one iteration; each chunk runs the solve's own
    states, bitwise those of a run in one chunk), and at each k the
    card's state is handed to the step server ``cpu`` (a ``CPUSteps``,
    which built problem ``name``), which takes one iteration from it
    while the card goes on; after the solve the two next iterates are
    compared: {'x', 'y', 'zL', 'zU': max |difference| / max |card's|,
    'mono_equal', 'mu'}.  ``states``, a dict, receives {k: {'state':
    the shared state, 'card': the card's next iterate}} (numpy).
    Returns (x, record, {k: comparison})."""
    rel = lambda a, b: float(np.max(np.abs(a - b))
                             / max(np.max(np.abs(b)), 1e-300))
    card, spent, resumes = {}, [0.0], {}
    solve_options = dict(base, **options)
    last = solve_options['max_iter']
    cpu_options = dict(solve_options, kkt_method=kkt_method)

    def resume(chunk):
        """The card solver's run_resume running ``chunk`` iterations a
        call (the chunk is fixed when the solver is built)."""
        if chunk not in resumes:
            saved, prob._chunk_iters = prob._chunk_iters, chunk
            try:
                resumes[chunk] = prob._build_solver()[2]
            finally:
                prob._chunk_iters = saved
        return resumes[chunk]

    drain = prob._drain

    def drain_with_crossovers(run_resume, free, res, state):
        def step(free_, st):
            k = int(st.it[0])
            if k not in ks:
                later = [j for j in ks if j > k]
                return resume(min(later) - k if later else last)(free_, st)
            res_, nxt = resume(1)(free_, st)
            t0 = time.time()
            shared = {f: v.detach().cpu().numpy()
                      for f, v in st._asdict().items()}
            card[k] = {f: getattr(nxt, f).cpu().numpy() for f in STEP_FIELDS}
            if states is not None:
                states[k] = dict(state=shared, card=card[k])
            cpu.submit(k, name, cpu_options, shared)
            spent[0] += time.time() - t0
            return res_, nxt
        return drain(step, free, res, state)

    prob._drain = drain_with_crossovers
    try:
        x, rec = nlink_solve(prob, guess, factor_dtype, kkt_method, base,
                             chunk_iters=1, **options)
    finally:
        del prob._drain
        prob.set_solver_options(chunk_iters=None)
    got = cpu.collect()
    out = {k: dict(mu=float(card[k]['mu'][0]),
                   mono_equal=bool(card[k]['mono'][0] == got[k]['mono'][0]),
                   **{f: rel(got[k][f][0], card[k][f][0])
                      for f in ('x', 'y', 'zL', 'zU')})
           for k in card}
    rec['wall_s'] -= spent[0]
    rec['crossover_s'] = spent[0]
    return x, rec, out


def nlink_path(counters, label, prob, guess, factor_dtype, reference=None,
               kkt_method='cr', required=None, forbidden=(), crossovers=None,
               cpu=None, step_tol=None, **options):
    """Phase 7: the nlink-9 solve on the card through ``Problem.solve``
    (NLINK_OPTIONS with ``options``, ``kkt_method``, a ``factor_dtype``
    factorization); counters reset just before and read just after.
    Fails unless every kernel of ``required`` (default: the wide PCR
    kernels) was launched and none of ``forbidden``, and the solution
    is finite and, where converged, feasible (every constraint within
    NLINK_VIOLATION of its status).  With a ``reference`` (the
    CPU's record) it prints whether the two agree in status, iterations
    (within NLINK_ITER_SLACK) and objective (NLINK_OBJ_TOL).  With
    ``crossovers`` (iteration counts) the solve runs in chunks that end
    there and takes them on the way (``solve_with_crossovers``), and it
    fails unless the solve converged and one iteration from the card's
    state at each count, card against CPU (``cpu``, a ``CPUSteps`` whose
    server built NLINK_NAME), agrees to NLINK_STEP_TOL.  Returns
    (launches, record)."""
    import torch
    torch.cuda.synchronize()
    reset_counts(*counters)
    if crossovers is None:
        x, rec = nlink_solve(prob, guess, factor_dtype, kkt_method,
                             **options)
    else:
        x, rec, steps = solve_with_crossovers(
            prob, guess, factor_dtype, kkt_method, crossovers, cpu,
            **options)
    launches = launch_counts(*counters)
    if x.shape != (prob.num_free,) or not np.all(np.isfinite(x)):
        fail('{}: the solution has the wrong shape or is not finite'.format(
            label))
    worst = float(np.max(np.abs(prob.constraints(x))))
    history = prob.obj_value
    log('{}: nlink-{} N={} kkt_method={} factor {}: status={} iterations={} '
        'obj={:.12g} inf_pr={:.3e} inf_du={:.3e} delta_w={:.3e} worst '
        'constraint={:.3e} wall_s={:.2f} ({:.1f} ms an iteration); '
        'objective after iterations 30/60/150/300: {}; launches={}'.format(
            label, NLINK_LINKS, NLINK_NODES, kkt_method,
            str(factor_dtype).split('.')[-1], rec['status'],
            rec['iterations'], rec['obj'], rec['inf_pr'], rec['inf_du'],
            rec['delta_w'], worst, rec['wall_s'],
            rec['wall_s'] / max(rec['iterations'], 1) * 1e3,
            [float(history[k - 1]) for k in (30, 60, 150, 300)
             if k <= len(history)], json.dumps(launches)))
    for kname in (WIDE_KERNELS if required is None else required):
        if launches[kname] == 0:
            fail('{} was not launched on the {}'.format(kname, label))
    for kname in forbidden:
        if launches[kname] != 0:
            fail('{} was launched {} times on the {}'.format(
                kname, launches[kname], label))
    if rec['status'] in NLINK_VIOLATION \
            and not worst <= NLINK_VIOLATION[rec['status']]:
        fail('{}: the status-{} solution violates its constraints by {:.3e} '
             '(limit {:.0e})'.format(label, rec['status'], worst,
                                     NLINK_VIOLATION[rec['status']]))
    if reference is not None:
        rel = abs(rec['obj'] - reference['obj']) / abs(reference['obj'])
        log('{}: the CPU (plain versions, recorded): status={} iterations={} '
            'obj={:.12g}; obj rel diff={:.2e}'.format(
                label, reference['status'], reference['iterations'],
                reference['obj'], rel))
        met = (rec['status'] == reference['status']
               and abs(rec['iterations'] - reference['iterations'])
               <= NLINK_ITER_SLACK and rel <= NLINK_OBJ_TOL)
        log('{}: card against the CPU run, the same status, iterations '
            'within {} and objectives within {:.0e} relative: {}'.format(
                label, NLINK_ITER_SLACK, NLINK_OBJ_TOL,
                'met' if met else 'NOT MET (see the one-iteration '
                'crossovers below)'))
    if crossovers is not None:
        if rec['status'] not in (0, 1):
            fail('{}: the float64 solve did not converge'.format(label))
        missing = [k for k in crossovers
                   if k < rec['iterations'] and k not in steps]
        if missing:
            fail('{}: no crossover at iterations {}'.format(label, missing))
        tol = {k: (step_tol or {}).get(k, NLINK_STEP_TOL) for k in steps}
        worst = {k: max(v[f] for f in ('x', 'y', 'zL', 'zU'))
                 for k, v in steps.items()}
        log('{}: one iteration from the card\'s state at iterations {}, card '
            'against CPU: largest relative difference of x, y, zL, zU {} '
            '(limits {}; {})'.format(
                label, sorted(steps),
                {k: '{:.3e}'.format(v) for k, v in worst.items()},
                {k: '{:.0e}'.format(v) for k, v in tol.items()},
                json.dumps(steps)))
        if any(worst[k] > tol[k] for k in steps) \
                or not all(v['mono_equal'] for v in steps.values()):
            fail('{}: an iteration from a shared state differs between the '
                 'card and the CPU'.format(label))
    return launches, rec


def sweep_in_solve(prob, guess, iters=1):
    """The wide downsweep's device time a call inside phase 7a's solve:
    its first ``iters`` iterations (the initialization included) again
    under torch.profiler (the device only).  Returns (ms a call, calls
    profiled)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    prob.set_solver_options(kkt_method='cr', factor_dtype=torch.float64,
                            **dict(NLINK_OPTIONS, max_iter=iters))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prob.solve(guess)
        torch.cuda.synchronize()
    prob.set_solver_options(max_iter=NLINK_OPTIONS['max_iter'])
    calls, total = 0, 0.0
    for e in device_events(prof):
        if 'pcr_wide_downsweep<' in e.key:
            calls += e.count
            total += e.self_device_time_total
    if not calls:
        fail('7a: the profiler saw no wide downsweep in the solve')
    return total / calls / 1e3, calls


# the hooks of the reproducibility probe (phase 7d): module attributes
# through which the solver reaches its steps, fingerprinted in call order
REPRO_HOOKS = (('opty_tpu_torch.ops.pcr_kernels', ('pcr_factor_levels',
                                                    'pcr_downsweep')),
               ('opty_tpu_torch.ops.block_kernels', ('block_inv',)),
               ('opty_tpu_torch.ops.tridiag', ('pcr_factor', 'pcr_solve')))
REPRO_ITERS = 30


def fingerprint(obj, out):
    """Append to ``out``, for each tensor in ``obj`` (nested tuples,
    lists, dicts, named tuples), the sum of its bit patterns in 16-bit
    words, reduced on its device (exact in 64 bits below 2^47 words):
    equal tensors give equal sums, and a change in any bit almost surely
    changes it.  Every NaN counts as one pattern: its payload, which
    differs between ways of making a NaN, says nothing of the solve."""
    import torch
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.is_floating_point():
            t = torch.where(torch.isnan(t), float('nan'), t)
        t = t.contiguous().view(-1)
        if t.element_size() == 1:
            t = t.view(torch.uint8).to(torch.int64)
        elif t.numel():
            t = t.view(torch.int16).to(torch.int64) & 0xffff
        out.append(t.sum(dtype=torch.int64))
    elif isinstance(obj, dict):
        for v in obj.values():
            fingerprint(v, out)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            fingerprint(v, out)


def fingerprinted_solve(prob, guess, max_iter=REPRO_ITERS):
    """Phase 7a's solve (cr, float64 factor) for ``max_iter`` iterations
    with every step on the way fingerprinted in call order
    (``fingerprint`` of the outputs of the solver's steps module, of the
    NLP callbacks, and of the PCR and border-inverse entry points,
    REPRO_HOOKS), each tagged with its iteration (a call of
    steps.monotone_barrier_update opens one).  Returns (x, record,
    [(iteration, step, fingerprints)])."""
    import importlib
    import inspect
    import torch
    from opty_tpu_torch import problem as problem_mod
    from opty_tpu_torch.nlp import steps
    calls, sums, where = [], [], {'it': 0}

    def hooked(name, fn):
        def call(*args, **kwargs):
            if name == 'steps.monotone_barrier_update':
                where['it'] += 1
            out = fn(*args, **kwargs)
            if not (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                n = len(sums)
                fingerprint(out, sums)
                calls.append((where['it'], name, n, len(sums)))
            return out
        return call

    saved = []

    def patch(mod, attr, name):
        saved.append((mod, attr, getattr(mod, attr)))
        setattr(mod, attr, hooked(name, getattr(mod, attr)))

    for modname, attrs in REPRO_HOOKS:
        mod = importlib.import_module(modname)
        for attr in attrs:
            patch(mod, attr, '{}.{}'.format(modname.rsplit('.', 1)[1], attr))
    for attr, fn in list(vars(steps).items()):
        if inspect.isfunction(fn) and fn.__module__ == steps.__name__:
            patch(steps, attr, 'steps.' + attr)
    make = problem_mod.make_collocation_nlp_functions

    def make_hooked(*args, **kwargs):
        fns, scale = make(*args, **kwargs)
        return fns._replace(**{
            f: hooked('fns.' + f, getattr(fns, f)) for f in fns._fields
            if callable(getattr(fns, f))}), scale
    saved.append((problem_mod, 'make_collocation_nlp_functions', make))
    problem_mod.make_collocation_nlp_functions = make_hooked
    try:
        x, rec = nlink_solve(prob, guess, torch.float64, max_iter=max_iter)
        values = torch.stack(sums).cpu().tolist() if sums else []
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    return x, rec, [(k, name, values[i:j]) for k, name, i, j in calls]


def first_difference(l1, l2):
    """(iteration, step, call index) of the first hooked call whose
    fingerprints differ between two ``fingerprinted_solve`` logs, or
    None where every call is equal."""
    first = next((a for a, b in zip(l1, l2) if a != b), None)
    if first is None and len(l1) != len(l2):
        return (None, 'the runs made {} and {} hooked calls'.format(
            len(l1), len(l2)), min(len(l1), len(l2)))
    if first is None:
        return None
    return first[0], first[1], l1.index(first)


def reproducibility(prob, guess):
    """Phase 7d: ``fingerprinted_solve`` for REPRO_ITERS iterations,
    twice in this process from the same start.  Prints whether the
    iterates are bitwise equal and, where not, the first iteration and
    the first step whose outputs differ.  Not a gate.  Returns the
    record."""
    (x1, _, l1), (x2, _, l2) = (fingerprinted_solve(prob, guess)
                                for _ in range(2))
    first = first_difference(l1, l2)
    equal = first is None and np.array_equal(x1.view(np.int64),
                                              x2.view(np.int64))
    rec = dict(iterations=REPRO_ITERS, bitwise_equal=bool(equal),
               steps_logged=len(l1),
               first_iteration=None if first is None else first[0],
               first_step=None if first is None else first[1],
               first_call=None if first is None else first[2])
    log('7d reproducibility: nlink-{} N={} cr float64, {} iterations twice '
        'from the same start in one process, {} hooked steps a run: the '
        'iterates are {}'.format(
            NLINK_LINKS, NLINK_NODES, REPRO_ITERS, len(l1),
            'bitwise equal' if equal else
            'NOT bitwise equal; the first step whose outputs differ: {} in '
            'iteration {} (call {} of the run)'.format(
                rec['first_step'], rec['first_iteration'], rec['first_call'])
            if first is not None else
            'NOT bitwise equal in the solution, every hooked step equal'))
    return rec


# phase 7f: the pivot step's edge cases (csrc/wide.cuh:pivot_row, lu_panel,
# divide).  Matrices of these sizes (1, a panel's 8, one past it, the
# border and the block of nlink-9, the largest) in the classes of
# ``pivot_edge_blocks``; the wide inverse against block_inv_plain, the
# wide factor against pcr_factor_levels_plain, each entry's kind
# (finite, NaN, +inf, -inf) compared and the finite entries within
# TOL_WIDE of the largest finite reference entry
PIVOT_SIZES = (1, 4, 8, 9, 41, 50, 64)
# the classes of well-conditioned, nonsingular blocks, whose inverses
# are held to TOL_WIDE (the others' finite entries follow the round-off
# of near-cancellations and are printed)
PIVOT_WELL_POSED = ('first-column ties', 'upper triangular',
                    'zero below the first pivot', 'subnormal beside normal')
PIVOT_BATCH = 16
# the first iterations of 7a whose factorizations phase 7f replays
PIVOT_TRIAL_ITERS = 40
PIVOT_TRIALS_KEPT = 6


def pivot_edge_blocks(n, dtype, device='cuda'):
    """{class: (PIVOT_BATCH, n, n) tensor} of inputs that the pivot
    step's order keys, renamed rows and fast division meet at their
    edges: exact ties of |entry| in every column (small integers, either
    sign; also in the first column of a random matrix, with opposite
    signs), a zero column below the diagonal (upper triangular; the
    first column zero below its head), exactly singular blocks (a row
    the sum of two others; a zero column; all zeros), subnormal entries
    (a whole matrix of them; some off the diagonal of a well-conditioned
    one) and NaN, +inf and
    -inf entries, at the first pivot and elsewhere."""
    import torch
    rng = np.random.default_rng(1000 + n)
    B = PIVOT_BATCH
    tiny = 1e-310 if dtype == torch.float64 else 1e-41
    normal = rng.standard_normal((B, n, n)) + n * np.eye(n)
    ints = rng.integers(-3, 4, (B, n, n)).astype(float)
    out = {'integer ties': ints,
           'first-column ties': normal.copy(),
           'upper triangular': np.triu(rng.standard_normal((B, n, n)))
           + n * np.eye(n),
           'zero below the first pivot': normal.copy(),
           'singular: row sum': ints.copy(),
           'singular: zero column': normal.copy(),
           'singular: zeros': np.zeros((B, n, n)),
           'subnormal': tiny * rng.standard_normal((B, n, n)),
           'subnormal beside normal': normal.copy(),
           'non-finite': normal.copy()}
    out['first-column ties'][:, :, 0] = rng.choice([-2.0, 2.0], (B, n))
    out['zero below the first pivot'][:, 1:, 0] = 0.0
    if n >= 3:
        out['singular: row sum'][:, -1] = ints[:, 0] + ints[:, 1]
    else:
        out['singular: row sum'][:, -1] = ints[:, 0]
    out['singular: zero column'][:, :, rng.integers(0, n)] = 0.0
    mask = (rng.random((B, n, n)) < 0.3) & ~np.eye(n, dtype=bool)
    out['subnormal beside normal'][mask] = tiny * rng.standard_normal(
        int(mask.sum()))
    for i in range(B):
        val = (np.nan, np.inf, -np.inf)[i % 3]
        r, c = (0, 0) if i < 3 else tuple(rng.integers(0, n, 2))
        out['non-finite'][i, r, c] = val
    return {k: torch.as_tensor(v, dtype=dtype, device=device)
            for k, v in out.items()}


def entry_kinds(x):
    """Each entry's kind: 0 finite, 1 NaN, 2 +inf, 3 -inf."""
    import torch
    return torch.where(torch.isnan(x), 1, torch.where(
        x == float('inf'), 2, torch.where(x == -float('inf'), 3, 0)))


def kinds_and_error(got, want):
    """(entries whose kind differs, matrices (leading index) where one
    side is all finite and the other not, max |got - want| over the
    entries finite in both / max |finite want|)."""
    import torch
    kg, kw = entry_kinds(got), entry_kinds(want)
    lead = lambda k: (k != 0).reshape(k.shape[0], -1).any(dim=1)
    both = (kg == 0) & (kw == 0)
    scale = want.double().abs()[kw == 0].max().item() if (kw == 0).any() \
        else 1.0
    err = (got.double() - want.double()).abs()[both].max().item() \
        if both.any() else 0.0
    return (int((kg != kw).sum()), int((lead(kg) != lead(kw)).sum()),
            err / max(scale, 1e-300))


def wide_inverse(A):
    """csrc/wide.cu's inverse of CUDA matrices A (..., n, n) at any n
    (block_inv takes it only where blocks.cu is not built); not counted:
    phase 7f's yardstick calls."""
    import torch
    from opty_tpu_torch.ops.cuda_build import check_cuda, launch, load
    from opty_tpu_torch.ops.pcr_kernels import _WIDE_SIGNATURES
    n = A.shape[-1]
    suffix = check_cuda('block_inv', (A,), (A.shape,))
    X = torch.empty_like(A)
    fn = getattr(load('wide', _WIDE_SIGNATURES), 'block_inv_wide_' + suffix)
    launch('block_inv', fn, (A.data_ptr(), X.data_ptr(), A.numel() // (n * n),
                             n), A.device)
    return X


def pivot_edge_inverses(bk, inverse=wide_inverse):
    """The wide inverse (``inverse``) against block_inv_plain on
    ``pivot_edge_blocks`` at PIVOT_SIZES in float32 and float64.
    Returns [record] with the outputs under 'out' (kept for other
    builds to be held to)."""
    import torch
    recs = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for n in PIVOT_SIZES:
            for cls, A in pivot_edge_blocks(n, dtype).items():
                got = inverse(A)
                want = bk.block_inv_plain(A)
                kinds, flags, err = kinds_and_error(got, want)
                recs.append(dict(dtype=tag, n=n, cls=cls, kinds=kinds,
                                 flags=flags, err=err,
                                 nonfinite=int((entry_kinds(got) != 0).sum()),
                                 out=got))
    return recs


def pivot_edge_factors(pk, factor=None):
    """The wide PCR factor (``factor``, default pk.pcr_factor_levels)
    against pcr_factor_levels_plain on systems at d = 8 and 50 whose
    diagonal blocks are ``pivot_edge_blocks`` (N = PIVOT_BATCH nodes,
    the border 4 / 41, small coupling blocks), so that the level-0
    inverses meet every class.  Returns [record] as
    ``pivot_edge_inverses``."""
    import torch
    factor = factor or pk.pcr_factor_levels
    recs = []
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        for d, b in ((8, 4), (50, 41)):
            rng = np.random.default_rng(d)
            N = PIVOT_BATCH
            E = torch.as_tensor(0.01 * rng.standard_normal((1, d, d, N)),
                                dtype=dtype, device='cuda')
            E[..., 0] = 0.0
            F = torch.as_tensor(0.1 * rng.standard_normal((1, d, b, N)),
                                dtype=dtype, device='cuda')
            for cls, blocks in pivot_edge_blocks(d, dtype).items():
                Dm = blocks.permute(1, 2, 0)[None].contiguous()
                got = factor(Dm, E, F)
                want = pk.pcr_factor_levels_plain(Dm, E, F)
                res = [kinds_and_error(g, w) for g, w in zip(got, want)]
                recs.append(dict(
                    dtype=tag, n=d, cls='factor, D blocks: ' + cls,
                    kinds=sum(r[0] for r in res), flags=max(r[1] for r in res),
                    err=max(r[2] for r in res),
                    nonfinite=sum(int((entry_kinds(g) != 0).sum())
                                  for g in got), out=got))
    return recs


def capture_trials(prob, guess, iters=PIVOT_TRIAL_ITERS,
                   keep=PIVOT_TRIALS_KEPT):
    """Phase 7a's solve for ``iters`` iterations with its factorizations'
    inputs kept: the first ``keep`` calls of the PCR factor and of the
    border inverse whose outputs hold a non-finite value (the
    regularization ladder's singular trials), else none, and beside them
    the first call of each.  Returns {'factor': [(D, E, F)],
    'border': [A]}."""
    import torch
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    kept = {'factor': [], 'border': []}
    seen = {'factor': 0, 'border': 0}
    fac0, inv0 = pk.pcr_factor_levels, bk.block_inv

    def keep_if(kind, args, out):
        outs = out if isinstance(out, tuple) else (out,)
        bad = not all(torch.isfinite(o).all().item() for o in outs)
        seen[kind] += 1
        if (bad or seen[kind] == 1) and len(kept[kind]) < keep:
            kept[kind].append(tuple(a.clone() for a in args))

    def factor(D, E, F):
        out = fac0(D, E, F)
        keep_if('factor', (D, E, F), out)
        return out

    def border(A, out=None):
        res = inv0(A, out)
        keep_if('border', (A,), res)
        return res

    pk.pcr_factor_levels = factor
    bk.block_inv = border         # ops/tridiag.py imports it at the call
    try:
        nlink_solve(prob, guess, torch.float64, max_iter=iters)
    finally:
        pk.pcr_factor_levels = fac0
        bk.block_inv = inv0
    return kept


def near_midpoint_divisors(dtype):
    """Divisors whose reciprocals lie next to a midpoint of two
    neighbouring values: +-2^e (1 - k u) for odd k and u the unit
    roundoff (2^-53, 2^-24), 1 / (1 - u) = 1 + u + u^2 + ... rounding up
    by a hair; then random ones of every magnitude."""
    import torch
    u = 2.0 ** (-53 if dtype == torch.float64 else -24)
    ks = np.arange(1, 64, 2)
    base = 1.0 - ks * u
    vals = np.concatenate([s * 2.0 ** e * base for e in (-7, -1, 0, 3, 20)
                           for s in (1.0, -1.0)])
    rng = np.random.default_rng(53)
    rand = rng.standard_normal(4096) * 10.0 ** rng.integers(-30, 30, 4096)
    if dtype == torch.float32:
        rand = rng.standard_normal(4096) * 10.0 ** rng.integers(-15, 15, 4096)
    return torch.as_tensor(np.concatenate([vals, rand]), dtype=dtype)


def division_check(gate=True):
    """Phase 7f's gate on the inverse's divisions (csrc/wide.cuh:divide):
    the wide inverse of 1 x 1 blocks [b] and of diagonal 2 x 2 blocks
    equal to block_inv_plain's on the CPU (IEEE division, correctly
    rounded), value for value, for ``near_midpoint_divisors`` in float32
    and float64.  An inverse whose divisions are one unit in the last
    place off on such quotients (1 / (1 - 2^-53)) fails (where
    ``gate``).  Returns {dtype: entries that differ}."""
    import torch
    from opty_tpu_torch.ops import block_kernels as bk
    out = {}
    for dtype in (torch.float32, torch.float64):
        tag = str(dtype).split('.')[-1]
        b = near_midpoint_divisors(dtype)
        one = b[:, None, None]
        two = torch.zeros((b.numel() // 2, 2, 2), dtype=dtype)
        two[:, 0, 0], two[:, 1, 1] = b[0::2][:two.shape[0]], \
            b[1::2][:two.shape[0]]
        bad = 0
        for A in (one, two):
            got = wide_inverse(A.cuda()).cpu()
            want = bk.block_inv_plain(A)
            bad += int((got != want).sum())
        out[tag] = bad
        log('7f divisions {}: the wide inverse of {} 1 x 1 and {} diagonal '
            '2 x 2 blocks (divisors next to a midpoint, then random) against '
            'block_inv_plain on the CPU: {} entries differ'.format(
                tag, b.numel(), two.shape[0], bad))
        if bad and gate:
            fail('7f: the wide inverse divides other than IEEE division in '
                 '{} ({} entries)'.format(tag, bad))
    return out


def pivot_edges(pk, bk, prob, guess):
    """Phase 7f: the pivot step's edge cases.  The wide inverse and the
    wide factor against their plain versions on ``pivot_edge_blocks``
    (``pivot_edge_inverses``, ``pivot_edge_factors``), and the
    factorizations that phase 7a's first PIVOT_TRIAL_ITERS iterations
    make (``capture_trials``: its singular trials where the ladder makes
    any) replayed through the kernels and the plain versions.  Each
    comparison is printed: the entries whose kind (finite, NaN, +inf,
    -inf) differs, the matrices finite on one side only, and the error
    of the finite entries.  Returns the records (without outputs)."""
    import torch
    division_check()
    recs = pivot_edge_inverses(bk) + pivot_edge_factors(pk)
    trials = capture_trials(prob, guess)
    for kind, inputs in trials.items():
        for i, args in enumerate(inputs):
            if kind == 'factor':
                got = pk.pcr_factor_levels(*args)
                want = pk.pcr_factor_levels_plain(*args)
            else:
                got, want = (bk.block_inv(*args),), (bk.block_inv_plain(*args),)
            res = [kinds_and_error(g, w) for g, w in zip(got, want)]
            recs.append(dict(dtype=str(args[0].dtype).split('.')[-1],
                             n=args[0].shape[-2 if kind == 'factor' else -1],
                             cls='7a {} call {}'.format(kind, i),
                             kinds=sum(r[0] for r in res),
                             flags=max(r[1] for r in res),
                             err=max(r[2] for r in res),
                             nonfinite=sum(int((entry_kinds(g) != 0).sum())
                                           for g in got)))
    torch.cuda.synchronize()
    bad = []
    for r in recs:
        r.pop('out', None)
        log('7f {} n={} {}: {} entries of another kind than the plain '
            'version\'s, {} matrices finite on one side only, finite '
            'entries within {:.3e} of the largest, {} non-finite entries'
            .format(r['dtype'], r['n'], r['cls'], r['kinds'], r['flags'],
                    r['err'], r['nonfinite']))
        # gates: a block with a non-finite entry inverts to NaN in every
        # entry on both sides, and factors to non-finite outputs on both;
        # the well-posed classes agree in kind everywhere and to TOL_WIDE;
        # 7a's factorizations agree in kind and finiteness.  Exactly
        # singular blocks are printed only: whether a pivot comes out
        # exactly zero follows the order of the sums.
        cls = r['cls'].split(': ', 1)[-1]
        if cls == 'non-finite' and (r['flags'] or (
                r['kinds'] and not r['cls'].startswith('factor'))):
            bad.append(r)
        elif cls in PIVOT_WELL_POSED and (
                r['flags'] or r['kinds'] or r['err'] > TOL_WIDE[r['dtype']]):
            bad.append(r)
        elif r['cls'].startswith('7a') and (r['flags'] or r['kinds']):
            bad.append(r)
    if bad:
        fail('7f: the wide inverse or factor departs from its plain version '
             'on {}'.format([(r['dtype'], r['n'], r['cls']) for r in bad]))
    return recs


def gallery_sizes(prob):
    """A problem's KKT block d (states + unknown inputs + EoM rows),
    border b (unknown parameters + a variable node interval + instance
    constraints) and node count N."""
    c = prob.collocator
    return (c.num_states + c.num_unknown_input_trajectories + c.num_eom,
            c.num_unknown_parameters + int(c.variable_duration)
            + c.num_instance_constraints, c.num_collocation_nodes)


def violation(prob, x):
    """The largest distance of the constraints from [cl, cu] (eom_bounds
    rows are path inequalities)."""
    g = prob.constraints(x)
    cl, cu = prob._low_con_bounds, prob._upp_con_bounds
    return float(np.max(np.maximum(np.maximum(cl - g, g - cu), 0.0)))


def gallery_steps(counters, cpu, smi):
    """Phase 9a: every gallery problem built on the card at its defaults
    (``gallery.build``: ``build_problem`` and ``initial_guess``;
    betts_10_47 its first phase), its (d, b, N) and ``kernel_supported``
    printed, failing where a dtype is refused; one IPM iteration from
    its documented start with the card's defaults, counters reset just
    before and read just after: the cr path's factor and downsweep (and
    the border inverse where b > 0) must launch; then one iteration from
    that state with kkt_method='cr' and a float64 factorization, taken
    by the card and by the CPU (``cpu``, a ``CPUSteps`` whose server
    built every gallery problem), must agree to NLINK_STEP_TOL relative
    in x, y, zL and zU (GALLERY_STEP_TOL where a problem has its own),
    with the same monotone-mode flag.  Returns ({name: (problem,
    guess)}, {name: record})."""
    import torch
    from opty_tpu_torch.examples import gallery
    from opty_tpu_torch.ops import pcr_kernels as pk
    built, recs, card = {}, {}, {}
    for name in gallery.NAMES:
        t0 = time.time()
        prob, guess = gallery.build(name, device='cuda')
        build_s = time.time() - t0
        d, b, N = gallery_sizes(prob)
        supported = {str(dt).split('.')[-1]: pk.kernel_supported(d, b, N, dt)
                     for dt in (torch.float32, torch.float64)}
        x0 = prob._as_tensor(guess)[None]
        prob.set_solver_options(chunk_iters=1)
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.time()
        _, state = prob._build_solver()[1](x0)
        torch.cuda.synchronize()
        first_s = time.time() - t0
        launches = {k: v for k, v in launch_counts(*counters).items() if v}
        prob.set_solver_options(kkt_method='cr', factor_dtype=torch.float64)
        _, nxt = prob._build_solver()[2](x0, state)
        prob.set_solver_options(chunk_iters=None)
        cpu.submit(name, name, dict(kkt_method='cr'),
                   {f: v.detach().cpu().numpy()
                    for f, v in state._asdict().items()})
        card[name] = {f: getattr(nxt, f).cpu().numpy() for f in STEP_FIELDS}
        built[name] = (prob, guess)
        recs[name] = dict(d=d, b=b, nodes=N, kernel_supported=supported,
                          launches=launches, build_s=build_s,
                          first_iteration_s=first_s)
        log('9a {}: (d, b, N) = ({}, {}, {}), kernel_supported {}; one '
            'iteration with the card\'s defaults: {:.2f} s (build {:.1f} s), '
            'launches {}'.format(name, d, b, N, json.dumps(supported),
                                 first_s, build_s, json.dumps(launches)))
        if not all(supported.values()):
            fail('9a {}: kernel_supported refuses (d, b, N) = ({}, {}, {})'
                 .format(name, d, b, N))
        factor = launches.get('pcr_factor_levels', 0) \
            + launches.get('pcr_factor_levels_wide', 0)
        sweep = launches.get('pcr_downsweep', 0) \
            + launches.get('pcr_downsweep_wide', 0)
        border = launches.get('block_inv', 0) \
            + launches.get('block_inv_wide', 0)
        if not factor or not sweep or (b and not border):
            fail('9a {}: the cr kernels were not launched: {}'.format(
                name, json.dumps(launches)))
    t0 = time.time()
    cpu_steps = cpu.collect()
    log('9a: the CPU side ended {:.1f} s after the card\'s ({} steps, {:.1f} '
        's of CPU steps)'.format(time.time() - t0, len(cpu_steps),
                                 cpu.seconds))
    worst, tol = {}, {}
    for name in gallery.NAMES:
        got, want = cpu_steps[name], card[name]
        recs[name]['step_rel'] = {
            f: float(np.max(np.abs(got[f] - want[f]))
                     / max(np.max(np.abs(want[f])), 1e-300))
            for f in ('x', 'y', 'zL', 'zU')}
        worst[name] = max(recs[name]['step_rel'].values())
        tol[name] = GALLERY_STEP_TOL.get(name, NLINK_STEP_TOL)
    log('9a: one iteration (float64 factor) from the card\'s state, card '
        'against CPU, largest relative difference of x, y, zL, zU: {} '
        '(limit {:.0e}; GALLERY_STEP_TOL {}; {})'.format(
            json.dumps({k: float('{:.3e}'.format(v))
                        for k, v in worst.items()}), NLINK_STEP_TOL,
            json.dumps(GALLERY_STEP_TOL), smi))
    for name in gallery.NAMES:
        if not worst[name] <= tol[name] or not np.array_equal(
                cpu_steps[name]['mono'], card[name]['mono']):
            fail('9a {}: one iteration from the card\'s state differs, card '
                 'against CPU: {} (limit {:.3e}), mono {} / {}'.format(
                     name, json.dumps(recs[name]['step_rel']), tol[name],
                     card[name]['mono'].tolist(),
                     cpu_steps[name]['mono'].tolist()))
    return built, recs


def gallery_gate(rec, ref):
    """Whether a cold solve meets phase 9b's gates against the JAX
    package's record ``ref``."""
    return (rec['status'] in (0, 1)
            and rec['violation'] <= GALLERY_VIOLATION
            and rec['obj'] <= ref['obj'] + GALLERY_OBJ_TOL * max(
                1.0, abs(ref['obj'])))


def gallery_cold(counters, built, smi):
    """Phase 9b: each problem of the cold-solve set (``gallery.COLD_SET``)
    solved on the card from its documented start with
    benchmarks/cold_gallery.py's configuration (``use_soc=False``, its
    ``COLD_MAX_ITER``), kkt_method='cr' and a float64 factorization,
    counters reset just before and read just after: status 0 or 1, the
    constraints within GALLERY_VIOLATION, the objective within
    GALLERY_OBJ_TOL of JAX_GALLERY's; iterations printed beside the JAX
    package's; then the same solve with the card's default factorization
    (float32 + 6 rounds), held to the same gates but printed, not
    gated, beside JAX_GALLERY_F32.
    betts_10_47 runs its three phases (``run_phases``, float64 factor):
    the gates on phases 1 and 3, phase 2's status printed.  The problems of
    GALLERY_UNGATED run for GALLERY_UNGATED_MAX_ITER iterations, printed,
    not gated.  Returns {name: record}."""
    import importlib
    import torch
    from opty_tpu_torch.config import default_factor_dtype
    from opty_tpu_torch.examples import gallery
    recs = {}
    for name in gallery.COLD_SET:
        mod = importlib.import_module('opty_tpu_torch.examples.gallery.'
                                      + name)
        prob, guess = built[name]
        gated = name not in GALLERY_UNGATED
        for tag, factor, jax_run in (
                ('float64', torch.float64, JAX_GALLERY[name]),
                ('default', default_factor_dtype(prob.device),
                 JAX_GALLERY_F32[name])):
            if not gated and tag == 'default':
                continue
            prob.set_solver_options(
                max_iter=mod.COLD_MAX_ITER if gated
                else GALLERY_UNGATED_MAX_ITER,
                use_soc=False, kkt_method='cr', factor_dtype=factor)
            torch.cuda.synchronize()
            reset_counts(*counters)
            t0 = time.time()
            x, info = prob.solve(guess)
            torch.cuda.synchronize()
            wall = time.time() - t0
            launches = {k: v for k, v in launch_counts(*counters).items()
                        if v}
            if x.shape != (prob.num_free,) or not np.all(np.isfinite(x)):
                fail('9b {} {}: the solution has the wrong shape or is not '
                     'finite'.format(name, tag))
            rec = dict(status=info['status'], iterations=info['iterations'],
                       obj=info['obj_val'], violation=violation(prob, x),
                       wall_s=wall, launches=launches)
            # both factorizations are held to the float64 run's optimum
            met = gallery_gate(rec, JAX_GALLERY[name])
            recs.setdefault(name, {})[tag] = dict(rec, met=met)
            log('9b {} {} factor: status={} iterations={} obj={!r} '
                'violation={:.3e} wall_s={:.2f} ({:.1f} ms an iteration); '
                'the JAX package on the CPU ({}): {}; gates {}; launches {} '
                '({})'.format(
                    name, tag, rec['status'], rec['iterations'], rec['obj'],
                    rec['violation'], wall,
                    wall / max(rec['iterations'], 1) * 1e3,
                    'cr float64' if tag == 'float64' else 'cr float32',
                    json.dumps(jax_run), 'met' if met else
                    ('NOT MET' if tag == 'float64' and gated else 'not met '
                     '(not gated)'), json.dumps(launches), smi))
            if tag == 'float64' and gated and not met:
                fail('9b {}: the cold solve fails its gates against the JAX '
                     'package\'s run'.format(name))
    from opty_tpu_torch.examples.gallery import betts_10_47
    ref = JAX_GALLERY['betts_10_47']
    t0 = time.time()
    phases = betts_10_47.run_phases(
        verbose=False, device='cuda',
        solver_options=dict(kkt_method='cr', factor_dtype=torch.float64))
    wall = time.time() - t0
    # every constraint of the three phases is an equality: the violation
    # is the largest |g|
    rows = [dict(status=info['status'], iterations=info['iterations'],
                 obj=info['obj_val'],
                 violation=float(np.max(np.abs(info['g']))))
            for _, info in phases]
    met = all(gallery_gate(rows[k], dict(obj=ref['obj'][k]))
              for k in (0, 2))
    recs['betts_10_47'] = {'float64': dict(phases=rows, met=met,
                                           wall_s=wall)}
    log('9b betts_10_47 float64 factor: phases (status, iterations, obj) '
        '{}; the JAX package on the CPU: {}; gates on phases 1 and 3 {}; '
        'wall_s={:.2f} ({})'.format(
            [(r['status'], r['iterations'], r['obj']) for r in rows],
            json.dumps(ref), 'met' if met else 'NOT MET', wall, smi))
    if not met:
        fail('9b betts_10_47: phases 1 and 3 fail their gates')
    return recs


def swing_up_examples(counters, smi):
    """Phase 9c: the JAX package's examples/pendulum_swing_up.py ported
    (opty_tpu_torch/examples/), its ``main`` on the card with its
    defaults (N = 501): status 0 and the objective within
    SWING_UP_OBJ_TOL relative of JAX_SWING_UP; then ``--batch 4 --nodes
    301`` (``solve_batch``), its statuses printed beside the JAX
    package's.  Counters reset just before each and read just after.
    Returns a record."""
    import torch
    from opty_tpu_torch.examples import pendulum_swing_up as ex
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.time()
    x, info = ex.main([])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: v for k, v in launch_counts(*counters).items() if v}
    rel = abs(info['obj_val'] - JAX_SWING_UP['obj']) / abs(
        JAX_SWING_UP['obj'])
    rec = dict(status=info['status'], iterations=info['iterations'],
               obj=info['obj_val'], rel_to_jax=rel, wall_s=wall,
               launches=launches)
    log('9c pendulum_swing_up N=501 (the card\'s defaults): status={} '
        'iterations={} obj={!r} wall_s={:.2f}; the JAX package on the CPU: '
        '{}; objective rel diff {:.3e} (limit {:.0e}); launches {} ({})'
        .format(info['status'], info['iterations'], info['obj_val'], wall,
                json.dumps(JAX_SWING_UP), rel, SWING_UP_OBJ_TOL,
                json.dumps(launches), smi))
    if x.ndim != 1 or not np.all(np.isfinite(x)):
        fail('9c: the solution has the wrong shape or is not finite')
    if info['status'] != 0 or not rel <= SWING_UP_OBJ_TOL:
        fail('9c: pendulum_swing_up status {} objective {!r} against the '
             'JAX package\'s {!r}'.format(info['status'], info['obj_val'],
                                          JAX_SWING_UP['obj']))
    reset_counts(*counters)
    t0 = time.time()
    res = ex.main(['--batch', '4', '--nodes', '301'])
    torch.cuda.synchronize()
    batch = dict(status=res.status.cpu().numpy().tolist(),
                 iterations=res.iterations.cpu().numpy().tolist(),
                 obj=res.obj_val.cpu().numpy().tolist(),
                 wall_s=time.time() - t0,
                 launches={k: v for k, v in launch_counts(*counters).items()
                           if v})
    rec['batch'] = batch
    log('9c pendulum_swing_up --batch 4 --nodes 301: statuses {} iterations '
        '{} wall_s={:.2f}; the JAX package on the CPU: {}; launches {}'
        .format(batch['status'], batch['iterations'], batch['wall_s'],
                json.dumps(JAX_SWING_UP_BATCH), json.dumps(batch['launches'])))
    return rec


def gallery_phases(counters, smi, cpu):
    """Phases 9a, 9b and 9c (``cpu``: 9a's ``CPUSteps``).  Returns
    {kernel: {'launches_gallery': {...}}} for the kernels' JSON record:
    the launches in 9a's first iterations (the card's defaults) and in
    9b's float64 cold solves, with those solves' iterations."""
    built, steps = phase('9a gallery', gallery_steps, counters, cpu, smi)
    cold = phase('9b gallery cold solves', gallery_cold, counters, built,
                 smi)
    phase('9c swing-up example', swing_up_examples, counters, smi)
    del built
    solves = [r['float64'] for name, r in cold.items()
              if 'launches' in r['float64'] and name not in GALLERY_UNGATED]
    return {kname: dict(launches_gallery=dict(
        first_iterations=sum(r['launches'].get(kname, 0)
                             for r in steps.values()),
        cold_float64=sum(r['launches'].get(kname, 0) for r in solves),
        cold_float64_iterations=sum(r['iterations'] for r in solves)))
        for kname, _, _, _ in KERNELS}


def kkt_residual(D, E, F, Kbb, r, rb, u, beta):
    """||K [u; beta] - [r; rb]|| / ||[r; rb]|| of a bordered block-
    tridiagonal system (D, E (..., N, d, d), F (..., N, d, b)), in
    float64."""
    import torch
    D, E, F, Kbb, r, rb, u, beta = (a.double() for a in (
        D, E, F, Kbb, r, rb, u, beta))
    mv = lambda A, x: (A @ x[..., None])[..., 0]
    Ku = mv(D, u) + mv(F, beta[..., None, :].expand(u.shape[:-1]
                                                     + beta.shape[-1:]))
    Ku[..., 1:, :] += mv(E[..., 1:, :, :], u[..., :-1, :])
    Ku[..., :-1, :] += mv(E[..., 1:, :, :].transpose(-1, -2), u[..., 1:, :])
    Kb = torch.einsum('...kdb,...kd->...b', F, u) + mv(Kbb, beta)
    num = torch.sqrt(torch.sum((Ku - r) ** 2) + torch.sum((Kb - rb) ** 2))
    return (num / torch.sqrt(torch.sum(r ** 2) + torch.sum(rb ** 2))).item()


def spike_local_factor_check(sk, sp, smi):
    """The spike path's local factorization on the card at 10c's slabs
    (SPIKE_PATH_SLABS lanes of ceil(501 / P) nodes, d = 5, the 2 d + b =
    14 spike columns as the border): scan_factor's S_inv and Melim
    against the plain ``_local_factor`` and the solved columns against
    the plain ``_local_solve``, float64 and float32, within TOL_WIDE
    (the wide kernel takes a border of 14) and TOL_SCAN for scan_solve's
    one right-hand side (csrc/scan.cu, b = 0); both kernels and their
    plain versions timed there, beside their bounds.  Returns records."""
    import torch
    L = -(-NODES // SPIKE_PATH_SLABS)
    cols = 2 * D + B_BORDER
    out = []
    for dtype in (torch.float64, torch.float32):
        tag = str(dtype).split('.')[-1]
        Dm, E, R, _, r, _ = scan_system(dtype, SPIKE_PATH_SLABS, L, b=cols,
                                        seed=12)
        S_inv, Melim, X = sp._factor_with_columns(Dm, E, R)
        S_p, M_p = sp._local_factor(Dm, E)
        X_p = sp._local_solve(S_p, M_p, E, R)
        y = sp._solve_one(S_inv, Melim, E, r)
        no_border = (S_inv.new_zeros(S_inv.shape[:-1] + (0,)), E,
                     S_inv.new_zeros(S_inv.shape[:-3] + (0, 0)), r,
                     S_inv.new_zeros(S_inv.shape[:-3] + (0,)))
        y_p = sk.scan_solve_plain(S_inv, Melim, *no_border)[0]
        K0 = Dm.new_zeros(Dm.shape[:-3] + (cols, cols))
        times = dict(
            factor_ms=timed(lambda: sk.scan_factor(Dm, E, R, K0), 20),
            factor_plain_ms=timed(
                lambda: sk.scan_factor_plain(Dm, E, R, K0), 1, 1),
            solve_ms=timed(lambda: sp._solve_one(S_inv, Melim, E, r), 20),
            solve_plain_ms=timed(
                lambda: sk.scan_solve_plain(S_inv, Melim, *no_border), 1, 1))
        counts = (scan_counts(D, cols, L, SPIKE_PATH_SLABS,
                              Dm.element_size())[0],
                  scan_counts(D, 0, L, SPIKE_PATH_SLABS,
                              Dm.element_size())[1])
        for key, (nbytes, ops) in zip(('factor', 'solve'), counts):
            times[key + '_bound_ms'], times[key + '_bound_by'] = bound(
                nbytes, ops, torch.cuda.get_device_name(0), tag)
        errs = {'S_inv': rel_err(S_inv, S_p)[1],
                'Melim': rel_err(Melim, M_p)[1], 'X': rel_err(X, X_p)[1],
                'scan_solve': rel_err(y, y_p)[1]}
        limits = {k: TOL_SCAN[tag] if k == 'scan_solve' else TOL_WIDE[tag]
                  for k in errs}
        log('10 local factor {} (P={}, L={}, d={}, {} spike columns): '
            'kernel against plain, max rel err {} (limits {}); device ms '
            '(kernel, plain, bound) scan_factor {:.4f}, {:.1f}, {:.5f} ({}), '
            'scan_solve {:.4f}, {:.1f}, {:.5f} ({}) ({})'.format(
                tag, SPIKE_PATH_SLABS, L, D, cols, json.dumps(
                    {k: float('{:.3e}'.format(v)) for k, v in errs.items()}),
                json.dumps(limits), times['factor_ms'],
                times['factor_plain_ms'], times['factor_bound_ms'],
                times['factor_bound_by'], times['solve_ms'],
                times['solve_plain_ms'], times['solve_bound_ms'],
                times['solve_bound_by'], smi))
        if not all(errs[k] <= limits[k] for k in errs):
            fail('10 local factor {}: the kernels disagree with the plain '
                 'versions: {}'.format(tag, json.dumps(errs)))
        out.append(dict(dtype=tag, slabs=SPIKE_PATH_SLABS, nodes=L,
                        columns=cols, **errs, **times))
    return out


def spike_system_solve(counters, sk, sp, mesh, dtype, smi):
    """10a and 10b in ``dtype`` on one lane of scan_system's kind made
    symmetric (D and Kbb: the scan solve, like any KKT solve here, takes
    the upper blocks as E^T and the border rows as F^T and its pivots as
    symmetric): returns a record."""
    import torch
    tag = str(dtype).split('.')[-1]
    Dm, E, F, Kbb, r, rb = scan_system(dtype, 1, SPIKE_NODES, seed=11)
    Dm = 0.5 * (Dm + Dm.transpose(-1, -2))
    Kbb = 0.5 * (Kbb + Kbb.transpose(-1, -2))
    torch.cuda.synchronize()
    reset_counts(*counters)
    t0 = time.time()
    u, beta = sp.spike_solve(Dm, E, F, Kbb, r, rb, mesh)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: v for k, v in launch_counts(*counters).items() if v}
    fac = sk.scan_factor(Dm, E, F, Kbb)
    u_ref, b_ref = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
    diff = max(rel_err(u, u_ref)[1], rel_err(beta, b_ref)[1])
    res = kkt_residual(Dm, E, F, Kbb, r, rb, u, beta)
    res_ref = kkt_residual(Dm, E, F, Kbb, r, rb, u_ref, b_ref)
    # 10b: the factorization once, two right-hand sides
    t1 = time.time()
    sfac = sp.spike_factor(Dm, E, F, Kbb, mesh)
    u_fa, b_fa = sp.spike_apply(sfac, r, rb, mesh)
    torch.cuda.synchronize()
    fa_wall = time.time() - t1
    r2, rb2 = torch.flip(r, (-2,)), -rb
    u2, b2 = sp.spike_apply(sfac, r2, rb2, mesh)
    u2_ref, b2_ref = sp.spike_solve(Dm, E, F, Kbb, r2, rb2, mesh)
    fa_diff = max(rel_err(u_fa, u)[1], rel_err(b_fa, beta)[1],
                  rel_err(u2, u2_ref)[1], rel_err(b2, b2_ref)[1])
    # the local factorization's launch alone, at this system's slabs
    axis = mesh.axis(Dm.device)
    Ds = sp._slabs(axis, Dm, unit=True)
    E_head, E_tail_T, Eint = sp._couplings(axis, sp._slabs(axis, E))
    R = torch.cat([sp._slabs(axis, r[..., None])[..., 0][..., None],
                   sp._spike_columns(E_head, E_tail_T, sp._slabs(axis, F),
                                     Ds.shape[-3])], dim=-1)
    K0 = Ds.new_zeros(Ds.shape[:-3] + (R.shape[-1],) * 2)
    factor_ms = timed(lambda: sk.scan_factor(Ds, Eint, R, K0), 3, 1)
    S_inv, Melim = sfac.S_inv, sfac.Melim
    y0 = sp._slabs(axis, r[..., None])[..., 0]
    solve_ms = timed(lambda: sp._solve_one(S_inv, Melim, sfac.Eint, y0), 3, 1)
    L, cols = Ds.shape[-3], R.shape[-1]
    counts = (scan_counts(D, cols, L, SPIKE_SLABS, Dm.element_size())[0],
              scan_counts(D, 0, L, SPIKE_SLABS, Dm.element_size())[1])
    (factor_bound, by_f), (solve_bound, by_s) = (
        bound(nbytes, ops, torch.cuda.get_device_name(0), tag)
        for nbytes, ops in counts)
    rec = dict(dtype=tag, nodes=SPIKE_NODES, slabs=SPIKE_SLABS, d=D,
               b=B_BORDER, rel_to_scan=diff, residual=res,
               scan_residual=res_ref, factor_apply_rel=fa_diff,
               solve_wall_s=wall, factor_apply_wall_s=fa_wall,
               launches=launches, scan_factor_ms=factor_ms,
               scan_factor_bound_ms=factor_bound, scan_factor_bound_by=by_f,
               scan_solve_ms=solve_ms, scan_solve_bound_ms=solve_bound,
               scan_solve_bound_by=by_s, lanes=SPIKE_SLABS, slab_nodes=L,
               columns=cols)
    log('10a spike_solve {} N={} P={} (d={}, b={}): relative difference '
        'to the card\'s scan solve {:.3e} (limit {:.0e}), relative '
        'residual {:.3e} (scan {:.3e}), wall {:.3f} s, launches {}; its '
        'scan_factor launch at the slabs ({} lanes of {} nodes, {} '
        'columns) {:.3f} ms (bound {:.5f} ms, {}), scan_solve {:.3f} ms '
        '(bound {:.5f} ms, {}) of device time ({}; in the full run the '
        'card is shared with phases 7c-7b)'.format(
            tag, SPIKE_NODES, SPIKE_SLABS, D, B_BORDER, diff, SPIKE_TOL[tag],
            res, res_ref, wall, json.dumps(launches), SPIKE_SLABS, L, cols,
            factor_ms, factor_bound, by_f, solve_ms, solve_bound, by_s,
            smi))
    log('10b spike_factor + spike_apply {}: against spike_solve (two '
        'right-hand sides) {:.3e} (limit {:.0e}), factor and apply wall '
        '{:.3f} s'.format(tag, fa_diff, SPIKE_TOL[tag], fa_wall))
    if not diff <= SPIKE_TOL[tag]:
        fail('10a spike_solve {}: {:.3e} from the scan solve'.format(
            tag, diff))
    if not fa_diff <= SPIKE_TOL[tag]:
        fail('10b spike_factor + spike_apply {}: {:.3e} from spike_solve'
             .format(tag, fa_diff))
    for kname in SPIKE_KERNELS[:1]:
        if not launches.get(kname):
            fail('10a: {} was not launched'.format(kname))
    return rec


def spike_path(counters, mesh, smi):
    """10c: bench.py's queue row 0 (default_rng(7), N = 501) solved on the
    card with kkt_method='scan' and then 'spike' on SPIKE_PATH_SLABS
    slabs, a float64 factorization, monotone mu, no second-order
    correction; counters reset just before the spike solve and read just
    after.  Returns a record."""
    import torch
    from opty_tpu_torch.models import swing_up_problem
    prob = swing_up_problem(num_nodes=NODES)
    free = np.random.default_rng(7).standard_normal((64, prob.num_free))[0]
    runs = {}
    for method in ('scan', 'spike'):
        prob.set_solver_options(
            kkt_method=method, factor_dtype=torch.float64, use_soc=False,
            mu_strategy='monotone', max_iter=200,
            mesh=mesh if method == 'spike' else None)
        torch.cuda.synchronize()
        reset_counts(*counters)
        t0 = time.time()
        x, info = prob.solve(free)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {k: v for k, v in launch_counts(*counters).items() if v}
        if x.shape != (prob.num_free,) or not np.all(np.isfinite(x)):
            fail('10c {}: the solution has the wrong shape or is not finite'
                 .format(method))
        runs[method] = dict(status=info['status'],
                            iterations=info['iterations'],
                            obj=info['obj_val'], wall_s=wall,
                            launches=launches)
        log('10c swing-up N={} row 0, kkt_method={!r}{}: status={} '
            'iterations={} obj={!r} wall_s={:.2f} ({:.1f} ms an iteration), '
            'launches {} ({})'.format(
                NODES, method, ' P={}'.format(SPIKE_PATH_SLABS)
                if method == 'spike' else '', info['status'],
                info['iterations'], info['obj_val'], wall,
                wall / max(info['iterations'], 1) * 1e3,
                json.dumps(launches), smi))
    sp_, sc = runs['spike'], runs['scan']
    rel = abs(sp_['obj'] - sc['obj']) / max(abs(sc['obj']), 1e-300)
    if sp_['status'] != sc['status'] \
            or abs(sp_['iterations'] - sc['iterations']) > SPIKE_ITER_SLACK \
            or not rel <= SPIKE_OBJ_TOL:
        fail('10c: the spike solve (status {}, {} iterations) parts from the '
             'scan solve (status {}, {} iterations), objective {:.3e} '
             'relative'.format(sp_['status'], sp_['iterations'],
                               sc['status'], sc['iterations'], rel))
    for kname in SPIKE_KERNELS:
        if not sp_['launches'].get(kname):
            fail('10c: {} was not launched by the spike solve'.format(kname))
    for kname in PCR_KERNELS:
        if sp_['launches'].get(kname):
            fail('10c: {} was launched by the spike solve'.format(kname))
    return dict(runs, obj_rel=rel)


def spike_phase(counters, smi):
    """Phase 10 (10a-10c, and the local factor's kernels against their
    plain versions at 10c's slabs).  Returns {kernel: {'launches_spike':
    ...}} for the kernels' JSON record and the phase's records."""
    import torch
    from opty_tpu_torch.ops import scan_kernels as sk
    from opty_tpu_torch.parallel import spike as sp
    from opty_tpu_torch.parallel.mesh import NodeMesh
    local = spike_local_factor_check(sk, sp, smi)
    mesh = NodeMesh(SPIKE_SLABS)
    solves = [spike_system_solve(counters, sk, sp, mesh, dtype, smi)
              for dtype in (torch.float64, torch.float32)]
    path = spike_path(counters, NodeMesh(SPIKE_PATH_SLABS), smi)
    kernels = {kname: dict(launches_spike=dict(
        swing_up=path['spike']['launches'].get(kname, 0),
        swing_up_iterations=path['spike']['iterations'],
        solve_float64=solves[0]['launches'].get(kname, 0)))
        for kname, _, _, _ in KERNELS}
    # the spike's launches at 10c's slabs (the plain versions beside) and
    # at 10a's (the plain factor there takes ~20 s a call: not timed)
    for kname, key in (('scan_factor_wide', 'factor'),
                       ('scan_solve', 'solve')):
        kernels[kname]['spike_shape'] = [dict(
            dtype=r['dtype'], lanes=r['slabs'], nodes=r['nodes'], d=D,
            b=r['columns'] if key == 'factor' else 0, ms=r[key + '_ms'],
            plain_ms=r[key + '_plain_ms'], bound_ms=r[key + '_bound_ms'],
            bound_by=r[key + '_bound_by']) for r in local] + [dict(
                dtype=r['dtype'], lanes=r['lanes'], nodes=r['slab_nodes'],
                d=D, b=r['columns'] if key == 'factor' else 0,
                ms=r['scan_' + key + '_ms'], plain_ms=None,
                bound_ms=r['scan_' + key + '_bound_ms'],
                bound_by=r['scan_' + key + '_bound_by']) for r in solves]
    return kernels, dict(local_factor=local, solves=solves, path=path)


def spike_alone():
    """``--spike-phase``: phase 10 alone (the kernels built first), its
    records printed as one JSON line."""
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: chip_smoke.py runs on the card only')
    sys.path.insert(0, HERE)
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    from opty_tpu_torch.ops import scan_kernels as sk
    smi = device_line()
    pk.build_kernels()
    _, recs = phase('10 spike', spike_phase, (pk, bk, sk), smi)
    print(json.dumps(recs), flush=True)


def gallery_process(out_path, fds=()):
    """``--gallery-process OUT [W R]``: phases 9a-9c in a process of
    their own on the same card, their records written to OUT as JSON.
    9a's CPU steps go to the step server whose stdin and stdout are the
    descriptors W and R (chip_smoke.py starts that server when it
    starts, so that its builds of the 25 problems overlap the first
    phases); without them this process starts its own.  chip_smoke.py
    runs it beside phases 7d, 7f, 7c and 7b, whose gates are numerical
    and which report no device time, so that the gallery adds little to
    the script's wall: those phases leave the card idle most of the
    time (PERF.md §5), and the card time-slices the two processes."""
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: chip_smoke.py runs on the card only')
    sys.path.insert(0, HERE)
    from opty_tpu_torch.examples import gallery
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    from opty_tpu_torch.ops import scan_kernels as sk
    smi = device_line()
    children = {}
    if fds:
        cpu = CPUSteps(os.fdopen(int(fds[0]), 'w'), os.fdopen(int(fds[1])))
    else:
        children['steps'] = start_step_server(gallery.NAMES)
        cpu = CPUSteps.of(children['steps'])
    try:
        out = gallery_phases((pk, bk, sk), smi, cpu)
    finally:
        stop_children(children)
    spike, _ = phase('10 spike', spike_phase, (pk, bk, sk), smi)
    for kname, rec in spike.items():
        out[kname].update(rec)
    with open(out_path, 'w') as f:
        json.dump(out, f)


def start_gallery_process(server):
    """Starts ``gallery_process`` in a child process, its CPU steps
    taken by the step server ``server`` (a child of this process);
    returns (the process, its output file's path, its log files, the
    start time)."""
    import tempfile
    out_path = os.path.join(tempfile.mkdtemp(prefix='chip_smoke_gallery_'),
                            'gallery.json')
    logs = (tempfile.TemporaryFile('w+'), tempfile.TemporaryFile('w+'))
    fds = (server.stdin.fileno(), server.stdout.fileno())
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), '--gallery-process',
         out_path] + [str(fd) for fd in fds], cwd=HERE, stdout=logs[0],
        stderr=logs[1], text=True, pass_fds=fds)
    proc.log_file = None
    return proc, out_path, logs, time.time()


def finish_gallery_process(started, server):
    """Waits for the gallery process, prints its output and fails with
    it (and with its step server's log); returns its records."""
    proc, out_path, logs, t0 = started
    t1 = time.time()
    rc = proc.wait(timeout=1200)
    for f in logs:
        f.seek(0)
    out, err = logs[0].read(), logs[1].read()
    log(out.rstrip())
    log('phases 9 gallery and 10 spike (a second process on the card, '
        'beside 7d, 7f, 7c and 7b): {:.1f} s, {:.1f} s of it after 7b'.format(
            time.time() - t0, time.time() - t1))
    if rc != 0:
        server.log_file.seek(0)
        fail('the gallery process (phases 9a-9c) failed: {}; its step '
             'server: {}'.format(err[-3000:], server.log_file.read()[-2000:]))
    with open(out_path) as f:
        return json.load(f)


def kernel_records(pcr, scan, blocks, launches, in_solve, iterations,
                   ident_shapes):
    """The JSON entries, each at the shape and dtype its path runs it:
    the PCR kernels at the main path's B = 32, N = 501 in float32 (the
    cr queue's launches; ``ms`` L2-warm, ``cold_ms`` L2-cold, float64
    beside); block_inv at the cr path's border call (32 matrices of
    d = 4, float32); block_matmul, on no solver path, at 8 matrices of
    d = 5 in float64 (the scan path's per-node call before the scan
    kernels); the scan kernels at the scan path's B = 32, N = 501 in
    float64 (the scan queue's launches, float32 beside); the wide PCR
    kernels at nlink-9's block at one lane in float32 (7b's launches,
    7a's beside); the wide scan kernels at nlink-9's block at one lane in
    float64 (7c's launches, and per iteration over 7c's
    ``iterations``).  Every measured shape is beside in ``shapes``;
    ``in_solve_ms`` is the profile's time per launch.  Every entry also
    holds its launches in the identification solves (8a, 8b), in all
    and per iteration, and the kernels those solves run hold their
    records at the examples' blocks in ``identification_shapes``."""
    out = []
    for kname, source, replaces, _ in KERNELS:
        entry = dict(name=kname, route='cuda', source=source,
                     replaces=replaces,
                     launches_default_path=launches['default'][kname],
                     launches_in_restoration={
                         m: launches['rest_' + m][kname]
                         for m in ('cr', 'scan')},
                     launches_identification={
                         label: dict(launches=launches[label][kname],
                                     per_iteration=launches[label][kname]
                                     / max(iterations[label], 1),
                                     in_solve_ms=in_solve[label].get(kname))
                         for label in IDENT_SHAPES})
        if ident_shapes.get(kname):
            entry['identification_shapes'] = ident_shapes[kname]
        if kname in WIDE_SCAN_KERNELS:
            shapes = blocks[kname]
            main = pick(shapes, dtype='float64', batch=1, d=WIDE_D, b=WIDE_B)
            entry.update(
                path='nlink scan', launches=launches['nlink_scan'][kname],
                per_iteration=launches['nlink_scan'][kname]
                / max(iterations['nlink_scan'], 1),
                max_abs_err=max(r['max_abs_err'] for r in shapes),
                max_rel_err=max(r['max_rel_err'] for r in shapes),
                dtype=main['dtype'], batch=1, cluster=main['cluster'],
                ms=main['ms'], cold_ms=main['cold_ms'],
                us_per_node=main['us_per_node'],
                in_solve_ms=in_solve['nlink_scan'].get(kname),
                plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                bound_by=main['bound_by'], library_ms=None, shapes=shapes)
            if kname == 'scan_factor_wide':
                entry['full_card'] = blocks['scan_factor_wide_full_card']
        elif kname in WIDE_KERNELS:
            shapes = blocks[kname]
            where = dict(dtype='float32', batch=1)
            if kname == 'block_inv_wide':
                where['d'] = WIDE_B
            main = pick(shapes, **where)
            entry.update(
                path='nlink', launches=launches['nlink'][kname],
                launches_float64_path=launches['nlink_f64'][kname],
                max_abs_err=max(r['max_abs_err'] for r in shapes),
                max_rel_err=max(r['max_rel_err'] for r in shapes),
                dtype=main['dtype'], batch=1, ms=main['ms'],
                cold_ms=main['cold_ms'],
                in_solve_ms=in_solve['nlink'].get(kname),
                plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                bound_by=main['bound_by'], library_ms=main['library_ms'],
                shapes=shapes)
            if kname == 'pcr_downsweep_wide':
                entry.update({k: main[k] for k in (
                    'cluster', 'stages', 'smem_bytes', 'threads',
                    'zero_stage_ms', 'zero_stage_cold_ms')})
        elif kname in pcr or kname in scan:
            shapes = pcr.get(kname) or scan[kname]
            path = 'cr' if kname in pcr else 'scan'
            main, other = (pick(shapes, dtype=tag, batch=BATCH, nodes=NODES)
                           for tag in (('float32', 'float64') if path == 'cr'
                                       else ('float64', 'float32')))
            entry.update(
                path=path, launches=launches[path][kname],
                max_abs_err=max(r['max_abs_err'] for r in shapes),
                max_rel_err=max(r['max_rel_err'] for r in shapes),
                dtype=main['dtype'], ms=main['ms'], cold_ms=main['cold_ms'],
                in_solve_ms=in_solve[path].get(kname),
                plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                bound_by=main['bound_by'], library_ms=None,
                other_dtype=dict((k, other[k]) for k in (
                    'dtype', 'ms', 'cold_ms', 'plain_ms', 'bound_ms',
                    'max_abs_err')), shapes=shapes)
            if path == 'scan':
                entry.update(redesign_of=['block_inv', 'block_matmul'],
                             us_per_node=main['us_per_node'])
        else:
            shapes = blocks[kname]
            main = pick(shapes, dtype='float32', d=B_BORDER, batch=BATCH) \
                if kname == 'block_inv' \
                else pick(shapes, dtype='float64', d=D, batch=8)
            entry.update(
                path='cr' if kname == 'block_inv' else None,
                launches=launches['cr'][kname],
                launches_scan_path=launches['scan'][kname],
                max_abs_err=max(r['max_abs_err'] for r in shapes),
                max_rel_err=max(r['max_rel_err'] for r in shapes),
                dtype=main['dtype'], d=main['d'], batch=main['batch'],
                ms=main['ms'], in_solve_ms=in_solve['cr'].get(kname),
                plain_ms=main['plain_ms'], bound_ms=main['bound_ms'],
                bound_by=main['bound_by'], library_ms=main['library_ms'],
                shapes=shapes)
        out.append(entry)
    return out


def main():
    if sys.argv[1:2] == ['--cpu-reference']:
        cpu_reference(sys.argv[2])
        return
    if sys.argv[1:2] == ['--gallery-process']:
        gallery_process(sys.argv[2], sys.argv[3:5])
        return
    if sys.argv[1:2] == ['--step-server']:
        step_server(sys.argv[2:])
        return
    if sys.argv[1:2] == ['--spike-phase']:
        spike_alone()
        return
    import torch
    if not torch.cuda.is_available():
        fail('no CUDA device: chip_smoke.py runs on the card only')
    sys.path.insert(0, HERE)
    from opty_tpu_torch.ops import block_kernels as bk
    from opty_tpu_torch.ops import pcr_kernels as pk
    from opty_tpu_torch.ops import scan_kernels as sk
    from opty_tpu_torch.examples import gallery
    counters = (pk, bk, sk)
    children = start_cpu_references(('cr', 'scan'))
    # the CPU's steps of 7a's and 7c's crossovers and of 9a, two step
    # servers that build their problems while the card's phases go on
    children['steps'] = start_step_server([NLINK_NAME])
    children['gallery steps'] = start_step_server(gallery.NAMES)
    try:
        run(torch, counters, pk, bk, sk, children)
    finally:
        stop_children(children)


def stop_children(children):
    """Kills what still runs of ``children`` and closes their pipes."""
    for child in children.values():
        if child.poll() is None:
            child.kill()
        for pipe in (child.stdin, child.stdout, child.stderr,
                     child.log_file):
            if pipe is not None:
                pipe.close()
        child.wait()


def device_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def run(torch, counters, pk, bk, sk, children):
    # 1. device
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = device_line()
    log('device: {} count={} torch={} cuda={} ({})'.format(
        name, count, torch.__version__, torch.version.cuda, smi))

    # 2. build
    t0 = time.time()
    logs = pk.build_kernels()
    log('build: {:.1f} s ({})'.format(time.time() - t0,
                                      ', '.join(logs) or 'cached'))
    for src, text in logs.items():
        for line in text.splitlines():
            if 'Compiling entry' in line or 'Used' in line \
                    or 'spill' in line:
                log('ptxas {}: {}'.format(src, line.strip()))
    dmma_in_sass()

    # 3. kernels against plain versions
    pcr = phase('3 pcr kernels', check_kernels, pk, name)
    scan = phase('3 scan kernels', check_scan_kernels, sk, name)
    phase('3 empty kernel', empty_kernel_ms, bk)
    blocks = phase('3 block kernels', check_block_kernels, bk, name)
    # 3w. the wide variants at the nlink-9 block; 3ws. the wide scan
    # kernels
    wide = phase('3w wide kernels', check_wide_kernels, pk, bk, name)
    wide.update(phase('3ws wide scan kernels', check_wide_scan_kernels, sk,
                      name))
    ident_shapes = phase('3w identification shapes', check_shapes, pk, bk,
                         name, IDENT_SHAPES, '3w')
    gal_shapes = phase('3w gallery shapes', check_shapes, pk, bk, name,
                       GALLERY_SHAPES, '3w (gallery shapes)')

    # 4. small reference solves, card against CPU
    phase('4 reference cr', reference_solve, 'cr', counters,
          children['cr'])
    ref = phase('4b reference scan', reference_solve, 'scan', counters,
                children['scan'])
    if not (ref['scan_factor'] and ref['scan_solve']) \
            or ref['block_inv'] or ref['block_matmul']:
        fail('the N = 101 scan solve on the card did not run through the '
             'scan kernels alone: {}'.format(json.dumps(ref)))
    # 4c. restoration with the default options, card against CPU
    rest_cr = phase('4c restoration cr', restoration_phase, counters,
                       'cr', children['cr'],
                       ('pcr_factor_levels', 'pcr_downsweep', 'block_inv'))
    rest_scan = phase('4c restoration scan', restoration_phase,
                         counters, 'scan', children['scan'],
                         ('scan_factor', 'scan_solve'))

    # 5. the main path, 5b. the scan path, 5c. the default path
    cr_launches, cr_wall, cr_iters = phase(
        '5 main path', queue_path, counters, 'main path',
        dict(kkt_method='cr', factor_dtype=torch.float32, use_soc=False,
             mu_strategy='monotone'),
        ('pcr_factor_levels', 'pcr_downsweep', 'block_inv'))
    scan_launches, scan_wall, scan_iters = phase(
        '5b scan path', queue_path, counters, 'scan path',
        dict(kkt_method='scan', factor_dtype=torch.float64, use_soc=False,
             mu_strategy='monotone'),
        ('scan_factor', 'scan_solve'), ('block_inv', 'block_matmul'))
    def_launches, def_wall, def_iters = phase(
        '5c default path', queue_path, counters, 'default path', {},
        ('pcr_factor_levels', 'pcr_downsweep', 'block_inv'),
        ('scan_factor', 'scan_solve'),
        DEFAULT_MEAN_FACTOR * JAX_DEFAULT_MEAN)
    log('queues of 64 on 32 lanes ({}): cr float32 factor + 6 rounds '
        '{:.2f} s ({:.3f} solves/s, mean {:.2f} iterations); scan float64 '
        'factor + 1 round {:.2f} s ({:.3f} solves/s, mean {:.2f} '
        'iterations); default options (cr float32 factor + 6 rounds, '
        'adaptive mu, SOC, restoration) {:.2f} s ({:.3f} solves/s, mean '
        '{:.2f} iterations against the JAX package\'s {:.2f})'.format(
            smi, cr_wall, 64 / cr_wall, cr_iters, scan_wall,
            64 / scan_wall, scan_iters, def_wall, 64 / def_wall, def_iters,
            JAX_DEFAULT_MEAN))

    # 6. where an iteration's time goes (after the counters were read)
    profiles = {
        'cr': phase('6 profile cr', iteration_profile, counters, 'cr',
                    BATCH, 8, dict(kkt_method='cr',
                                   factor_dtype=torch.float32,
                                   use_soc=False, mu_strategy='monotone')),
        'scan': phase('6 profile scan', iteration_profile, counters, 'scan',
                      BATCH, 4, dict(kkt_method='scan',
                                     factor_dtype=torch.float64,
                                     use_soc=False,
                                     mu_strategy='monotone')),
        'default': phase('6 profile default', iteration_profile, counters,
                         'default', BATCH, 8, {})}
    solves = {p: profiles[p][1]['pcr_downsweep'] for p in ('cr', 'default')}
    log('profile: pcr_downsweep launches (one a solve) per iteration: cr '
        '{:.3f}, default {:.3f}; the corrector and the SOC add {:.3f} '
        'solves an iteration'.format(solves['cr'], solves['default'],
                                     solves['default'] - solves['cr']))
    # the nlink-9 chain at N = 60 (phase 7's problem, built here): 8
    # lanes from its initial guess and small perturbations of it, the
    # card's default factorization
    prob, guess = phase('7 nlink build', nlink_problem, 'cuda')
    rng = np.random.default_rng(3)

    def nlink_lanes(lanes):
        return prob, guess[None] + 0.01 * rng.standard_normal(
            (lanes, guess.size))
    profiles['nlink'] = phase(
        '6 profile nlink', iteration_profile, counters, 'nlink', 8, 2,
        dict(NLINK_OPTIONS, kkt_method='cr', factor_dtype=torch.float32),
        nlink_lanes)
    profiles['nlink_scan'] = phase(
        '6 profile nlink scan', iteration_profile, counters, 'nlink scan', 8,
        2, dict(NLINK_OPTIONS, kkt_method='scan', factor_dtype=torch.float64),
        nlink_lanes)
    in_solve = {p: v[0] for p, v in profiles.items()}

    # 7a. the nlink-9 solve, float64 factorization, against the CPU's;
    # 7c. the JAX package's gait-scale configuration (scan, float64);
    # 7b. the card's default factorization, NLINK_DEFAULT_MAX_ITER
    # iterations of its stall
    from opty_tpu_torch.config import default_factor_dtype
    # the crossovers' CPU steps: a step server started at the beginning
    # (it builds the CPU's nlink-9 problem there) takes them while the
    # card's solve goes on
    steps_cpu = CPUSteps.of(children['steps'])
    nlink_f64, rec_f64 = phase(
        '7a nlink float64', nlink_path, counters, 'nlink float64', prob,
        guess, torch.float64, NLINK_CPU, crossovers=NLINK_CROSSOVERS,
        cpu=steps_cpu)
    sweep_ms, sweep_calls = phase('7a wide downsweep in the solve',
                                  sweep_in_solve, prob, guess)
    per_iter = nlink_f64['pcr_downsweep_wide'] / max(rec_f64['iterations'],
                                                     1)
    log('nlink float64: pcr_downsweep_wide {} launches in {} iterations '
        '({:.3f} an iteration), {:.2f} us a call in the solve (profiler, its '
        'first {} calls): {:.4f} ms of device time an iteration ({})'.format(
            nlink_f64['pcr_downsweep_wide'], rec_f64['iterations'], per_iter,
            sweep_ms * 1e3, sweep_calls, per_iter * sweep_ms, smi))
    # 8a, 8b. the JAX package's identification examples at their sizes
    ident = {label: phase(label + ' identification', ident_solve, counters,
                          label, smi) for label in IDENT_SHAPES}
    # 9a-9c. the gallery and the swing-up example, in a second process
    # on the card beside 7d, 7f, 7c and 7b (their gates are numerical
    # and they report no device time; the phases before them had the
    # card to themselves)
    gallery_run = start_gallery_process(children['gallery steps'])
    children['gallery process'] = gallery_run[0]
    phase('7d reproducibility', reproducibility, prob, guess)
    phase('7f pivot edges', pivot_edges, pk, bk, prob, guess)
    nlink_scan, rec_scan = phase(
        '7c nlink scan float64', nlink_path, counters, 'nlink scan float64',
        prob, guess, torch.float64, kkt_method='scan',
        required=WIDE_SCAN_KERNELS, forbidden=PCR_KERNELS,
        crossovers=NLINK_SCAN_CROSSOVERS, cpu=steps_cpu,
        step_tol=NLINK_SCAN_STEP_TOL)
    log('nlink scan float64: status={} iterations={} obj={:.12g} '
        'wall_s={:.2f} '
        'on the card; the JAX package on the CPU (gait_scale.py '
        '--small-program, printed, not gated): status={} iterations={} '
        'obj={:.12g} warm_solve_s={}'.format(
            rec_scan['status'], rec_scan['iterations'], rec_scan['obj'],
            rec_scan['wall_s'], JAX_GAIT_CPU['status'],
            JAX_GAIT_CPU['iterations'], JAX_GAIT_CPU['obj'],
            JAX_GAIT_CPU['warm_solve_s']))
    nlink_def, rec_def = phase(
        '7b nlink default', nlink_path, counters, 'nlink default', prob,
        guess, default_factor_dtype(prob.device),
        max_iter=NLINK_DEFAULT_MAX_ITER)
    log('nlink default: objective {:.6f} after {} iterations (status {}); '
        'the JAX package\'s cr float32 run stalls at {:.2f} (status {} after '
        '{} iterations, recorded)'.format(
            rec_def['obj'], rec_def['iterations'], rec_def['status'],
            JAX_CR_F32_STALL['obj'], JAX_CR_F32_STALL['status'],
            JAX_CR_F32_STALL['iterations']))
    log('nlink-{} N={} ({}): float64 factor {} in {} iterations, {:.2f} s; '
        'scan float64 factor {} in {} iterations, {:.2f} s; the card\'s '
        'default (float32 factor + 6 rounds) {} after {} iterations, {:.2f} '
        's; the JAX package on the CPU: {}'.format(
            NLINK_LINKS, NLINK_NODES, smi, rec_f64['status'],
            rec_f64['iterations'], rec_f64['wall_s'], rec_scan['status'],
            rec_scan['iterations'], rec_scan['wall_s'], rec_def['status'],
            rec_def['iterations'], rec_def['wall_s'],
            json.dumps(JAX_GAIT_CPU)))

    gallery = finish_gallery_process(gallery_run, children['gallery steps'])
    for kname, recs in gal_shapes.items():
        if recs:
            gallery[kname]['gallery_shapes'] = recs

    blocks.update(wide)
    records = kernel_records(
        pcr, scan, blocks, {'cr': cr_launches, 'scan': scan_launches,
                            'default': def_launches, 'rest_cr': rest_cr,
                            'rest_scan': rest_scan, 'nlink': nlink_def,
                            'nlink_f64': nlink_f64, 'nlink_scan': nlink_scan,
                            '8a': ident['8a'][0], '8b': ident['8b'][0]},
        dict(in_solve, **{label: ident[label][1]['in_solve_ms']
                          for label in IDENT_SHAPES}),
        {'nlink_scan': rec_scan['iterations'],
         '8a': ident['8a'][1]['iterations'],
         '8b': ident['8b'][1]['iterations']}, ident_shapes)
    for entry in records:
        entry.update(gallery.get(entry['name'], {}))
    print(json.dumps({'kernels': records}), flush=True)
    print(smi, flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name, 'count': count}}), flush=True)


if __name__ == '__main__':
    main()
