"""Hand-written CUDA kernels for the PCR factorization, their plain
PyTorch versions, their launch plan and their launch counters.

The counterpart of opty_tpu/ops/pallas_pcr.py.  Two kernels, both in
csrc/pcr.cu, built for Hopper (sm_90a) with nvcc at first use and
loaded through ctypes (ops/cuda_build.py):

* ``pcr_factor_levels`` replaces ``_factor_kernel`` (reached through
  ``pcr_factor_fused``): every PCR level of the bordered
  block-tridiagonal system in one launch.  Bound on an H100 by device
  memory: it writes L levels of two d x d multipliers per node plus the
  final inverse and border columns (37.5 MB at the main path's
  B = 32, d = 5, b = 4, N = 501, float32) for ~0.3 GFLOP.
* ``pcr_downsweep`` replaces ``_downsweep_kernel`` (reached through
  ``pcr_downsweep_fused``): r <- r - A_l r_{k-s} - B_l r_{k+s} through
  every stored level.  Bound by reading the stored levels (28.9 MB at
  the main path).

Both run one instance on a thread block cluster (``launch_plan``): the
node axis is split over C blocks so that the main path's 32 instances
cover the card, and neighbours in other blocks are read from their
shared memory.  The factor runs a thread per node and keeps its level
state in shared memory, or, for an instance too large for one cluster's
shared memory, in a global scratch; the downsweep runs a thread per
(node, row) that loads the next level into registers while this one
computes, each thread looping where a block owns more pairs than
threads.  Both need sm_90 clusters.  The factor takes any N; the
downsweep's r must fit a cluster's shared memory (2 d values a node:
d = 5, float32, N up to 92,976), beyond which it raises ValueError.

Those kernels hold a node's d x d blocks in one thread's registers and
are built for d in {3, 5} with b <= 8.  Every other shape up to
d = 64 and b = 64 goes to the wide variants in csrc/wide.cu:
``pcr_factor_levels`` as L + 1 launches of a thread block per node with
the blocks in shared memory (one launch per level, a node's next
inverse formed beside its level update; a call is counted once in
``wide_factor_launches``), and ``pcr_downsweep`` on a plan of its own
(``launch_plan('wide_downsweep', ...)``, ``wide_downsweep_launches``):
a cluster of up to 16 blocks an instance that split its rows, the
stored levels streamed by bulk copies into a ring of shared-memory
stages ahead of the sums, each block's new rows of r copied to every
other block after each level; or, where two units cannot fit beside r,
zero stages and the narrow kernel's design with A and B read from
device memory (counted also in ``wide_downsweep_direct_launches``).
``pcr_downsweep_in_order`` forms the wide kernel's sums in its order in
PyTorch, so that the card's result can be held to it bitwise.

Unlike the Pallas kernels, neither pads the node axis: outputs keep the
caller's N.  A tensor on the CPU goes to the plain version
(``pcr_factor_levels_plain``/``pcr_downsweep_plain``, the level loops
of opty_tpu/ops/tridiag.py); a CUDA tensor goes to a kernel, or the
wrapper raises.  Each wrapper counts its kernel launches in
``factor_launches``/``downsweep_launches`` (and the wide counters).

``kernel_supported(d, b, N, dtype)`` says, from static shapes alone,
whether the kernels take a system, as the JAX package's
``fused_supported`` does for its Pallas kernels.  It decides no route:
on the card a system outside it raises with its shape.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from .cuda_build import build_kernels, check_cuda, launch, load
from .lanes import block_inv_nl, matmul_nl, matvec_nl, transpose_nl
from .tridiag import _down, _up, num_levels

__all__ = ['pcr_factor_levels', 'pcr_downsweep', 'pcr_factor_levels_plain',
           'pcr_downsweep_plain', 'pcr_downsweep_in_order', 'launch_plan',
           'LaunchPlan', 'WideSweepPlan', 'wide_sweep_smem',
           'wide_staged_plan', 'wide_direct_plan', 'launch_wide_downsweep',
           'build_kernels',
           'reset_launch_counts', 'kernel_supported', 'SUPPORTED_D', 'MAX_B',
           'WIDE_MAX_D', 'WIDE_MAX_B']

SUPPORTED_D = (3, 5)      # block sizes instantiated in csrc/pcr.cu
MAX_B = 8                 # widest border the kernels take
WIDE_MAX_D = 64           # the wide variants (csrc/wide.cu): 1 <= d <= 64,
WIDE_MAX_B = 64           # 0 <= b <= 64
MAX_SMEM = 227 * 1024     # dynamic shared memory a block may use (H100)
MAX_FACTOR_THREADS = 256  # the kernels' __launch_bounds__ (csrc/pcr.cu)
MAX_SWEEP_THREADS = 1024
FILL_BLOCKS = 256         # about two blocks for each of the H100's 132 SMs
PORTABLE_CLUSTER = 8      # larger clusters need the non-portable attribute
MAX_CLUSTER = 16          # the most an H100 schedules
# clusters of C blocks that an H100 (132 SMs in GPCs of up to 18) holds
# at once where each block takes most of an SM's shared memory, as the
# wide downsweep's do (cudaOccupancyMaxActiveClusters on an H100 80GB
# HBM3): the wide plan keeps a batch within one wave of clusters, which
# measured faster than more blocks an instance in two waves
ACTIVE_CLUSTERS = {16: 7, 8: 15, 4: 30, 2: 66, 1: 132}

factor_launches = 0
downsweep_launches = 0
wide_factor_launches = 0
wide_downsweep_launches = 0
wide_downsweep_direct_launches = 0   # of those, the zero-stage branch


def reset_launch_counts():
    global factor_launches, downsweep_launches, wide_factor_launches, \
        wide_downsweep_launches, wide_downsweep_direct_launches
    factor_launches = 0
    downsweep_launches = 0
    wide_factor_launches = 0
    wide_downsweep_launches = 0
    wide_downsweep_direct_launches = 0


def _narrow(d, b):
    """Whether csrc/pcr.cu's register kernels are built for (d, b)."""
    return d in SUPPORTED_D and 0 <= b <= MAX_B


def _sweep_fits(d, N, dtype):
    """Whether the downsweep's r fits the shared memory of a cluster of
    MAX_CLUSTER blocks (launch_plan raises beyond)."""
    return 2 * d * -(-N // MAX_CLUSTER) * dtype.itemsize <= MAX_SMEM


def kernel_supported(d, b, N, dtype):
    """True when the cr path's kernels take a (d, b, N) system in
    ``dtype`` on the card: the factor, the downsweep and the border
    inverse (ops/block_kernels.py).  A pure function of static shape
    and dtype; on the card the wrappers raise outside it."""
    if dtype not in (torch.float32, torch.float64) or N < 1:
        return False
    if not (1 <= d <= WIDE_MAX_D and 0 <= b <= WIDE_MAX_B):
        return False
    return _sweep_fits(d, N, dtype)


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def pcr_factor_levels_plain(D, E, F):
    """Every PCR level of (..., d, d, N) systems in plain PyTorch.

    Returns (A (..., L, d, d, N), B (..., L, d, d, N), Dinv (..., d, d, N),
    Fp (..., d, b, N), Z (..., d, b, N)) with Z = Dinv^T F."""
    N = D.shape[-1]
    F0 = F
    Lb = E                                    # couples u_{k-s}
    Ub = transpose_nl(_up(E, 1))              # E_{k+1}^T couples u_{k+s}
    A_levels, B_levels = [], []
    s = 1
    for _ in range(num_levels(N)):
        Dinv = block_inv_nl(D)
        A = matmul_nl(Lb, _down(Dinv, s))
        B = matmul_nl(Ub, _up(Dinv, s))
        D = D - matmul_nl(A, _down(Ub, s)) - matmul_nl(B, _up(Lb, s))
        F = F - matmul_nl(A, _down(F, s)) - matmul_nl(B, _up(F, s))
        Lb, Ub = -matmul_nl(A, _down(Lb, s)), -matmul_nl(B, _up(Ub, s))
        A_levels.append(A)
        B_levels.append(B)
        s *= 2
    Dinv = block_inv_nl(D)
    Z = matmul_nl(transpose_nl(Dinv), F0)
    return (torch.stack(A_levels, dim=-4), torch.stack(B_levels, dim=-4),
            Dinv, F, Z)


def pcr_downsweep_plain(A, B, r):
    """r (..., d, N) through every stored level of A, B (..., L, d, d, N)."""
    s = 1
    for l in range(A.shape[-4]):
        r = (r - matvec_nl(A[..., l, :, :, :], _down(r, s))
             - matvec_nl(B[..., l, :, :, :], _up(r, s)))
        s *= 2
    return r


def pcr_downsweep_in_order(A, B, r):
    """``pcr_downsweep_plain`` with each sum formed in the wide kernel's
    order (csrc/wide.cu): at each level and (row, node), ta = sum over j
    ascending of A[i, j] * r[j] at node k - s, a product and then an add
    (no fused multiply-add), tb the same of B at k + s, then
    (r - ta) - tb; a neighbour outside [0, N) is a zero multiplied in.
    Elementwise torch operations round each step as the kernel does, so
    the two agree bitwise on any device.  Tests and chip_smoke.py only."""
    d = r.shape[-2]
    s = 1
    for l in range(A.shape[-4]):
        rm, rp = _down(r, s), _up(r, s)
        Al, Bl = A[..., l, :, :, :], B[..., l, :, :, :]
        ta = Al[..., :, 0, :] * rm[..., None, 0, :]
        tb = Bl[..., :, 0, :] * rp[..., None, 0, :]
        for j in range(1, d):
            ta = ta + Al[..., :, j, :] * rm[..., None, j, :]
            tb = tb + Bl[..., :, j, :] * rp[..., None, j, :]
        r = (r - ta) - tb
        s *= 2
    return r


# ---------------------------------------------------------------------------
# launch plan
# ---------------------------------------------------------------------------

class LaunchPlan(NamedTuple):
    cluster: int          # C blocks per instance (a thread block cluster)
    nodes_per_block: int  # block r owns nodes [r * npb, min((r+1) * npb, N))
    threads: int          # threads per block: the factor's one per node,
                          # the downsweep's one per (node, row), each
                          # looping where the block owns more
    smem_bytes: int       # dynamic shared memory per block
    blocks: int           # the grid: batch * cluster
    scratch: int          # the factor's state values per block in a global
                          # scratch (0: the state lies in shared memory)


class WideSweepPlan(NamedTuple):
    cluster: int          # C blocks per instance (a thread block cluster)
    rows_per_block: int   # stages > 0: block q owns rows [q d // C,
                          # (q + 1) d // C), at most this many, at every
                          # node; 0 stages: every row (d)
    nodes_per_block: int  # stages > 0: N; 0 stages: block q owns nodes
                          # [q * npb, min((q + 1) * npb, N))
    stages: int           # units (a row of a level of A and of B) the
                          # shared-memory ring holds; 0: A and B read from
                          # device memory
    threads: int          # threads per block: one per (row, node), each
                          # looping where the block owns more, and (stages
                          # > 0) a producer warp
    smem_bytes: int       # dynamic shared memory per block
    blocks: int           # the grid: batch * cluster


def wide_sweep_smem(d, N, stages, rows, itemsize):
    """Bytes of shared memory a block of the wide downsweep's staged
    branch takes (csrc/wide.cu:SweepLayout) for a cluster whose blocks
    own up to ``rows`` rows: a full and an empty mbarrier for each of
    max(stages, rows) units in turn, two for the exchange of r, one for
    its first copy, and a zero; r twice (ping-pong, d rows of N values
    padded to 16 bytes); ``stages`` units of two slabs of d x N values,
    each with 16 bytes for its source's alignment."""
    a16 = lambda n: -(-n // 16) * 16
    r = a16(d * a16(N * itemsize))
    slab = a16(d * N * itemsize) + 16
    return a16(8 * (2 * max(stages, rows) + 4)) + 2 * r + 2 * stages * slab


def _state_values(d, b, npb):
    """The factor's state per block: [D | Lb | Ub | F] ping-pong and two
    buffers of inverses (csrc/pcr.cu)."""
    return (2 * (3 * d * d + d * b) + 2 * d * d) * npb


def _split(N, cluster):
    """(C, npb): ``cluster`` halved while a block would own no node."""
    C = cluster
    while C > 1 and -(-N // C) * (C - 1) >= N:
        C //= 2
    return C, -(-N // C)


def _wide_sweep_plan(batch, d, N, dtype):
    """The wide downsweep's plan (see ``launch_plan``)."""
    C = 1 << (min(d, MAX_CLUSTER).bit_length() - 1)
    while C > 1 and batch > ACTIVE_CLUSTERS[C]:
        C //= 2
    return wide_staged_plan(batch, d, N, dtype, C) \
        or wide_direct_plan(batch, d, N, dtype)


def wide_staged_plan(batch, d, N, dtype, cluster):
    """The wide downsweep's staged plan on clusters of ``cluster`` blocks
    (at most d), or None where two units do not fit beside r."""
    es = dtype.itemsize
    L = num_levels(N)
    rows = -(-d // cluster)
    least = min(2, L * (d // cluster))     # two units, or all a block has
    stages = min(2, L) * rows
    while stages > least \
            and wide_sweep_smem(d, N, stages, rows, es) > MAX_SMEM:
        stages -= 1
    smem = wide_sweep_smem(d, N, stages, rows, es)
    if smem > MAX_SMEM:
        return None
    threads = min(MAX_SWEEP_THREADS - 32, -(-rows * N // 32) * 32) + 32
    return WideSweepPlan(cluster, rows, N, stages, threads, smem,
                         batch * cluster)


def wide_direct_plan(batch, d, N, dtype):
    """The wide downsweep's zero-stage plan: the narrow kernel's node
    split ('downsweep'), A and B read from device memory.  Where the
    ring fits, ``launch_wide_downsweep`` takes it too (the card's tests
    and chip_smoke.py hold the two branches to each other and time
    them)."""
    p = launch_plan('downsweep', batch, d, 0, N, dtype)
    return WideSweepPlan(p.cluster, d, p.nodes_per_block, 0, p.threads,
                         p.smem_bytes, p.blocks)


@functools.lru_cache(maxsize=256)
def launch_plan(kernel, batch, d, b, N, dtype):
    """How ``kernel`` ('factor', 'downsweep' or 'wide_downsweep') runs
    ``batch`` instances of (d, b, N) in ``dtype``.

    'wide_downsweep' (csrc/wide.cu, every d the register kernels do not
    take) returns a ``WideSweepPlan``: C is the largest power of two up
    to MAX_CLUSTER and d whose ``batch`` clusters the card holds at once
    (ACTIVE_CLUSTERS: 16 blocks at up to 7 instances, 8 at up to 15, 2
    at 32), the blocks split the d rows, and the ring takes up to two
    levels of a block's units (a row of a level of A and of B each), at
    least two, within MAX_SMEM beside r's two buffers; a thread per
    (row, node) up to 992 and the producer's warp.  Where two units do
    not fit (large N), zero stages, on the narrow kernel's node split
    ('downsweep' below).  Every other kernel returns a ``LaunchPlan``.

    C, the cluster size, starts at the smallest power of two that gives
    at least FILL_BLOCKS blocks (at most PORTABLE_CLUSTER), and shrinks
    while a block would own no node.  The factor's C grows until its
    share of the state fits half of MAX_SMEM, so that two blocks share
    an SM and the card holds every cluster at once (or, where no
    portable cluster does that, all of MAX_SMEM at up to MAX_CLUSTER);
    where none fits, the state goes to a global scratch at the first C.
    The downsweep's C grows, within the portable sizes, until each
    (node, row) has a thread of its own, then, up to MAX_CLUSTER, until
    r fits MAX_SMEM; ValueError where it does not.  Memoised (the plan
    is an immutable tuple): the main path plans thousands of launches
    of a few shapes.
    """
    if kernel == 'wide_downsweep':
        return _wide_sweep_plan(batch, d, N, dtype)
    if kernel not in ('factor', 'downsweep'):
        raise ValueError('launch_plan: unknown kernel {!r}'.format(kernel))
    es = dtype.itemsize
    want = 1
    while want < PORTABLE_CLUSTER and batch * want < FILL_BLOCKS:
        want *= 2
    if kernel == 'factor':
        for top, smem_limit in ((PORTABLE_CLUSTER, MAX_SMEM // 2),
                                (MAX_CLUSTER, MAX_SMEM)):
            cluster = want
            while cluster <= top:
                C, npb = _split(N, cluster)
                smem = _state_values(d, b, npb) * es
                if smem <= smem_limit:
                    threads = min(MAX_FACTOR_THREADS, -(-npb // 32) * 32)
                    return LaunchPlan(C, npb, threads, smem, batch * C, 0)
                cluster *= 2
        C, npb = _split(N, want)
        threads = min(MAX_FACTOR_THREADS, -(-npb // 32) * 32)
        return LaunchPlan(C, npb, threads, 0, batch * C,
                          _state_values(d, b, npb))
    cluster = want
    while cluster < PORTABLE_CLUSTER \
            and d * _split(N, cluster)[1] > MAX_SWEEP_THREADS:
        cluster *= 2
    while True:
        C, npb = _split(N, cluster)
        smem = 2 * d * npb * es                  # r ping-pong
        if smem <= MAX_SMEM:
            threads = min(MAX_SWEEP_THREADS, -(-d * npb // 32) * 32)
            return LaunchPlan(C, npb, threads, smem, batch * C, 0)
        if cluster >= MAX_CLUSTER:
            raise ValueError(
                'pcr downsweep: r of N={} nodes of d={} in {} needs {} bytes '
                'of shared memory a block on a cluster of {} blocks (limit '
                '{})'.format(N, d, dtype, smem, MAX_CLUSTER, MAX_SMEM))
        cluster *= 2


_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
               for name, args in (
                   ('pcr_factor_levels', [_VP] * 9 + [_CI] * 9 + [_VP]),
                   ('pcr_downsweep', [_VP] * 4 + [_CI] * 8 + [_VP]))}
_WIDE_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
                    for name, args in (
                        ('pcr_wide_factor', [_VP] * 9 + [_CI] * 5 + [_VP]),
                        ('pcr_wide_downsweep',
                         [_VP] * 4 + [_CI] * 9 + [_VP]),
                        ('block_inv_wide', [_VP, _VP, _CI, _CI, _VP]))}


def _check_dims(name, d, b, N):
    if not 1 <= d <= WIDE_MAX_D:
        raise ValueError('{}: block size d={} is not built (built: 1..{})'
                         .format(name, d, WIDE_MAX_D))
    if not 0 <= b <= WIDE_MAX_B:
        raise ValueError('{}: border width b={} exceeds {}'.format(
            name, b, WIDE_MAX_B))
    if N < 1:
        raise ValueError('{}: empty node axis'.format(name))


def _wide_scratch_values(d, b):
    """The wide factor's scratch per node: two level states of
    3 d^2 + d b values and two inverse buffers of d^2 (csrc/wide.cu)."""
    return 2 * (3 * d * d + d * b) + 2 * d * d


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def pcr_factor_levels(D, E, F):
    """PCR factorization levels of a batch of systems.

    D, E (B, d, d, N) with E[..., 0] = 0, F (B, d, b, N).  Returns
    (A (B, L, d, d, N), B (B, L, d, d, N), Dinv (B, d, d, N),
    Fp (B, d, b, N), Z (B, d, b, N)), L = ceil(log2 N)."""
    if D.ndim != 4:
        raise ValueError('pcr_factor_levels: D must be (B, d, d, N)')
    nbatch, d, _, N = D.shape
    b = F.shape[-2]
    if D.device.type == 'cpu' and E.device.type == 'cpu' \
            and F.device.type == 'cpu':
        return pcr_factor_levels_plain(D, E, F)
    suffix = check_cuda('pcr_factor_levels', (D, E, F),
                        ((nbatch, d, d, N), (nbatch, d, d, N),
                         (nbatch, d, b, N)))
    _check_dims('pcr_factor_levels', d, b, N)
    L = num_levels(N)
    new = lambda *shape: torch.empty(shape, dtype=D.dtype, device=D.device)
    A = new(nbatch, L, d, d, N)
    B = new(nbatch, L, d, d, N)
    Dinv = new(nbatch, d, d, N)
    Fp = new(nbatch, d, b, N)
    Z = new(nbatch, d, b, N)
    global factor_launches, wide_factor_launches
    if not _narrow(d, b):
        scratch = new(nbatch * N * _wide_scratch_values(d, b))
        fn = getattr(load('wide', _WIDE_SIGNATURES),
                     'pcr_wide_factor_' + suffix)
        launch('pcr_factor_levels', fn,
               (D.data_ptr(), E.data_ptr(), F.data_ptr(), A.data_ptr(),
                B.data_ptr(), Dinv.data_ptr(), Fp.data_ptr(), Z.data_ptr(),
                scratch.data_ptr(), nbatch, d, b, N, L), D.device)
        wide_factor_launches += 1
        return A, B, Dinv, Fp, Z
    plan = launch_plan('factor', nbatch, d, b, N, D.dtype)
    scratch = new(nbatch, plan.cluster, plan.scratch) if plan.scratch \
        else None
    fn = getattr(load('pcr', _SIGNATURES), 'pcr_factor_levels_' + suffix)
    launch('pcr_factor_levels', fn,
           (D.data_ptr(), E.data_ptr(), F.data_ptr(), A.data_ptr(),
            B.data_ptr(), Dinv.data_ptr(), Fp.data_ptr(), Z.data_ptr(),
            None if scratch is None else scratch.data_ptr(), nbatch, d, b,
            N, L, plan.cluster, plan.nodes_per_block, plan.threads,
            plan.smem_bytes), D.device)
    factor_launches += 1
    return A, B, Dinv, Fp, Z


def pcr_downsweep(A, B, r):
    """r (B, d, N) through every stored level of A, B (B, L, d, d, N)."""
    if A.ndim != 5:
        raise ValueError('pcr_downsweep: A must be (B, L, d, d, N)')
    nbatch, L, d, _, N = A.shape
    if A.device.type == 'cpu' and B.device.type == 'cpu' \
            and r.device.type == 'cpu':
        return pcr_downsweep_plain(A, B, r)
    suffix = check_cuda('pcr_downsweep', (A, B, r),
                        ((nbatch, L, d, d, N), (nbatch, L, d, d, N),
                         (nbatch, d, N)))
    _check_dims('pcr_downsweep', d, 0, N)
    if _narrow(d, 0):
        out = torch.empty_like(r)
        plan = launch_plan('downsweep', nbatch, d, 0, N, r.dtype)
        fn = getattr(load('pcr', _SIGNATURES), 'pcr_downsweep_' + suffix)
        launch('pcr_downsweep', fn,
               (A.data_ptr(), B.data_ptr(), r.data_ptr(), out.data_ptr(),
                nbatch, d, N, L, plan.cluster, plan.nodes_per_block,
                plan.threads, plan.smem_bytes), r.device)
        global downsweep_launches
        downsweep_launches += 1
        return out
    return _wide_sweep(A, B, r, launch_plan('wide_downsweep', nbatch, d, 0,
                                            N, r.dtype), suffix)


def launch_wide_downsweep(A, B, r, plan):
    """csrc/wide.cu's downsweep of CUDA tensors on ``plan`` (a
    ``WideSweepPlan``); pcr_downsweep launches it on
    ``launch_plan('wide_downsweep', ...)``.  Counted in
    wide_downsweep_launches, and a zero-stage plan also in
    wide_downsweep_direct_launches."""
    nbatch, L, d, _, N = A.shape
    suffix = check_cuda('pcr_downsweep', (A, B, r),
                        ((nbatch, L, d, d, N), (nbatch, L, d, d, N),
                         (nbatch, d, N)))
    _check_dims('pcr_downsweep', d, 0, N)
    return _wide_sweep(A, B, r, plan, suffix)


def _wide_sweep(A, B, r, plan, suffix):
    nbatch, L, d, _, N = A.shape
    out = torch.empty_like(r)
    fn = getattr(load('wide', _WIDE_SIGNATURES),
                 'pcr_wide_downsweep_' + suffix)
    launch('pcr_downsweep', fn,
           (A.data_ptr(), B.data_ptr(), r.data_ptr(), out.data_ptr(), nbatch,
            d, N, L, plan.cluster, plan.nodes_per_block, plan.threads,
            plan.smem_bytes, plan.stages), r.device)
    global wide_downsweep_launches, wide_downsweep_direct_launches
    wide_downsweep_launches += 1
    if not plan.stages:
        wide_downsweep_direct_launches += 1
    return out
