"""Hand-written CUDA kernels for the scan KKT factorization and solve,
their plain PyTorch versions and their launch counters.

Two kernels, each in two builds for Hopper (sm_90a), compiled with nvcc
at first use and loaded through ctypes (ops/cuda_build.py):

* ``scan_factor``: the forward elimination of nlp/kkt.py:factor_kkt
  (opty_tpu/nlp/kkt.py:225-253) over every node of every lane in one
  launch.  It takes in the pivot inverses and square products that the
  Pallas kernels ``_inv_kernel``/``_matmul_kernel``
  (opty_tpu/ops/pallas_blocks.py) compute, and the border Schur inverse
  at its end.
* ``scan_solve``: the whole of nlp/kkt.py:solve_factored
  (opty_tpu/nlp/kkt.py:256-295) in one launch.

Both walk the N nodes of a lane in order, so each lane's chain of node
steps, not bytes, bounds them.  Arrays are lanes first, (..., N, d, d),
float32 or float64.  Node blocks of d = 2..8 with a border of b = 0..8
go to csrc/scan.cu (a thread per matrix entry, counted in
``factor_launches``/``solve_launches``); every other d = 1..64, b =
0..64 whose shared memory fits (``wide_smem``) to csrc/scan_wide.cu
(counted in ``wide_factor_launches``/``wide_solve_launches``), such as
the nlink-9 chain's d = 50, b = 41.  There each lane runs on a thread
block cluster of ``cluster_size(B, d, b, dtype)`` blocks of 256
threads: the factor's chain (M_k, S_k, S_k^-1) on one block and, in a
cluster of two, the products off it (Ft_k, T_k, the border sum) on the
other, a node behind; the solve's two chains on one block and the
per-node products between them spread over the cluster's blocks.

A tensor on the CPU goes to the plain version (``scan_factor_plain``/
``scan_solve_plain``: the node loops of the JAX package's ``lax.scan``
recursions, the CPU path and its parity target); a CUDA tensor goes to
a kernel, or the wrapper raises.

``kernel_supported(d, b, N, dtype)`` says, from static shapes alone,
whether the kernels take a system.  It decides no route: on the card
a system outside it (d or b above 64) raises with its shape.
"""

import ctypes

import torch

from .block_kernels import block_matmul_plain
from .cuda_build import check_cuda, launch, load
from .smallblock import block_inv

__all__ = ['scan_factor', 'scan_solve', 'scan_factor_plain',
           'scan_solve_plain', 'check_factor', 'check_solve',
           'reset_launch_counts', 'kernel_supported', 'wide_smem',
           'cluster_size', 'launch_wide_factor', 'launch_wide_solve',
           'SUPPORTED_D', 'MAX_B', 'WIDE_MAX_D', 'WIDE_MAX_B', 'MAX_SMEM',
           'FACTOR_CLUSTERS', 'SOLVE_CLUSTERS']

SUPPORTED_D = tuple(range(2, 9))   # block sizes instantiated in scan.cu
MAX_B = 8                          # widest border scan.cu takes
WIDE_MAX_D = 64                    # scan_wide.cu: 1 <= d <= 64,
WIDE_MAX_B = 64                    # 0 <= b <= 64, within MAX_SMEM
MAX_SMEM = 227 * 1024              # dynamic shared memory a block may use
INVERSE_INTS = 128                 # an inverse's two row maps
PANEL = 8                          # csrc/wide.cuh: an inverse's panel
SMS = 132                          # streaming multiprocessors of an H100
FACTOR_CLUSTERS = (1, 2)           # blocks a lane scan_wide.cu is built for
SOLVE_CLUSTERS = (1, 2, 4, 8)
CHAIN_STAGES, STAGES = 4, 3        # the wide solve's rings

factor_launches = 0
solve_launches = 0
wide_factor_launches = 0
wide_solve_launches = 0

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
               for name, args in (
                   ('scan_factor', [_VP] * 8 + [_CI] * 4 + [_VP]),
                   ('scan_solve', [_VP] * 9 + [_CI] * 4 + [_VP]))}
# the wide entries: the narrow ones' arguments, the solve's scratch
# after its outputs, and the cluster size after the ints
_WIDE_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
                    for name, args in (
                        ('scan_wide_factor', [_VP] * 8 + [_CI] * 5 + [_VP]),
                        ('scan_wide_solve', [_VP] * 10 + [_CI] * 5 + [_VP]))}
# scan_wide_smem(d, b, itemsize, cluster, out[2]): the layouts' bytes
# (factor, solve), which wide_smem must equal (tests/test_torch_cuda.py)
_WIDE_SIGNATURES['scan_wide_smem'] = [_CI] * 4 + [
    ctypes.POINTER(ctypes.c_ulonglong)]


def reset_launch_counts():
    global factor_launches, solve_launches, wide_factor_launches, \
        wide_solve_launches
    factor_launches = 0
    solve_launches = 0
    wide_factor_launches = 0
    wide_solve_launches = 0


def _narrow(d, b):
    """Whether csrc/scan.cu's kernels are built for (d, b)."""
    return d in SUPPORTED_D and 0 <= b <= MAX_B


def _ceil(n, m):
    return -(-n // m) * m


def _pitch(n):
    return _ceil(n, 8) + 4


def _factor_values(d, b, cluster, rank):
    """The values of a factor block of csrc/scan_wide.cu (FactorLayout):
    the chain's five d x d matrices (rank 0), the off-chain's three d x b
    and, in a cluster, two d x d read back from device memory (rank 1;
    both at cluster 1), the b x b border sum after at least b x b
    values, then the inverse's scratch at the widest pitch it inverts."""
    mat = _ceil(d, 4) * _pitch(d)
    matb = _ceil(d, 4) * _pitch(b)
    bb = _ceil(b, 4) * _pitch(b)
    at, ld = 0, 0
    if rank == 0:
        at, ld = 5 * mat, _pitch(d)
    if cluster == 1 or rank == 1:
        at += 3 * matb + (2 * mat if cluster > 1 else 0)
        at = max(at, bb) + bb
        ld = max(ld, _pitch(b))
    return at + 4 * PANEL * ld


def wide_smem(d, b, itemsize, cluster=1):
    """(factor, solve): the bytes of dynamic shared memory a block of
    csrc/scan_wide.cu's kernels takes at (d, b) in a dtype of
    ``itemsize`` bytes with ``cluster`` blocks a lane (FactorLayout,
    the larger of a cluster's two blocks, and SolveLayout, the same at
    every cluster size).  Matrices keep rows padded to a multiple of 4
    and a pitch of ceil8(columns) + 4, and the inverse its ints.  The
    solve: a ring of the largest of its phases' stages (four of Melim_k
    and r_k; three of S_k^-1 and rt_k, of Ft_k and y_k, of Ft_k, of
    E_{k+1} and S_k^-1; each run of n values round8(n + 4)), then five
    vectors."""
    factor = max(_factor_values(d, b, cluster, rank)
                 for rank in range(min(cluster, 2)))
    factor = factor * itemsize + 4 * INVERSE_INTS
    mat, ft, vec = (_ceil(n + 4, 8) for n in (d * d, d * b, d))
    ring = max(max(CHAIN_STAGES, STAGES) * (mat + vec), STAGES * (ft + vec),
               STAGES * 2 * mat)
    solve = (ring + 3 * _ceil(d, 8) + 2 * _ceil(b, 8)) * itemsize
    return factor, solve


def _fits(d, b, itemsize, cluster):
    return max(wide_smem(d, b, itemsize, cluster)) <= MAX_SMEM


def cluster_size(B, d, b, dtype):
    """(factor, solve): the blocks a lane of scan_wide.cu's kernels runs
    on for B lanes of (d, b) blocks in ``dtype``, a pure function of
    them.  The factor takes two (the chain and the products off it)
    while the 2 B blocks fit the card's 132 SMs at once, or wherever one
    block's shared memory cannot hold the lane; the solve the most of 8,
    4, 2 whose B c blocks fit half the SMs (a cluster of 4 or 8 must
    find its SMs in one GPC: at B = 32 four blocks a lane, 128 in all,
    ran 27 % slower than two).  Without a border there is nothing off
    the chains: one block."""
    itemsize = dtype.itemsize
    if b == 0:
        return (1 if _fits(d, b, itemsize, 1) else 2), 1
    factor = 2 if 2 * B <= SMS or not _fits(d, b, itemsize, 1) else 1
    solve = max(c for c in SOLVE_CLUSTERS if c == 1 or 2 * B * c <= SMS)
    return factor, solve


def kernel_supported(d, b, N, dtype):
    """True when scan_factor and scan_solve take a (d, b, N) system in
    ``dtype`` on the card: a pure function of static shape and dtype."""
    if dtype not in (torch.float32, torch.float64) or N < 1:
        return False
    if _narrow(d, b):
        return True
    return (1 <= d <= WIDE_MAX_D and 0 <= b <= WIDE_MAX_B
            and any(_fits(d, b, dtype.itemsize, c) for c in FACTOR_CLUSTERS))


# ---------------------------------------------------------------------------
# plain versions (the CPU path, and the yardstick of the kernels)
# ---------------------------------------------------------------------------

def _node_first(a):
    """(..., N, x, y) -> (N, ..., x, y), a view."""
    return a.movedim(-3, 0)


def _lanes_first(a):
    """(N, ..., x, y) -> (..., N, x, y), a view."""
    return a.movedim(0, -3)


def scan_factor_plain(D, E, F, Kbb):
    """Block-tridiagonal forward elimination with border Schur
    accumulation of D, E (..., N, d, d), F (..., N, d, b), Kbb
    (..., b, b).  Returns (S_inv, Melim (..., N, d, d), Ft (..., N, d, b),
    Kbb_schur_inv (..., b, b)); the per-node arrays are views of
    node-major storage, so each step reads and writes one contiguous
    slice over the lanes."""
    D, E, F = (_node_first(a).contiguous() for a in (D, E, F))
    ET = E.transpose(-1, -2).contiguous()
    N, b = D.shape[0], F.shape[-1]

    S_inv = torch.empty_like(D)
    Melim = torch.empty_like(D)
    Ft = torch.empty_like(F)
    S = torch.empty_like(D[0])              # scratch of one step
    S_prev_inv = torch.zeros_like(D[0])
    Ft_prev = torch.zeros_like(F[0])
    for k in range(N):
        Mk = Melim[k].copy_(block_matmul_plain(E[k], S_prev_inv))
        torch.sub(D[k], block_matmul_plain(Mk, ET[k]), out=S)
        S_prev_inv = block_inv(S, out=S_inv[k])
        Ft_prev = torch.sub(F[k], Mk @ Ft_prev, out=Ft[k])

    if b:
        dKbb = -(Ft.transpose(-1, -2) @ (S_inv @ Ft))
        Kbb_schur_inv = block_inv(Kbb + torch.sum(dKbb, dim=0))
    else:
        Kbb_schur_inv = Kbb.new_zeros(Kbb.shape)
    return (_lanes_first(S_inv), _lanes_first(Melim), _lanes_first(Ft),
            Kbb_schur_inv)


def scan_solve_plain(S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb):
    """Solve with a scan factorization (S_inv, Melim, E (..., N, d, d),
    Ft (..., N, d, b), Kbb_schur_inv (..., b, b)) in its equilibrated
    variables: r (..., N, d), rb (..., b) -> (u (..., N, d), beta
    (..., b))."""
    S_inv, Melim, Ft, E = (_node_first(a) for a in (S_inv, Melim, Ft, E))
    r = r.movedim(-2, 0)
    N, b = S_inv.shape[0], Ft.shape[-1]

    rt = r.new_empty(r.shape)
    rt_prev = torch.zeros_like(r[0])
    for k in range(N):
        rt_prev = torch.sub(r[k], (Melim[k] @ rt_prev[..., None])[..., 0],
                            out=rt[k])

    if b:
        drb = -(Ft.transpose(-1, -2)
                @ (S_inv @ rt[..., None]))[..., 0]
        beta = (Kbb_schur_inv
                @ (rb + torch.sum(drb, dim=0))[..., None])[..., 0]
        Fb = (Ft @ beta[..., None])[..., 0]
    else:
        beta = rb.new_zeros(rb.shape)
    ET_next = torch.cat([E[1:], torch.zeros_like(E[:1])],
                        dim=0).transpose(-1, -2)

    u = rt.new_empty(rt.shape)
    u_next = torch.zeros_like(rt[0])
    for k in reversed(range(N)):
        rhs = rt[k] - (ET_next[k] @ u_next[..., None])[..., 0]
        if b:
            rhs = rhs - Fb[k]
        u_next = torch.matmul(S_inv[k], rhs[..., None],
                              out=u[k][..., None])[..., 0]
    return u.movedim(0, -2), beta


# ---------------------------------------------------------------------------
# argument checks of the kernels (also run on CPU tensors by the tests)
# ---------------------------------------------------------------------------

def _check_dims(name, d, b, N, dtype):
    """Raise ValueError, naming the shape, unless a kernel takes it;
    returns whether it is scan.cu's (narrow) rather than scan_wide.cu's."""
    if not 1 <= d <= WIDE_MAX_D:
        raise ValueError('{}: block size d={} is not built (built: 1..{})'
                         .format(name, d, WIDE_MAX_D))
    if not 0 <= b <= WIDE_MAX_B:
        raise ValueError('{}: border width b={} exceeds {}'.format(
            name, b, WIDE_MAX_B))
    if N < 1:
        raise ValueError('{}: empty node axis'.format(name))
    if _narrow(d, b):
        return True
    if not any(_fits(d, b, dtype.itemsize, c) for c in FACTOR_CLUSTERS):
        need = min(max(wide_smem(d, b, dtype.itemsize, c))
                   for c in FACTOR_CLUSTERS)
        raise ValueError('{}: d={}, b={} in {} needs {} bytes of shared '
                         'memory a block (limit {})'.format(
                             name, d, b, dtype, need, MAX_SMEM))
    return False


def check_factor(D, E, F, Kbb):
    """What scan_factor's kernel takes: D, E (..., N, d, d), F
    (..., N, d, b), Kbb (..., b, b), on one CUDA device in one dtype,
    contiguous.  Returns (dtype suffix, lanes, N, d, b, whether scan.cu
    takes it rather than scan_wide.cu); raises ValueError on anything
    else."""
    name = 'scan_factor'
    if D.ndim < 3 or D.shape[-1] != D.shape[-2] or F.ndim < 3:
        raise ValueError('{}: expected D (..., N, d, d) and F (..., N, d, '
                         'b), got {} and {}'.format(
                             name, tuple(D.shape), tuple(F.shape)))
    lead, (N, d) = D.shape[:-3], D.shape[-3:-1]
    b = F.shape[-1]
    narrow = _check_dims(name, d, b, N, D.dtype)
    suffix = check_cuda(name, (D, E, F, Kbb),
                        (D.shape, D.shape, lead + (N, d, b), lead + (b, b)))
    return suffix, lead.numel(), N, d, b, narrow


def check_solve(S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb):
    """What scan_solve's kernel takes (see check_factor), r (..., N, d)
    and rb (..., b) beside the factorization."""
    name = 'scan_solve'
    if S_inv.ndim < 3 or S_inv.shape[-1] != S_inv.shape[-2] \
            or Ft.ndim < 3:
        raise ValueError('{}: expected S_inv (..., N, d, d) and Ft (..., N, '
                         'd, b), got {} and {}'.format(
                             name, tuple(S_inv.shape), tuple(Ft.shape)))
    lead, (N, d) = S_inv.shape[:-3], S_inv.shape[-3:-1]
    b = Ft.shape[-1]
    narrow = _check_dims(name, d, b, N, S_inv.dtype)
    suffix = check_cuda(
        name, (S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb),
        (S_inv.shape, S_inv.shape, lead + (N, d, b), S_inv.shape,
         lead + (b, b), lead + (N, d), lead + (b,)))
    return suffix, lead.numel(), N, d, b, narrow


def _on_cpu(*tensors):
    return all(t.device.type == 'cpu' for t in tensors)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def launch_wide_factor(D, E, F, Kbb, cluster):
    """csrc/scan_wide.cu's factor of a system that check_factor gives to
    it, on ``cluster`` blocks a lane (FACTOR_CLUSTERS); scan_factor's
    outputs.  scan_factor launches it at cluster_size's choice; the
    card's tests and chip_smoke.py time every candidate."""
    suffix, nbatch, N, d, b, narrow = check_factor(D, E, F, Kbb)
    if narrow or cluster not in FACTOR_CLUSTERS:
        raise ValueError('scan_factor: no wide build for d={}, b={} on {} '
                         'blocks'.format(d, b, cluster))
    S_inv, Melim = torch.empty_like(D), torch.empty_like(D)
    Ft, Kinv = torch.empty_like(F), torch.empty_like(Kbb)
    if nbatch:
        fn = getattr(load('scan_wide', _WIDE_SIGNATURES),
                     'scan_wide_factor_' + suffix)
        launch('scan_factor', fn,
               (D.data_ptr(), E.data_ptr(), F.data_ptr(), Kbb.data_ptr(),
                S_inv.data_ptr(), Melim.data_ptr(), Ft.data_ptr(),
                Kinv.data_ptr(), nbatch, d, N, b, cluster), D.device)
        global wide_factor_launches
        wide_factor_launches += 1
    return S_inv, Melim, Ft, Kinv


def launch_wide_solve(S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb, cluster):
    """csrc/scan_wide.cu's solve on ``cluster`` blocks a lane
    (SOLVE_CLUSTERS), as launch_wide_factor."""
    args = (S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb)
    suffix, nbatch, N, d, b, narrow = check_solve(*args)
    if narrow or cluster not in SOLVE_CLUSTERS:
        raise ValueError('scan_solve: no wide build for d={}, b={} on {} '
                         'blocks'.format(d, b, cluster))
    u, beta = torch.empty_like(r), torch.empty_like(rb)
    if nbatch:
        # y_k and the threads' parts of Ft_k beta between the phases
        scratch = r.new_empty(nbatch * N * 5 * d)
        fn = getattr(load('scan_wide', _WIDE_SIGNATURES),
                     'scan_wide_solve_' + suffix)
        launch('scan_solve', fn,
               tuple(a.data_ptr() for a in args)
               + (u.data_ptr(), beta.data_ptr(), scratch.data_ptr(), nbatch,
                  d, N, b, cluster), r.device)
        global wide_solve_launches
        wide_solve_launches += 1
    return u, beta


def scan_factor(D, E, F, Kbb):
    """The scan factorization of D, E (..., N, d, d) (E[..., 0, :, :] = 0),
    F (..., N, d, b), Kbb (..., b, b): returns (S_inv, Melim
    (..., N, d, d), Ft (..., N, d, b), Kbb_schur_inv (..., b, b)), lanes
    first, contiguous on the card."""
    if _on_cpu(D, E, F, Kbb):
        return scan_factor_plain(D, E, F, Kbb)
    suffix, nbatch, N, d, b, narrow = check_factor(D, E, F, Kbb)
    if not narrow:
        return launch_wide_factor(
            D, E, F, Kbb, cluster_size(nbatch, d, b, D.dtype)[0])
    S_inv, Melim = torch.empty_like(D), torch.empty_like(D)
    Ft, Kinv = torch.empty_like(F), torch.empty_like(Kbb)
    if nbatch:
        fn = getattr(load('scan', _SIGNATURES), 'scan_factor_' + suffix)
        launch('scan_factor', fn,
               (D.data_ptr(), E.data_ptr(), F.data_ptr(), Kbb.data_ptr(),
                S_inv.data_ptr(), Melim.data_ptr(), Ft.data_ptr(),
                Kinv.data_ptr(), nbatch, d, N, b), D.device)
        global factor_launches
        factor_launches += 1
    return S_inv, Melim, Ft, Kinv


def scan_solve(S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb):
    """Solve with a scan factorization in its equilibrated variables:
    r (..., N, d), rb (..., b) -> (u (..., N, d), beta (..., b))."""
    args = (S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb)
    if _on_cpu(*args):
        return scan_solve_plain(*args)
    suffix, nbatch, N, d, b, narrow = check_solve(*args)
    if not narrow:
        return launch_wide_solve(
            *args, cluster_size(nbatch, d, b, S_inv.dtype)[1])
    u, beta = torch.empty_like(r), torch.empty_like(rb)
    if nbatch:
        fn = getattr(load('scan', _SIGNATURES), 'scan_solve_' + suffix)
        launch('scan_solve', fn,
               tuple(a.data_ptr() for a in args)
               + (u.data_ptr(), beta.data_ptr(), nbatch, d, N, b),
               r.device)
        global solve_launches
        solve_launches += 1
    return u, beta
