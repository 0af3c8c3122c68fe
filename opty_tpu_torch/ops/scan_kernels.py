"""Hand-written CUDA kernels for the scan KKT factorization and solve,
their plain PyTorch versions and their launch counters.

Two kernels, both in csrc/scan.cu, built for Hopper (sm_90a) with nvcc
at first use and loaded through ctypes (ops/cuda_build.py):

* ``scan_factor``: the forward elimination of nlp/kkt.py:factor_kkt
  (opty_tpu/nlp/kkt.py:225-253) over every node of every lane in one
  launch, a thread block per lane, a thread per matrix entry.  It takes
  in the pivot inverses and square products that the Pallas kernels
  ``_inv_kernel``/``_matmul_kernel`` (opty_tpu/ops/pallas_blocks.py)
  compute, and the border Schur inverse at its end.
* ``scan_solve``: the whole of nlp/kkt.py:solve_factored
  (opty_tpu/nlp/kkt.py:256-295) in one launch, a warp per lane, a
  thread per row.

Both walk the N nodes of a lane in order, so each lane's chain of node
steps, not bytes, bounds them (csrc/scan.cu).  Arrays are lanes first,
(..., N, d, d), d = 2..8, a border of b = 0..8 columns, float32 or
float64.

A tensor on the CPU goes to the plain version (``scan_factor_plain``/
``scan_solve_plain``: the node loops of the JAX package's ``lax.scan``
recursions, the CPU path and its parity target); a CUDA tensor goes to
the kernel, or the wrapper raises.  Each wrapper counts its kernel
launches in ``factor_launches``/``solve_launches``.

``kernel_supported(d, b, N, dtype)`` says, from static shapes alone,
whether the kernels take a system.  It decides no route: on the card
a system outside it (d > 8 or b > 8, such as nlink-9's d = 50, b = 41)
raises with its shape.
"""

import ctypes

import torch

from .block_kernels import block_matmul_plain
from .cuda_build import check_cuda, launch, load
from .smallblock import block_inv

__all__ = ['scan_factor', 'scan_solve', 'scan_factor_plain',
           'scan_solve_plain', 'check_factor', 'check_solve',
           'reset_launch_counts', 'kernel_supported', 'SUPPORTED_D',
           'MAX_B']

SUPPORTED_D = tuple(range(2, 9))   # block sizes instantiated in scan.cu
MAX_B = 8                          # widest border the kernels take

factor_launches = 0
solve_launches = 0

_VP, _CI = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {name + sfx: args for sfx in ('_f32', '_f64')
               for name, args in (
                   ('scan_factor', [_VP] * 8 + [_CI] * 4 + [_VP]),
                   ('scan_solve', [_VP] * 9 + [_CI] * 4 + [_VP]))}


def reset_launch_counts():
    global factor_launches, solve_launches
    factor_launches = 0
    solve_launches = 0


def kernel_supported(d, b, N, dtype):
    """True when scan_factor and scan_solve take a (d, b, N) system in
    ``dtype`` on the card: a pure function of static shape and dtype."""
    return (dtype in (torch.float32, torch.float64) and d in SUPPORTED_D
            and 0 <= b <= MAX_B and N >= 1)


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

def _check_dims(name, d, b, N):
    if d not in SUPPORTED_D:
        raise ValueError('{}: block size d={} is not built (built: {})'
                         .format(name, d, SUPPORTED_D))
    if not 0 <= b <= MAX_B:
        raise ValueError('{}: border width b={} exceeds {}'.format(
            name, b, MAX_B))
    if N < 1:
        raise ValueError('{}: empty node axis'.format(name))


def check_factor(D, E, F, Kbb):
    """What scan_factor's kernel takes: D, E (..., N, d, d), F
    (..., N, d, b), Kbb (..., b, b), on one CUDA device in one dtype,
    contiguous.  Returns (dtype suffix, lanes, N, d, b); raises
    ValueError on anything else."""
    name = 'scan_factor'
    if D.ndim < 3 or D.shape[-1] != D.shape[-2] or F.ndim < 3:
        raise ValueError('{}: expected D (..., N, d, d) and F (..., N, d, '
                         'b), got {} and {}'.format(
                             name, tuple(D.shape), tuple(F.shape)))
    lead, (N, d) = D.shape[:-3], D.shape[-3:-1]
    b = F.shape[-1]
    _check_dims(name, d, b, N)
    suffix = check_cuda(name, (D, E, F, Kbb),
                        (D.shape, D.shape, lead + (N, d, b), lead + (b, b)))
    return suffix, lead.numel(), N, d, b


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
    _check_dims(name, d, b, N)
    suffix = check_cuda(
        name, (S_inv, Melim, Ft, E, Kbb_schur_inv, r, rb),
        (S_inv.shape, S_inv.shape, lead + (N, d, b), S_inv.shape,
         lead + (b, b), lead + (N, d), lead + (b,)))
    return suffix, lead.numel(), N, d, b


def _on_cpu(*tensors):
    return all(t.device.type == 'cpu' for t in tensors)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def scan_factor(D, E, F, Kbb):
    """The scan factorization of D, E (..., N, d, d) (E[..., 0, :, :] = 0),
    F (..., N, d, b), Kbb (..., b, b): returns (S_inv, Melim
    (..., N, d, d), Ft (..., N, d, b), Kbb_schur_inv (..., b, b)), lanes
    first, contiguous on the card."""
    if _on_cpu(D, E, F, Kbb):
        return scan_factor_plain(D, E, F, Kbb)
    suffix, nbatch, N, d, b = check_factor(D, E, F, Kbb)
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
    suffix, nbatch, N, d, b = check_solve(*args)
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
