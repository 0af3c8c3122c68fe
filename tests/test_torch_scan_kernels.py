"""The scan kernels' wrappers (opty_tpu_torch/ops/scan_kernels.py) on
CPU tensors, where they run their plain versions, against opty_tpu's
vmapped factor_kkt/solve_factored, with the same numpy inputs on both
sides, in the three structural cases of tests/test_torch_scan.py; a
factorization in the kernels' layout (lanes first, contiguous) through
the plain solve; and the kernels' argument checks.  (The CUDA kernels
themselves are held against these plain versions on the card:
tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opty_tpu.nlp import kkt as jax_kkt
from opty_tpu_torch.nlp import kkt as torch_kkt
from opty_tpu_torch.ops import scan_kernels as sk
from test_torch_scan import CASES, LANES, _random_blocks, _rel

N = 11


def _inputs(case):
    nz, M, bw, o = case
    lanes = [_random_blocks(N, nz, M, bw, o, seed) for seed in range(LANES)]
    arrs = {k: np.stack([lane[k] for lane in lanes]) for k in lanes[0]}
    rng = np.random.default_rng(5)
    r = rng.normal(size=(LANES, N, nz + M))
    rb = rng.normal(size=(LANES, bw + o))
    jb = jax_kkt.KKTBlocks(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tb = torch_kkt.KKTBlocks(**{k: torch.as_tensor(v)
                                for k, v in arrs.items()})
    return jb, tb, r, rb


def _equilibrated(tb):
    return torch_kkt._equilibrate(*torch_kkt._assemble_node_blocks(tb))


@pytest.fixture(scope='module', params=CASES, ids=str)
def case(request):
    """The JAX reference's factorization and solve of one case."""
    jb, tb, r, rb = _inputs(request.param)
    jfac = jax.jit(jax.vmap(jax_kkt.factor_kkt))(jb)
    ju, jbeta = jax.jit(jax.vmap(jax_kkt.solve_factored))(
        jfac, jnp.asarray(r), jnp.asarray(rb))
    return tb, r, rb, jfac, ju, jbeta


def _solve(solve, fac, sn, sb, r, rb):
    """A solve in the equilibrated variables, scaled as solve_factored
    scales it."""
    u, beta = solve(*fac[:3], fac[3], fac[4],
                    (torch.as_tensor(r) * sn).contiguous(),
                    (torch.as_tensor(rb) * sb).contiguous())
    return u * sn, beta * sb


def test_wrappers_on_cpu_match_reference(case):
    tb, r, rb, jfac, ju, jbeta = case
    D, E, F, Kbb, sn, sb = _equilibrated(tb)
    S_inv, Melim, Ft, Kinv = sk.scan_factor(D, E, F, Kbb)
    for name, got in (('S_inv', S_inv), ('Melim', Melim), ('Ft', Ft),
                      ('Kbb_schur_inv', Kinv)):
        assert _rel(got, getattr(jfac, name)) <= 1e-12, name
    u, beta = _solve(sk.scan_solve, (S_inv, Melim, Ft, E, Kinv), sn, sb,
                     r, rb)
    assert _rel(u, ju) <= 1e-12
    assert _rel(beta, jbeta) <= 1e-12


def test_kernel_layout_through_plain_solve(case):
    """Lanes-first contiguous factorization fields, as scan_factor's
    kernel writes them, through the plain solve."""
    tb, r, rb, jfac, ju, jbeta = case
    D, E, F, Kbb, sn, sb = _equilibrated(tb)
    fac = [a.contiguous() for a in sk.scan_factor_plain(D, E, F, Kbb)]
    assert fac[0].shape == (LANES, N) + tuple(D.shape[-2:])
    u, beta = _solve(sk.scan_solve_plain, fac[:3] + [E, fac[3]], sn, sb,
                     r, rb)
    assert _rel(u, ju) <= 1e-12
    assert _rel(beta, jbeta) <= 1e-12


def _factor_args(d=5, b=4, dtype=torch.float32):
    new = lambda *shape: torch.zeros(shape, dtype=dtype)
    return new(2, 7, d, d), new(2, 7, d, d), new(2, 7, d, b), new(2, b, b)


def test_argument_checks_refuse():
    """What the kernels do not take raises before any launch; called
    directly on CPU tensors, as the wrappers call them on CUDA ones.
    d = 9 and b = 9 go to the wide kernels, as does d = b = 64 in
    float64 (on a cluster of two blocks a lane); d or b above 64 are
    refused."""
    with pytest.raises(ValueError, match='not built'):
        sk.check_factor(*_factor_args(d=65))
    with pytest.raises(ValueError, match='border'):
        sk.check_factor(*_factor_args(b=65))
    for args in (_factor_args(d=9), _factor_args(b=9),
                 _factor_args(d=64, b=64),
                 _factor_args(d=64, b=64, dtype=torch.float64)):
        with pytest.raises(ValueError, match='CUDA device'):
            sk.check_factor(*args)
    D, E, F, Kbb = _factor_args()
    with pytest.raises(ValueError, match='share one device'):
        sk.check_factor(D, E.double(), F, Kbb)
    with pytest.raises(ValueError, match='contiguous'):
        sk.check_factor(D, E.transpose(-1, -2), F, Kbb)
    with pytest.raises(ValueError, match='expected shape'):
        sk.check_factor(D, E, F, Kbb[:, :3])
    r, rb = torch.zeros(2, 7, 5), torch.zeros(2, 4)
    with pytest.raises(ValueError, match='not built'):
        D9, E9, F9, K9 = _factor_args(d=65)
        sk.check_solve(D9, D9, F9, E9, K9, torch.zeros(2, 7, 65), rb)
    with pytest.raises(ValueError, match='share one device'):
        sk.check_solve(D, D, F, E, Kbb, r.double(), rb)
    with pytest.raises(ValueError, match='contiguous'):
        sk.check_solve(D, D, F, E, Kbb,
                       r.transpose(0, 1).contiguous().transpose(0, 1), rb)
    # well-formed CPU tensors pass every check but the device's
    with pytest.raises(ValueError, match='CUDA device'):
        sk.check_factor(D, E, F, Kbb)
