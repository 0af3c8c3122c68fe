"""The plain versions of the PCR kernels (opty_tpu_torch/ops) against
opty_tpu: float64 against the jnp path of ops/tridiag.py, float32
against the Pallas kernels run in interpret mode, and a bordered solve
against a dense numpy solve.  (The CUDA kernels themselves are held
against these plain versions on the card: tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opty_tpu.ops import pallas_pcr
from opty_tpu.ops import tridiag as jax_tridiag
from opty_tpu_torch.ops import lanes, pcr_kernels
from opty_tpu_torch.ops import tridiag as torch_tridiag

SHAPES = [(3, 0, 40), (5, 4, 200)]


@pytest.fixture
def _interpret_mode():
    """Run the Pallas kernels through the interpreter off-TPU (as
    tests/test_pallas_pcr.py does)."""
    prev = pallas_pcr._INTERPRET
    pallas_pcr._INTERPRET = jax.default_backend() == 'cpu'
    yield
    pallas_pcr._INTERPRET = prev


def _system(B, d, b, N, seed=0):
    """Numpy inputs made like tests/test_pallas_pcr.py's."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, d, d, N)) + 4.0 * np.eye(d)[:, :, None]
    E = rng.standard_normal((B, d, d, N))
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((B, d, b, N))
    Kbb = rng.standard_normal((B, b, b)) + 5.0 * np.eye(b)
    r = rng.standard_normal((B, d, N))
    rb = rng.standard_normal((B, b))
    return D, E, F, Kbb, r, rb


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize('d,b,N', SHAPES)
def test_factor_and_solve_match_jnp_float64(d, b, N):
    D, E, F, Kbb, r, rb = _system(2, d, b, N)
    want = jax.vmap(jax_tridiag.pcr_factor)(
        *map(jnp.asarray, (D, E, F, Kbb)))
    got = torch_tridiag.pcr_factor(*map(torch.as_tensor, (D, E, F, Kbb)))
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= 1e-10, name
    u_j, beta_j = jax.vmap(jax_tridiag.pcr_solve)(
        want, jnp.asarray(r), jnp.asarray(rb))
    u_t, beta_t = torch_tridiag.pcr_solve(got, torch.as_tensor(r),
                                          torch.as_tensor(rb))
    assert _rel(u_t, u_j) <= 1e-10
    assert _rel(beta_t, beta_j) <= 1e-10


@pytest.mark.parametrize('d,b,N', SHAPES)
def test_plain_matches_pallas_float32(_interpret_mode, d, b, N):
    """float32 plain versions against the Pallas kernels, with the
    tolerances of tests/test_pallas_pcr.py: level 0 is exact float32
    algebra (1e-5), later levels accumulate roundoff in another order
    (5e-2 on the final state)."""
    D, E, F, _, r, _ = _system(1, d, b, N, seed=1)
    f32 = lambda x: jnp.asarray(x[0], jnp.float32)
    A_p, B_p, Dinv_p, Fp_p, Z_p = pallas_pcr.pcr_factor_fused(
        f32(D), f32(E), f32(F))
    t32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    A, B, Dinv, Fp, Z = pcr_kernels.pcr_factor_levels(t32(D), t32(E), t32(F))
    assert A.dtype == torch.float32
    assert _rel(A[0, 0], A_p[0][..., :N]) < 1e-5
    assert _rel(B[0, 0], B_p[0][..., :N]) < 1e-5
    assert _rel(Dinv[0], Dinv_p[..., :N]) < 5e-2
    if b:
        assert _rel(Fp[0], Fp_p[..., :N]) < 5e-2
        assert _rel(Z[0], Z_p[..., :N]) < 5e-2

    Np = Dinv_p.shape[-1]
    rp = jnp.concatenate([f32(r), jnp.zeros((d, Np - N), jnp.float32)], -1)
    want = pallas_pcr.pcr_downsweep_fused(A_p, B_p, rp)
    got = pcr_kernels.pcr_downsweep(A, B, t32(r))
    assert _rel(got[0], want[..., :N]) < 5e-2


def test_batched_equals_single():
    """A batch of systems factors and sweeps exactly as each alone."""
    d, b, N = 5, 4, 200
    D, E, F, _, r, _ = _system(4, d, b, N, seed=2)
    D, E, F, r = map(torch.as_tensor, (D, E, F, r))
    batched = pcr_kernels.pcr_factor_levels(D, E, F)
    swept = pcr_kernels.pcr_downsweep(batched[0], batched[1], r)
    for i in (0, 3):
        single = pcr_kernels.pcr_factor_levels(D[i:i + 1], E[i:i + 1],
                                               F[i:i + 1])
        for got, want in zip(batched, single):
            assert torch.equal(got[i:i + 1], want)
        one = pcr_kernels.pcr_downsweep(single[0], single[1], r[i:i + 1])
        assert torch.equal(swept[i:i + 1], one)


def _dense(D, E, F, Kbb):
    d, N, b = D.shape[0], D.shape[-1], F.shape[1]
    K = np.zeros((d * N + b, d * N + b))
    for k in range(N):
        K[k*d:(k+1)*d, k*d:(k+1)*d] = D[:, :, k]
        if k > 0:
            K[k*d:(k+1)*d, (k-1)*d:k*d] = E[:, :, k]
            K[(k-1)*d:k*d, k*d:(k+1)*d] = E[:, :, k].T
        K[k*d:(k+1)*d, d*N:] = F[:, :, k]
        K[d*N:, k*d:(k+1)*d] = F[:, :, k].T
    K[d*N:, d*N:] = Kbb
    return K


def test_bordered_solve_matches_dense():
    """As tests/test_pallas_pcr.py's padded round trip, in float64: a
    diagonally dominant chain with a border, against numpy."""
    d, b, N = 4, 3, 75
    rng = np.random.default_rng(7)
    D = rng.standard_normal((d, d, N)) * 0.1 + 6.0 * np.eye(d)[:, :, None]
    E = 0.3 * rng.standard_normal((d, d, N))
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((d, b, N))
    Kbb = rng.standard_normal((b, b)) + 6.0 * np.eye(b)
    r = rng.standard_normal((d, N))
    rb = rng.standard_normal((b,))
    fac = torch_tridiag.pcr_factor(*map(torch.as_tensor, (D, E, F, Kbb)))
    u, beta = torch_tridiag.pcr_solve(fac, torch.as_tensor(r),
                                      torch.as_tensor(rb))
    assert u.shape == (d, N)
    sol = np.linalg.solve(_dense(D, E, F, Kbb),
                          np.concatenate([r.T.reshape(-1), rb]))
    assert _rel(u, sol[:d*N].reshape(N, d).T) <= 1e-8
    assert _rel(beta, sol[d*N:]) <= 1e-8


def test_block_inverse_first_maximum_pivot():
    """Ties in the pivot column take the first row (argmax's rule), and
    the inverse matches numpy."""
    A = np.array([[1.0, 2.0, 0.0], [-1.0, 0.5, 1.0], [1.0, 0.0, 3.0]])
    got = lanes.block_inv_nl(torch.as_tensor(A)[..., None])[..., 0]
    assert _rel(got, np.linalg.inv(A)) <= 1e-14


def test_wrappers_reject_bad_input():
    D = torch.zeros(1, 5, 5, 8)
    with pytest.raises(ValueError):
        pcr_kernels.pcr_factor_levels(D[0], D[0], D[0])
    with pytest.raises(ValueError):
        pcr_kernels.pcr_downsweep(D, D, D[:, 0])


# ---------------------------------------------------------------------------
# the kernels' launch plan (pure Python: checked here, run on the card)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('N', [2, 3, 40, 200, 501, 4000])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d', pcr_kernels.SUPPORTED_D)
@pytest.mark.parametrize('kernel', ['factor', 'downsweep'])
def test_launch_plan(kernel, d, dtype, N):
    """Every shape the wrappers take has a plan: every node owned by
    exactly one block, shared memory within a block's limit, a cluster
    the card can launch, threads within the kernel's bound and no warp
    without a node."""
    pk = pcr_kernels
    most = pk.MAX_FACTOR_THREADS if kernel == 'factor' \
        else pk.MAX_SWEEP_THREADS
    for batch in (1, 32, 200):
        for b in ((0, 4, pk.MAX_B) if kernel == 'factor' else (0,)):
            plan = pk.launch_plan(kernel, batch, d, b, N, dtype)
            C, npb = plan.cluster, plan.nodes_per_block
            assert C in (1, 2, 4, 8, 16) and C <= pk.MAX_CLUSTER
            owned = [k for rank in range(C)
                     for k in range(rank * npb, min((rank + 1) * npb, N))]
            assert owned == list(range(N))          # each node once
            assert (C - 1) * npb < N                # no block idle
            assert 0 <= plan.smem_bytes <= pk.MAX_SMEM
            assert plan.threads % 32 == 0 and 32 <= plan.threads <= most
            work = npb if kernel == 'factor' else d * npb
            assert plan.threads < work + 32          # no idle warp
            assert plan.blocks == batch * C
            # the state lies in shared memory or in the scratch
            assert (plan.scratch == 0) == (plan.smem_bytes > 0)
            assert kernel == 'factor' or plan.scratch == 0


def test_launch_plan_covers_the_card_on_the_main_path():
    """The main path's 32 lanes (N = 501, d = 5, b = 4) run at least 96
    blocks per launch in both dtypes, one cluster per instance, the
    state in shared memory, and the float32 factor leaves room for two
    blocks on an SM.  The plan is memoised."""
    for kernel in ('factor', 'downsweep'):
        for dtype in (torch.float32, torch.float64):
            plan = pcr_kernels.launch_plan(kernel, 32, 5, 4, 501, dtype)
            assert plan.blocks >= 96 and plan.cluster > 1
            assert plan.scratch == 0
    plan = pcr_kernels.launch_plan('factor', 32, 5, 4, 501, torch.float32)
    assert 2 * plan.smem_bytes <= pcr_kernels.MAX_SMEM
    assert pcr_kernels.launch_plan('factor', 32, 5, 4, 501,
                                   torch.float32) is plan
    with pytest.raises(ValueError, match='unknown kernel'):
        pcr_kernels.launch_plan('solve', 1, 5, 4, 501, torch.float32)


def test_launch_plan_reach():
    """The factor takes any N: its state leaves shared memory for a
    global scratch only where a cluster of MAX_CLUSTER blocks cannot
    hold it (d = 5, b = 4: N = 3,872 in float32).  The downsweep takes
    MAX_CLUSTER times what one block's shared memory holds of r, and
    refuses beyond."""
    pk = pcr_kernels
    f32, f64 = torch.float32, torch.float64
    edge = pk.launch_plan('factor', 1, 5, 4, 3872, f32)
    assert edge.scratch == 0 and edge.cluster == pk.MAX_CLUSTER
    for N, dtype in ((3873, f32), (1937, f64), (4000, f32), (10 ** 6, f64)):
        plan = pk.launch_plan('factor', 1, 5, 4, N, dtype)
        assert plan.scratch > 0 and plan.smem_bytes == 0
        assert plan.cluster * plan.nodes_per_block >= N
    for d, dtype in ((5, f32), (5, f64), (3, f32)):
        one_block = pk.MAX_SMEM // (2 * d * dtype.itemsize)
        plan = pk.launch_plan('downsweep', 1, d, 0, one_block, dtype)
        assert plan.threads == pk.MAX_SWEEP_THREADS < d * plan.nodes_per_block
        top = pk.MAX_CLUSTER * one_block
        plan = pk.launch_plan('downsweep', 1, d, 0, top, dtype)
        assert plan.cluster == pk.MAX_CLUSTER
        with pytest.raises(ValueError, match='shared memory'):
            pk.launch_plan('downsweep', 1, d, 0, top + pk.MAX_CLUSTER, dtype)
