"""opty_tpu_torch's n-link chain on a cart (models/nlink.py) against
opty_tpu's, on the CPU in float64 with the same numpy inputs: the
9-link chain's transcription at N = 12 (20 states, 10 inputs, a
variable node interval, 40 instance constraints: the KKT node block
d = 50 and border b = 41), a cyclic-reduction and a scan factor and
solve at that block through the plain versions of the wide kernels, the
route gate ``kernel_supported`` of the PCR and scan kernels with the
wide scan kernels' shared-memory sizing, and the two-link reach solve
of tests/test_nlink.py."""

import numpy as np
import pytest
import sympy as sm
import torch

import jax.numpy as jnp

from opty_tpu.models.nlink import n_link_cart_problem as jax_problem
from opty_tpu.models.nlink import n_link_initial_guess as jax_guess
from opty_tpu.nlp import kkt as jax_kkt
from opty_tpu.nlp.collocation import \
    make_collocation_nlp_functions as jax_functions
from opty_tpu.ops import tridiag as jax_tridiag
from opty_tpu_torch import interop
from opty_tpu_torch.models.nlink import n_link_cart_problem as torch_problem
from opty_tpu_torch.models.nlink import n_link_initial_guess as torch_guess
from opty_tpu_torch.nlp import kkt as torch_kkt
from opty_tpu_torch.nlp.collocation import \
    make_collocation_nlp_functions as torch_functions
from opty_tpu_torch.ops import pcr_kernels, scan_kernels
from opty_tpu_torch.ops import tridiag as torch_tridiag
from opty_tpu_torch.transcribe.collocator import ConstraintCollocator
from opty_tpu_torch.transcribe.hessian import make_hvp_seeds
from test_torch_scan import _random_blocks

N = 12
# transcription: the same lowered expressions evaluated in another order
# of torch's and XLA's fused operations, relative to the largest entry
RTOL = 1e-12


@pytest.fixture(scope='module')
def pair9():
    """Both packages' 9-link reach problem at N = 12, built once (the
    SymPy derivation takes ~12 s a package)."""
    jp, q_start = jax_problem(num_links=9, num_nodes=N)
    tp, _ = torch_problem(num_links=9, num_nodes=N, device='cpu')
    return jp, tp, q_start


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _point(prob, q_start, seed):
    free = jax_guess(prob, q_start)
    return free + 0.01 * np.random.default_rng(seed).standard_normal(
        free.shape)


def test_the_wide_block_class(pair9):
    jp, tp, _ = pair9
    col = tp.collocator
    assert (col.num_states, col.num_unknown_input_trajectories,
            col.num_instance_constraints, col._bw) == (20, 10, 40, 1)
    assert col._nz + col.num_eom == 50                  # d
    assert col._bw + col.num_instance_constraints == 41  # b
    assert (tp.num_free, tp.num_constraints) == (jp.num_free,
                                                 jp.num_constraints)
    np.testing.assert_array_equal(tp.lower_bound, jp.lower_bound)
    np.testing.assert_array_equal(tp.upper_bound, jp.upper_bound)
    for got, want in zip(tp.jacobianstructure(), jp.jacobianstructure()):
        np.testing.assert_array_equal(got, want)


def test_initial_guess(pair9):
    """The inverse-dynamics guess solves per-interval least squares on
    the Jacobian blocks of each package."""
    jp, tp, q_start = pair9
    assert _rel(torch_guess(tp, q_start), jax_guess(jp, q_start)) <= 1e-10


@pytest.mark.parametrize('seed', [0, 1])
def test_constraints_jacobian_objective(pair9, seed):
    jp, tp, q_start = pair9
    x = _point(jp, q_start, seed)
    assert _rel(tp.con(x), jp.con(x)) <= RTOL
    assert _rel(tp.jacobian(x), jp.jacobian(x)) <= RTOL
    assert abs(tp.objective(x) - jp.objective(x)) <= RTOL * abs(
        jp.objective(x))
    assert _rel(tp.gradient(x), jp.gradient(x)) <= RTOL


def _blocks_hvp(col, blocks, v):
    """The action of node blocks (Hd, Ho, Hw, Hww) on a free vector."""
    Hd, Ho, Hw, Hww = (b.numpy() for b in blocks)
    n, q, Nn = col.num_states, col.num_unknown_input_trajectories, N
    nz = n + q
    vn = np.concatenate([v[:n * Nn].reshape(n, Nn).T,
                         v[n * Nn:nz * Nn].reshape(q, Nn).T], axis=1)
    vw = v[nz * Nn:]
    prev = np.vstack([np.zeros((1, nz)), vn[:-1]])
    nxt = np.vstack([vn[1:], np.zeros((1, nz))])
    Ho_next = np.concatenate([Ho[1:], np.zeros((1, nz, nz))])
    rn = (np.einsum('kij,kj->ki', Hd, vn) + np.einsum('kji,kj->ki', Ho, prev)
          + np.einsum('kij,kj->ki', Ho_next, nxt)
          + np.einsum('kij,j->ki', Hw, vw))
    rw = np.einsum('kij,ki->j', Hw, vn) + Hww @ vw
    return np.concatenate([rn[:, :n].T.reshape(-1), rn[:, n:].T.reshape(-1),
                           rw])


def test_hessian_blocks_against_the_reference_jacobian(pair9):
    """The EoM part of the Lagrangian Hessian, applied to a direction,
    against central differences of y^T J from the JAX package's sparse
    Jacobian (step 1e-6: agreement to ~1e-7 relative)."""
    jp, tp, q_start = pair9
    col = tp.collocator
    rng = np.random.default_rng(5)
    x = _point(jp, q_start, 2)
    M = col.num_eom
    y_nodes = rng.standard_normal((N - 1, M))
    y = np.concatenate([y_nodes.T.reshape(-1),
                        np.zeros(col.num_instance_constraints)])
    rows, cols = jp.jacobianstructure()

    def jty(point):
        g = np.zeros(jp.num_free)
        np.add.at(g, cols, np.asarray(jp.jacobian(point)) * y[rows])
        return g

    v = rng.standard_normal(jp.num_free)
    v /= np.linalg.norm(v)
    eps = 1e-6
    fd = (jty(x + eps * v) - jty(x - eps * v)) / (2 * eps)
    blocks = col.hessian_blocks(torch.as_tensor(x), torch.as_tensor(y_nodes))
    assert _rel(_blocks_hvp(col, blocks, v), fd) <= 1e-6


def test_hessian_blocks_match_reference(pair9):
    """The collocator's Hessian blocks of y^T c against the JAX
    package's (its scan-mode wide derivatives, the port's full-width
    sweep), to round-off."""
    jp, tp, q_start = pair9
    x = _point(jp, q_start, 3)
    y = np.random.default_rng(6).standard_normal(
        (N - 1, tp.collocator.num_eom))
    got = tp.collocator.hessian_blocks(torch.as_tensor(x),
                                       torch.as_tensor(y))
    want = jp.collocator.hessian_blocks(jnp.asarray(x), jnp.asarray(y))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _rel(g, w) <= RTOL


def test_kkt_prepare_matches_reference(pair9):
    """kkt_prepare's blocks of the scaled Lagrangian Hessian and of the
    Jacobian (the objective's and the instance constraints' curvature,
    Hw and Hww of the variable h included) against the JAX package's,
    at one lane, with the scales of the same starting point."""
    jp, tp, q_start = pair9
    rng = np.random.default_rng(7)
    x0 = _point(jp, q_start, 4)
    x = _point(jp, q_start, 5)
    y = rng.standard_normal(jp.num_constraints)
    fns, _ = torch_functions(tp.collocator, tp._obj_fn, tp._obj_grad_fn,
                             scale_from=torch.as_tensor(x0)[None],
                             kkt_method='cr')
    prep = fns.kkt_prepare(torch.as_tensor(x)[None],
                           torch.as_tensor(y)[None])
    jfns, _ = jax_functions(jp.collocator, jp._obj_fn, jp._obj_grad_fn,
                            scale_from=jnp.asarray(x0), kkt_method='cr')
    want = jfns.kkt_prepare(jnp.asarray(x), jnp.asarray(y))
    assert set(prep) == set(want)
    for k, w in want.items():
        assert _rel(prep[k][0], w) <= RTOL, k


def _wide_system(d, b, n, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((d, d, n)) + 2.0 * d * np.eye(d)[:, :, None]
    E = rng.standard_normal((d, d, n)) / d
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((d, b, n))
    Kbb = rng.standard_normal((b, b)) + 5.0 * np.eye(b)
    return D, E, F, Kbb, rng.standard_normal((d, n)), rng.standard_normal(b)


def test_cr_factor_and_solve_at_the_nlink_block():
    """A cyclic-reduction factor and solve at d = 50, b = 41 through the
    plain versions (the CPU route of the wide kernels) against the JAX
    package's jnp level loop, to 1e-10 relative."""
    D, E, F, Kbb, r, rb = _wide_system(50, 41, N)
    want = jax_tridiag.pcr_factor(*map(jnp.asarray, (D, E, F, Kbb)))
    got = torch_tridiag.pcr_factor(*map(torch.as_tensor, (D, E, F, Kbb)))
    for name in want._fields:
        assert _rel(getattr(got, name), getattr(want, name)) <= 1e-10, name
    u_j, beta_j = jax_tridiag.pcr_solve(want, jnp.asarray(r),
                                        jnp.asarray(rb))
    u_t, beta_t = torch_tridiag.pcr_solve(got, torch.as_tensor(r),
                                          torch.as_tensor(rb))
    assert _rel(u_t, u_j) <= 1e-10
    assert _rel(beta_t, beta_j) <= 1e-10


def test_scan_factor_and_solve_at_the_nlink_block():
    """A scan factor and solve at nlink-9's block (nz = 30, M = 20, so
    d = 50; a border of bw = 1 and o = 40, so b = 41) through the plain
    versions (the CPU route of the wide scan kernels, reached through
    nlp/kkt.py) against the JAX package's factor_kkt / solve_factored,
    to 1e-10 relative; no kernel launch is counted."""
    blocks = _random_blocks(N, 30, 20, 1, 40, seed=3)
    rng = np.random.default_rng(5)
    r, rb = rng.normal(size=(N, 50)), rng.normal(size=41)
    jfac = jax_kkt.factor_kkt(jax_kkt.KKTBlocks(
        **{k: jnp.asarray(v) for k, v in blocks.items()}))
    ju, jbeta = jax_kkt.solve_factored(jfac, jnp.asarray(r), jnp.asarray(rb))
    scan_kernels.reset_launch_counts()
    fac = torch_kkt.factor_kkt(torch_kkt.KKTBlocks(
        **{k: torch.as_tensor(v) for k, v in blocks.items()}))
    assert fac.S_inv.shape == (N, 50, 50) and fac.Ft.shape == (N, 50, 41)
    for name in jfac._fields:
        assert _rel(getattr(fac, name), getattr(jfac, name)) <= 1e-10, name
    u, beta = torch_kkt.solve_factored(fac, torch.as_tensor(r),
                                       torch.as_tensor(rb))
    assert _rel(u, ju) <= 1e-10
    assert _rel(beta, jbeta) <= 1e-10
    assert (scan_kernels.factor_launches, scan_kernels.solve_launches,
            scan_kernels.wide_factor_launches,
            scan_kernels.wide_solve_launches) == (0, 0, 0, 0)


F32, F64 = torch.float32, torch.float64


@pytest.mark.parametrize('args, want', [
    ((5, 4, 501, F32), True), ((5, 4, 501, F64), True),
    ((50, 41, 60, F32), True), ((50, 41, 60, F64), True),
    ((1, 1, 2, F32), True), ((64, 64, 1, F64), True), ((2, 0, 7, F32), True),
    ((65, 4, 60, F32), False), ((5, 65, 60, F32), False),
    ((0, 4, 60, F32), False), ((5, 4, 0, F32), False),
    ((5, 4, 60, torch.float16), False),
    # r of the downsweep in 16 blocks' shared memory: 2 d ceil(N / 16)
    # values of 8 bytes within 227 KB
    ((50, 41, 4640, F64), True), ((50, 41, 4641, F64), False)])
def test_pcr_route_gate(args, want):
    assert pcr_kernels.kernel_supported(*args) is want


@pytest.mark.parametrize('args, want', [
    ((5, 4, 501, F64), True), ((2, 0, 1, F32), True), ((8, 8, 9, F64), True),
    # the wide kernels (csrc/scan_wide.cu) take nlink-9's block, d or b
    # from 9 and d = 1, wherever their shared memory fits
    ((50, 41, 60, F64), True), ((50, 41, 60, F32), True),
    ((50, 41, 1, F64), True), ((9, 0, 60, F64), True),
    ((5, 9, 60, F64), True), ((1, 0, 3, F64), True),
    ((64, 64, 60, F32), True),
    # one block's factor at d = 64 in float64: b = 16 takes 225,280 bytes
    # of the 232,448, b = 17 239,488; a cluster of two takes every b up
    # to 64 (226,816 bytes at b = 64, the off-chain block's)
    ((64, 64, 60, F64), True),
    ((64, 16, 60, F64), True), ((64, 17, 60, F64), True),
    ((50, 48, 60, F64), True), ((50, 49, 60, F64), True),
    ((65, 0, 60, F32), False), ((5, 65, 60, F32), False),
    ((5, 4, 0, F64), False), ((5, 4, 60, torch.float16), False)])
def test_scan_route_gate(args, want):
    assert scan_kernels.kernel_supported(*args) is want


@pytest.mark.parametrize('d, b, itemsize, cluster, want', [
    (50, 41, 8, 1, (223872, 122304)), (50, 41, 4, 1, (112192, 61152)),
    (64, 16, 8, 1, (225280, 198784)), (64, 64, 4, 1, (165888, 99776)),
    (50, 41, 8, 2, (146944, 122304)), (50, 41, 4, 2, (73728, 61152)),
    (64, 64, 8, 2, (226816, 199552)), (64, 64, 8, 1, (331264, 199552)),
    (50, 41, 8, 8, (146944, 122304))])
def test_wide_scan_shared_memory(d, b, itemsize, cluster, want):
    """The wide scan kernels' shared memory a block, as csrc/scan_wide.cu
    lays it out: the factor's chain (five padded d x d matrices) and
    off-chain products (three d x b, in a cluster two d x d read back,
    the b x b border sum) in one block, or the larger of the two in a
    cluster, each with the inverse's scratch; the solve's ring (its
    largest phase's stages: three of E_{k+1} and S_k^-1 here) and its
    vectors, at every cluster size."""
    assert scan_kernels.wide_smem(d, b, itemsize, cluster) == want


@pytest.mark.parametrize('B, want', [
    (1, (2, 8)), (8, (2, 8)), (9, (2, 4)), (16, (2, 4)), (17, (2, 2)),
    (32, (2, 2)), (33, (2, 2)), (34, (2, 1)),
    (66, (2, 1)), (67, (1, 1)), (132, (1, 1)), (200, (1, 1))])
def test_wide_scan_cluster_size_at_the_nlink_block(B, want):
    """nlink-9's (50, 41): the factor's cluster of two while its 2 B
    blocks fit the 132 SMs, the solve's largest of 8, 4, 2 while B c
    blocks fit half of them, in either dtype; one block beyond."""
    for dtype in (F32, F64):
        assert scan_kernels.cluster_size(B, 50, 41, dtype) == want


@pytest.mark.parametrize('d, b, dtype, B, want', [
    # no border: nothing off the chains, one block
    (9, 0, F64, 1, (1, 1)), (64, 0, F64, 1, (1, 1)),
    # beyond one block's shared memory the factor keeps two at any B
    (64, 64, F64, 1, (2, 8)), (64, 64, F64, 200, (2, 1)),
    (50, 49, F64, 100, (2, 1)), (64, 64, F32, 100, (1, 1)),
    # small blocks follow the batch as nlink-9's
    (1, 3, F64, 4, (2, 8)), (12, 5, F32, 40, (2, 1)),
    (12, 5, F32, 70, (1, 1))])
def test_wide_scan_cluster_size_by_block_class(d, b, dtype, B, want):
    c = scan_kernels.cluster_size(B, d, b, dtype)
    assert c == want
    assert c[0] in scan_kernels.FACTOR_CLUSTERS
    assert c[1] in scan_kernels.SOLVE_CLUSTERS
    assert max(scan_kernels.wide_smem(d, b, dtype.itemsize, c[0])) \
        <= scan_kernels.MAX_SMEM


def test_cpu_calls_are_no_plain_route():
    """A CPU tensor goes to the plain versions as the wrappers' own CPU
    path, whatever the shape, and no kernel launch is counted; the
    same shapes beyond the gate (b = 65 here) raise on the card."""
    D, E, F, Kbb, r, rb = _wide_system(50, 65, 4)
    pcr_kernels.reset_launch_counts()
    fac = torch_tridiag.pcr_factor(*map(torch.as_tensor, (D, E, F, Kbb)))
    u, beta = torch_tridiag.pcr_solve(fac, torch.as_tensor(r),
                                      torch.as_tensor(rb))
    assert torch.isfinite(u).all() and beta.shape == (65,)
    assert (pcr_kernels.factor_launches, pcr_kernels.downsweep_launches,
            pcr_kernels.wide_factor_launches,
            pcr_kernels.wide_downsweep_launches) == (0, 0, 0, 0)


@pytest.mark.parametrize('dtype', [F32, F64])
@pytest.mark.parametrize('batch', [1, 8, 32])
def test_wide_downsweep_plan_at_the_nlink_block(batch, dtype):
    """The wide downsweep runs nlink-9's d = 50, N = 60 on a plan of its
    own: clusters that split the 50 rows, as large as the card holds the
    batch's clusters at once (16 blocks at one lane, 8 at eight, 2 at
    32), every (row, node) pair owned by one block, a ring of at least
    two units (a row of a level of A and of B) beside r's two buffers
    within a block's shared memory, a thread per (row, node) and a
    producer warp."""
    plan = pcr_kernels.launch_plan('wide_downsweep', batch, 50, 0, 60, dtype)
    C = plan.cluster
    assert C == {1: 16, 8: 8, 32: 2}[batch] and plan.blocks == batch * C
    rows = [range(q * 50 // C, (q + 1) * 50 // C) for q in range(C)]
    assert [i for r in rows for i in r] == list(range(50))
    assert min(map(len, rows)) >= 1
    assert plan.rows_per_block == max(map(len, rows))
    assert plan.nodes_per_block == 60
    assert 2 <= plan.stages <= 2 * plan.rows_per_block
    assert plan.smem_bytes == pcr_kernels.wide_sweep_smem(
        50, 60, plan.stages, plan.rows_per_block, dtype.itemsize)
    assert plan.smem_bytes <= pcr_kernels.MAX_SMEM
    # a thread per (row, node) up to 992, and the producer's warp
    assert plan.threads - 32 == min(pcr_kernels.MAX_SWEEP_THREADS - 32,
                                    -(-plan.rows_per_block * 60 // 32) * 32)
    # at the route gate's edge r alone fills the shared memory: zero
    # stages, the nodes split over 16 blocks, A and B read directly
    edge = pcr_kernels.launch_plan('wide_downsweep', batch, 50, 0, 4640, F64)
    assert edge.stages == 0 and edge.cluster == pcr_kernels.MAX_CLUSTER
    assert edge.cluster * edge.nodes_per_block >= 4640
    assert edge.smem_bytes == 2 * 50 * edge.nodes_per_block * 8 \
        <= pcr_kernels.MAX_SMEM


def test_entry_points_default_to_the_card():
    """ConstraintCollocator, interop.state_from_numpy and
    make_hvp_seeds run on the card unless given ``device='cpu'``: without
    a card they raise."""
    t = sm.Symbol('t')
    x, v = sm.Function('x')(t), sm.Function('v')(t)
    eom = sm.Matrix([x.diff(t) - v, v.diff(t) + x])
    state = {'x': np.zeros(3)}
    if torch.cuda.is_available():
        col = ConstraintCollocator(eom, (x, v), 4, 0.1, time_symbol=t)
        assert col._device.type == 'cuda'
        assert make_hvp_seeds(4, 2, 0, 0, F64).device.type == 'cuda'
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConstraintCollocator(eom, (x, v), 4, 0.1, time_symbol=t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        interop.state_from_numpy(state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_hvp_seeds(4, 2, 0, 0, F64)
    col = ConstraintCollocator(eom, (x, v), 4, 0.1, time_symbol=t,
                               device='cpu')
    assert col._device.type == 'cpu'


def test_two_link_reach_matches_reference():
    """tests/test_nlink.py's variable-duration two-link reach, solved
    by both packages with the default options: the same status and
    iterations, objectives within 1e-8 relative, the final
    configuration reached and h within its bounds."""
    jp, q_start = jax_problem(num_links=2, num_nodes=31)
    tp, _ = torch_problem(num_links=2, num_nodes=31, device='cpu')
    guess = torch_guess(tp, q_start)
    assert _rel(guess, jax_guess(jp, q_start)) <= 1e-10
    _, want = jp.solve(guess)
    sol, got = tp.solve(guess)
    assert got['status'] == want['status'] == 0
    assert got['iterations'] == want['iterations']
    assert abs(got['obj_val'] - want['obj_val']) <= 1e-8 * abs(
        want['obj_val'])
    assert got['inf_pr'] < 1e-6
    for i in range(3):
        np.testing.assert_allclose(sol[i * 31 + 30], 0.0, atol=1e-5)
    assert 0.0 < sol[-1] <= 0.2 + 1e-12
