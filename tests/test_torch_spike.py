"""opty_tpu_torch's node-split SPIKE KKT solve (parallel/spike.py) on the
CPU, its slabs a tensor axis of one process, against opty_tpu:

* random bordered block-tridiagonal systems (numpy default_rng) at
  N = 16-64 on P = 2 and 4 slabs, and at node counts P does not divide:
  ``spike_solve`` against the dense oracle of tests/test_kkt.py and the
  JAX package's unsharded ``solve_structured_kkt``, and the port's
  ``solve_structured_kkt_sharded`` (equilibration, a float32 factor,
  refinement) against the JAX package's refined solve, to 1e-8;
* ``spike_factor`` + ``spike_apply`` against ``spike_solve``, lanes, the
  system without a border, and the kernels' shape gate;
* the pendulum swing-up at N = 101 solved with kkt_method='spike' on 4
  slabs against the JAX package's 'scan' solve from the same start:
  the same status and iterations, the objective within 1e-8 relative.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from opty_tpu.nlp.kkt import KKTBlocks as JaxBlocks
from opty_tpu.nlp.kkt import solve_structured_kkt as jax_solve
from opty_tpu_torch.nlp.kkt import KKTBlocks, _assemble_node_blocks
from opty_tpu_torch.ops import scan_kernels as sk
from opty_tpu_torch.parallel import spike as sp
from opty_tpu_torch.parallel.mesh import NodeMesh
from test_kkt import dense_kkt

FIELDS = KKTBlocks._fields


def random_arrays(seed, N, nz, M, bw, o, lanes=(), reg=3.0):
    """tests/test_kkt.py's random_blocks from a seeded generator, as
    numpy arrays keyed by the KKTBlocks fields (optional lane axes)."""
    rng = np.random.default_rng(seed)
    sh = lambda *s: lanes + s
    sym = lambda a: 0.5 * (a + np.swapaxes(a, -1, -2))
    Hd = sym(rng.normal(size=sh(N, nz, nz))) + reg * np.eye(nz)
    Ho = rng.normal(size=sh(N, nz, nz)) * 0.3
    Ho[..., 0, :, :] = 0.0
    Hw = rng.normal(size=sh(N, nz, bw)) * 0.3
    Hww = sym(rng.normal(size=sh(bw, bw))) + reg * np.eye(bw)
    P = rng.normal(size=sh(N, M, nz))
    Q = rng.normal(size=sh(N, M, nz))
    C = rng.normal(size=sh(N, M, bw)) * 0.5
    for a in (P, Q, C):
        a[..., 0, :, :] = 0.0
    Ds = np.abs(rng.normal(size=sh(N, M))) * 0.1
    Ds[..., 0, :] = 1.0
    Gz = rng.normal(size=sh(o, N, nz)) * (rng.random(sh(o, N, nz)) < 0.05)
    Gw = rng.normal(size=sh(o, bw))
    Di = np.abs(rng.normal(size=sh(o))) * 0.01
    return dict(zip(FIELDS, (Hd, Ho, Hw, Hww, P, Q, C, Ds, Gz, Gw, Di)))


def torch_blocks(arrs):
    return KKTBlocks(**{k: torch.as_tensor(v) for k, v in arrs.items()})


def jax_blocks(arrs):
    return JaxBlocks(**{k: jnp.asarray(v) for k, v in arrs.items()})


def system(seed, N, nz, M, bw, o, lanes=()):
    """(arrays, torch D, E, F, Kbb, r, rb) of a random system."""
    arrs = random_arrays(seed, N, nz, M, bw, o, lanes)
    D, E, F, Kbb = _assemble_node_blocks(torch_blocks(arrs))
    rng = np.random.default_rng(seed + 100)
    r = torch.as_tensor(rng.normal(size=D.shape[:-1]))
    rb = torch.as_tensor(rng.normal(size=Kbb.shape[:-1]))
    return arrs, D, E, F, Kbb, r, rb


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize('N,nz,M,bw,o,P', [
    (64, 3, 2, 2, 3, 4), (48, 2, 2, 1, 2, 2), (61, 3, 2, 2, 3, 4),
    (16, 2, 1, 1, 1, 4), (33, 3, 2, 0, 2, 2)])
def test_spike_matches_dense_and_unsharded(N, nz, M, bw, o, P):
    arrs, D, E, F, Kbb, r, rb = system(N + P, N, nz, M, bw, o)
    u, beta = sp.spike_solve(D, E, F, Kbb, r, rb, NodeMesh(P))
    K = dense_kkt(jax_blocks(arrs))
    sol = np.linalg.solve(K, np.concatenate([r.numpy().ravel(),
                                             rb.numpy()]))
    d = D.shape[-1]
    np.testing.assert_allclose(u.numpy(), sol[:N * d].reshape(N, d),
                               rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(beta.numpy(), sol[N * d:], rtol=1e-8,
                               atol=1e-8)
    ju, jb = jax_solve(jax_blocks(arrs), jnp.asarray(r.numpy()),
                       jnp.asarray(rb.numpy()))
    assert _rel(u, ju) <= 1e-8
    if beta.numel():
        assert _rel(beta, jb) <= 1e-8


@pytest.mark.parametrize('P', [2, 4])
def test_sharded_structured_solve_refined(P):
    """The wrapper (equilibration, float32 factor, three refinement
    rounds) against the JAX package's unsharded refined solve."""
    arrs, D, E, F, Kbb, r, rb = system(7, 64, 3, 2, 2, 2)
    ju, jb = jax_solve(jax_blocks(arrs), jnp.asarray(r.numpy()),
                       jnp.asarray(rb.numpy()), refine_steps=2)
    u, beta = sp.solve_structured_kkt_sharded(
        torch_blocks(arrs), r, rb, NodeMesh(P), factor_dtype=torch.float32,
        refine_steps=3)
    assert _rel(u, ju) <= 1e-7
    assert _rel(beta, jb) <= 1e-7


@pytest.mark.parametrize('lanes', [(), (3,)])
def test_factor_apply_matches_solve(lanes):
    """spike_factor + spike_apply equal the fused spike_solve, for a
    second right-hand side on the same factorization too, with lanes."""
    _, D, E, F, Kbb, r, rb = system(11, 40, 2, 1, 1, 1, lanes)
    mesh = NodeMesh(4)
    fac = sp.spike_factor(D, E, F, Kbb, mesh)
    for rr, rbb in ((r, rb), (torch.flip(r, (-2,)), -rb)):
        u, beta = sp.spike_apply(fac, rr, rbb, mesh)
        u_s, beta_s = sp.spike_solve(D, E, F, Kbb, rr, rbb, mesh)
        assert _rel(u, u_s) <= 1e-10
        assert _rel(beta, beta_s) <= 1e-10


def test_no_border():
    arrs, D, E, F, Kbb, r, rb = system(6, 32, 2, 2, 0, 0)
    u, beta = sp.spike_solve(D, E, F, Kbb, r, rb, NodeMesh(4))
    sol = np.linalg.solve(dense_kkt(jax_blocks(arrs)), r.numpy().ravel())
    np.testing.assert_allclose(u.numpy(), sol.reshape(u.shape), rtol=1e-8,
                               atol=1e-8)
    assert beta.shape == (0,)


def test_local_factor_and_sweeps_are_the_scan_recursion():
    """The slabs' local factorization with the spike columns as the scan
    factor's border (the kernel's route) gives the plain ``_local_factor``
    and ``_local_solve``; one right-hand side through scan_solve with an
    empty border gives ``_local_solve`` too."""
    _, D, E, F, Kbb, r, _ = system(13, 24, 3, 2, 2, 1, (4,))
    Eint = E.clone()
    Eint[..., 0, :, :] = 0.0
    R = torch.cat([r[..., None], F], dim=-1)
    S_inv, Melim, X = sp._factor_with_columns(D, Eint, R)
    S_p, M_p = sp._local_factor(D, Eint)
    assert torch.equal(S_inv, S_p) and torch.equal(Melim, M_p)
    assert _rel(X, sp._local_solve(S_p, M_p, Eint, R)) <= 1e-14
    y = sp._solve_one(S_inv, Melim, Eint, r)
    assert _rel(y, sp._local_solve(S_p, M_p, Eint, r[..., None])[..., 0]) \
        <= 1e-14


def test_kernel_shape_gate():
    """The spike columns ride as the scan factor's border: 2 d + b = 141
    columns at nlink-9's block (d = 50, b = 41) exceed the kernels' 64,
    and the card's check refuses the shape by name."""
    d, cols = 50, 2 * 50 + 41
    D = torch.zeros(2, 3, d, d)
    with pytest.raises(ValueError, match='b=141'):
        sk.check_factor(D, D, torch.zeros(2, 3, d, cols),
                        torch.zeros(2, cols, cols))
    assert not sk.kernel_supported(d, cols, 3, torch.float64)
    assert sk.kernel_supported(5, 2 * 5 + 4 + 1, 126, torch.float64)


def test_spike_needs_a_mesh():
    from opty_tpu_torch.models import swing_up_problem
    prob = swing_up_problem(num_nodes=11, device='cpu')
    prob.set_solver_options(kkt_method='spike')
    with pytest.raises(ValueError, match="requires a mesh"):
        prob.solve(np.zeros(prob.num_free))


N_PEND = 101
SEED = 29


def test_pendulum_spike_matches_jax_scan():
    """N = 101 swing-up (torque bound 20), monotone mu, a float64
    factor, no second-order correction, from default_rng(29).normal
    (chip_smoke.py's phase 4 start): the port's spike solve on 4 slabs
    (101 nodes: 26 a slab, three padding nodes) against the JAX
    package's scan solve; the mesh given to the Problem."""
    from opty_tpu_torch.models import swing_up_problem
    from test_problem import build_pendulum
    x0 = np.random.default_rng(SEED).normal(size=3 * N_PEND)
    jprob = build_pendulum(num_nodes=N_PEND, tmax=20.0)
    assert jprob.num_free == x0.size
    jprob.set_solver_options(kkt_method='scan', factor_dtype=jnp.float64,
                             mu_strategy='monotone', use_soc=False)
    _, ij = jprob.solve(x0)
    tprob = swing_up_problem(num_nodes=N_PEND, torque_bound=20.0,
                             device='cpu', mesh=NodeMesh(4))
    tprob.set_solver_options(kkt_method='spike', factor_dtype=torch.float64,
                             mu_strategy='monotone', use_soc=False)
    _, it = tprob.solve(x0)
    assert ij['status'] == 0
    assert (it['status'], it['iterations']) == (ij['status'],
                                                ij['iterations'])
    assert abs(it['obj_val'] - ij['obj_val']) <= 1e-8 * abs(ij['obj_val'])
