"""opty_tpu_torch's scan KKT path (the sequential block elimination,
the float64 reference path and the CPU default) against opty_tpu's,
with the same numpy inputs on both sides:

* factor_kkt / solve_factored / kkt_matvec on random bordered blocks,
  two lanes against the JAX functions vmapped over two, in the three
  structural cases of tests/test_kkt.py, and a solve against a dense
  numpy oracle;
* kkt_apply of make_collocation_nlp_functions(kkt_method='scan') on the
  pendulum swing-up's blocks at one iterate;
* full pendulum solves (N = 101, torque bound 20, float64 factor,
  monotone mu, no second-order correction) from seeds whose reference
  scan solve never enters the restoration phase: 29 and 39.
"""

import numpy as np
import pytest
import sympy as sm
import torch

import jax
import jax.numpy as jnp

from opty_tpu.nlp import kkt as jax_kkt
from opty_tpu.nlp.collocation import \
    make_collocation_nlp_functions as jax_functions
from opty_tpu.transcribe.collocator import ConstraintCollocator as JaxCol
from opty_tpu.utils import create_objective_function as jax_objective
from opty_tpu_torch.models import swing_up_problem
from opty_tpu_torch.nlp import kkt as torch_kkt
from opty_tpu_torch.nlp.collocation import \
    make_collocation_nlp_functions as torch_functions
from opty_tpu_torch.transcribe.collocator import \
    ConstraintCollocator as TorchCol
from opty_tpu_torch.utils import create_objective_function as torch_objective
from test_kkt import dense_kkt
from test_problem import build_pendulum

LANES = 2
# (nz, M, bw, o) of tests/test_kkt.py's cases: border and instance
# rows, no border, border without instance rows
CASES = [(3, 2, 2, 3), (2, 2, 0, 0), (4, 3, 1, 0)]
SOLVE_SEEDS = (29, 39)


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _random_blocks(N, nz, M, bw, o, seed, reg=3.0):
    """One lane of bordered blocks, made as tests/test_kkt.py's."""
    rng = np.random.default_rng(seed)
    Hd = rng.normal(size=(N, nz, nz))
    Hd = 0.5 * (Hd + np.swapaxes(Hd, 1, 2)) + reg * np.eye(nz)
    Ho = rng.normal(size=(N, nz, nz)) * 0.3
    Ho[0] = 0.0
    Hww = rng.normal(size=(bw, bw))
    P = rng.normal(size=(N, M, nz))
    Q = rng.normal(size=(N, M, nz))
    C = rng.normal(size=(N, M, bw)) * 0.5
    P[0] = Q[0] = C[0] = 0.0
    Ds = np.abs(rng.normal(size=(N, M))) * 0.1
    Ds[0] = 1.0
    return dict(
        Hd=Hd, Ho=Ho, Hw=rng.normal(size=(N, nz, bw)) * 0.3,
        Hww=0.5 * (Hww + Hww.T) + reg * np.eye(bw), P=P, Q=Q, C=C, Ds=Ds,
        Gz=rng.normal(size=(o, N, nz)) * (rng.random((o, N, nz)) < 0.3),
        Gw=rng.normal(size=(o, bw)), Di=np.abs(rng.normal(size=(o,))) * 0.01)


@pytest.mark.parametrize('case', CASES)
def test_factor_solve_matvec_match_reference(case):
    N = 11
    nz, M, bw, o = case
    lanes = [_random_blocks(N, nz, M, bw, o, seed) for seed in range(LANES)]
    arrs = {k: np.stack([lane[k] for lane in lanes]) for k in lanes[0]}
    rng = np.random.default_rng(5)
    r = rng.normal(size=(LANES, N, nz + M))
    rb = rng.normal(size=(LANES, bw + o))

    jb = jax_kkt.KKTBlocks(**{k: jnp.asarray(v) for k, v in arrs.items()})
    tb = torch_kkt.KKTBlocks(**{k: torch.as_tensor(v)
                                for k, v in arrs.items()})
    jfac = jax.jit(jax.vmap(jax_kkt.factor_kkt))(jb)
    tfac = torch_kkt.factor_kkt(tb)
    for name in jax_kkt.KKTFactorization._fields:
        assert _rel(getattr(tfac, name), getattr(jfac, name)) <= 1e-12, name

    ju, jbeta = jax.jit(jax.vmap(jax_kkt.solve_factored))(
        jfac, jnp.asarray(r), jnp.asarray(rb))
    tu, tbeta = torch_kkt.solve_factored(tfac, torch.as_tensor(r),
                                         torch.as_tensor(rb))
    assert _rel(tu, ju) <= 1e-12
    assert _rel(tbeta, jbeta) <= 1e-12

    jKu, jKb = jax.jit(jax.vmap(jax_kkt.kkt_matvec))(jb, ju, jbeta)
    tKu, tKb = torch_kkt.kkt_matvec(tb, torch.as_tensor(np.array(ju)),
                                    torch.as_tensor(np.array(jbeta)))
    assert _rel(tKu, jKu) <= 1e-12
    assert _rel(tKb, jKb) <= 1e-12

    # the refined solve against a dense numpy solve, lane by lane
    u, beta = torch_kkt.solve_structured_kkt(
        tb, torch.as_tensor(r), torch.as_tensor(rb), method='scan')
    for lane in range(LANES):
        K = dense_kkt(jax_kkt.KKTBlocks(**lanes[lane]))
        sol = np.linalg.solve(K, np.concatenate([r[lane].ravel(),
                                                 rb[lane]]))
        got = np.concatenate([u[lane].numpy().ravel(), beta[lane].numpy()])
        assert _rel(got, sol) <= 1e-10


def test_kkt_apply_matches_reference():
    """kkt_prepare -> kkt_factor -> kkt_apply (one refinement round and
    a dedicated residual pass) on the pendulum's blocks (N = 21)."""
    N = 21
    I, m, g, d, t = sm.symbols('I, m, g, d, t')
    theta, omega, T = sm.symbols('theta, omega, T', cls=sm.Function)
    states = (theta(t), omega(t))
    eom = sm.Matrix([theta(t).diff(t) - omega(t),
                     I * omega(t).diff(t) + m * g * d * sm.sin(theta(t))
                     - T(t)])
    par_map = {I: 1.0, m: 1.0, g: 9.81, d: 1.0}
    inst = (theta(0.0), theta(10.0) - np.pi, omega(0.0), omega(10.0))
    h = 10.0 / (N - 1)
    cols = [JaxCol(eom, states, N, h, par_map, instance_constraints=inst,
                   time_symbol=t),
            TorchCol(eom, states, N, h, par_map, instance_constraints=inst,
                     time_symbol=t, device='cpu')]
    objs = [make(sm.Integral(T(t) ** 2, t), states, (T(t),), (), N, h,
                 time_symbol=t)
            for make in (jax_objective, torch_objective)]
    rng = np.random.default_rng(0)
    nf, mc = cols[0].num_free, cols[0].num_constraints
    data = dict(x0=rng.standard_normal((LANES, nf)),
                x=rng.standard_normal((LANES, nf)),
                y=rng.standard_normal((LANES, mc)),
                sigma=np.abs(rng.standard_normal((LANES, nf))),
                ds=0.1 * np.abs(rng.standard_normal((LANES, mc))),
                rx=rng.standard_normal((LANES, nf)),
                rc=rng.standard_normal((LANES, mc)))

    T_ = lambda k: torch.as_tensor(data[k])
    fns, _ = torch_functions(cols[1], *objs[1], factor_dtype=torch.float64,
                             scale_from=T_('x0'), kkt_method='scan')
    fac = fns.kkt_factor(fns.kkt_prepare(T_('x'), T_('y')), T_('sigma'),
                         T_('ds'))
    assert isinstance(fac[1], torch_kkt.KKTFactorization)
    dx, dy, resid = fns.kkt_apply(fac, T_('rx'), T_('rc'))

    def one_lane(x0, x, y, sigma, ds, rx, rc):
        jfns, _ = jax_functions(cols[0], *objs[0], factor_dtype=jnp.float64,
                                scale_from=x0, kkt_method='scan')
        return jfns.kkt_apply(
            jfns.kkt_factor(jfns.kkt_prepare(x, y), sigma, ds), rx, rc)

    jdx, jdy, jres = jax.jit(jax.vmap(one_lane))(
        *[jnp.asarray(data[k]) for k in
          ('x0', 'x', 'y', 'sigma', 'ds', 'rx', 'rc')])
    assert _rel(dx, jdx) <= 1e-10
    assert _rel(dy, jdy) <= 1e-10
    assert float(resid.max()) < 1e-12 and float(jres.max()) < 1e-12


@pytest.fixture(scope='module')
def problems():
    """One compiled JAX solver shared by the solves, and the port's
    problem with the CPU defaults (scan, float64 factor)."""
    jprob = build_pendulum(num_nodes=101, tmax=20.0)
    jprob.set_solver_options(factor_dtype=jnp.float64, kkt_method='scan',
                             mu_strategy='monotone', use_soc=False)
    tprob = swing_up_problem(num_nodes=101, torque_bound=20.0,
                             device='cpu')
    tprob.set_solver_options(mu_strategy='monotone', use_soc=False)
    return jprob, tprob


@pytest.mark.parametrize('seed', SOLVE_SEEDS)
def test_solve_matches_reference(problems, seed):
    jprob, tprob = problems
    free = np.random.default_rng(seed).normal(size=jprob.num_free)
    xj, ij = jprob.solve(free)
    xt, it = tprob.solve(free)
    assert ij['rest_iterations'] == 0
    assert ij['status'] in (0, 1)
    assert it['status'] == ij['status']
    assert it['iterations'] == ij['iterations']
    assert abs(it['obj_val'] - ij['obj_val']) <= 1e-8 * abs(ij['obj_val'])
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-6)
