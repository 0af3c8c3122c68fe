"""opty_tpu_torch's structured KKT solve (kkt_prepare -> kkt_factor ->
kkt_apply with refinement, kkt_method='cr') against opty_tpu's on the
pendulum swing-up's KKT blocks at one iterate (N = 31), with the same
numpy inputs on both sides."""

import numpy as np
import pytest
import sympy as sm
import torch

import jax.numpy as jnp

from opty_tpu.nlp.collocation import \
    make_collocation_nlp_functions as jax_functions
from opty_tpu.nlp.kkt import solve_structured_kkt as jax_solve
from opty_tpu.transcribe.collocator import ConstraintCollocator as JaxCol
from opty_tpu.utils import create_objective_function as jax_objective
from opty_tpu_torch.nlp.collocation import \
    make_collocation_nlp_functions as torch_functions
from opty_tpu_torch.nlp.kkt import KKTBlocks, solve_structured_kkt
from opty_tpu_torch.transcribe.collocator import \
    ConstraintCollocator as TorchCol
from opty_tpu_torch.utils import create_objective_function as torch_objective

N = 31
LANES = 2


@pytest.fixture(scope='module')
def setup():
    I, m, g, d, t = sm.symbols('I, m, g, d, t')
    theta, omega, T = sm.symbols('theta, omega, T', cls=sm.Function)
    states = (theta(t), omega(t))
    eom = sm.Matrix([theta(t).diff(t) - omega(t),
                     I * omega(t).diff(t) + m * g * d * sm.sin(theta(t))
                     - T(t)])
    par_map = {I: 1.0, m: 1.0, g: 9.81, d: 1.0}
    inst = (theta(0.0), theta(10.0) - np.pi, omega(0.0), omega(10.0))
    h = 10.0 / (N - 1)
    jc = JaxCol(eom, states, N, h, par_map, instance_constraints=inst,
                time_symbol=t)
    tc = TorchCol(eom, states, N, h, par_map, instance_constraints=inst,
                  time_symbol=t, device='cpu')
    jo, jg = jax_objective(sm.Integral(T(t) ** 2, t), states, (T(t),), (),
                           N, h, time_symbol=t)
    to, tg = torch_objective(sm.Integral(T(t) ** 2, t), states, (T(t),),
                             (), N, h, time_symbol=t)
    rng = np.random.default_rng(0)
    nf, mc = jc.num_free, jc.num_constraints
    data = dict(
        x0=rng.standard_normal((LANES, nf)),
        x=rng.standard_normal((LANES, nf)),
        y=rng.standard_normal((LANES, mc)),
        sigma=np.abs(rng.standard_normal((LANES, nf))),
        ds=0.1 * np.abs(rng.standard_normal((LANES, mc))),
        rx=rng.standard_normal((LANES, nf)),
        rc=rng.standard_normal((LANES, mc)))
    return jc, tc, jo, jg, to, tg, data


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize('factor,tol', [('float64', 1e-10),
                                        ('float32', 1e-8)])
def test_factor_and_apply_match_reference(setup, factor, tol):
    """float64 factor (1 refinement round) and float32 factor (6 rounds
    of float64 refinement) against the JAX package, lane by lane."""
    jc, tc, jo, jg, to, tg, data = setup
    T = lambda k: torch.as_tensor(data[k])
    fns, (sf, dsc) = torch_functions(
        tc, to, tg, factor_dtype=getattr(torch, factor),
        scale_from=T('x0'), kkt_method='cr')
    prep = fns.kkt_prepare(T('x'), T('y'))
    fac = fns.kkt_factor(prep, T('sigma'), T('ds'))
    dx, dy, resid = fns.kkt_apply(fac, T('rx'), T('rc'))
    assert fac[1].fac.Dinv.dtype == getattr(torch, factor)
    for lane in range(LANES):
        J = lambda k: jnp.asarray(data[k][lane])
        jfns, (jsf, jdsc) = jax_functions(
            jc, jo, jg, factor_dtype=getattr(jnp, factor),
            scale_from=J('x0'), kkt_method='cr')
        assert _rel(sf[lane], jsf) <= 1e-14
        assert _rel(dsc[lane], jdsc) <= 1e-14
        jprep = jfns.kkt_prepare(J('x'), J('y'))
        for k, v in jprep.items():
            assert _rel(prep[k][lane], v) <= 1e-12, k
        jfac = jfns.kkt_factor(jprep, J('sigma'), J('ds'))
        jdx, jdy, jres = jfns.kkt_apply(jfac, J('rx'), J('rc'))
        assert _rel(dx[lane], jdx) <= tol
        assert _rel(dy[lane], jdy) <= tol
        # both refined to float64 round-off
        assert float(resid[lane]) < 1e-12 and float(jres) < 1e-12


def test_gauss_newton_mask(setup):
    """gn_mask drops the Lagrangian Hessian (the least-squares
    multiplier system) exactly as the reference does."""
    jc, tc, jo, jg, to, tg, data = setup
    T = lambda k: torch.as_tensor(data[k])
    fns, _ = torch_functions(tc, to, tg, factor_dtype=torch.float64,
                             scale_from=T('x0'), kkt_method='cr')
    prep = fns.kkt_prepare(T('x'), T('y'))
    fac = fns.kkt_factor(prep, T('sigma'), T('ds'), True)
    dx, dy, _ = fns.kkt_apply(fac, T('rx'), T('rc'))
    J = lambda k: jnp.asarray(data[k][1])
    jfns, _ = jax_functions(jc, jo, jg, factor_dtype=jnp.float64,
                            scale_from=J('x0'), kkt_method='cr')
    jfac = jfns.kkt_factor(jfns.kkt_prepare(J('x'), J('y')), J('sigma'),
                           J('ds'), True)
    jdx, jdy, _ = jfns.kkt_apply(jfac, J('rx'), J('rc'))
    assert _rel(dx[1], jdx) <= 1e-10
    assert _rel(dy[1], jdy) <= 1e-10


def test_solve_structured_kkt_random_blocks():
    """solve_structured_kkt(method='cr') on random bordered blocks,
    float32 factor refined in float64, against the reference."""
    rng = np.random.default_rng(3)
    Nn, nz, M, bw, o = 20, 3, 2, 0, 4
    sym = lambda a: a + np.swapaxes(a, -1, -2)
    arrs = dict(
        Hd=sym(rng.standard_normal((Nn, nz, nz))) + 8 * np.eye(nz),
        Ho=0.3 * rng.standard_normal((Nn, nz, nz)),
        Hw=np.zeros((Nn, nz, bw)), Hww=np.zeros((bw, bw)),
        P=rng.standard_normal((Nn, M, nz)),
        Q=rng.standard_normal((Nn, M, nz)),
        C=np.zeros((Nn, M, bw)), Ds=0.1 + np.abs(rng.random((Nn, M))),
        Gz=0.1 * rng.standard_normal((o, Nn, nz)), Gw=np.zeros((o, bw)),
        Di=0.1 + np.abs(rng.random(o)))
    arrs['P'][0] = arrs['Q'][0] = 0.0
    r = rng.standard_normal((Nn, nz + M))
    rb = rng.standard_normal(bw + o)
    from opty_tpu.nlp.kkt import KKTBlocks as JaxBlocks
    ju, jb = jax_solve(JaxBlocks(**{k: jnp.asarray(v)
                                    for k, v in arrs.items()}),
                       jnp.asarray(r), jnp.asarray(rb),
                       factor_dtype=jnp.float32, refine_steps=6,
                       method='cr')
    tu, tb = solve_structured_kkt(
        KKTBlocks(**{k: torch.as_tensor(v) for k, v in arrs.items()}),
        torch.as_tensor(r), torch.as_tensor(rb),
        factor_dtype=torch.float32, refine_steps=6, method='cr')
    assert _rel(tu, ju) <= 1e-8
    assert _rel(tb, jb) <= 1e-8


def test_unported_methods_raise(setup):
    """kkt_method='spike' without a mesh raises the JAX package's
    ValueError (opty_tpu/nlp/collocation.py) in both packages; with a
    node mesh of 4 slabs the port's spike factor and refined apply match
    the JAX package's scan solve, lane by lane."""
    from opty_tpu_torch.parallel.mesh import NodeMesh
    jc, tc, jo, jg, to, tg, data = setup
    with pytest.raises(ValueError, match="'spike' requires a mesh"):
        torch_functions(tc, to, tg, kkt_method='spike')
    with pytest.raises(ValueError, match="'spike' requires a mesh"):
        jax_functions(jc, jo, jg, kkt_method='spike')
    T = lambda k: torch.as_tensor(data[k])
    fns, _ = torch_functions(tc, to, tg, factor_dtype=torch.float64,
                             scale_from=T('x0'), kkt_method='spike',
                             mesh=NodeMesh(4))
    fac = fns.kkt_factor(fns.kkt_prepare(T('x'), T('y')), T('sigma'),
                         T('ds'))
    dx, dy, resid = fns.kkt_apply(fac, T('rx'), T('rc'))
    for lane in range(LANES):
        J = lambda k: jnp.asarray(data[k][lane])
        jfns, _ = jax_functions(jc, jo, jg, factor_dtype=jnp.float64,
                                scale_from=J('x0'), kkt_method='scan')
        jfac = jfns.kkt_factor(jfns.kkt_prepare(J('x'), J('y')),
                               J('sigma'), J('ds'))
        jdx, jdy, _ = jfns.kkt_apply(jfac, J('rx'), J('rc'))
        assert _rel(dx[lane], jdx) <= 1e-10
        assert _rel(dy[lane], jdy) <= 1e-10
