"""opty_tpu_torch's solver breadth against opty_tpu's, in float64 on
the CPU, with the same numpy inputs on both sides:

* the adaptive-mu helpers (complementarity_average, stall_fallback,
  mehrotra_probe) and slack_opt on tests/test_ipm_units.py's specs,
  within 1e-12 relative;
* restoration_solve on that file's three cases (certified infeasible,
  reaches feasibility, time box and dead lane): the same flags and
  iteration counts, x, s and theta within 1e-10 (absolute below unit
  size: the certified case restores x to about 1e-6 of 0);
* the dense solve_ipm problems of tests/test_ipm.py with the default
  options (HS071, the far start, the infeasible problem, which
  restores): the same status, iteration count and restoration
  iterations;
* kkt_prepare_gn, kkt_apply_soc and kkt_solve_feasibility of the
  collocation functions on the N = 101 pendulum, within 1e-10.

The solver-level checks (one iteration from a crossed-over state, full
default-option solves) are in tests/test_torch_solver_default.py.
"""

import numpy as np
import pytest
import sympy as sm
import torch

import jax
import jax.numpy as jnp

from opty_tpu.nlp import steps as jsteps
from opty_tpu.nlp.collocation import \
    make_collocation_nlp_functions as jax_functions
from opty_tpu.nlp.ipm import make_nlp_functions_dense as jax_dense
from opty_tpu.nlp.ipm import solve_ipm as jax_solve_ipm
from opty_tpu.nlp.ipm_types import IPMOptions as JaxOptions
from opty_tpu.transcribe.collocator import ConstraintCollocator as JaxCol
from opty_tpu.utils import create_objective_function as jax_objective
from opty_tpu_torch.nlp import steps as tsteps
from opty_tpu_torch.nlp.collocation import \
    make_collocation_nlp_functions as torch_functions
from opty_tpu_torch.nlp.ipm import make_nlp_functions_dense as torch_dense
from opty_tpu_torch.nlp.ipm import solve_ipm as torch_solve_ipm
from opty_tpu_torch.nlp.ipm_types import IPMOptions, Spec
from opty_tpu_torch.transcribe.collocator import \
    ConstraintCollocator as TorchCol
from opty_tpu_torch.utils import create_objective_function as torch_objective
from test_ipm_units import _spec as jax_spec

INF = 1e20
TOL = 1e-12          # the step functions, relative
TOL_REST = 1e-10     # restoration iterates
TOL_KKT = 1e-10      # the collocation KKT entry points


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _err(got, want):
    """Max abs difference over max(1, max |want|): relative on values of
    unit size and above, absolute below (a restored x near 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)


def _t(a):
    """A numpy / JAX array as a float64 (or bool / int) torch tensor
    with a lane axis of 1."""
    a = np.array(a)
    if a.dtype.kind == 'f':
        a = a.astype(np.float64)
    return torch.as_tensor(a)[None]


def torch_spec(js):
    """The port's Spec (one lane) of an opty_tpu Spec."""
    opt = IPMOptions(**js.opt._asdict())
    return Spec(opt=opt, **{f: _t(getattr(js, f))
                            for f in Spec._fields if f != 'opt'})


def _spec_cases():
    """The specs of tests/test_ipm_units.py: all-finite, mixed finite
    and infinite, inequality ranges and a one-sided row."""
    return [
        jax_spec(),
        jax_spec(n=2, m=1, xl=[0.0, -1e20], xu=[1e20, 1e20], cl=[-1.0],
                 cu=[1.0]),
        jax_spec(n=4, m=3, xl=[-2.0, 0.0, -1e20, 1.0],
                 xu=[2.0, 1e20, 1e20, 3.0], cl=[-1.0, 0.0, -1e20],
                 cu=[1.0, 1e20, 0.5]),
    ]


def _point(js, seed):
    """A random interior point of the spec's boxes with random
    nonnegative duals."""
    rng = np.random.default_rng(seed)
    n, m = js.xl.shape[0], js.cl.shape[0]

    def inside(lo, hi, k):
        lo, hi = np.asarray(lo), np.asarray(hi)
        base = rng.uniform(0.1, 0.9, k)
        return np.where((lo > -1e18) & (hi < 1e18), lo + base * (hi - lo),
                        np.where(lo > -1e18, lo + 2 * base,
                                 np.where(hi < 1e18, hi - 2 * base,
                                          rng.standard_normal(k))))
    return dict(x=inside(js.xl, js.xu, n), s=inside(js.cl, js.cu, m),
                zL=np.abs(rng.standard_normal(n)) * np.asarray(js.mL),
                zU=np.abs(rng.standard_normal(n)) * np.asarray(js.mU),
                wL=np.abs(rng.standard_normal(m)) * np.asarray(js.msL),
                wU=np.abs(rng.standard_normal(m)) * np.asarray(js.msU),
                dx=rng.standard_normal(n), ds=rng.standard_normal(m))


# ---------------------------------------------------------------------------
# adaptive-mu helpers and slack_opt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', range(3))
@pytest.mark.parametrize('seed', [0, 1])
def test_complementarity_average_and_probe(case, seed):
    js = _spec_cases()[case]
    ts = torch_spec(js)
    p = _point(js, seed)
    J = {k: jnp.asarray(v) for k, v in p.items()}
    T = {k: _t(v) for k, v in p.items()}
    want = jsteps.complementarity_average(js, J['x'], J['s'], J['zL'],
                                          J['zU'], J['wL'], J['wU'])
    got = tsteps.complementarity_average(ts, T['x'], T['s'], T['zL'],
                                         T['zU'], T['wL'], T['wU'])
    assert _rel(got[0], want) <= TOL
    jd = jsteps.barrier_diagonals(js, J['x'], J['s'], J['zL'], J['zU'],
                                  J['wL'], J['wU'])
    td = tsteps.barrier_diagonals(ts, T['x'], T['s'], T['zL'], T['zU'],
                                  T['wL'], T['wU'])
    for scale in (1e-2, 1.0, 50.0):       # unblocked to blocked steps
        for mu_prev, bad in ((0.1, False), (1e-3, False), (0.1, True)):
            want = jsteps.mehrotra_probe(
                js, jd, J['zL'], J['zU'], J['wL'], J['wU'],
                scale * J['dx'], scale * J['ds'], jnp.asarray(mu_prev),
                jnp.asarray(bad))
            got = tsteps.mehrotra_probe(
                ts, td, T['zL'], T['zU'], T['wL'], T['wU'],
                scale * T['dx'], scale * T['ds'],
                torch.tensor([mu_prev], dtype=torch.float64),
                torch.tensor([bad]))
            assert _rel(got[0], want) <= TOL, (scale, mu_prev, bad)


def test_stall_fallback_sequences():
    """The observation sequences of TestStallFallback, fed to both."""
    js = jax_spec()
    ts = torch_spec(js)
    w = js.opt.stall_window
    runs = [([1e-3] * (w + 2), [0.999 ** i for i in range(w + 2)]),
            ([1.0] * (w + 2), [5.0] * (w + 2)),
            ([1.0] * 30, [10.0 * 0.5 ** i for i in range(30)]),
            ([1.0] * 30, [3.0 * (1.0 + 0.02 * (-1) ** i) for i in range(30)])]
    for mono, in_rest in ((False, False), (True, False), (False, True)):
        for alphas, Es in runs:
            jc, jb = jnp.asarray(0, jnp.int32), jnp.asarray(np.inf)
            tc = torch.zeros(1, dtype=torch.int32)
            tb = torch.full((1,), np.inf, dtype=torch.float64)
            for a, E in zip(alphas, Es):
                jc, jf, jb = jsteps.stall_fallback(
                    js, jnp.asarray(mono), jnp.asarray(in_rest),
                    jnp.asarray(a), jnp.asarray(E), jb, jc)
                tc, tf, tb = tsteps.stall_fallback(
                    ts, torch.tensor([mono]), torch.tensor([in_rest]),
                    torch.tensor([a], dtype=torch.float64),
                    torch.tensor([E], dtype=torch.float64), tb, tc)
                assert int(tc[0]) == int(jc)
                assert bool(tf[0]) == bool(jf)
                assert float(tb[0]) == float(jb)


@pytest.mark.parametrize('mu_R', [1e-8, 1e-3, 0.5, 10.0])
def test_slack_opt(mu_R):
    """Range, one-sided, equality and free rows, and a row narrower
    than twice the margin mu_R / (4 rho_R) (its clamps cross, as in the
    reference)."""
    js = jax_spec(n=2, m=5, cl=[-1.0, 0.0, -1e20, 0.0, -1e-3],
                  cu=[1.0, 1e20, 1e20, 0.0, 1e-3])
    ts = torch_spec(js)
    rng = np.random.default_rng(int(mu_R * 1e3) % 97)
    c = 3.0 * rng.standard_normal(5)
    s = np.array([0.2, 1.5, -0.3, 0.0, 0.0])
    want = jsteps.slack_opt(js, jnp.asarray(c), jnp.asarray(s),
                            jnp.asarray(mu_R), 1000.0)
    got = tsteps.slack_opt(ts, _t(c), _t(s),
                           torch.tensor([mu_R], dtype=torch.float64), 1000.0)
    assert _rel(got[0], want) <= TOL


# ---------------------------------------------------------------------------
# restoration_solve on the dense oracles of tests/test_ipm_units.py
# ---------------------------------------------------------------------------

def _rest_case(name):
    """(objective, constraints) for JAX and torch, the spec, x0 and the
    keyword arguments of tests/test_ipm_units.py's restoration cases."""
    if name == 'feasible':
        return (lambda x: jnp.sum(x ** 2),
                lambda x: jnp.asarray([x[0] ** 2 + x[1] - 1.0]),
                lambda x: torch.sum(x ** 2),
                lambda x: torch.stack([x[0] ** 2 + x[1] - 1.0]),
                jax_spec(n=2, m=1, xl=-10.0 * np.ones(2),
                         xu=10.0 * np.ones(2), cl=[0.0], cu=[0.0]),
                np.array([3.0, 5.0]), dict(max_inner=100))
    opt = JaxOptions(rest_reduction=0.05) if name == 'infeasible' else None
    return (lambda x: jnp.sum(x),
            lambda x: jnp.asarray([x[0] ** 2 + 1.0]),
            lambda x: torch.sum(x),
            lambda x: torch.stack([x[0] ** 2 + 1.0]),
            jax_spec(n=1, m=1, xl=[-10.0], xu=[10.0], cl=[0.0], cu=[0.0],
                     opt=opt),
            np.array([2.0]),
            dict(max_inner=200) if name == 'infeasible'
            else dict(max_inner=3))


@pytest.mark.parametrize('name,live,s0', [
    ('infeasible', True, 0.0), ('feasible', True, 0.0),
    ('time_box', True, 0.0), ('time_box', False, 7.5)])
def test_restoration_solve(name, live, s0):
    jo, jcon, to, tcon, js, x0, kw = _rest_case(name)
    ts = torch_spec(js)
    if not live:
        kw = {}
    jf, tf = jax_dense(jo, jcon), torch_dense(to, tcon)
    ft, fp, fc = jsteps.fresh_filter(jnp.asarray(1e4), jnp.float64)
    want = jsteps.restoration_solve(
        js, jf, jnp.asarray(x0), jnp.full((1,), s0), jcon(jnp.asarray(x0)),
        jnp.asarray(0.1), jnp.asarray(live), ft, fp, fc,
        jnp.asarray(1e-6), **kw)
    tft, tfp, tfc = tsteps.fresh_filter(
        torch.tensor([1e4], dtype=torch.float64), torch.float64)
    got = tsteps.restoration_solve(
        ts, tf, _t(x0), torch.full((1, 1), s0, dtype=torch.float64),
        tf.constraints(_t(x0)), torch.tensor([0.1], dtype=torch.float64),
        torch.tensor([live]), tft, tfp, tfc,
        torch.tensor([1e-6], dtype=torch.float64), **kw)
    for f in ('success', 'certified', 'kick', 'iters'):
        assert int(getattr(got, f)[0]) == int(getattr(want, f)), f
    assert _err(got.x[0], want.x) <= TOL_REST
    assert _err(got.s[0], want.s) <= TOL_REST
    assert _err(got.theta[0], want.theta) <= TOL_REST
    if not live:
        assert int(got.iters[0]) == 0
        assert float(got.x[0, 0]) == 2.0 and float(got.s[0, 0]) == 7.5


# ---------------------------------------------------------------------------
# dense solve_ipm with the default options
# ---------------------------------------------------------------------------

def _dense_problem(name):
    if name == 'hs071':
        return (lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
                lambda x: jnp.stack([x[0] * x[1] * x[2] * x[3],
                                     jnp.sum(x ** 2)]),
                lambda x: x[0] * x[3] * (x[0] + x[1] + x[2]) + x[2],
                lambda x: torch.stack([x[0] * x[1] * x[2] * x[3],
                                       torch.sum(x ** 2)]),
                [1.0, 5.0, 5.0, 1.0], np.ones(4), np.full(4, 5.0),
                [25.0, 40.0], [INF, 40.0], {})
    if name == 'far_start':
        return (lambda x: (x[0] - 3.0) ** 2 + (x[1] - 3.0) ** 2,
                lambda x: jnp.stack([x[0] ** 2 + x[1] ** 2, x[0] + x[1]]),
                lambda x: (x[0] - 3.0) ** 2 + (x[1] - 3.0) ** 2,
                lambda x: torch.stack([x[0] ** 2 + x[1] ** 2, x[0] + x[1]]),
                [50.0, -40.0], np.full(2, -INF), np.full(2, INF),
                [4.0, 2.5], [4.0, INF], {})
    return (lambda x: x[0] ** 2,
            lambda x: jnp.stack([x[0], x[0] - 1.0]),
            lambda x: x[0] ** 2,
            lambda x: torch.stack([x[0], x[0] - 1.0]),
            [5.0], np.full(1, -INF), np.full(1, INF), np.zeros(2),
            np.zeros(2), dict(max_iter=300))


@pytest.mark.parametrize('name', ['hs071', 'far_start', 'infeasible'])
def test_dense_solves_with_defaults(name):
    jo, jcon, to, tcon, x0, xl, xu, cl, cu, kw = _dense_problem(name)
    A = lambda v: np.asarray(v, np.float64)
    want = jax_solve_ipm(jax_dense(jo, jcon), jnp.asarray(A(x0)),
                         jnp.asarray(A(xl)), jnp.asarray(A(xu)),
                         jnp.asarray(A(cl)), jnp.asarray(A(cu)),
                         options=JaxOptions(**kw))
    got = torch_solve_ipm(torch_dense(to, tcon), _t(A(x0)),
                          torch.as_tensor(A(xl)), torch.as_tensor(A(xu)),
                          torch.as_tensor(A(cl)), torch.as_tensor(A(cu)),
                          options=IPMOptions(**kw))
    assert int(got.status[0]) == int(want.status)
    assert int(got.iterations[0]) == int(want.iterations)
    assert int(got.rest_total[0]) == int(want.rest_total)
    assert bool(got.mono[0]) == bool(want.mono)
    if name == 'infeasible':
        assert int(got.status[0]) in (2, -2)
        assert int(want.rest_total) > 0
    else:
        assert int(got.status[0]) in (0, 1)
        assert _rel(got.x[0], want.x) <= 1e-8


# ---------------------------------------------------------------------------
# the collocation KKT entry points (N = 101 pendulum)
# ---------------------------------------------------------------------------

N = 101
LANES = 2


@pytest.fixture(scope='module')
def pendulum():
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
    rng = np.random.default_rng(5)
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


@pytest.mark.parametrize('method', ['cr', 'scan'])
def test_collocation_entry_points(pendulum, method):
    """kkt_prepare_gn (Jacobian blocks, zero Hessian blocks),
    kkt_apply_soc (one refinement round, no residual) on a
    factorization of kkt_prepare's blocks, and kkt_solve_feasibility,
    lane by lane against the reference."""
    jc, tc, jo, jg, to, tg, data = pendulum
    T = lambda k: torch.as_tensor(data[k])
    fns, _ = torch_functions(tc, to, tg, factor_dtype=torch.float64,
                             scale_from=T('x0'), kkt_method=method)
    gn = fns.kkt_prepare_gn(T('x'))
    prep = fns.kkt_prepare(T('x'), T('y'))
    fac = fns.kkt_factor(prep, T('sigma'), T('ds'))
    soc = fns.kkt_apply_soc(fac, T('rx'), T('rc'))
    feas = fns.kkt_solve_feasibility(gn, T('sigma'), T('rc'))
    assert len(soc) == 2 and len(feas) == 2

    @jax.jit
    def reference(x0, x, y, sigma, ds, rx, rc):
        jfns, _ = jax_functions(jc, jo, jg, factor_dtype=jnp.float64,
                                scale_from=x0, kkt_method=method)
        jgn = jfns.kkt_prepare_gn(x)
        jfac = jfns.kkt_factor(jfns.kkt_prepare(x, y), sigma, ds)
        return (jgn, jfns.kkt_apply_soc(jfac, rx, rc),
                jfns.kkt_solve_feasibility(jgn, sigma, rc))

    for lane in range(LANES):
        jgn, jsoc, jfeas = reference(*(jnp.asarray(data[k][lane]) for k in (
            'x0', 'x', 'y', 'sigma', 'ds', 'rx', 'rc')))
        assert set(jgn) == set(gn)
        for k, v in jgn.items():
            assert _rel(gn[k][lane], v) <= TOL_KKT, k
        for got, want in zip(soc + feas, jsoc + jfeas):
            assert _rel(got[lane], want) <= TOL_KKT


def test_take_lanes_gathers_the_scaling(pendulum):
    """The functions narrowed to one lane evaluate that lane exactly as
    the batch does (a restoration visit runs on its lanes only)."""
    jc, tc, jo, jg, to, tg, data = pendulum
    T = lambda k: torch.as_tensor(data[k])
    fns, _ = torch_functions(tc, to, tg, factor_dtype=torch.float64,
                             scale_from=T('x0'), kkt_method='cr')
    one = fns.take_lanes(torch.tensor([1]))
    x = T('x')
    assert torch.equal(one.constraints(x[1:]), fns.constraints(x)[1:])
    assert torch.equal(one.objective(x[1:]), fns.objective(x)[1:])
    gn = fns.kkt_prepare_gn(x)
    for k, v in one.kkt_prepare_gn(x[1:]).items():
        assert torch.equal(v, gn[k][1:]), k
