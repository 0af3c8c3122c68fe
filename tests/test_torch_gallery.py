"""opty_tpu_torch's gallery (opty_tpu_torch/examples/gallery/) against
the JAX package's (examples/gallery/), on the CPU in float64: each of
the 25 problems (the seven largest through this file's checks in
tests/test_torch_gallery_large.py) built by both packages'
``build_problem`` at a small size (15 nodes where ``build_problem`` takes a
node count; park2004 at 15 nodes, one_legged_time_trial at 6 samples a
crank revolution, friction_slack at N = 12), compared in its sizes and
classification, bounds, constraints and Jacobian values at two seeded
points near the documented start, objective and gradient there, and
the Hessian blocks (relative to the Hessian's largest entry); the
port's documented starts (``initial_guess``) against
benchmarks/cold_gallery.py's.  betts_10_47's ``build_problem`` reads
its phase-3 start from the reference's CSV, absent here: both modules
read a CSV written by the test instead, and its first phase is
compared as the JAX module's ``run_phases`` builds it.

Agreement is to round-off (RTOL, relative to the largest entry, as in
tests/test_torch_transcribe_breadth.py).  The hilly race's table
interpolation (``_common.interp``) is held against ``jnp.interp`` at
knots and outside the table, value and derivative.
"""

import importlib
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opty_tpu_torch.examples import gallery
from opty_tpu_torch.examples.gallery import _common

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'benchmarks'))
sys.path.insert(0, os.path.join(ROOT, 'examples', 'gallery'))

RTOL = 1e-12
NODES = 15
SMALL = {'park2004': dict(num_nodes=NODES),
         'one_legged_time_trial': dict(samples_per_rev=6),
         'friction_slack': dict(N=12)}
# the problems with the largest equations of motion (their SymPy
# builds and JAX compiles take most of this file's time) are checked
# in tests/test_torch_gallery_large.py, the others here
LARGE = ('ball_on_disc', 'car_around_pylons', 'car_in_garage',
         'double_pendulum_cart', 'drone', 'one_legged_time_trial',
         'steamboat')
CASES = sorted(set(gallery.NAMES) - set(LARGE)) + ['betts_10_47 phase 1']


class _Stop(Exception):
    pass


def _jax_phase1():
    """The phase-1 problem and start that the JAX module's
    ``run_phases`` builds (its first solve is stopped)."""
    from opty_tpu import Problem
    import betts_10_47
    built = []
    saved = Problem.solve

    def stop(prob, guess, *args, **kwargs):
        built.append((prob, np.asarray(guess)))
        raise _Stop

    Problem.solve = stop
    try:
        with pytest.raises(_Stop):
            betts_10_47.run_phases(verbose=False)
    finally:
        Problem.solve = saved
    return built[0]


def _phase3_csv(tmp_path):
    n = 101
    start = np.zeros(3 * n + 1)
    start[[0, n, 2 * n]] = 11125.0, 789.5, 1.0
    path = str(tmp_path / 'phase3.csv')
    np.savetxt(path, start)
    return path


def _cold_guess(name, jp):
    """benchmarks/cold_gallery.py's documented start for the JAX
    problem (its special runners: ``build_problem``'s guess, park2004's with
    the gains at 0.25)."""
    import cold_gallery
    if cold_gallery.PORTS[name] is not None:
        return cold_gallery.PORTS[name][2](jp, jp.collocator
                                           .num_collocation_nodes)
    return None


@pytest.fixture(scope='module', params=CASES)
def pair(request, tmp_path_factory):
    return make_pair(request.param, tmp_path_factory)


def make_pair(name, tmp_path_factory):
    """(name, JAX problem, port problem, the port's documented start,
    the JAX side's start or None) of a case."""
    tport = importlib.import_module('opty_tpu_torch.examples.gallery.'
                                    + name.split()[0])
    if name == 'betts_10_47 phase 1':
        jp, want = _jax_phase1()
        tp = tport.build_phase1(device='cpu')
        return name, jp, tp, tport.guess_phase1(), want
    jmod = importlib.import_module(name)
    kw = SMALL.get(name, dict(num_nodes=NODES))
    if name == 'betts_10_47':
        path = _phase3_csv(tmp_path_factory.mktemp('betts_10_47'))
        saved = jmod.csv, tport.csv
        jmod.csv = tport.csv = lambda _p: path
        try:
            jout, tout = jmod.build_problem(), tport.build_problem(
                device='cpu')
        finally:
            jmod.csv, tport.csv = saved
        assert jout[1] == tout[1] == path
    else:
        jout = jmod.build_problem(**kw)
        tout = tport.build_problem(device='cpu', **kw)
    jp = jout[0] if isinstance(jout, tuple) else jout
    tp = tout[0] if isinstance(tout, tuple) else tout
    assert isinstance(jout, tuple) == isinstance(tout, tuple)
    if isinstance(jout, tuple):
        assert len(jout) == len(tout)
        for j, t in zip(jout[1:], tout[1:]):
            if isinstance(j, np.ndarray):
                np.testing.assert_array_equal(t, j)
            else:
                assert t == j
    if name == 'betts_10_47':
        start = tport.guess_phase3(11125.0, 789.5, 1.0)
        return name, jp, tp, start, None
    start = tport.initial_guess(tp)
    want = _cold_guess(name, jp)
    if want is None:        # a special runner: build_problem's guess
        want = np.array(jout[1], dtype=float)
        if name == 'park2004':
            want[-8:] = 0.25
    return name, jp, tp, start, want


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(want))
    if want.size == 0:
        return 0.0
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _jitted(jc, name):
    """The JAX collocator's method ``name`` compiled once (op-by-op it
    takes seconds a problem)."""
    cache = jc.__dict__.setdefault('_test_jitted', {})
    if name not in cache:
        cache[name] = jax.jit(getattr(jc, name))
    return cache[name]


def _free(start, seed):
    """A seeded point near the documented start."""
    rng = np.random.default_rng(seed)
    return start + 0.01 * (1.0 + np.abs(start)) * rng.normal(
        size=start.shape)


def test_sizes_and_classification(pair):
    _, jp, tp, _, _ = pair
    jc, tc = jp.collocator, tp.collocator
    for name in ('num_free', 'num_constraints', 'num_states', 'num_eom',
                 'unknown_parameters', 'known_parameters',
                 'unknown_input_trajectories', 'known_input_trajectories',
                 'variable_duration', 'integration_method',
                 'num_collocation_nodes', 'num_instance_constraints',
                 '_nz', '_bw'):
        assert getattr(tc, name) == getattr(jc, name), name
    for got, want in zip(tc.jacobian_indices(), jc.jacobian_indices()):
        np.testing.assert_array_equal(got, want)
    for name in ('lower_bound', 'upper_bound', '_low_con_bounds',
                 '_upp_con_bounds'):
        np.testing.assert_array_equal(getattr(tp, name), getattr(jp, name))


def test_documented_start(pair):
    """The port's ``initial_guess`` is cold_gallery.py's (betts_10_47's
    first phase: the JAX ``run_phases``' start; its third, which starts
    from the CSV there: ``guess_phase3`` meets the start's three
    instance constraints)."""
    _, jp, _, start, want = pair
    if want is None:
        g = jp.con(start)[-4:-1]
        np.testing.assert_allclose(g, 0.0, atol=1e-9)
        return
    np.testing.assert_array_equal(start, want)


@pytest.mark.parametrize('seed', [0, 1])
def test_constraints_and_jacobian(pair, seed):
    _, jp, tp, start, _ = pair
    free = _free(start, seed)
    assert _rel(tp.con(free), jp.con(free)) <= RTOL
    assert _rel(tp.con_jac(free), jp.con_jac(free)) <= RTOL


def test_objective_and_gradient(pair):
    _, jp, tp, start, _ = pair
    free = _free(start, 2)
    assert _rel(tp.objective(free), jp.objective(free)) <= RTOL
    assert _rel(tp.gradient(free), jp.gradient(free)) <= RTOL


def test_hessian_blocks(pair):
    _, jp, tp, start, _ = pair
    free = _free(start, 3)
    jc, tc = jp.collocator, tp.collocator
    y = np.random.default_rng(4).normal(size=(jc.num_collocation_nodes - 1,
                                              jc.num_eom))
    got = tc.hessian_blocks(torch.as_tensor(free), torch.as_tensor(y))
    want = _jitted(jc, 'hessian_blocks')(jnp.asarray(free), jnp.asarray(y))
    # relative to the Hessian's largest entry: a block that is zero but
    # for round-off (steamboat's cross blocks, 6e-17) has no scale of
    # its own
    want = [np.asarray(w) for w in want]
    scale = max(float(np.max(np.abs(w))) for w in want if w.size)
    for g, w in zip(got, want):
        g = g.numpy()
        assert g.shape == w.shape and np.all(np.isfinite(w))
        if w.size:
            assert np.max(np.abs(g - w)) <= RTOL * scale


def test_hilly_race_interp():
    """``_common.interp`` is ``jnp.interp`` on hilly_race's tables:
    inside, on knots (the segment to the right, the last knot's to the
    left), outside (clamped); values and derivatives, also batched."""
    amp, omega = 50.0, 2 * np.pi / 500.0
    xp = np.linspace(-250.0, 1250.0, num=3001)
    fp = np.arctan(amp * omega * np.cos(omega * xp))
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-300.0, 1300.0, 40), xp[[0, 1, 7,
                        1500, 2999, 3000]], [-250.0 - 1e-9, 1250.0 + 1e-9,
                                             -1e4, 1e4]])
    txp, tfp = torch.as_tensor(xp), torch.as_tensor(fp)
    jxp, jfp = jnp.asarray(xp), jnp.asarray(fp)
    got = _common.interp(torch.as_tensor(x), txp, tfp)
    want = jnp.interp(jnp.asarray(x), jxp, jfp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15,
                               atol=0.0)

    def t_scalar(v):
        return _common.interp(v, txp, tfp)

    dgot = torch.func.vmap(torch.func.grad(t_scalar))(torch.as_tensor(x))
    dwant = jax.vmap(jax.grad(lambda v: jnp.interp(v, jxp, jfp)))(
        jnp.asarray(x))
    np.testing.assert_allclose(dgot.numpy(), np.asarray(dwant), rtol=1e-12,
                               atol=0.0)
    # knots take the right-hand segment's slope; outside the slope is 0
    assert dgot[-4:].abs().max() == 0.0
    slope = (fp[8] - fp[7]) / (xp[8] - xp[7])
    np.testing.assert_allclose(dgot[40 + 2].item(), slope, rtol=1e-12)


@pytest.mark.parametrize('name', ['betts_10_7', 'betts_10_47'])
def test_card_is_the_default_device(name):
    """Without a card a gallery problem built at its defaults raises,
    naming device='cpu', as every entry point of the port does."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is usable')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gallery.build(name)
