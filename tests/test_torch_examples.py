"""opty_tpu_torch's pendulum_swing_up and nlink_reach examples
(opty_tpu_torch/examples/) against the JAX package's scripts
(examples/pendulum_swing_up.py, examples/nlink_reach.py), on the CPU in
float64: each script's ``main`` with the same arguments in both
packages (the JAX package's solves are caught by
scripts/reference_gallery.py's ``run_example_main``): the swing-up's
fixed-duration solve at N = 301 to its end (44 iterations), its
``--variable-duration`` solve at N = 51 and ``--batch 3`` through
``solve_batch`` at N = 51, and the n-link reach with 2 links at 12
nodes, solved to its end.  The fixed-duration solve converges only on
fine grids (the torque bound of 2 is tight: from the script's start it
fails at N = 101) and N = 301 is the smallest the CPU finishes within a
test's time; the other two swing-up paths take hundreds of iterations
or fail below that, so they are cut to MAX_ITER iterations (``max_iter``
set on each problem as it solves, in both packages) and the check is
that both scripts build the same problems and starts and take the same
first MAX_ITER iterations.  The same status and iteration count, and
objectives within OBJ_TOL relative.  The swing-up's full runs at the
example's own sizes are chip_smoke.py's phase 9c.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))

from reference_gallery import run_example_main  # noqa: E402

from opty_tpu_torch import Problem  # noqa: E402
from opty_tpu_torch.examples import nlink_reach  # noqa: E402
from opty_tpu_torch.examples import pendulum_swing_up  # noqa: E402

MAX_ITER = 12
OBJ_TOL = 1e-8


@pytest.fixture
def capped(monkeypatch):
    """The port's solves cut to MAX_ITER iterations."""
    for name in ('solve', 'solve_batch'):
        method = getattr(Problem, name)

        def wrapped(prob, *args, _method=method, **kwargs):
            prob.set_solver_options(max_iter=MAX_ITER)
            return _method(prob, *args, **kwargs)
        monkeypatch.setattr(Problem, name, wrapped)


def _jax(script, argv, **kwargs):
    return run_example_main(os.path.join(ROOT, 'examples', script), argv,
                            **kwargs)


def _same(got, want):
    assert got['status'] == want['status']
    assert got['iterations'] == want['iterations']
    assert abs(got['obj_val'] - want['obj_val']) <= OBJ_TOL * abs(
        want['obj_val'])


@pytest.mark.parametrize('argv, cap', [
    (['--nodes', '301'], None),
    (['--nodes', '51', '--variable-duration'], MAX_ITER)],
    ids=['fixed', 'variable-duration'])
def test_swing_up(argv, cap, request):
    if cap:
        request.getfixturevalue('capped')
    (_, want), = _jax('pendulum_swing_up.py', argv,
                      options=cap and dict(max_iter=cap))
    sol, got = pendulum_swing_up.main(argv, device='cpu')
    _same(got, want)
    if not cap:
        assert got['status'] == 0
    assert sol.shape == want['x'].shape


def test_swing_up_batch(capped):
    argv = ['--nodes', '51', '--batch', '3']
    # the JAX script's report of the best converged objective fails
    # when no lane converged (np.min of an empty array); the port's
    # prints nan
    want, = _jax('pendulum_swing_up.py', argv,
                 options=dict(max_iter=MAX_ITER), errors=(ValueError,))
    got = pendulum_swing_up.main(argv, device='cpu')
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(want.status))
    np.testing.assert_array_equal(got.iterations.numpy(),
                                  np.asarray(want.iterations))
    np.testing.assert_allclose(got.obj_val.numpy(), np.asarray(want.obj_val),
                               rtol=OBJ_TOL, atol=0.0)


def test_nlink_reach():
    argv = ['--links', '2', '--nodes', '12']
    (_, want), = _jax('nlink_reach.py', argv)
    _, got = nlink_reach.main(argv, device='cpu')
    _same(got, want)


def test_card_is_the_default_device():
    """Without a card the examples raise, naming device='cpu'."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is usable')
    for main, argv in ((pendulum_swing_up.main, ['--nodes', '11']),
                       (nlink_reach.main, ['--links', '1', '--nodes', '5'])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(argv)
