"""opty_tpu_torch's spring-mass-damper model and plots against
opty_tpu's: spring_damper_problem(num_nodes=31) solved by both packages
from the same start (the same status and iterations, the solutions
within 1e-8), then each ``plot_*`` method drawn on the Agg backend, as
tests/test_plotting.py draws them, with the same axes and the same
plotted data as the JAX package's figures.
"""

import matplotlib

matplotlib.use('Agg')

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from opty_tpu.models import spring_damper_problem as jax_spring_damper  # noqa: E402,E501
from opty_tpu_torch.models import spring_damper_problem  # noqa: E402


@pytest.fixture(scope='module')
def solved():
    out = {}
    for name, build in (('jax', lambda: jax_spring_damper(num_nodes=31)),
                        ('torch', lambda: spring_damper_problem(
                            num_nodes=31, device='cpu'))):
        prob = build()
        np.random.seed(0)
        sol, info = prob.solve(np.random.randn(prob.num_free) * 0.1)
        out[name] = (prob, sol, info)
    return out


def lines(axes):
    """The (x, y) data of every line and the heights of every bar on
    ``axes``, in drawing order."""
    data = []
    for ax in np.atleast_1d(axes).ravel():
        for line in ax.get_lines():
            data.append(np.vstack([np.asarray(line.get_xdata(), float),
                                   np.asarray(line.get_ydata(), float)]))
        for patch in ax.patches:
            data.append(np.array([patch.get_height()]))
    return data


def same_figures(got, want, rtol=1e-8, atol=1e-10):
    assert len(np.atleast_1d(got).ravel()) == len(np.atleast_1d(want).ravel())
    dg, dw = lines(got), lines(want)
    assert len(dg) == len(dw)
    for g, w in zip(dg, dw):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    plt.close('all')


def test_spring_damper_solves(solved):
    (jprob, jsol, jinfo), (tprob, tsol, tinfo) = solved['jax'], \
        solved['torch']
    assert tinfo['status'] == jinfo['status'] == 0
    assert tinfo['iterations'] == jinfo['iterations']
    np.testing.assert_allclose(tsol, jsol, rtol=0, atol=1e-8)
    np.testing.assert_allclose(tinfo['obj_val'], jinfo['obj_val'],
                               rtol=1e-8)
    assert tprob.num_free == jprob.num_free


@pytest.mark.parametrize('show_bounds', [False, True])
def test_plot_trajectories(solved, show_bounds):
    axes = {k: p.plot_trajectories(s, show_bounds=show_bounds)
            for k, (p, s, _) in solved.items()}
    assert len(axes['torch']) == 3  # x, v, F
    same_figures(axes['torch'], axes['jax'])


@pytest.mark.parametrize('subplots, show_bounds', [
    (False, False), (True, False), (True, True)])
def test_plot_constraint_violations(solved, subplots, show_bounds):
    axes = {k: p.plot_constraint_violations(s, subplots=subplots,
                                            show_bounds=show_bounds)
            for k, (p, s, _) in solved.items()}
    M = solved['torch'][0].collocator.num_eom
    assert len(axes['torch']) == (M if subplots else 1) + 1
    same_figures(axes['torch'], axes['jax'], atol=1e-8)


def test_plot_objective_value(solved):
    axes = {k: p.plot_objective_value() for k, (p, _, _) in solved.items()}
    assert len(axes['torch'].get_lines()) == 1
    same_figures(axes['torch'], axes['jax'], rtol=1e-6)


def test_plot_jacobian_sparsity(solved):
    axes = {k: p.plot_jacobian_sparsity() for k, (p, _, _) in solved.items()}
    got = [im.get_array() for im in axes['torch'].get_images()] or \
        [np.vstack(ln.get_data()) for ln in axes['torch'].get_lines()]
    want = [im.get_array() for im in axes['jax'].get_images()] or \
        [np.vstack(ln.get_data()) for ln in axes['jax'].get_lines()]
    assert len(got) == len(want) == 1
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    plt.close('all')
