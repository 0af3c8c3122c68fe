"""tests/test_torch_gallery.py's checks on the seven gallery problems
with the largest equations of motion (LARGE there: their SymPy builds
and JAX compiles take most of the time): both packages'
``build_problem`` at a small size, compared in sizes and
classification, bounds, constraints and Jacobian values, objective and
gradient, the Hessian blocks and the documented start, on the CPU in
float64."""

import pytest

from test_torch_gallery import (  # noqa: F401  (collected here too)
    LARGE, make_pair, test_constraints_and_jacobian, test_documented_start,
    test_hessian_blocks, test_objective_and_gradient,
    test_sizes_and_classification)


@pytest.fixture(scope='module', params=LARGE)
def pair(request, tmp_path_factory):
    return make_pair(request.param, tmp_path_factory)
