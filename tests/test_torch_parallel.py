"""opty_tpu_torch's batch meshes (parallel/mesh.py) on the CPU: a batch
split over a mesh, padded to a multiple of its size, solves to the
unsharded ``solve_batch`` result (the JAX package's
tests/test_parallel.py asks the same of its 8-device mesh)."""

import numpy as np
import pytest
import torch

from opty_tpu_torch.models import spring_damper_problem
from opty_tpu_torch.parallel import (make_batch_mesh, shard_batch,
                                     solve_batch_sharded)


@pytest.fixture(scope='module')
def problem():
    return spring_damper_problem(num_nodes=21, device='cpu')


def test_sharded_batch_with_padding(problem):
    batch = np.random.default_rng(6).normal(size=(5, problem.num_free)) \
        * 0.1
    mesh = make_batch_mesh(['cpu'] * 3)              # pads 5 rows to 6
    res = solve_batch_sharded(problem, batch, mesh)
    ref = problem.solve_batch(batch)
    assert res.x.shape == (5, problem.num_free)
    assert res.status.shape == (5,)
    assert np.all(res.status.numpy() == 0)
    np.testing.assert_array_equal(res.status.numpy(), ref.status.numpy())
    np.testing.assert_allclose(res.x.numpy(), ref.x.numpy(), rtol=0,
                               atol=1e-12)


def test_shard_batch_splits_rows():
    mesh = make_batch_mesh(['cpu', 'cpu'])
    parts = shard_batch(np.arange(12.0).reshape(4, 3), mesh)
    assert [tuple(p.shape) for p in parts] == [(2, 3), (2, 3)]
    assert torch.equal(torch.cat(parts), torch.arange(12.0).reshape(4, 3)
                       .double())
    with pytest.raises(ValueError, match='does not split'):
        shard_batch(np.zeros((3, 2)), mesh)


def test_mesh_on_another_device_is_refused(problem):
    mesh = make_batch_mesh(['meta'])
    with pytest.raises(ValueError, match='build one a device'):
        solve_batch_sharded(problem, np.zeros((2, problem.num_free)), mesh)
