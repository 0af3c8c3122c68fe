"""The plain versions of the batched small-matrix kernels
(opty_tpu_torch/ops/block_kernels.py) against opty_tpu's Pallas kernels
run in interpret mode, and the port's scan-path inverse
(ops/smallblock.py) against opty_tpu's, with the same numpy inputs on
both sides.  (The CUDA kernels themselves are held against these plain
versions on the card: tests/test_torch_cuda.py.)"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opty_tpu.ops import smallblock as jax_smallblock
from opty_tpu.ops.pallas_blocks import block_inv_pallas, block_matmul_pallas
from opty_tpu_torch.ops import block_kernels as bk
from opty_tpu_torch.ops import smallblock

INTERP = jax.default_backend() == 'cpu'


def _rel(got, want):
    """Max-norm error relative to the largest entry of ``want``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


def _matrices(shape, seed, shift=3.0):
    d = shape[-1]
    rng = np.random.default_rng(seed)
    return rng.normal(size=shape) + shift * np.eye(d)


@pytest.mark.parametrize('shape', [(7, 4, 4), (300, 5, 5), (3, 11, 6, 6)])
def test_inverse_plain_matches_pallas(shape):
    """float32, same pivot rule and select swaps; the two differ only
    in the order of the back substitution's small sums.  Diagonally
    dominant inputs keep the condition number, which scales that
    difference, small."""
    A = _matrices(shape, seed=sum(shape),
                  shift=2.0 * shape[-1]).astype(np.float32)
    want = block_inv_pallas(jnp.asarray(A), interpret=INTERP)
    got = bk.block_inv_plain(torch.as_tensor(A))
    assert got.dtype == torch.float32
    assert _rel(got, want) <= 1e-5


@pytest.mark.parametrize('shape', [(5, 3, 3), (200, 5, 5), (2, 9, 4, 4)])
def test_matmul_plain_matches_pallas(shape):
    rng = np.random.default_rng(sum(shape))
    A = rng.normal(size=shape).astype(np.float32)
    B = rng.normal(size=shape).astype(np.float32)
    want = block_matmul_pallas(jnp.asarray(A), jnp.asarray(B),
                               interpret=INTERP)
    got = bk.block_matmul_plain(torch.as_tensor(A), torch.as_tensor(B))
    assert _rel(got, want) <= 1e-6


def test_scan_inverse_matches_reference():
    """The gather-swap form against opty_tpu's CPU form in float64, a
    zero leading pivot included; both equal numpy's inverse."""
    A = _matrices((4, 9, 5, 5), seed=1, shift=1.0)
    A[0, 0] = np.eye(5)[[1, 0, 2, 3, 4]]          # zero leading pivot
    got = smallblock.block_inv(torch.as_tensor(A))
    want = jax_smallblock.block_inv(jnp.asarray(A))
    assert _rel(got, want) <= 1e-13
    assert _rel(got, np.linalg.inv(A)) <= 1e-12
    # the plain kernel version (select swaps) agrees on finite input
    assert _rel(bk.block_inv_plain(torch.as_tensor(A)), want) <= 1e-13


def test_singular_input_is_non_finite_on_both_sides():
    A = np.array([[[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]],
                  [[2.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 4.0]]])
    got = smallblock.block_inv(torch.as_tensor(A)).numpy()
    want = np.asarray(jax_smallblock.block_inv(jnp.asarray(A)))
    assert not np.all(np.isfinite(got[0]))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    assert _rel(got[1], want[1]) == 0.0


def test_cpu_wrappers_use_plain_versions():
    """On the CPU the wrappers run the plain versions, fill ``out`` and
    count no launch."""
    A = torch.as_tensor(_matrices((6, 5, 5), seed=2))
    B = torch.as_tensor(_matrices((6, 5, 5), seed=3))
    bk.reset_launch_counts()
    out = torch.empty_like(A)
    assert bk.block_inv(A, out=out) is out
    assert torch.equal(out, bk.block_inv_plain(A))
    assert torch.equal(bk.block_matmul(A, B), bk.block_matmul_plain(A, B))
    X = torch.empty_like(A)
    assert smallblock.block_inv(A, out=X) is X
    assert torch.equal(X, smallblock.block_inv(A))
    assert (bk.inv_launches, bk.matmul_launches) == (0, 0)
