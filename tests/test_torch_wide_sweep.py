"""The wide PCR downsweep's CPU-side pieces (opty_tpu_torch/ops/
pcr_kernels.py): the in-order reference ``pcr_downsweep_in_order``,
which forms csrc/wide.cu's sums in its order so that the card's result
can be held to it bitwise, against the plain version and against the
JAX package's Pallas downsweep in interpret mode; the wide kernel's own
launch plan (``launch_plan('wide_downsweep', ...)``) over the shapes
the route gate admits, with its shared-memory layout; and the narrow
kernel's plan at the pendulum's shapes, pinned."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from opty_tpu.ops import pallas_pcr
from opty_tpu_torch.ops import pcr_kernels as pk
from opty_tpu_torch.ops.tridiag import num_levels

F32, F64 = torch.float32, torch.float64
# the in-order sums against the plain version's torch reductions, max
# |diff| / max |ref| (chip_smoke.py:TOL_WIDE_SWEEP, the card's limit for
# the kernel against the plain version)
TOL_WIDE_SWEEP = {F64: 1e-11, F32: 1e-4}


def _levels(B, d, N, seed=0):
    """Stored levels and a right-hand side scaled like a diagonally
    dominant system's (the off-diagonal blocks by 1/d)."""
    rng = np.random.default_rng(seed)
    L = num_levels(N)
    return (rng.standard_normal((B, L, d, d, N)) / d,
            rng.standard_normal((B, L, d, d, N)) / d,
            rng.standard_normal((B, d, N)))


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    return np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-300)


@pytest.mark.parametrize('dtype', [F32, F64])
@pytest.mark.parametrize('d, N', [(50, 60), (9, 7)])
def test_in_order_matches_plain(d, N, dtype):
    A, B, r = (torch.as_tensor(x, dtype=dtype) for x in _levels(2, d, N))
    got = pk.pcr_downsweep_in_order(A, B, r)
    assert got.dtype == dtype and got.shape == r.shape
    assert _rel(got, pk.pcr_downsweep_plain(A, B, r)) <= TOL_WIDE_SWEEP[dtype]


@pytest.mark.parametrize('d, N', [(9, 7), (50, 12)])
def test_in_order_matches_pallas_downsweep(d, N):
    """float32, one instance, against opty_tpu's _downsweep_kernel run
    by the Pallas interpreter (pcr_downsweep_fused)."""
    A, B, r = (x[0] for x in _levels(1, d, N, seed=1))
    prev = pallas_pcr._INTERPRET
    pallas_pcr._INTERPRET = jax.default_backend() == 'cpu'
    try:
        want = pallas_pcr.pcr_downsweep_fused(
            *(jnp.asarray(x, jnp.float32) for x in (A, B, r)))
    finally:
        pallas_pcr._INTERPRET = prev
    got = pk.pcr_downsweep_in_order(
        *(torch.as_tensor(x[None], dtype=F32) for x in (A, B, r)))[0]
    assert _rel(got, want) <= TOL_WIDE_SWEEP[F32]


def test_in_order_keeps_nan():
    """A NaN in a stored level spreads along the levels' couplings as the
    kernel's sums spread it; a neighbour outside [0, N) is a zero
    multiplied in, so an infinite multiplier there gives NaN, as in the
    kernel."""
    A, B, r = (torch.as_tensor(x) for x in _levels(1, 9, 7, seed=2))
    A[0, 0, 2, 3, 4] = float('nan')
    got = pk.pcr_downsweep_in_order(A, B, r)
    plain = pk.pcr_downsweep_plain(A, B, r)
    assert torch.equal(torch.isnan(got), torch.isnan(plain))
    assert torch.isnan(got[0, 2, 4])
    A, B, r = (torch.as_tensor(x) for x in _levels(1, 9, 7, seed=2))
    A[0, 0, 1, 2, 0] = float('inf')            # node 0 has no k - 1
    assert torch.isnan(pk.pcr_downsweep_in_order(A, B, r)[0, 1, 0])


def _owned(plan, d, N):
    """[(rank, row, node)] of every (row, node) pair the plan gives the
    blocks of one instance."""
    C = plan.cluster
    pairs = []
    for q in range(C):
        if plan.stages:
            rows = range(q * d // C, (q + 1) * d // C)
            nodes = range(N)
        else:
            rows = range(d)
            nodes = range(q * plan.nodes_per_block,
                          min((q + 1) * plan.nodes_per_block, N))
        pairs += [(q, i, g) for i in rows for g in nodes]
    return pairs


def _check_wide_plan(plan, batch, d, N, dtype):
    """The invariants csrc/wide.cu's entry checks, and more: every pair
    owned once, no block without a row or node, the ring at least two
    units (or all a block has) beside r, all within a block's limits."""
    C = plan.cluster
    assert 1 <= C <= pk.MAX_CLUSTER and C & (C - 1) == 0
    assert plan.blocks == batch * C
    owned = _owned(plan, d, N)
    assert sorted((i, g) for _, i, g in owned) \
        == [(i, g) for i in range(d) for g in range(N)]
    assert {q for q, _, _ in owned} == set(range(C))
    assert plan.threads % 32 == 0
    assert 32 <= plan.threads <= pk.MAX_SWEEP_THREADS
    assert 0 < plan.smem_bytes <= pk.MAX_SMEM
    if plan.stages:
        rows = -(-d // C)
        assert C <= d and plan.rows_per_block == rows
        assert plan.nodes_per_block == N
        assert min(2, num_levels(N) * (d // C)) <= plan.stages <= 2 * rows
        assert plan.smem_bytes == pk.wide_sweep_smem(
            d, N, plan.stages, rows, dtype.itemsize)
        # a thread per (row, node) up to 992, and the producer's warp
        assert plan.threads - 32 == min(pk.MAX_SWEEP_THREADS - 32,
                                        -(-rows * N // 32) * 32)
    else:
        assert plan.rows_per_block == d
        assert plan.smem_bytes == 2 * d * plan.nodes_per_block \
            * dtype.itemsize


@pytest.mark.parametrize('d, N, dtype, stages', [
    # nlink-9's block: two levels of a block's four rows in float32,
    # three of the four in float64
    (50, 60, F32, 8), (50, 60, F64, 3),
    # two units beside r's two buffers fit up to N = 192 (float32) and
    # 96 (float64) at d = 50; beyond, zero stages
    (50, 126, F32, 3), (50, 192, F32, 2), (50, 193, F32, 0),
    (50, 96, F64, 2), (50, 97, F64, 0),
    # the gate's edges: r of 16 blocks filling their shared memory
    (50, 4640, F64, 0), (50, 9296, F32, 0), (64, 60, F64, 2),
    (64, 60, F32, 6), (1, 2, F64, 1), (1, 1, F32, 1), (2, 7, F32, 2),
    (9, 37, F64, 4), (7, 5, F32, 4), (12, 1000, F32, 0)])
def test_wide_plan_covers_the_gate(d, N, dtype, stages):
    """Every shape the route gate admits has a wide plan, staged or not,
    at 1, 8 and 32 instances."""
    assert pk.kernel_supported(d, 0, N, dtype)
    for batch in (1, 8, 32):
        plan = pk.launch_plan('wide_downsweep', batch, d, 0, N, dtype)
        _check_wide_plan(plan, batch, d, N, dtype)
        if batch == 1:
            assert plan.stages == stages


@pytest.mark.parametrize('d, N, stages, rows, itemsize, want', [
    (50, 60, 8, 4, 4, 216416), (50, 60, 3, 4, 8, 192192),
    (50, 60, 8, 25, 4, 216688), (1, 2, 1, 1, 8, 144), (9, 7, 4, 2, 4, 2848),
    (50, 37, 8, 4, 4, 134944)])
def test_wide_sweep_smem(d, N, stages, rows, itemsize, want):
    """csrc/wide.cu:SweepLayout's bytes: a full and an empty mbarrier
    for each of max(stages, rows) units, three more and a zero, r twice
    in rows padded to 16 bytes (N = 37 in float32: 38 values), and the
    units' two slabs, each at 16 bytes' slack."""
    assert pk.wide_sweep_smem(d, N, stages, rows, itemsize) == want


# the narrow downsweep's plan (csrc/pcr.cu) at phase 3's shapes of the
# pendulum's d = 5, as it was before the wide kernel had a plan of its
# own: (cluster, nodes_per_block, threads, smem_bytes, blocks, scratch)
# for float32 and float64
NARROW_PLANS = {
    (32, 501): ((8, 63, 320, 2520, 256, 0), (8, 63, 320, 5040, 256, 0)),
    (8, 501): ((8, 63, 320, 2520, 64, 0), (8, 63, 320, 5040, 64, 0)),
    (128, 501): ((4, 126, 640, 5040, 512, 0),
                 (4, 126, 640, 10080, 512, 0)),
    (32, 101): ((8, 13, 96, 520, 256, 0), (8, 13, 96, 1040, 256, 0)),
    (1, 4000): ((8, 500, 1024, 20000, 8, 0),
                (8, 500, 1024, 40000, 8, 0)),
    (200, 501): ((4, 126, 640, 5040, 800, 0),
                 (4, 126, 640, 10080, 800, 0))}


@pytest.mark.parametrize('batch, N', sorted(NARROW_PLANS))
def test_narrow_plan_is_unchanged(batch, N):
    for dtype, want in zip((F32, F64), NARROW_PLANS[batch, N]):
        plan = pk.launch_plan('downsweep', batch, 5, 0, N, dtype)
        assert isinstance(plan, pk.LaunchPlan)
        assert tuple(plan) == want
