"""The CUDA kernels of opty_tpu_torch (csrc/pcr.cu, csrc/blocks.cu,
csrc/scan.cu, csrc/wide.cu, csrc/scan_wide.cu) against their plain
versions, on the card.  Marked ``cuda``; without a
card every test skips.  On a machine with one:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from opty_tpu_torch.ops import block_kernels as bk
from opty_tpu_torch.ops import pcr_kernels as pk
from opty_tpu_torch.ops import scan_kernels as sk
from opty_tpu_torch.ops import tridiag

pytestmark = pytest.mark.cuda

# (d, b, N, B).  The kernels split each instance's nodes over a cluster
# of blocks (pk.launch_plan), so neighbours k +- s cross block
# boundaries: besides the main path's shape, N not a multiple of the
# cluster, N below the cluster the batch alone would ask for, N = 2, and
# more clusters than the card holds at once.
SHAPES = [(5, 4, 501, 32), (3, 0, 40, 4), (5, 4, 37, 8), (5, 4, 3, 1),
          (5, 4, 2, 1), (3, 2, 101, 3), (5, 4, 501, 200)]
# same operation order on both sides (nvcc -fmad=false); float32 PCR
# amplifies roundoff across the levels (tests/test_pallas_pcr.py's
# tolerance for two float32 versions)
TOL = {torch.float64: 1e-9, torch.float32: 5e-2}


@pytest.fixture
def card():
    """Decided here, never at import, so every xdist worker collects the
    same tests."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


def _system(B, d, b, N, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, d, d, N)) + 4.0 * np.eye(d)[:, :, None]
    E = rng.standard_normal((B, d, d, N))
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((B, d, b, N))
    r = rng.standard_normal((B, d, N))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to(D), to(E), to(F), to(r)


def _rel(got, want):
    assert got.shape == want.shape
    if want.numel() == 0:          # the border arrays at b = 0
        return 0.0
    err = torch.max(torch.abs(got.double() - want.double())).item()
    return err / max(torch.max(torch.abs(want.double())).item(), 1e-300)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d,b,N,B', SHAPES)
def test_kernels_match_plain(card, d, b, N, B, dtype):
    D, E, F, r = _system(B, d, b, N, dtype, card)
    got = pk.pcr_factor_levels(D, E, F)
    want = pk.pcr_factor_levels_plain(D, E, F)
    assert got[0].shape == (B, tridiag.num_levels(N), d, d, N)
    for g, w in zip(got, want):
        assert g.device.type == 'cuda' and g.dtype == dtype
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= TOL[dtype]
    swept = pk.pcr_downsweep(got[0], got[1], r)
    assert _rel(swept, pk.pcr_downsweep_plain(got[0], got[1], r)) \
        <= TOL[dtype]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('nbatch,N', [(5, 200), (3, 37), (200, 501)])
def test_batched_equals_single(card, nbatch, N, dtype):
    """Each instance alone runs on another cluster size than in the
    batch (pk.launch_plan), with the same result."""
    D, E, F, r = _system(nbatch, 5, 4, N, dtype, card, seed=1)
    A, B, Dinv, Fp, Z = pk.pcr_factor_levels(D, E, F)
    swept = pk.pcr_downsweep(A, B, r)
    for i in (0, nbatch - 1):
        one = pk.pcr_factor_levels(D[i:i + 1], E[i:i + 1], F[i:i + 1])
        for g, w in zip((A, B, Dinv, Fp, Z), one):
            assert torch.equal(g[i:i + 1], w)
        assert torch.equal(swept[i:i + 1],
                           pk.pcr_downsweep(one[0], one[1], r[i:i + 1]))


def test_launch_counters_move(card):
    D, E, F, r = _system(2, 5, 4, 64, torch.float32, card)
    pk.reset_launch_counts()
    A, B, _, _, _ = pk.pcr_factor_levels(D, E, F)
    pk.pcr_downsweep(A, B, r)
    pk.pcr_downsweep(A, B, r)
    assert (pk.factor_launches, pk.downsweep_launches) == (1, 2)
    # the plain versions are not launches
    pk.pcr_factor_levels_plain(D, E, F)
    assert pk.factor_launches == 1


def test_one_launch_per_call_at_any_batch(card):
    """More clusters than the card holds at once still take one launch
    each, and the plan's grid covers the batch."""
    D, E, F, r = _system(200, 5, 4, 501, torch.float32, card)
    plan = pk.launch_plan('factor', 200, 5, 4, 501, torch.float32)
    assert plan.blocks == 200 * plan.cluster > 132
    pk.reset_launch_counts()
    A, B, _, _, _ = pk.pcr_factor_levels(D, E, F)
    pk.pcr_downsweep(A, B, r)
    torch.cuda.synchronize()
    assert (pk.factor_launches, pk.downsweep_launches) == (1, 1)


# Instances beyond one cluster's shared memory: the factor's state in
# its global scratch (d = 5, b = 4 from N = 3,873 in float32 and
# N = 1,937 in float64; d = 3, b = 2 from N = 11,057), and the
# downsweep's threads looping over more (node, row) pairs than a block
# has threads; and the largest float32 factor whose state a cluster of
# 16 blocks holds in shared memory.
LARGE = [(5, 4, 4000, 2, torch.float32), (5, 4, 2900, 2, torch.float64),
         (3, 2, 12000, 1, torch.float32), (5, 4, 3872, 1, torch.float32)]


@pytest.mark.parametrize('d,b,N,B,dtype', LARGE)
def test_large_instances_match_plain(card, d, b, N, B, dtype):
    D, E, F, r = _system(B, d, b, N, dtype, card)
    got = pk.pcr_factor_levels(D, E, F)
    want = pk.pcr_factor_levels_plain(D, E, F)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert torch.equal(g, w)
    swept = pk.pcr_downsweep(got[0], got[1], r)
    assert _rel(swept, pk.pcr_downsweep_plain(got[0], got[1], r)) \
        <= TOL[dtype]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_downsweep_at_its_reach(card, dtype):
    """r filling the shared memory of a cluster of 16 blocks (d = 5),
    through levels made from a seed."""
    N = pk.MAX_CLUSTER * (pk.MAX_SMEM // (2 * 5 * dtype.itemsize))
    plan = pk.launch_plan('downsweep', 1, 5, 0, N, dtype)
    assert plan.cluster == pk.MAX_CLUSTER
    L = tridiag.num_levels(N)
    gen = torch.Generator(device=card).manual_seed(3)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=card,
                                      dtype=dtype)
    A, B = 0.05 * draw(1, L, 5, 5, N), 0.05 * draw(1, L, 5, 5, N)
    r = draw(1, 5, N)
    assert _rel(pk.pcr_downsweep(A, B, r), pk.pcr_downsweep_plain(A, B, r)) \
        <= TOL[dtype]


def test_refused_launch_raises(card):
    """A launch that CUDA refuses (more dynamic shared memory than a
    block may have) is returned by the C entry, raised by the launch,
    and leaves nothing for the next launch to report.  A plan that
    would leave a node unowned or asks for a cluster above 16 blocks is
    refused by the C entry itself, before any launch."""
    from opty_tpu_torch.ops.cuda_build import launch, load
    D, E, F, r = _system(1, 5, 4, 2, torch.float32, card)
    A, B, _, _, _ = pk.pcr_factor_levels(D, E, F)
    fn = load('pcr', pk._SIGNATURES).pcr_downsweep_f32
    out = torch.empty_like(r)
    args = (A.data_ptr(), B.data_ptr(), r.data_ptr(), out.data_ptr(), 1, 5,
            2, 1)
    for cluster, npb, threads, smem in ((1, 2, 32, 300 * 1024),
                                        (1, 1, 32, 1024),
                                        (32, 1, 32, 1024)):
        with pytest.raises(RuntimeError, match='cudaError'):
            launch('pcr_downsweep', fn, args + (cluster, npb, threads, smem),
                   card)
    torch.cuda.synchronize()
    assert _rel(pk.pcr_downsweep(A, B, r), pk.pcr_downsweep_plain(A, B, r)) \
        <= TOL[torch.float32]


def test_wrapper_refuses_what_the_build_lacks(card):
    D, E, F, _ = _system(1, 65, 2, 16, torch.float32, card)
    with pytest.raises(ValueError, match='not built'):
        pk.pcr_factor_levels(D, E, F)
    D, E, F, _ = _system(1, 5, 65, 16, torch.float32, card)
    with pytest.raises(ValueError, match='border'):
        pk.pcr_factor_levels(D, E, F)
    D, E, F, _ = _system(1, 5, 2, 16, torch.float16, card)
    with pytest.raises(ValueError):
        pk.pcr_factor_levels(D, E, F)
    D, E, F, _ = _system(1, 5, 2, 16, torch.float32, card)
    with pytest.raises(ValueError, match='contiguous'):
        pk.pcr_factor_levels(D.transpose(1, 2), E, F)


# ---------------------------------------------------------------------------
# the wide variants (csrc/wide.cu): d and b outside the register kernels
# ---------------------------------------------------------------------------

# (d, b, N, B): nlink-9's class, the gallery's small d, b = 1, the
# largest block and border, a border wider than the block, N = 1
WIDE_SHAPES = [(50, 41, 60, 8), (4, 2, 37, 3), (2, 1, 16, 2), (7, 9, 5, 1),
               (64, 64, 20, 2), (3, 12, 9, 2), (6, 0, 1, 1)]
# the factor and the inverse sum in another order than their plain
# versions (FP64 tensor cores, fused multiply-adds, the inverse's
# elimination and back substitution blocked in panels), and
# the downsweep by torch's reduction order in matvec_nl: round-off
# apart, amplified through the levels in float32
WIDE_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}


def _wide_system(B, d, b, N, dtype, device, seed=0):
    """A diagonally dominant system, so that the levels stay well
    conditioned at every d."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, d, d, N)) + 2.0 * d * np.eye(d)[:, :, None]
    E = rng.standard_normal((B, d, d, N)) / d
    E[..., 0] = 0.0
    F = 0.1 * rng.standard_normal((B, d, b, N))
    r = rng.standard_normal((B, d, N))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to(D), to(E), to(F), to(r)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d, b, N, B', WIDE_SHAPES)
def test_wide_kernels_match_plain(card, d, b, N, B, dtype):
    D, E, F, r = _wide_system(B, d, b, N, dtype, card)
    pk.reset_launch_counts()
    got = pk.pcr_factor_levels(D, E, F)
    assert (pk.factor_launches, pk.wide_factor_launches) == (0, 1)
    want = pk.pcr_factor_levels_plain(D, E, F)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= WIDE_TOL[dtype]
    A, Bm = got[0], got[1]
    out = pk.pcr_downsweep(A, Bm, r)
    # the downsweep takes no border: d = 3 and 5 keep the narrow kernel
    narrow = d in pk.SUPPORTED_D
    assert (pk.downsweep_launches, pk.wide_downsweep_launches) == \
        ((1, 0) if narrow else (0, 1))
    assert _rel(out, pk.pcr_downsweep_plain(A, Bm, r)) <= WIDE_TOL[dtype]


# the wide downsweep (csrc/wide.cu) against pcr_downsweep_in_order, its
# sums in the kernel's order: bitwise.  (d, N, B, dtype): nlink-9's block
# at 1, 8 and 32 lanes (clusters of 16, 8 and 2), the smallest and
# largest blocks, an odd N, in both dtypes, and the route gate's edge in
# each, where the plan takes zero stages
WIDE_SWEEP_CASES = [(d, N, B, dtype) for dtype in (torch.float32,
                                                   torch.float64)
                    for d, N, B in ((50, 60, 1), (50, 60, 8), (50, 60, 32),
                                    (1, 60, 1), (9, 60, 1), (64, 60, 1),
                                    (50, 37, 1), (9, 7, 3))] \
    + [(50, 9296, 1, torch.float32), (50, 4640, 1, torch.float64)]


def _same_bits(got, want):
    """The same bits (the sign of a zero included), NaN in the same
    places."""
    nan = torch.isnan(got)
    bits = torch.int64 if got.element_size() == 8 else torch.int32
    return bool(torch.equal(nan, torch.isnan(want))
                and torch.equal(torch.where(nan, 0, got).view(bits),
                                torch.where(nan, 0, want).view(bits)))


def _sweep_levels(B, d, N, dtype, device, seed=0):
    """Stored levels scaled as a diagonally dominant system's, drawn on
    the card from a seed."""
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = lambda *shape: torch.randn(*shape, generator=gen, device=device,
                                      dtype=dtype)
    L = tridiag.num_levels(N)
    return draw(B, L, d, d, N) / d, draw(B, L, d, d, N) / d, draw(B, d, N)


@pytest.mark.parametrize('d, N, B, dtype', WIDE_SWEEP_CASES)
def test_wide_downsweep_bitwise_in_order(card, d, N, B, dtype):
    """Both branches of the wide downsweep (the plan's; zero stages on
    the narrow kernel's node split) give pcr_downsweep_in_order's bits,
    and agree with the plain version to WIDE_TOL."""
    assert pk.kernel_supported(d, 0, N, dtype)
    A, Bm, r = _sweep_levels(B, d, N, dtype, card)
    plan = pk.launch_plan('wide_downsweep', B, d, 0, N, dtype)
    assert (plan.stages == 0) == (N > 1000)
    pk.reset_launch_counts()
    got = pk.pcr_downsweep(A, Bm, r)
    zero = pk.launch_wide_downsweep(A, Bm, r,
                                    pk.wide_direct_plan(B, d, N, dtype))
    assert (pk.wide_downsweep_launches, pk.downsweep_launches) == (2, 0)
    assert pk.wide_downsweep_direct_launches == (1 if plan.stages else 2)
    want = pk.pcr_downsweep_in_order(A, Bm, r)
    assert _same_bits(got, want) and _same_bits(zero, want)
    assert _rel(got, pk.pcr_downsweep_plain(A, Bm, r)) <= WIDE_TOL[dtype]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_downsweep_every_cluster_size(card, dtype):
    """The staged branch on clusters of 1 to 16 blocks at nlink-9's
    block, one and three lanes: the same bits at every size."""
    for B in (1, 3):
        A, Bm, r = _sweep_levels(B, 50, 60, dtype, card, seed=B)
        want = pk.pcr_downsweep_in_order(A, Bm, r)
        for C in (1, 2, 4, 8, 16):
            plan = pk.wide_staged_plan(B, 50, 60, dtype, C)
            assert plan is not None and plan.stages >= 2
            assert _same_bits(pk.launch_wide_downsweep(A, Bm, r, plan), want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_wide_downsweep_keeps_nan(card, dtype):
    """A NaN in one lane's levels, and an infinite multiplier against a
    neighbour outside [0, N), give NaN where the in-order sums do, and
    only in their lanes."""
    A, Bm, r = _sweep_levels(4, 50, 60, dtype, card, seed=5)
    A[2, 1, 3, 4, 10] = float('nan')
    Bm[1, 0, 0, 0, 59] = float('inf')
    got = pk.pcr_downsweep(A, Bm, r)
    assert _same_bits(got, pk.pcr_downsweep_in_order(A, Bm, r))
    assert torch.isnan(got[2]).any() and torch.isnan(got[1]).any()
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[3]).all()


def test_wide_downsweep_refuses_a_bad_plan(card):
    """The C entry refuses, before any launch, a staged plan on a
    cluster wider than the rows, or with too little shared memory; the
    wrapper raises."""
    A, Bm, r = _sweep_levels(1, 9, 60, torch.float32, card)
    good = pk.wide_staged_plan(1, 9, 60, torch.float32, 8)
    for bad in (good._replace(cluster=16, blocks=16),
                good._replace(smem_bytes=good.smem_bytes - 16),
                good._replace(threads=32)):
        with pytest.raises(RuntimeError, match='cudaError'):
            pk.launch_wide_downsweep(A, Bm, r, bad)
    torch.cuda.synchronize()
    assert _same_bits(pk.launch_wide_downsweep(A, Bm, r, good),
                      pk.pcr_downsweep_in_order(A, Bm, r))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d', [1, 9, 41, 64])
def test_wide_block_inv_matches_plain(card, d, dtype):
    for B in (1, 8, 32):
        A = _matrices(B, d, dtype, card, seed=B)
        bk.reset_launch_counts()
        X = bk.block_inv(A)
        assert (bk.inv_launches, bk.wide_inv_launches) == (0, 1)
        assert torch.isfinite(X).all()
        assert _rel(X, bk.block_inv_plain(A)) <= WIDE_TOL[dtype]


def test_graph_capture_runs_without_garbage_collection(card):
    """The derivative passes' graphs are captured with the cyclic
    collector off (a dead graph destroyed inside a capture invalidates
    it) and turned back on after; the warm-up call runs with it on."""
    import gc
    from opty_tpu_torch.nlp.collocation import _graphed
    seen = []

    def fn(a):
        seen.append(gc.isenabled())
        return a + 1.0

    x = torch.arange(8.0, device=card)
    graphed = _graphed(fn)
    assert torch.equal(graphed(x), x + 1.0)
    assert torch.equal(graphed(2.0 * x), 2.0 * x + 1.0)
    assert seen == [True, False] and gc.isenabled()


def test_card_raises_beyond_the_kernels(card):
    """A system no kernel takes raises with its shape on the card, in
    the cr path (a border above 64) and in the scan path (d above 64):
    nothing falls back to the plain versions there.  d = b = 64 in
    float64, beyond one block's shared memory, runs on a cluster of two
    (the factor's chain and the products off it apart)."""
    D, E, F, r = _wide_system(1, 4, 65, 8, torch.float64, card)
    Kbb = torch.eye(65, dtype=torch.float64, device=card)[None] * 10.0
    pk.reset_launch_counts()
    with pytest.raises(ValueError, match='b=65'):
        tridiag.pcr_factor(D, E, F, Kbb)
    assert pk.wide_factor_launches == pk.factor_launches == 0
    Ds = torch.eye(65, dtype=torch.float64, device=card).expand(
        1, 8, 65, 65).contiguous()
    with pytest.raises(ValueError, match='d=65'):
        sk.scan_factor(Ds, torch.zeros_like(Ds),
                       torch.zeros(1, 8, 65, 0, dtype=torch.float64,
                                   device=card),
                       torch.zeros(1, 0, 0, dtype=torch.float64,
                                   device=card))
    D, E, F, Kbb, r, rb = _scan_system(1, 4, 64, 64, torch.float64, card)
    sk.reset_launch_counts()
    assert sk.cluster_size(1, 64, 64, torch.float64)[0] == 2
    assert sk.cluster_size(100, 64, 64, torch.float64)[0] == 2
    for g, w in zip(sk.scan_factor(D, E, F, Kbb),
                    sk.scan_factor_plain(D, E, F, Kbb)):
        assert _rel(g, w) <= SCAN_TOL[torch.float64]
    assert (sk.wide_factor_launches, sk.factor_launches) == (1, 0)


# ---------------------------------------------------------------------------
# batched small-matrix kernels (csrc/blocks.cu)
# ---------------------------------------------------------------------------

# same operation order on both sides (nvcc -fmad=false): 0 expected on
# finite inputs; the stated bounds absorb any order difference
BLOCK_TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
BATCHES = (1, 7, 32, 16032)


def _matrices(B, d, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((B, d, d)) + 2.0 * d * np.eye(d)
    return torch.as_tensor(A, dtype=dtype, device=device)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d', bk.SUPPORTED_D)
def test_block_kernels_match_plain(card, d, dtype):
    for B in BATCHES:
        A = _matrices(B, d, dtype, card, seed=B)
        Bm = _matrices(B, d, dtype, card, seed=B + 1)
        X = bk.block_inv(A)
        C = bk.block_matmul(A, Bm)
        for got, want in ((X, bk.block_inv_plain(A)),
                          (C, bk.block_matmul_plain(A, Bm))):
            assert got.device.type == 'cuda' and got.dtype == dtype
            assert torch.isfinite(got).all()
            assert _rel(got, want) <= BLOCK_TOL[dtype], B
        # a thread per output entry keeps the plain version's ordered sum
        assert torch.equal(C, bk.block_matmul_plain(A, Bm)), B


def test_block_kernels_batch_shapes_and_out(card):
    A = _matrices(3 * 11, 6, torch.float64, card).reshape(3, 11, 6, 6)
    out = torch.empty_like(A)
    assert bk.block_inv(A, out=out) is out
    assert _rel(out, bk.block_inv_plain(A)) <= BLOCK_TOL[torch.float64]
    C = bk.block_matmul(A, out)
    eye = torch.eye(6, dtype=A.dtype, device=card).expand_as(C)
    assert _rel(C, eye) <= 1e-12


def test_block_inv_zero_leading_pivot(card):
    A = torch.tensor([[[0.0, 1.0], [1.0, 0.0]], [[2.0, 1.0], [1.0, 2.0]]],
                     dtype=torch.float64, device=card)
    want = torch.linalg.inv(A.cpu())
    assert _rel(bk.block_inv(A).cpu(), want) <= 1e-15


def test_block_inv_singular_batch(card):
    """Singular matrices among regular ones: the kernel's output is
    non-finite wherever the plain version's is, and equal elsewhere."""
    A = _matrices(6, 3, torch.float64, card, seed=4)
    A[1] = torch.tensor([[1.0, 2.0, 3.0], [2.0, 4.0, 6.0], [1.0, 0.0, 1.0]])
    A[3] = 0.0
    A[4, :, 1] = 0.0
    got = bk.block_inv(A)
    want = bk.block_inv_plain(A)
    bad = ~torch.isfinite(want)
    assert bad[1].any() and bad[3].any() and bad[4].any()
    assert (~torch.isfinite(got))[bad].all()
    both = torch.isfinite(got) & ~bad
    assert torch.equal(got[both], want[both])
    assert torch.isfinite(got[[0, 2, 5]]).all()


def test_block_wrappers_refuse_bad_input(card):
    A = _matrices(4, 5, torch.float32, card)
    with pytest.raises(ValueError, match='not built'):
        bk.block_inv(_matrices(4, 65, torch.float32, card))
    with pytest.raises(ValueError, match='not built'):
        bk.block_matmul(_matrices(4, 1, torch.float64, card),
                        _matrices(4, 1, torch.float64, card))
    with pytest.raises(ValueError):
        bk.block_inv(A.half())
    with pytest.raises(ValueError, match='share one device'):
        bk.block_matmul(A, A.double())
    with pytest.raises(ValueError, match='share one device'):
        bk.block_matmul(A, A.cpu())
    with pytest.raises(ValueError, match='expected shape'):
        bk.block_matmul(A, A[:2])
    with pytest.raises(ValueError, match=r'\(\.\.\., d, d\)'):
        bk.block_inv(A[..., :4])
    with pytest.raises(ValueError, match='contiguous'):
        bk.block_inv(A.transpose(-1, -2))
    with pytest.raises(ValueError, match='contiguous'):
        bk.block_inv(A, out=torch.empty_like(A).transpose(-1, -2))


def test_block_launch_counters_move(card):
    A = _matrices(8, 5, torch.float64, card)
    bk.reset_launch_counts()
    bk.block_inv(A)
    bk.block_matmul(A, A)
    bk.block_matmul(A, A)
    assert (bk.inv_launches, bk.matmul_launches) == (1, 2)
    bk.block_inv_plain(A)
    bk.block_matmul_plain(A, A)
    assert (bk.inv_launches, bk.matmul_launches) == (1, 2)


def test_empty_launch(card):
    bk.reset_launch_counts()
    bk.empty_launch(card)
    torch.cuda.synchronize()
    assert (bk.inv_launches, bk.matmul_launches) == (0, 0)


# ---------------------------------------------------------------------------
# scan factorization and solve kernels (csrc/scan.cu)
# ---------------------------------------------------------------------------

# the kernel inverts by Gauss-Jordan, the plain version by elimination
# and back substitution, and the plain solve's products go through
# cuBLAS: round-off apart, on systems whose pivots stay well conditioned
SCAN_TOL = {torch.float64: 1e-11, torch.float32: 1e-4}
SCAN_NB = [(N, B) for N in (1, 2, 3, 101, 501) for B in (1, 8, 32, 200)]
SCAN_DB = [(d, b) for d in (2, 5, 8) for b in (0, 4, 8)]


def _scan_system(B, N, d, b, dtype, device, seed=0):
    """chip_smoke.py's scan_system: D = 4 I plus noise, E of norm about
    1 / 2, F = 0.1 noise, Kbb about -4 I, and a right-hand side."""
    rng = np.random.default_rng(seed)
    s = 0.5 / np.sqrt(d)
    D = s * rng.standard_normal((B, N, d, d)) + 4.0 * np.eye(d)
    E = s * rng.standard_normal((B, N, d, d))
    E[:, 0] = 0.0
    F = 0.1 * rng.standard_normal((B, N, d, b))
    Kbb = 0.5 / np.sqrt(max(b, 1)) * rng.standard_normal((B, b, b)) \
        - 4.0 * np.eye(b)
    r = rng.standard_normal((B, N, d))
    rb = rng.standard_normal((B, b))
    to = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return to(D), to(E), to(F), to(Kbb), to(r), to(rb)


def _check_scan(B, N, d, b, dtype, card):
    D, E, F, Kbb, r, rb = _scan_system(B, N, d, b, dtype, card)
    fac = sk.scan_factor(D, E, F, Kbb)
    for g, w in zip(fac, sk.scan_factor_plain(D, E, F, Kbb)):
        assert g.device.type == 'cuda' and g.dtype == dtype
        assert g.is_contiguous() and torch.isfinite(g).all()
        assert _rel(g, w) <= SCAN_TOL[dtype]
    got = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
    want = sk.scan_solve_plain(*fac[:3], E, fac[3], r, rb)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        assert _rel(g, w) <= SCAN_TOL[dtype]


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('N,B', SCAN_NB)
def test_scan_kernels_match_plain(card, N, B, dtype):
    _check_scan(B, N, 5, 4, dtype, card)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('d,b', SCAN_DB)
def test_scan_kernels_block_sizes(card, d, b, dtype):
    _check_scan(8, 37, d, b, dtype, card)


@pytest.mark.parametrize('b', [0, 4])
def test_scan_factorizations_interchange(card, b):
    """A kernel factorization solved by the plain solve, and a plain
    factorization (made contiguous) solved by the kernel."""
    dtype = torch.float64
    D, E, F, Kbb, r, rb = _scan_system(8, 101, 5, b, dtype, card, seed=2)
    kfac = sk.scan_factor(D, E, F, Kbb)
    pfac = [a.contiguous() for a in sk.scan_factor_plain(D, E, F, Kbb)]
    want = sk.scan_solve_plain(*pfac[:3], E, pfac[3], r, rb)
    for got in (sk.scan_solve_plain(*kfac[:3], E, kfac[3], r, rb),
                sk.scan_solve(*pfac[:3], E, pfac[3], r, rb)):
        for g, w in zip(got, want):
            assert _rel(g, w) <= SCAN_TOL[dtype]


def test_scan_singular_lane(card):
    """A singular pivot makes its lane's outputs non-finite from that
    node on, as in the plain version, and leaves the other lanes
    equal to their plain versions."""
    dtype = torch.float64
    D, E, F, Kbb, r, rb = _scan_system(4, 30, 5, 4, dtype, card, seed=3)
    D[2, 10] = 0.0
    E[2, 10] = 0.0               # S_10 = D_10 = 0 in lane 2
    fac = sk.scan_factor(D, E, F, Kbb)
    want = sk.scan_factor_plain(D, E, F, Kbb)
    assert not torch.isfinite(want[0][2, 10]).all()
    assert not torch.isfinite(fac[0][2, 10]).all()
    assert not torch.isfinite(fac[3][2]).all()
    good = [0, 1, 3]
    for g, w in zip(fac, want):
        assert torch.isfinite(g[good]).all()
        assert _rel(g[good], w[good]) <= SCAN_TOL[dtype]
    u, beta = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
    assert not torch.isfinite(u[2]).all()
    assert torch.isfinite(u[good]).all() and torch.isfinite(beta[good]).all()


def test_scan_one_launch_per_call(card):
    D, E, F, Kbb, r, rb = _scan_system(200, 501, 5, 4, torch.float64, card)
    sk.reset_launch_counts()
    fac = sk.scan_factor(D, E, F, Kbb)
    sk.scan_solve(*fac[:3], E, fac[3], r, rb)
    sk.scan_solve(*fac[:3], E, fac[3], r, rb)
    torch.cuda.synchronize()
    assert (sk.factor_launches, sk.solve_launches) == (1, 2)
    sk.scan_factor_plain(D, E, F, Kbb)          # not a launch
    assert sk.factor_launches == 1


def test_scan_wrappers_refuse_bad_input(card):
    D, E, F, Kbb, r, rb = _scan_system(2, 8, 5, 4, torch.float32, card)
    with pytest.raises(ValueError, match='not built'):
        sk.scan_factor(*_scan_system(2, 8, 65, 4, torch.float32, card)[:4])
    with pytest.raises(ValueError, match='border'):
        sk.scan_factor(*_scan_system(2, 8, 5, 65, torch.float32, card)[:4])
    with pytest.raises(ValueError, match='share one device'):
        sk.scan_factor(D, E.double(), F, Kbb)
    with pytest.raises(ValueError, match='share one device'):
        sk.scan_factor(D, E, F.cpu(), Kbb)
    with pytest.raises(ValueError, match='contiguous'):
        sk.scan_factor(D, E.transpose(-1, -2), F, Kbb)
    with pytest.raises(ValueError):
        sk.scan_factor(D.half(), E.half(), F.half(), Kbb.half())
    fac = sk.scan_factor(D, E, F, Kbb)
    with pytest.raises(ValueError, match='contiguous'):
        sk.scan_solve(*fac[:3], E, fac[3], r.transpose(0, 1).contiguous()
                      .transpose(0, 1), rb)
    with pytest.raises(ValueError, match='expected shape'):
        sk.scan_solve(*fac[:3], E, fac[3], r[:, :4], rb)


def test_scan_refused_launch_raises(card):
    """The C entry refuses what it was not built for (here d = 9) and
    returns the error, which the launch raises; the next launch runs."""
    from opty_tpu_torch.ops.cuda_build import launch, load
    D, E, F, Kbb, r, rb = _scan_system(2, 8, 5, 4, torch.float32, card)
    out = [torch.empty_like(a) for a in (D, D, F, Kbb)]
    fn = load('scan', sk._SIGNATURES).scan_factor_f32
    args = tuple(a.data_ptr() for a in (D, E, F, Kbb, *out))
    for d, N, nb in ((9, 8, 4), (5, 0, 4), (5, 8, 9)):
        with pytest.raises(RuntimeError, match='cudaError'):
            launch('scan_factor', fn, args + (2, d, N, nb), card)
    fac = sk.scan_factor(D, E, F, Kbb)
    torch.cuda.synchronize()
    assert _rel(fac[0], sk.scan_factor_plain(D, E, F, Kbb)[0]) \
        <= SCAN_TOL[torch.float32]


def test_scan_solve_on_card_equals_cpu(card):
    """A scan solve through the scan kernels on the card against the
    same solve through the plain versions on the CPU."""
    from opty_tpu_torch.models import swing_up_problem
    out = {}
    for dev in ('cuda', 'cpu'):
        prob = swing_up_problem(num_nodes=11, torque_bound=20.0, device=dev)
        prob.set_solver_options(kkt_method='scan', factor_dtype=torch.float64,
                                mu_strategy='monotone', use_soc=False,
                                max_iter=40)
        x0 = np.random.default_rng(29).normal(size=prob.num_free)
        bk.reset_launch_counts()
        sk.reset_launch_counts()
        out[dev] = prob.solve(x0)[1]
        if dev == 'cuda':
            assert sk.factor_launches > 0 and sk.solve_launches > 0
            assert (bk.inv_launches, bk.matmul_launches) == (0, 0)
    got, want = out['cuda'], out['cpu']
    assert got['status'] == want['status']
    assert got['iterations'] == want['iterations']
    assert abs(got['obj_val'] - want['obj_val']) \
        <= 1e-10 * abs(want['obj_val'])


def test_default_solve_with_restoration_on_card_equals_cpu(card):
    """A solve with the library's default options (adaptive mu, the
    second-order correction, restoration) from a start that enters
    restoration (chip_smoke.py's phase 4c), through the PCR and block
    kernels on the card, against the same solve through the plain
    versions on the CPU."""
    from opty_tpu_torch.models import swing_up_problem
    out = {}
    for dev in ('cuda', 'cpu'):
        prob = swing_up_problem(num_nodes=101, torque_bound=20.0, device=dev)
        prob.set_solver_options(kkt_method='cr', factor_dtype=torch.float64)
        x0 = np.random.default_rng(57).normal(size=prob.num_free)
        pk.reset_launch_counts()
        bk.reset_launch_counts()
        out[dev] = prob.solve(x0)[1]
        if dev == 'cuda':
            assert pk.factor_launches > 0 and pk.downsweep_launches > 0
            assert bk.inv_launches > 0
    got, want = out['cuda'], out['cpu']
    assert got['rest_iterations'] > 0 and want['rest_iterations'] > 0
    assert got['status'] == want['status']
    assert want['status'] in (0, 1)
    assert abs(got['iterations'] - want['iterations']) <= 2
    assert abs(got['obj_val'] - want['obj_val']) \
        <= 1e-6 * abs(want['obj_val'])


# ---------------------------------------------------------------------------
# wide scan factorization and solve kernels (csrc/scan_wide.cu)
# ---------------------------------------------------------------------------

def _wide_scan_blocks(dtype):
    """chip_smoke.py's phase 3ws blocks: nlink-9's d = 50, b = 41, the
    smallest wide block d = 9 without a border, and d = 64 with the
    widest border the shared memory takes (64 in both dtypes: in
    float64 on a cluster of two)."""
    b64 = max(b for b in range(65) if sk.kernel_supported(64, b, 60, dtype))
    return [(50, 41), (9, 0), (64, b64)]


def _wide_scan_clusters(d, b, dtype):
    """The cluster sizes each wide scan kernel is built for that the
    shared memory takes at (d, b)."""
    return ([c for c in sk.FACTOR_CLUSTERS
             if max(sk.wide_smem(d, b, dtype.itemsize, c)) <= sk.MAX_SMEM],
            list(sk.SOLVE_CLUSTERS))


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('B', [1, 8, 32])
def test_wide_scan_kernels_match_plain(card, B, dtype):
    """Through the wrappers (cluster_size's choice), then at every
    cluster size the build takes at the shape."""
    for d, b in _wide_scan_blocks(dtype):
        D, E, F, Kbb, r, rb = _scan_system(B, 60, d, b, dtype, card)
        sk.reset_launch_counts()
        fac = sk.scan_factor(D, E, F, Kbb)
        got = sk.scan_solve(*fac[:3], E, fac[3], r, rb)
        assert (sk.factor_launches, sk.solve_launches,
                sk.wide_factor_launches, sk.wide_solve_launches) == \
            (0, 0, 1, 1)
        want = sk.scan_factor_plain(D, E, F, Kbb)
        for g, w in zip(fac, want):
            assert g.is_contiguous() and torch.isfinite(g).all()
            assert _rel(g, w) <= SCAN_TOL[dtype], (d, b)
        want_sol = sk.scan_solve_plain(*fac[:3], E, fac[3], r, rb)
        for g, w in zip(got, want_sol):
            assert torch.isfinite(g).all()
            assert _rel(g, w) <= SCAN_TOL[dtype], (d, b)
        factors, solves = _wide_scan_clusters(d, b, dtype)
        for c in factors:
            for g, w in zip(sk.launch_wide_factor(D, E, F, Kbb, c), want):
                assert torch.isfinite(g).all()
                assert _rel(g, w) <= SCAN_TOL[dtype], (d, b, c)
        for c in solves:
            for g, w in zip(sk.launch_wide_solve(*fac[:3], E, fac[3], r, rb,
                                                 c), want_sol):
                assert torch.isfinite(g).all()
                assert _rel(g, w) <= SCAN_TOL[dtype], (d, b, c)


@pytest.mark.parametrize('N', [1, 2, 5, 9])
def test_wide_scan_clusters_beyond_the_nodes(card, N):
    """A solve cluster of more blocks than nodes (blocks without a node
    take part in its barriers only), and the factor's cluster of two at
    N = 1 (the off-chain block's only node after the chain's last)."""
    D, E, F, Kbb, r, rb = _scan_system(3, N, 50, 41, torch.float64, card)
    want = [a.contiguous() for a in sk.scan_factor_plain(D, E, F, Kbb)]
    for c in sk.FACTOR_CLUSTERS:
        for g, w in zip(sk.launch_wide_factor(D, E, F, Kbb, c), want):
            assert _rel(g, w) <= SCAN_TOL[torch.float64], c
    want_sol = sk.scan_solve_plain(*want[:3], E, want[3], r, rb)
    for c in sk.SOLVE_CLUSTERS:
        got = sk.launch_wide_solve(*want[:3], E, want[3], r, rb, c)
        for g, w in zip(got, want_sol):
            assert _rel(g, w) <= SCAN_TOL[torch.float64], c


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('cluster', [1, 2, 4, 8])
@pytest.mark.parametrize('d,b', [(50, 41), (50, 48), (50, 49), (64, 16),
                                 (64, 17), (64, 64), (9, 0), (1, 3)])
def test_wide_scan_shared_memory_matches_the_kernel(card, d, b, cluster,
                                                     dtype):
    """wide_smem, the pure sizing rule that kernel_supported and
    cluster_size read, is the bytes csrc/scan_wide.cu's own layouts ask
    for at launch, at every cluster size, at the old gate's boundary
    shapes (one block's factor takes d = 50 up to b = 48 in float64,
    d = 64 up to b = 16; a cluster of two every b)."""
    import ctypes
    from opty_tpu_torch.ops.cuda_build import load
    out = (ctypes.c_ulonglong * 2)()
    lib = load('scan_wide', sk._WIDE_SIGNATURES)
    assert lib.scan_wide_smem(d, b, dtype.itemsize, cluster, out) == 0
    assert sk.wide_smem(d, b, dtype.itemsize, cluster) == (out[0], out[1])


@pytest.mark.parametrize('d,b', [(1, 3), (12, 5), (5, 9), (33, 17)])
def test_wide_scan_kernels_other_blocks(card, d, b):
    """Blocks between the classes: d = 1, d or b just past scan.cu's 8,
    and odd sizes that leave partial tiles."""
    _check_scan(4, 23, d, b, torch.float64, card)


def test_wide_scan_one_launch_per_call(card):
    for B in (1, 8, 32, 100):
        D, E, F, Kbb, r, rb = _scan_system(B, 20, 50, 41, torch.float64,
                                           card)
        sk.reset_launch_counts()
        fac = sk.scan_factor(D, E, F, Kbb)
        sk.scan_solve(*fac[:3], E, fac[3], r, rb)
        sk.scan_solve(*fac[:3], E, fac[3], r, rb)
        torch.cuda.synchronize()
        assert (sk.wide_factor_launches, sk.wide_solve_launches) == (1, 2)
        sk.scan_factor_plain(D, E, F, Kbb)      # not a launch
        assert (sk.factor_launches, sk.wide_factor_launches) == (0, 1)


def test_wide_scan_singular_lane(card):
    """A singular pivot at d = 50 makes its lane's outputs non-finite
    from that node on and leaves the other lanes equal to their plain
    versions, at every cluster size."""
    dtype = torch.float64
    D, E, F, Kbb, r, rb = _scan_system(4, 30, 50, 41, dtype, card, seed=3)
    D[2, 10] = 0.0
    E[2, 10] = 0.0               # S_10 = D_10 = 0 in lane 2
    want = sk.scan_factor_plain(D, E, F, Kbb)
    assert not torch.isfinite(want[0][2, 10]).all()
    good = [0, 1, 3]
    for fc in (None,) + sk.FACTOR_CLUSTERS:
        fac = sk.scan_factor(D, E, F, Kbb) if fc is None else \
            sk.launch_wide_factor(D, E, F, Kbb, fc)
        assert not torch.isfinite(fac[0][2, 10]).all()
        assert not torch.isfinite(fac[3][2]).all()
        for g, w in zip(fac, want):
            assert torch.isfinite(g[good]).all()
            assert _rel(g[good], w[good]) <= SCAN_TOL[dtype]
        for sc in (None,) + sk.SOLVE_CLUSTERS:
            u, beta = sk.scan_solve(*fac[:3], E, fac[3], r, rb) \
                if sc is None else \
                sk.launch_wide_solve(*fac[:3], E, fac[3], r, rb, sc)
            assert not torch.isfinite(u[2]).all()
            assert torch.isfinite(u[good]).all()
            assert torch.isfinite(beta[good]).all()


def test_nlink_scan_iteration_on_card_equals_cpu(card):
    """One interior-point iteration of nlink-9 (N = 12) with
    kkt_method='scan' and a float64 factorization through the wide scan
    kernels on the card, against the same iteration through the plain
    versions on the CPU from the card's state (chip_smoke.py's phase 7c
    crossovers)."""
    from opty_tpu_torch import interop
    from opty_tpu_torch.models.nlink import (n_link_cart_problem,
                                             n_link_initial_guess)
    options = dict(kkt_method='scan', factor_dtype=torch.float64,
                   chunk_iters=1, mu_init=1e-5, use_soc=False,
                   max_rest_visit=0, dw_decay='hold')
    card_prob, q_start = n_link_cart_problem(9, 12, device='cuda')
    cpu_prob, _ = n_link_cart_problem(9, 12, device='cpu')
    guess = n_link_initial_guess(card_prob, q_start)
    steps = {}
    for name, p in (('card', card_prob), ('cpu', cpu_prob)):
        p.set_solver_options(**options)
        steps[name] = p._build_solver()[1:]
    sk.reset_launch_counts()
    _, state = steps['card'][0](torch.as_tensor(guess, device=card)[None])
    _, state = steps['card'][1](torch.as_tensor(guess, device=card)[None],
                                state)
    _, nxt = steps['card'][1](torch.as_tensor(guess, device=card)[None],
                              state)
    torch.cuda.synchronize()
    assert sk.wide_factor_launches > 0 and sk.wide_solve_launches > 0
    shared = interop.state_from_numpy(
        {f: v.detach().cpu().numpy() for f, v in state._asdict().items()},
        'cpu')
    _, got = steps['cpu'][1](torch.as_tensor(guess)[None], shared)
    for f in ('x', 'y', 'zL', 'zU'):
        want = getattr(nxt, f)[0].cpu().double()
        assert _rel(getattr(got, f)[0].double(), want) <= 1e-8, f
