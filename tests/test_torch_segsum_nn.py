"""segment_sum over runs of ids and three_nn over lane-split scans.

On the CPU (the wrappers run their twins there): ``segment_sum`` against
``jax.ops.segment_sum`` on chunked-run ids (each chunk's valid prefix
carries its sample, its pad tail ``num_batch``), sorted flat ids with the
pads last, random unsorted ids and a single segment, at C 1, 3, 64 and 130
and N not a multiple of 512; the port's ``global_pool`` (sums and means)
and ``broadcast_to_points`` (forward, and the backward that segment_sum
computes) against JAX's, through ``jax.vjp``; ``three_nn`` index for
index against JAX's ``three_nn`` on clouds where known points repeat at
strides of 1, 8, 16 and 32 indices (exact ties that a lane-split scan
sees in different lanes, or in one), at M 3, 5, 33, 256 and 512.
On a card (``cuda``-marked): each kernel against its twin at those cases
and at the paths' shapes, segment_sum with the same bits from two
launches (up to SEG_SMEM segments), on an all-pad input, with ids out of
range left out, and on its general path (more than SEG_SMEM segments);
three_nn exact, and bit-equal from two launches.

Tolerances: segment_sum against JAX 1e-6 of the largest entry (its
values lie on a 1/64 grid, where every partial sum is exact in f32, so
the orders of the adds do not show); on the card ATOL + RTOL times the
largest entry, ``chip_smoke.py``'s bound, for N(0, 1) values (a block's
runs and the blocks' partials are added in another order than the
twin's).  three_nn exact: its clouds lie on a 1/64 grid, where every
squared distance is exact in f32 whatever the FMA spelling, and its
distances within 1e-6 (JAX takes sqrt of another spelling of the same
exact sum).

JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_segsum_nn.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops

ATOL, RTOL = 1e-5, 1e-4
CHANNELS = (1, 3, 64, 130)
SEG_N = 1237  # rows: not a multiple of 512, nor of a block's step


def _chunked(rng, n=SEG_N, nb=3):
    """[n] ids in nb chunks: each chunk's valid prefix carries its sample
    and its pad tail nb (one chunk all pad); S = nb + 1."""
    ids = np.full(n, nb, np.int32)
    bounds = np.linspace(0, n, nb + 1).astype(int)
    for b in range(nb - 1):
        lo, hi = bounds[b], bounds[b + 1]
        ids[lo:lo + rng.randint(1, hi - lo)] = b
    return ids, nb + 1


def _sorted_flat(rng, n=SEG_N, nb=5):
    """Sorted ids of nb samples, the pad rows (nb) last; S = nb + 1."""
    ids = np.concatenate([np.sort(rng.randint(0, nb, n - 37)), np.full(37, nb)])
    return ids.astype(np.int32), nb + 1


SEG_IDS = {
    "chunked runs": _chunked,
    "sorted flat": _sorted_flat,
    "random": lambda rng: (rng.randint(0, 7, SEG_N).astype(np.int32), 7),
    "single": lambda rng: (np.zeros(SEG_N, np.int32), 1),
}


def _seg_case(kind, c, seed=0, grid=True):
    rng = np.random.RandomState(seed)
    ids, s = SEG_IDS[kind](rng)
    if grid:  # k / 64: every partial sum exact in f32
        x = (rng.randint(-64, 65, (len(ids), c)) / 64.0).astype(np.float32)
    else:
        x = rng.randn(len(ids), c).astype(np.float32)
    return x, ids, s


@pytest.fixture(scope="module")
def jax_mod():
    import jax

    from pointcontrast_tpu.detect import ops as jdet
    from pointcontrast_tpu.sparse import ops as jops

    return jax, jdet, jops


def _close_to(got, want, rtol):
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max(initial=0.0)
    assert err <= rtol * np.abs(want).max(initial=0.0), err


@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("kind", list(SEG_IDS))
def test_segment_sum_matches_jax(jax_mod, kind, c):
    jax = jax_mod[0]
    x, ids, s = _seg_case(kind, c)
    want = np.asarray(jax.ops.segment_sum(x, ids, num_segments=s))
    got = sk.segment_sum(torch.from_numpy(x), torch.from_numpy(ids), s)
    assert got.shape == (s, c) and got.dtype == torch.float32
    _close_to(got.numpy(), want, 1e-6)


@pytest.mark.parametrize("average", [True, False])
def test_global_pool_and_broadcast_match_jax(jax_mod, average):
    """The pool (sums and counts: two segment sums) and the broadcast's
    backward (a segment sum over ids whose pad rows join the last
    sample) against JAX through jax.vjp, on chunked-run ids."""
    jax, _, jops = jax_mod
    rng = np.random.RandomState(3)
    ids, s = _chunked(rng, nb=4)
    nb = s - 1
    x = (rng.randint(-64, 65, (len(ids), 64)) / 64.0).astype(np.float32)
    x[ids == nb] = 0.0  # pad rows are zero
    want = np.asarray(jops.global_pool(x, ids, nb, average))
    got = tops.global_pool(torch.from_numpy(x), torch.from_numpy(ids), nb, average)
    _close_to(got.numpy(), want, 1e-6)

    per = (rng.randint(-64, 65, (nb, 64)) / 64.0).astype(np.float32)
    ct = (rng.randint(-64, 65, (len(ids), 64)) / 64.0).astype(np.float32)
    out, vjp = jax.vjp(lambda p: jops.broadcast_to_points(p, ids), per)
    t_per = torch.from_numpy(per).requires_grad_()
    t_out = tops.broadcast_to_points(t_per, torch.from_numpy(ids))
    np.testing.assert_array_equal(t_out.detach().numpy(), np.asarray(out))
    t_out.backward(torch.from_numpy(ct))
    (want_grad,) = vjp(ct)
    _close_to(t_per.grad.numpy(), want_grad, 1e-6)
    assert (ids == nb).any()  # pad rows, whose cotangent lands in the last sample


# --------------------------------------------------------------------------
# three_nn

NN_M = (3, 5, 33, 256, 512)


def _nn_clouds(m, seed, b_=2, n=77):
    """Unknown and known clouds on a 1/64 grid in a 2 m box; known points
    repeat at strides of 1, 8, 16 and 32 indices, so exact ties fall in
    different lanes of a group (1, 8, 16) and in one (32)."""
    rng = np.random.RandomState(seed)
    known = (rng.randint(0, 128, (b_, m, 3)) / 64.0).astype(np.float32)
    for stride in (1, 8, 16, 32):
        src = np.arange(0, m - stride, 2 * stride + 3)
        known[:, src + stride] = known[:, src]
    unknown = (rng.randint(0, 128, (b_, n, 3)) / 64.0).astype(np.float32)
    unknown[:, :3] = known[:, :3]  # distance 0 to a repeated point
    return unknown, known


@pytest.mark.parametrize("m", NN_M)
def test_three_nn_matches_jax(jax_mod, m):
    jdet = jax_mod[1]
    unknown, known = _nn_clouds(m, seed=m)
    jd, ji = (np.asarray(a) for a in jdet.three_nn(unknown, known))
    dist, idx = dk.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(dist.numpy(), jd, rtol=1e-6, atol=0)
    if m >= 33:  # ties decided by index among the first three
        d2 = ((unknown[:, :, None] - known[:, None]) ** 2).sum(-1)
        tied = (np.sort(d2, -1)[..., :3, None] == d2[..., None, :]).sum(-1) > 1
        assert tied.any()


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


def _card_close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= ATOL + RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


def _seg_on_card(x, ids, s, card, what, exact=False):
    tx, ti = torch.from_numpy(x).to(card), torch.from_numpy(ids).to(card)
    got = sk.segment_sum(tx, ti, s)
    keep = (ti >= 0) & (ti < s)
    want = sk.segment_sum_plain(tx[keep], ti[keep], s)
    if exact:
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    else:
        _card_close(got, want, what)
    return tx, ti, got


@pytest.mark.cuda
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("kind", list(SEG_IDS))
def test_segment_sum_kernel_matches_twin(card, kind, c):
    sk.reset_launches()
    x, ids, s = _seg_case(kind, c, grid=False)
    tx, ti, got = _seg_on_card(x, ids, s, card, f"{kind} C{c}")
    assert torch.equal(got, sk.segment_sum(tx, ti, s))  # the same bits
    assert sk.segment_sum.launches == 2
    x, ids, s = _seg_case(kind, c, grid=True)  # exact sums: equal to the twin
    _seg_on_card(x, ids, s, card, f"{kind} C{c} grid", exact=True)


# the paths' shapes: (rows, channels, samples), the InstanceBatchNorm
# levels of the semseg batch (PadScheme.scannet(262144), 6 chunks) and a
# deep one with two channel tiles' worth past 128
SEG_PATH_SHAPES = [(262144, 64, 6), (99612, 128, 6), (27522, 256, 6), (7866, 512, 6),
                   (262144, 1, 6)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,nb", SEG_PATH_SHAPES)
def test_segment_sum_kernel_at_path_shapes(card, n, c, nb):
    """Chunked runs at the paths' sizes (pool: S = nb + 1; the broadcast's
    backward: pad rows in the last sample, S = nb), the same bits from
    two launches."""
    rng = np.random.RandomState(n + c)
    ids, s = _chunked(rng, n=n, nb=nb)
    x = rng.randn(n, c).astype(np.float32)
    for ids_, s_ in ((ids, s), (np.minimum(ids, nb - 1), nb)):
        tx, ti, got = _seg_on_card(x, ids_, s_, card, f"N{n} C{c} S{s_}")
        assert torch.equal(got, sk.segment_sum(tx, ti, s_))


@pytest.mark.cuda
def test_segment_sum_all_pad_and_out_of_range(card):
    rng = np.random.RandomState(9)
    x = rng.randn(3000, 64).astype(np.float32)
    ids = np.full(3000, 4, np.int32)  # every row in the pad segment
    _, _, got = _seg_on_card(x, ids, 5, card, "all pad")
    assert not got[:4].any()
    ids = rng.randint(-3, 9, 3000).astype(np.int32)  # ids outside [0, 6) left out
    for c in CHANNELS:
        _seg_on_card(rng.randn(3000, c).astype(np.float32), ids, 6, card,
                     f"out of range C{c}")
    _, _, got = _seg_on_card(x, np.full(3000, 7, np.int32), 6, card, "none in range")
    assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("s", [sk.SEG_SMEM, sk.SEG_SMEM + 1, 40])
def test_segment_sum_general_path(card, s):
    """Random ids at S = SEG_SMEM (the last deterministic one: the same
    bits from two launches) and past it (the general path's atomics)."""
    rng = np.random.RandomState(s)
    for c in CHANNELS:
        x = rng.randn(20000, c).astype(np.float32)
        ids = rng.randint(0, s, 20000).astype(np.int32)
        tx, ti, got = _seg_on_card(x, ids, s, card, f"S{s} C{c}")
        if s <= sk.SEG_SMEM:
            assert torch.equal(got, sk.segment_sum(tx, ti, s))


@pytest.mark.cuda
@pytest.mark.parametrize("m", NN_M)
def test_three_nn_kernel_exact(card, m):
    unknown, known = (torch.from_numpy(a).to(card) for a in _nn_clouds(m, seed=m))
    dk.reset_launches()
    dist, idx = dk.three_nn(unknown, known)
    want_d, want_i = dk.three_nn_plain(unknown, known)
    torch.testing.assert_close(idx, want_i, rtol=0, atol=0)
    torch.testing.assert_close(dist, want_d, rtol=0, atol=0)
    d2, i2 = dk.three_nn(unknown, known)
    assert torch.equal(d2, dist) and torch.equal(i2, idx)
    assert dk.three_nn.launches == 2


@pytest.mark.cuda
@pytest.mark.parametrize("b_,n,m", [(8, 512, 256), (8, 1024, 512), (3, 1000, 1500),
                                    (1, 1, 3), (2, 33, 130)])
def test_three_nn_kernel_shapes(card, b_, n, m):
    """FP1's and FP2's shapes, a cloud past one staged tile (1500 known
    points), one unknown point over three known, and N not a multiple of
    the points a block takes, on 1/64-grid clouds with repeated points."""
    rng = np.random.RandomState(n + m)
    known = (rng.randint(0, 256, (b_, m, 3)) / 64.0).astype(np.float32)
    known[:, m // 2:] = known[:, :m - m // 2]  # every point twice
    unknown = (rng.randint(0, 256, (b_, n, 3)) / 64.0).astype(np.float32)
    tu, tk = torch.from_numpy(unknown).to(card), torch.from_numpy(known).to(card)
    dist, idx = dk.three_nn(tu, tk)
    want_d, want_i = dk.three_nn_plain(tu, tk)
    torch.testing.assert_close(idx, want_i, rtol=0, atol=0)
    torch.testing.assert_close(dist, want_d, rtol=0, atol=0)
