"""``gather_gemm`` and ``gather_wgrad`` on the card against their plain
twins, with the ``skip`` rows the sparse ops pass and the pyramid's live
orders: Cout tiles of 32 to 96 and past them, ragged widths (4-byte
copies), an unaligned table, the tap split of small grids (its partials
added in split order) and large grids without it, and the same result from
two launches.  Here, on the CPU, the split choices of the wrapper and the
live orders (``topology.live_order``) that the pyramids carry.

This file imports no JAX, so the card's machine runs its ``cuda`` tests:
    python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_gather_kernels.py"""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds
from pointcontrast_tpu_torch.sparse import kernels
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import ORDERED_MAPS, build_pyramid, live_order

NPADS = [512, 512, 480, 96, 30]
RTOL, ATOL = 1e-4, 1e-5


def _coords(rng, num_batch=3, n_per=(150, 90, 120), extent=24):
    out = []
    for b in range(num_batch):
        flat = rng.choice(extent ** 3, n_per[b], replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((n_per[b], 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyr():
    pyr, _, _, orphan = build_chunked_pyramid(_coords(np.random.RandomState(0)),
                                              5, NPADS, num_batch=3)
    assert not orphan.any()
    return pyr


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _idx(a, dev):
    return torch.from_numpy(np.asarray(a).astype(np.int32)).to(dev)


def _close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= ATOL + RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


def _big_map(gen, k, b_, s, dev, live=0.5):
    """A random [k, B, s] map: rows in [0, s - 1), pad row s - 1 at a
    (1 - live) share of the entries and at every row past 0.7 s."""
    m = torch.randint(0, s - 1, (k, b_, s), device=dev, generator=gen, dtype=torch.int32)
    dead = torch.rand((k, b_, s), device=dev, generator=gen) > live
    dead[:, :, int(0.7 * s):] = True
    return torch.where(dead, torch.full_like(m, s - 1), m)


def _order_of(m):
    """The live order [B, S_out] of a [K, B, S_out] map whose pad row is
    its largest entry's chunk's last row, S_out - 1 here."""
    host = m.cpu().numpy()
    s = host.shape[2]
    return torch.from_numpy(np.stack([live_order(host[:, b], s - 1)
                                      for b in range(host.shape[1])])).to(m.device)


def _fragments_computed(live, order):
    """The share of (row, tap) pairs gather_gemm computes: every row of a
    16-row fragment of ``order`` with a live row at that tap.  live [K, S]."""
    k, s = live.shape
    frag = np.pad(live[:, order], ((0, 0), (0, -s % 16))).reshape(k, -1, 16)
    return 16 * frag.any(-1).sum() / live.size


@pytest.mark.parametrize("layout", ["chunked", "flat"])
def test_pyramids_carry_live_orders(layout):
    """Every gather map of a chunked or flat pyramid comes with its live
    order: per chunk a permutation of the map's output rows in which the
    rows' live-tap sets (tap 0 first) never decrease, so equal sets sit
    side by side, and no more (fragment, tap) pairs to compute than in the
    rows' own order (fewer at level 0)."""
    coords = _coords(np.random.RandomState(1), n_per=(400, 300, 350), extent=16)
    if layout == "chunked":
        pyr = build_chunked_pyramid(coords, 5, [1536, 768, 480, 96, 30], num_batch=3,
                                    build_down3=True)[0]
    else:
        pyr = build_pyramid(coords, 5, npads=[1536, 768, 480, 96, 30], build_down3=True)[0]
    check_pyramid_bounds(pyr)
    gains = []
    for lv in pyr.levels:
        for name, oname in ORDERED_MAPS:
            m, o = getattr(lv, name), getattr(lv, oname)
            if m is None:
                assert o is None
                continue
            m = m.astype(np.int64)
            if layout == "chunked":
                chunks = [(m[:, b], o[b]) for b in range(m.shape[1])]
            else:
                chunks = [(m, o)]
            pad = (lv.valid.shape[0] // (pyr.num_batch if layout == "chunked" else 1)) - 1
            for mb, ob in chunks:
                ob = ob.astype(np.int64)
                assert np.array_equal(np.sort(ob), np.arange(mb.shape[1])), oname
                live = mb != pad
                keys = [tuple(col) for col in live[:, ob].T.tolist()]
                assert keys == sorted(keys, reverse=False), oname
                ordered = _fragments_computed(live, ob)
                own = _fragments_computed(live, np.arange(mb.shape[1]))
                assert ordered <= own, oname
                if name == "nbr":
                    gains.append(own - ordered)
    assert max(gains) > 0.05


def test_pyramid_bounds_refuse_a_broken_order():
    """The host check refuses a live order that is not a permutation: the
    kernel writes the output row each entry names."""
    pyr = build_chunked_pyramid(_coords(np.random.RandomState(0)), 5, NPADS, num_batch=3)[0]
    check_pyramid_bounds(pyr)
    pyr.levels[1].nbr_order[0, 0] = pyr.levels[1].nbr_order[0, 1]
    with pytest.raises(ValueError, match="nbr_order: not a permutation"):
        check_pyramid_bounds(pyr)


def test_wrappers_split_small_grids_only():
    """The tap split: none at a wide grid or at few taps; at a small grid
    enough splits for two waves of 132 SMs, 3 taps a split at least."""
    saved = kernels._gemm_tile_n
    kernels._gemm_tile_n = lambda cout: 64  # the kernel's Cout tile
    try:
        assert kernels._gemm_splits(8, 16384, 32, 27) == 1
        assert kernels._gemm_splits(8, 180, 128, 27) == 9   # 32 blocks
        assert kernels._gemm_splits(8, 491, 128, 27) == 5   # 64 blocks
        assert kernels._gemm_splits(8, 180, 128, 8) == 2
        assert kernels._gemm_splits(8, 180, 128, 1) == 1
    finally:
        kernels._gemm_tile_n = saved


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(3, 32), (32, 32), (64, 64), (96, 96), (128, 256),
                                      (20, 20), (37, 259)])
def test_gather_gemm_matches_twin_on_card(pyr, card, cin, cout):
    """K1 forward with its centre, K2's 8 taps, a stacked table (K3's
    parent design's dF), each with the pad row skipped and the maps' live
    orders, on the small pyramid (tap splits) and on a large random map (no split), with and
    without its order."""
    gen = torch.Generator(device=card).manual_seed(cin * 1000 + cout)
    lv = pyr.levels[0]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, pyr.levels[1].valid.shape[0] // b_
    nbr, down = _idx(lv.nbr, card), _idx(lv.down_nbr, card)
    x0 = torch.randn(b_, s0, cin, device=card, generator=gen)
    w = torch.randn(27, cin, cout, device=card, generator=gen)
    taps = [i for i in range(27) if i != 13]
    big = _big_map(gen, 27, 2, 20000, card)
    xb = torch.randn(2, 20000, cin, device=card, generator=gen)
    stacked = torch.randn(b_, 8 * s1, cin, device=card, generator=gen)
    order0, down_order = _idx(lv.nbr_order, card), _idx(lv.down_order, card)
    calls = [
        (x0, nbr, taps, 0, w[taps].contiguous(), w[13], s0, s0 - 1, order0),
        (x0, down, list(range(8)), 0, w[:8].contiguous(), None, s1, s0 - 1, down_order),
        (stacked, None, None, s1, w[:8].contiguous(), None, s1, -1),
        (xb, big, taps, 0, w[taps].contiguous(), w[13], 20000, 19999),
        (xb, big, taps, 0, w[taps].contiguous(), w[13], 20000, 19999, _order_of(big)),
    ]
    kernels.reset_launches()
    for args in calls:
        got = kernels.gather_gemm(*args)
        _close(got, kernels.gather_gemm_plain(*args), f"gather_gemm {cin}->{cout}")
        assert torch.equal(got, kernels.gather_gemm(*args)), "not the same twice"
    assert kernels.gather_gemm.launches == 2 * len(calls)


@pytest.mark.cuda
def test_gather_gemm_reads_unaligned_tables(pyr, card):
    """A table whose start is not 16-byte aligned takes the 4-byte copies."""
    gen = torch.Generator(device=card).manual_seed(5)
    lv = pyr.levels[0]
    b_, s0 = 3, lv.valid.shape[0] // 3
    nbr = _idx(lv.nbr, card)
    x0 = torch.randn(b_ * s0 * 32 + 1, device=card, generator=gen)[1:].view(b_, s0, 32)
    w = torch.randn(27, 32, 64, device=card, generator=gen)
    args = (x0, nbr, list(range(27)), 0, w, None, s0, s0 - 1)
    _close(kernels.gather_gemm(*args), kernels.gather_gemm_plain(*args), "unaligned")


@pytest.mark.cuda
@pytest.mark.parametrize("ca,cg", [(3, 32), (32, 32), (64, 64), (96, 96), (256, 128),
                                   (37, 20), (32, 96)])
def test_gather_wgrad_matches_twin_on_card(pyr, card, ca, cg):
    """K1's dW (the cotangent through the map, its pad row skipped), K2's
    (the features through the down map), K3's (a stacked table) and a
    large random map, the row slices added in slice order: the same dW
    twice."""
    gen = torch.Generator(device=card).manual_seed(ca * 1000 + cg)
    lv = pyr.levels[0]
    b_ = 3
    s0, s1 = lv.valid.shape[0] // b_, pyr.levels[1].valid.shape[0] // b_
    nbr, down = _idx(lv.nbr, card), _idx(lv.down_nbr, card)
    a0 = torch.randn(b_, s0, ca, device=card, generator=gen)
    g0 = torch.randn(b_, s0, cg, device=card, generator=gen)
    g1 = torch.randn(b_, s1, cg, device=card, generator=gen)
    dy = torch.randn(b_, 8 * s1, cg, device=card, generator=gen)
    a1 = torch.randn(b_, s1, ca, device=card, generator=gen)
    big = _big_map(gen, 27, 2, 30000, card)
    ab = torch.randn(2, 30000, ca, device=card, generator=gen)
    gb = torch.randn(2, 30000, cg, device=card, generator=gen)
    calls = [
        (a0, None, None, 0, g0, nbr, list(range(27)), 0, 27, s0, -1, s0 - 1),
        (a0, down, list(range(8)), 0, g1, None, None, 0, 8, s1, s0 - 1, -1),
        (a1, None, None, 0, dy, None, None, s1, 8, s1, -1, -1),
        (ab, None, None, 0, gb, big, list(range(27)), 0, 27, 30000, -1, 29999),
    ]
    for args in calls:
        got = kernels.gather_wgrad(*args)
        _close(got, kernels.gather_wgrad_plain(*args), f"gather_wgrad {ca}x{cg}")
        assert torch.equal(got, kernels.gather_wgrad(*args)), "not the same twice"
