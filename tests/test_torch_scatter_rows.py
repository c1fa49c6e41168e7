"""The port's row kernels: ``detect.kernels.gather_rows`` and
``sparse.kernels.scatter_sum`` with its ``skip_from`` bound.  On the CPU:
the brick:2 adjoints' maps name every row below their bound at most once
and only pad rows past it; the bound equals the single skipped row it
replaced on every row below it, on chunked, flat and brick maps; both
wrappers refuse index spaces of 2^31 or more.  On a card: each kernel
against its plain twin.

This file imports no JAX, so the card's machine (which has none) runs its
``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_scatter_rows.py

Exact comparisons throughout: the twins add the same rows in the same
order, and a gather is a copy; only destinations that many sources name
get unordered f32 atomics on the card (1e-5 of the largest entry)."""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid

NS = 8  # slots of a brick
NB = 3
NPADS = [600, 480, 200, 60]


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _i(a):
    return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32))


@pytest.fixture(scope="module")
def brick_levels():
    """Levels 0 and 1 of one pair collated in the brick:2 layout."""
    ds = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0,
                              seed=0)
    batch = collate_pair([ds[0]], PadScheme(npad0=4096), npos=64,
                         rng=np.random.RandomState(7), layout="brick:2")
    return batch.pyramid0.levels[:2]


def _brick_adjoints(levels):
    """{name: (rows [1, 1, n] of the source table, its rows, skip_from, the
    source table's valid bricks)} of the level-0 placement gather (into the
    flat next level's rows, one per level-0 brick) and the level-1 -> 0 up
    gather (into level 1's brick rows), as ``brick_down_conv`` and
    ``brick_up_conv`` pass them."""
    lv0, lv1 = levels
    nb0, nb1 = lv0.valid.shape[0] // NS, lv1.valid.shape[0] // NS
    place = np.asarray(lv0.down_nbr.place)
    return {
        "placement": (_i(place.T.reshape(1, 1, -1)), nb0, nb0 - 1,
                      lv0.valid.reshape(nb0, NS).any(1)),
        "up gather": (_i(np.asarray(lv0.up_parent).reshape(1, 1, -1)), nb1 * NS,
                      (nb1 - 1) * NS, np.repeat(lv1.valid.reshape(nb1, NS).any(1), NS)),
    }


@pytest.mark.parametrize("name", ["placement", "up gather"])
def test_brick_adjoints_name_each_kept_row_once(brick_levels, name):
    """Below ``skip_from`` every destination is named at most once (so the
    kernel's adds never meet and it is exact); at and past it lie only the
    pad brick's rows, which are all invalid.  Many sources do point there."""
    rows, s_in, skip_from, valid = _brick_adjoints(brick_levels)[name]
    rows = rows.reshape(-1).numpy()
    kept = rows[rows < skip_from]
    assert np.bincount(kept, minlength=s_in).max() <= 1
    assert not valid[skip_from:].any()
    assert valid[:skip_from].any()
    assert (rows >= skip_from).sum() > 1  # the contention the bound leaves out


def _single_row_skip(g3, map_, s_in, skip):
    """``scatter_sum_plain`` as it was before ``skip_from``: one skipped row."""
    b_, _, c = g3.shape
    out = g3.new_zeros(b_, s_in, c)
    for t in range(map_.shape[0]):
        idx = map_[t].long()
        y = torch.where((idx != skip)[..., None], g3, 0.0)
        out.scatter_add_(1, idx.unsqueeze(-1).expand(-1, -1, c), y)
    return out


def _maps(case, brick_levels):
    """(map [K, B, S_g], s_in, skip_from, the single row skipped before)."""
    if case.startswith("chunked"):
        pyr = build_chunked_pyramid(_coords(), 3, NPADS[:3], num_batch=NB)[0]
        s0, s1 = (int(l.valid.shape[0]) // NB for l in pyr.levels[:2])
        if case == "chunked pool":
            return _i(pyr.levels[0].down_nbr), s0, s0 - 1, s0 - 1
        return _i(pyr.levels[0].up_parent)[None], s1, s1 - 1, s1 - 1
    if case == "flat pool":
        lv = build_pyramid(_coords(), 3, npads=NPADS[:3], num_batch=NB)[0].levels[0]
        n0 = int(lv.valid.shape[0])
        return _i(lv.down_nbr)[:, None], n0, n0 - 1, n0 - 1
    rows, s_in, skip_from, _ = _brick_adjoints(brick_levels)[case]
    return rows, s_in, skip_from, s_in - 1


@pytest.mark.parametrize("case", ["chunked pool", "chunked unpool", "flat pool",
                                  "placement", "up gather"])
def test_skip_from_equals_the_single_skipped_row_below_it(brick_levels, case):
    """Bit for bit on every row below ``skip_from``; nothing at or past it."""
    map_, s_in, skip_from, skip = _maps(case, brick_levels)
    k, b_, s_g = map_.shape
    g3 = torch.from_numpy(np.random.RandomState(3).randn(b_, s_g, 5).astype(np.float32))
    got = sk.scatter_sum_plain(g3, map_, range(k), 0, s_in, skip_from)
    want = _single_row_skip(g3, map_, s_in, skip)
    assert torch.equal(got[:, :skip_from], want[:, :skip_from])
    assert not got[:, skip_from:].any()
    assert torch.equal(sk.scatter_sum(g3, map_, range(k), 0, s_in, skip_from), got)


def _expanded(*shape, dtype=torch.float32):
    """A tensor of ``shape`` that holds one element (no memory to speak of)."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


def test_gather_rows_refuses_index_spaces_of_2_31():
    idx = torch.zeros(2, 4, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31"):
        dk.gather_rows(_expanded(2, 2 ** 15, 2 ** 15), idx)  # B N C = 2^31
    with pytest.raises(ValueError, match="2\\^31"):  # B M C = 2^32
        dk.gather_rows(torch.zeros(2, 4, 2 ** 14), torch.zeros(2, 2 ** 17, dtype=torch.int32))
    out = dk.gather_rows(_expanded(1, 2 ** 16 - 1, 2 ** 15), idx[:1])  # one row less
    assert out.shape == (1, 4, 2 ** 15)


@pytest.mark.parametrize("what", ["g3", "out", "map"])
def test_scatter_sum_refuses_index_spaces_of_2_31(what):
    g3, map_, s_in = {
        "g3": (_expanded(2, 2 ** 15, 2 ** 15), _expanded(1, 2, 2 ** 15, dtype=torch.int32), 4),
        "out": (torch.zeros(1, 4, 2 ** 15), torch.zeros(1, 1, 4, dtype=torch.int32), 2 ** 16),
        "map": (torch.zeros(1, 2 ** 15, 1), _expanded(2 ** 16, 1, 2 ** 15, dtype=torch.int32), 4),
    }[what]
    with pytest.raises(ValueError, match=f"{what} spans"):
        sk.scatter_sum(g3, map_, [0], 0, s_in, s_in - 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_gather_rows_matches_plain_twin_on_card():
    """Bit-exact copies at the widths of the detection path (C 3: one
    thread a row; 256: float4 lanes; 259: scalar lanes) and at C 8 and 36,
    from 16-byte aligned tables and from one that is not; one launch each."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for c in (3, 8, 36, 256, 259):
        table = torch.randn(3, 2000, c, device=dev, generator=gen)
        idx = torch.randint(0, 2000, (3, 256, 16), device=dev, generator=gen,
                            dtype=torch.int32)
        calls.append((table, idx))
    shifted = torch.randn(3 * 2000 * 256 + 1, device=dev, generator=gen)[1:]
    calls.append((shifted.view(3, 2000, 256), calls[3][1]))  # float4-misaligned
    dk.reset_launches()
    for table, idx in calls:
        got = dk.gather_rows(table, idx)
        torch.cuda.synchronize()
        assert torch.equal(got, dk.gather_rows_plain(table, idx))
    assert dk.launch_counts()["gather_rows"] == len(calls)


@pytest.mark.cuda
def test_scatter_sum_matches_plain_twin_on_card(brick_levels):
    """The brick adjoints (each kept row named once: exact); every source
    into one row (the contention the bound now leaves out, held to 1e-5 of
    the largest entry) with and without a bound that skips it; 8 taps of a
    chunked pool map from a float4-misaligned cotangent; one launch each."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    exact, loose = [], []
    for name, (rows, s_in, skip_from, _) in _brick_adjoints(brick_levels).items():
        g3 = torch.randn(1, rows.shape[2], 64, device=dev, generator=gen)
        exact.append((g3, rows.to(dev), [0], 0, s_in, skip_from))
    one = torch.zeros(1, 1, 5000, dtype=torch.int32, device=dev) + 17
    g3 = torch.randn(1, 5000, 64, device=dev, generator=gen)
    loose.append((g3, one, [0], 0, 40, -1))
    exact.append((g3, one, [0], 0, 40, 17))  # all skipped: zeros
    pyr = build_chunked_pyramid(_coords(), 3, NPADS[:3], num_batch=NB)[0]
    s0, s1 = (int(l.valid.shape[0]) // NB for l in pyr.levels[:2])
    shifted = torch.randn(NB * s1 * 64 + 1, device=dev, generator=gen)[1:]
    loose.append((shifted.view(NB, s1, 64), _i(pyr.levels[0].down_nbr).to(dev),
                  range(8), 0, s0, s0 - 1))
    sk.reset_launches()
    for args in exact + loose:
        got = sk.scatter_sum(*args)
        want = sk.scatter_sum_plain(*args)
        torch.cuda.synchronize()
        if any(args is e for e in exact):
            assert torch.equal(got, want)
        else:
            scale = float(want.abs().max())
            torch.testing.assert_close(got, want, rtol=0, atol=1e-5 * scale)
    assert sk.launch_counts()["scatter_sum"] == len(exact) + len(loose)
