"""Ball query at the edges of a warp-a-centre scan, and K4's dF scatter
with the map's live order.

On the CPU: ``ball_query_plain`` (and the wrapper on CPU tensors) index
for index against JAX's ``ball_query`` where the kernel's 32-point steps
meet the data: the nsample-th hit as the last lane of a step and as the
first of the next, clouds of 31, 33 and 1000 points, no hit, every point
inside, points exactly at the radius, duplicated points, nsample 64 (one
step's hits straddle the end); K4's forward and backward through
``sparse_conv`` with the live order (``down3_order``, ``down_order``,
``nbr_order``) against ``jax.vjp`` of JAX's ``_conv_chunk_down_fused`` at
valid rows, the order reaching ``scatter_gemm``; the wrapper's refusal of
an order of another shape or type.
On a card (``cuda``-marked): the ball-query kernel index for index
against its twin at the same edges and at SA1's shape (8 x 2048 centres
over 40000 points, r 0.2, ns 64), with the same bits from two launches;
the scatter_gemm kernel against its twin at ResNet K4 shapes (27 taps
and 1 tap, with the live order and without), with an all-pad chunk, tap
splits, repeated destinations and Cin / Cout that are not multiples of 4.

Tolerances: ball query exact everywhere (its clouds lie on a 1/64 grid,
where every squared distance is exact in f32 whatever the FMA spelling,
so a point at the radius is outside on both sides); K4 against JAX 1e-5
of the largest entry (rows of up to 27 products summed in other orders,
f32, "highest" matmul precision); scatter_gemm on the
card to ATOL + RTOL times the largest entry, ``chip_smoke.py``'s bound
(f32 atomics add in an order that changes from run to run).

JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_ball_scatter.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import live_order

NB = 3
NPADS = [1500, 1200, 600, 300, 150, 60]
ATOL, RTOL = 1e-5, 1e-4
FAR = np.float32(40.0)  # a coordinate no ball reaches


def _grid(rng, shape, cells=256):
    """f32 coordinates on a 1/64 grid in [0, cells / 64)."""
    return (rng.randint(0, cells, shape) / 64.0).astype(np.float32)


def _hits_at(n, hits, nsample, b_=2):
    """One centre a sample at (1, 1, 1), points far away except those at
    ``hits``, which lie inside r 0.25 (offsets of 1/16 and 1/8)."""
    rng = np.random.RandomState(n)
    xyz = np.full((b_, n, 3), FAR, np.float32)
    xyz[:, hits] = 1.0 + _grid(rng, (b_, len(hits), 3), cells=9) - 0.0625
    centres = np.ones((b_, 1, 3), np.float32)
    return centres, xyz, 0.25, nsample


def _cloud(n, m, radius, nsample, seed, distinct=None, b_=2):
    """Grid clouds of n points (``distinct`` of them, each repeated), m
    centres among the points plus one far away (no hit)."""
    rng = np.random.RandomState(seed)
    base = _grid(rng, (b_, distinct or n, 3), cells=128)
    xyz = base[:, rng.permutation(np.arange(n) % (distinct or n))]
    centres = np.concatenate([xyz[:, rng.choice(n, m, replace=n < m)],
                              np.full((b_, 1, 3), FAR, np.float32)], axis=1)
    return centres, xyz, radius, nsample


def _at_radius():
    """Centres at (1, 1, 1) and (1.5, 0.25, 2), r 0.3125: points exactly at
    the radius (offsets (3/16, 1/4, 0) and the like, 5/16 long) and points
    just inside and outside, in a shuffled order."""
    rng = np.random.RandomState(7)
    offs = np.array([[3, 4, 0], [0, 3, 4], [-4, 0, 3], [5, 0, 0], [0, -5, 0],
                     [3, 3, 3], [4, 3, 1], [1, 1, 1], [0, 0, 0], [6, 0, 0]],
                    np.float32) / 16.0
    centres = np.array([[[1.0, 1.0, 1.0], [1.5, 0.25, 2.0]]], np.float32)
    pts = (centres[0, :, None, :] + offs[None]).reshape(-1, 3)
    pts = np.concatenate([pts, _grid(rng, (30, 3))])[None]
    return centres, pts[:, rng.permutation(pts.shape[1])], 0.3125, 12


BALL_CASES = {
    # the 32nd hit as lane 31 of the first step, and as lane 0 of the second
    "nth hit lane 31": lambda: _hits_at(100, list(range(32)) + [40, 70], 32),
    "nth hit lane 0": lambda: _hits_at(100, list(range(1, 33)) + [50], 32),
    "hits across steps ns 5": lambda: _hits_at(200, [3, 31, 32, 63, 64, 65, 199], 5),
    "N 31": lambda: _cloud(31, 9, 0.5, 8, seed=1),
    "N 33": lambda: _cloud(33, 9, 0.5, 8, seed=2),
    "N 1000": lambda: _cloud(1000, 40, 0.3, 16, seed=3),
    "no hit": lambda: _hits_at(77, [], 8),
    "all inside": lambda: _cloud(90, 12, 10.0, 16, seed=4),
    "at the radius": _at_radius,
    "duplicates": lambda: _cloud(1200, 30, 0.25, 16, seed=5, distinct=300),
    "ns 64": lambda: _cloud(700, 25, 0.6, 64, seed=6),
    "ns 64 one step straddles": lambda: _hits_at(
        300, list(range(20, 60)) + list(range(100, 140)), 64),
}


@pytest.fixture(scope="module")
def jax_mod():
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    from pointcontrast_tpu.detect import ops as jdet
    from pointcontrast_tpu.sparse import ops as jops

    return jax, jdet, jops


@pytest.mark.parametrize("case", list(BALL_CASES))
def test_ball_query_plain_matches_jax(jax_mod, case):
    centres, xyz, radius, nsample = BALL_CASES[case]()
    want = np.asarray(jax_mod[1].ball_query(centres, xyz, radius, nsample))
    tc, tx = torch.from_numpy(centres), torch.from_numpy(xyz)
    got = dk.ball_query_plain(tc, tx, radius, nsample)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(dk.ball_query(tc, tx, radius, nsample).numpy(), want)
    if case == "no hit":
        assert not want.any()
    if case == "at the radius":  # 5 of the 10 offsets lie at 5/16: left out
        d2 = ((xyz[0][None] - centres[0][:, None]) ** 2).sum(-1)
        assert (d2 == np.float32(radius * radius)).sum(1).min() == 5
        assert (d2[np.arange(2)[:, None], want[0]] < radius * radius).all()


def _pyramid():
    rng = np.random.RandomState(0)
    out = []
    for b, k in enumerate((400, 260, 330)):
        flat = rng.choice(30 ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (30,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return build_chunked_pyramid(np.concatenate(out).astype(np.int32), 6, NPADS,
                                 num_batch=NB, build_down3=True)[0]


@pytest.fixture(scope="module")
def pyramid():
    return _pyramid()


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int(valid.sum()), c)
    return f


K4_MAPS = {  # (source level, map, its live order, destination level)
    "k3s2 level 0": (0, "down_nbr3", "down3_order", 1),
    "k3s2 level 2": (2, "down_nbr3", "down3_order", 3),
    "1 tap level 1": (1, "down_nbr", "down_order", 2),
    "same level 2 without rev": (2, "nbr", "nbr_order", 2),
}


@pytest.mark.parametrize("which", list(K4_MAPS))
def test_k4_backward_with_live_order_matches_jax(jax_mod, pyramid, which, monkeypatch):
    """K4 through ``sparse_conv`` with the map's live order: the forward
    and both gradients against ``jax.vjp`` of JAX's
    ``_conv_chunk_down_fused`` at valid rows, and the backward's scatter
    gets the forward's order."""
    jax, _, jops = jax_mod
    import jax.numpy as jnp

    lsrc, mname, oname, ldst = K4_MAPS[which]
    src, dst = pyramid.levels[lsrc], pyramid.levels[ldst]
    m = getattr(src, mname)
    m = m[0:1] if mname == "down_nbr" else m
    order = getattr(src, oname)
    k = m.shape[0]
    rng = np.random.RandomState(k + lsrc)
    cin, cout = 5, 7
    f = _feats(rng, src.valid, cin)
    ct = _feats(rng, dst.valid, cout)
    w = (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32)
    jmap = jnp.asarray(np.asarray(m, np.int32))
    jout, vjp = jax.vjp(lambda x, wt: jops._conv_chunk_down_fused(x, jmap, wt,
                                                                 jops._fused_group()),
                        jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = (np.asarray(a) for a in vjp(jnp.asarray(ct)))

    seen = []
    real = tops.scatter_gemm

    def spy(*args):
        seen.append(args[6] if len(args) > 6 else None)
        return real(*args)

    monkeypatch.setattr(tops, "scatter_gemm", spy)
    x = torch.from_numpy(f).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    t_order = torch.from_numpy(np.asarray(order).astype(np.int32))
    out = tops.sparse_conv(x, torch.from_numpy(np.asarray(m, np.int32)), wt, order=t_order)
    out.backward(torch.from_numpy(ct))
    assert len(seen) == 1 and seen[0] is not None and torch.equal(seen[0], t_order)
    vin, vout = src.valid > 0, dst.valid > 0
    _close(out.detach().numpy()[vout], np.asarray(jout)[vout])
    _close(x.grad.numpy()[vin], jdf[vin])
    _close(wt.grad.numpy(), jdw)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_scatter_gemm_refuses_a_bad_order():
    """The wrapper checks the order's shape and type on either device; on
    a CPU tensor with a good order it is its twin (an order moves no sum)."""
    rng = np.random.RandomState(3)
    b_, s_out, s_in, cin, cout = 2, 20, 15, 4, 6
    g = torch.from_numpy(rng.randn(b_, s_out, cout).astype(np.float32))
    m = torch.from_numpy(rng.randint(0, s_in, (3, b_, s_out)).astype(np.int32))
    w = torch.from_numpy(rng.randn(2, cin, cout).astype(np.float32))
    order = torch.stack([torch.from_numpy(live_order(m[:, b].numpy(), s_in - 1))
                         for b in range(b_)])
    want = sk.scatter_gemm_plain(g, m, [0, 2], w, s_in, s_in - 1)
    assert torch.equal(sk.scatter_gemm(g, m, [0, 2], w, s_in, s_in - 1, order), want)
    with pytest.raises(ValueError, match="order: shape"):
        sk.scatter_gemm(g, m, [0, 2], w, s_in, s_in - 1, order[:, 1:])
    with pytest.raises(ValueError, match="order: shape"):
        sk.scatter_gemm(g, m, [0, 2], w, s_in, s_in - 1, order[0])
    with pytest.raises(TypeError, match="order must be torch.int32"):
        sk.scatter_gemm(g, m, [0, 2], w, s_in, s_in - 1, order.long())


def test_scatter_splits_small_grids_only(monkeypatch):
    """scatter_gemm's step split: none at a wide grid or at few steps; at a
    small grid enough splits for SCATTER_BLOCKS, 3 steps a split at least."""
    monkeypatch.setattr(sk, "_gemm_tile_n", lambda cin: 64)  # the kernel's Cin tile
    assert sk.SCATTER_BLOCKS == 1056
    assert sk._scatter_splits(8, 40000, 32, 27) == 1      # 2504 blocks
    assert sk._scatter_splits(6, 174, 512, 27 * 16) == 11  # 96 blocks
    assert sk._scatter_splits(6, 174, 1024, 64) == 6       # 192 blocks
    assert sk._scatter_splits(8, 180, 128, 8) == 2         # 32 blocks, 8 steps
    assert sk._scatter_splits(6, 174, 512, 5) == 1


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _sa1(card):
    """SA1's shape: 8 clouds of 40000 points (a 4 x 4 x 2.5 m room on the
    1/64 grid, 3/4 duplicates), 2048 centres among them, r 0.2, ns 64."""
    rng = np.random.RandomState(11)
    base = np.stack([_grid(rng, (8, 10000), 256), _grid(rng, (8, 10000), 256),
                     _grid(rng, (8, 10000), 160)], axis=-1)
    xyz = base[:, rng.permutation(np.arange(40000) % 10000)]
    centres = xyz[:, rng.choice(40000, 2048, replace=False)]
    return centres, xyz, 0.2, 64


@pytest.mark.cuda
@pytest.mark.parametrize("case", [*BALL_CASES, "SA1"])
def test_ball_query_kernel_matches_twin(card, case):
    centres, xyz, radius, nsample = _sa1(card) if case == "SA1" else BALL_CASES[case]()
    tc, tx = (torch.from_numpy(np.ascontiguousarray(a)).to(card) for a in (centres, xyz))
    dk.reset_launches()
    got = dk.ball_query(tc, tx, radius, nsample)
    torch.testing.assert_close(got, dk.ball_query_plain(tc, tx, radius, nsample),
                               rtol=0, atol=0)
    assert torch.equal(got, dk.ball_query(tc, tx, radius, nsample))
    assert dk.ball_query.launches == 2


def _card_close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= ATOL + RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


def _random_map(gen, k, b_, s_out, s_in, live, card):
    """[k, b_, s_out] int32 rows of [0, s_in), a share ``live`` of them not
    the pad row s_in - 1, and each chunk's live order."""
    m = torch.randint(0, s_in - 1, (k, b_, s_out), generator=gen, dtype=torch.int32)
    m[torch.rand(k, b_, s_out, generator=gen) >= live] = s_in - 1
    order = torch.stack([torch.from_numpy(live_order(m[:, b].numpy(), s_in - 1))
                         for b in range(b_)])
    return m.to(card), order.to(card)


SCATTER_SHAPES = {  # (taps, B, S_out, S_in, Cin, Cout, live share)
    "layer1_0.conv1 27 taps 64->64": (27, 6, 4587, 16602, 64, 64, 0.3),
    "layer4_0.conv2 27 taps 512->512": (27, 6, 174, 174, 512, 512, 0.13),
    "layer4_0.downsample 1 tap 1024->2048": (1, 6, 174, 480, 1024, 2048, 0.2),
    "layer3_0.downsample 1 tap 512->1024": (1, 6, 480, 1310, 512, 1024, 0.2),
    "crf flat 13 taps 20->20": (13, 1, 20000, 20000, 20, 20, 0.9),
    "ragged 8 taps 37->45": (8, 2, 900, 700, 37, 45, 0.5),
    "ragged 27 taps 6->3": (27, 3, 300, 500, 6, 3, 0.4),
}


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(SCATTER_SHAPES))
def test_scatter_gemm_kernel_matches_twin(card, which):
    """The kernel against its twin with the map's live order and without
    it; the deep shapes' small grids take tap and Cout-chunk splits."""
    k, b_, s_out, s_in, cin, cout, live = SCATTER_SHAPES[which]
    gen = torch.Generator().manual_seed(k + cin)
    m, order = _random_map(gen, k, b_, s_out, s_in, live, card)
    g = torch.randn(b_, s_out, cout, generator=gen).to(card)
    w = torch.randn(k, cin, cout, generator=gen).to(card)
    taps = list(range(k))
    want = sk.scatter_gemm_plain(g, m, taps, w, s_in, s_in - 1)
    sk.reset_launches()
    for o in (order, None):
        got = sk.scatter_gemm(g, m, taps, w, s_in, s_in - 1, o)
        _card_close(got, want, f"{which} order {o is not None}")
        assert not got[:, s_in - 1].any()  # the skipped pad row
    assert sk.scatter_gemm.launches == 2


@pytest.mark.cuda
def test_scatter_gemm_all_pad_chunk_and_repeats(card):
    """One chunk whose map names only the pad row leaves its dF exact
    zeros; another whose rows all name one of three destinations (repeats
    across rows and taps) adds them all."""
    gen = torch.Generator().manual_seed(5)
    k, b_, s_out, s_in, cin, cout = 9, 3, 500, 400, 64, 96
    m, order = _random_map(gen, k, b_, s_out, s_in, 0.5, card)
    m[:, 0] = s_in - 1
    m[:, 2] = torch.randint(0, 3, (k, s_out), generator=gen, dtype=torch.int32).to(card)
    order = torch.stack([torch.from_numpy(live_order(m[:, b].cpu().numpy(), s_in - 1))
                         for b in range(b_)]).to(card)
    g = torch.randn(b_, s_out, cout, generator=gen).to(card)
    w = torch.randn(k, cin, cout, generator=gen).to(card)
    got = sk.scatter_gemm(g, m, list(range(k)), w, s_in, s_in - 1, order)
    want = sk.scatter_gemm_plain(g, m, list(range(k)), w, s_in, s_in - 1)
    assert not got[0].any()
    assert got[2, :3].abs().min() > 0 and not got[2, 3:].any()
    _card_close(got, want, "all pad / repeats")


@pytest.mark.cuda
def test_scatter_gemm_splits_small_grids(card):
    """The deep levels' grids fall below GEMM_BLOCKS and take splits of
    their (tap, Cout chunk) steps; a listed subset of the map's taps."""
    assert sk._scatter_splits(6, 174, 512, 27 * 16) > 1
    assert sk._scatter_splits(6, 174, 1024, 1 * 64) > 1
    gen = torch.Generator().manual_seed(9)
    m, order = _random_map(gen, 30, 2, 150, 160, 0.4, card)
    g = torch.randn(2, 150, 256, generator=gen).to(card)
    w = torch.randn(12, 128, 256, generator=gen).to(card)
    taps = list(range(3, 27, 2))
    assert sk._scatter_splits(2, 150, 128, len(taps) * 8) > 1
    got = sk.scatter_gemm(g, m, taps, w, 160, 159, order)
    _card_close(got, sk.scatter_gemm_plain(g, m, taps, w, 160, 159), "splits")
