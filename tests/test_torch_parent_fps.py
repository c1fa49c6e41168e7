"""The up order that ``parent_gemm`` tiles its rows in, the kernel's
``skip``, and furthest point sampling.

On the CPU: every pyramid with a parent map (chunked, voxel and the flat
levels of brick:2) carries its up order (``topology.up_order``), per chunk
a permutation of the fine rows sorted stably by offset with the rows whose
parent is the coarse pad row last, and ``check_pyramid_bounds`` refuses one
that is not; ``parent_gemm_plain`` with that order and the ``skip`` each
caller passes against JAX on pyramids whose truncation orphans fine voxels:
K3's forward (``skip = S_c - 1``) and K2's dF (``skip = -1``, with a
cotangent whose coarse pad row is not zero, which the orphans read), and
K2's dF with ``skip = S_c - 1`` differing from JAX at the orphans;
``furthest_point_sample_plain`` index for index against JAX on a cloud of
duplicates, at ``npoint > N`` and at B = 3.
On a card (``cuda``-marked): the ``parent_gemm`` kernel against its twin
with and without the order, both ``skip`` values, Cout tiles of 32 to 96,
ragged widths and the offset split of small grids, the same bits from two
launches; the FPS kernel index for index against its twin at every cluster
size the wrapper takes, the shared-memory form included.

Tolerances: against JAX (f32, "highest" matmul precision), 1e-5 of the
largest entry: both sides sum the same products in other orders.  On the
card, ``parent_gemm`` to ATOL + RTOL times the largest entry (the bound
``chip_smoke.py`` holds it to); FPS exact.

JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_parent_fps.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    check_pyramid_bounds,
    collate_pair,
)
from pointcontrast_tpu_torch.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid, up_order

NB = 3
TRUNCATING = [660, 300, 120, 45]  # every level past 0 drops coarse voxels
ROOMY = [1800, 1800, 1200, 600]
TOL = 1e-5
ATOL, RTOL = 1e-5, 1e-4
KINDS = ["chunked", "chunked truncated", "flat", "flat truncated", "brick:2"]


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _pyramid(kind):
    """(host pyramid, chunks) of a kind in KINDS: flat maps are one chunk."""
    npads = TRUNCATING if kind.endswith("truncated") else ROOMY
    if kind.startswith("chunked"):
        return build_chunked_pyramid(_coords(), 4, npads, num_batch=NB)[0], NB
    if kind.startswith("flat"):
        return build_pyramid(_coords(), 4, npads=npads, num_batch=NB)[0], 1
    ds = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0, seed=0)
    return collate_pair([ds[0]], PadScheme(npad0=4096), npos=64,
                        rng=np.random.RandomState(7), layout="brick:2").pyramid0, 1


def _up_levels(kind):
    """[(level, parent, off, order, down, valid_f, valid_c)] of every level
    with a parent map and an up order, as [B, S] int32 / bool numpy (flat
    maps as B = 1; ``down`` the [8, B, S_c] down map)."""
    pyr, b_ = _pyramid(kind)
    out = []
    for l, (lv, lv1) in enumerate(zip(pyr.levels, pyr.levels[1:])):
        if lv.up_offset is None:  # a brick level: its up conv is a gather
            assert lv.up_order is None
            continue
        rows = lambda a: np.asarray(a).astype(np.int32).reshape(b_, -1)  # noqa: E731
        out.append((l, rows(lv.up_parent), rows(lv.up_offset), rows(lv.up_order),
                    np.asarray(lv.down_nbr).astype(np.int32).reshape(8, b_, -1),
                    np.asarray(lv.valid).reshape(b_, -1) > 0,
                    np.asarray(lv1.valid).reshape(b_, -1) > 0))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_up_order_is_offset_major(kind):
    """Per chunk the up order is a permutation of the fine rows; along it
    the offsets never decrease, the rows whose parent is the coarse pad row
    (pad rows and orphans) come last, and rows of one offset keep their own
    order (a stable sort), as ``topology.up_order`` builds it."""
    pyr, _ = _pyramid(kind)
    check_pyramid_bounds(pyr)
    levels = _up_levels(kind)
    assert levels
    for _, parent, off, order, _, valid_f, valid_c in levels:
        pad = valid_c.shape[1] - 1
        for b in range(parent.shape[0]):
            o = order[b]
            assert np.array_equal(np.sort(o), np.arange(o.size))
            key = np.where(parent[b] == pad, 8, off[b])[o]
            assert (np.diff(key) >= 0).all()
            for k in np.unique(key):
                assert (np.diff(o[key == k]) > 0).all()
            assert np.array_equal(o, up_order(parent[b], off[b], pad))
            assert (key[valid_f[b][o] & (parent[b][o] != pad)] < 8).all()


@pytest.mark.parametrize("kind", ["chunked", "flat"])
def test_bounds_refuse_a_broken_up_order(kind):
    """The host check refuses an up order that is not a permutation of the
    fine rows (the kernel writes the row each entry names) or has another
    shape than the parent map, a [B, S] or [N] vector, not a map."""
    pyr, _ = _pyramid(kind)
    lv = pyr.levels[1]
    good = lv.up_order.copy()
    lv.up_order[..., 0] = lv.up_order[..., 1]
    with pytest.raises(ValueError, match="level 1 up_order: not a permutation"):
        check_pyramid_bounds(pyr)
    lv.up_order = good[..., :-1]
    with pytest.raises(ValueError, match="level 1 up_order: shape"):
        check_pyramid_bounds(pyr)
    lv.up_order = good
    check_pyramid_bounds(pyr)


@pytest.fixture(scope="module")
def jax_ops():
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.detect import ops as jdet
    from pointcontrast_tpu.sparse import ops as jops

    def k3(f, parent, off, w):
        """JAX's sparse_conv_transpose: [B, S_f] maps the chunked form, a
        flat [1, N] one the flat form."""
        p, o = (parent[0], off[0]) if parent.shape[0] == 1 else (parent, off)
        with jax.default_matmul_precision("highest"):
            return np.asarray(jops.sparse_conv_transpose(
                jnp.asarray(f), jnp.asarray(p), jnp.asarray(o), jnp.asarray(w)))

    def k2_df(f, down, parent, off, w, ct):
        """dF of JAX's chunked k2s2 down conv (``_conv_chunk_down2``, the
        gather through the parent map), a flat map taken as one chunk."""
        with jax.default_matmul_precision("highest"):
            _, vjp = jax.vjp(lambda f: jops.sparse_conv(
                f, jnp.asarray(down), jnp.asarray(w),
                up=(jnp.asarray(parent), jnp.asarray(off))), jnp.asarray(f))
            return np.asarray(vjp(jnp.asarray(ct))[0])

    def fps(xyz, npoint):
        return np.asarray(jdet.furthest_point_sample(jnp.asarray(xyz), npoint))

    return {"k3": k3, "k2_df": k2_df, "fps": fps}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())


def _orphans(parent, valid_f, valid_c):
    return valid_f & (parent == valid_c.shape[1] - 1)


def _level(kind, level):
    lv = [x for x in _up_levels(kind) if x[0] == level]
    assert lv
    return lv[0][1:]


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k3_forward_with_skip_and_order_matches_jax(jax_ops, kind, level):
    """K3's forward passes the coarse pad row as ``skip`` and the up order:
    every fine row, the orphans (whose parent is that row, with zero
    features) included, equals JAX's, and the skipped rows are exact
    zeros; through ``sparse_conv_transpose`` too."""
    parent, off, order, _, valid_f, valid_c = _level(kind, level)
    assert _orphans(parent, valid_f, valid_c).any(), "no orphans"
    b_, s_c = valid_c.shape
    rng = np.random.RandomState(20 + level)
    cin, cout = 6, 5
    f = (rng.randn(valid_c.size, cin) * valid_c.reshape(-1, 1)).astype(np.float32)
    w = (rng.randn(8, cin, cout) * 0.3).astype(np.float32)
    want = k3 = jax_ops["k3"](f, parent, off, w).reshape(b_, -1, cout)
    tp, to, tord = (torch.from_numpy(a) for a in (parent, off, order))
    got = sk.parent_gemm_plain(torch.from_numpy(f).reshape(b_, s_c, cin), tp, to,
                               torch.from_numpy(w), s_c - 1, tord).numpy()
    _close(got, want)
    assert not got[parent == s_c - 1].any()
    flat = lambda a: a[0] if b_ == 1 else a  # noqa: E731
    out = tops.sparse_conv_transpose(torch.from_numpy(f), flat(tp), flat(to),
                                     torch.from_numpy(w), up_order=flat(tord))
    _close(out.numpy(), k3.reshape(-1, cout))


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k2_df_without_skip_matches_jax_at_orphans(jax_ops, kind, level):
    """K2's dF passes ``skip = -1``: with a cotangent whose coarse pad row
    is not zero, JAX gives each orphaned fine voxel ``ct[pad] W_0^T``, and
    so do ``parent_gemm_plain`` and the port's K2 backward (with the up
    order), at every valid fine row."""
    parent, off, order, down, valid_f, valid_c = _level(kind, level)
    orphan = _orphans(parent, valid_f, valid_c)
    assert orphan.any(), "no orphans"
    b_, s_f = valid_f.shape
    s_c = valid_c.shape[1]
    rng = np.random.RandomState(30 + level)
    cin, cout = 6, 5
    f = (rng.randn(valid_f.size, cin) * valid_f.reshape(-1, 1)).astype(np.float32)
    w = (rng.randn(8, cin, cout) * 0.3).astype(np.float32)
    ct = rng.randn(valid_c.size, cout).astype(np.float32)  # pad rows too
    want = jax_ops["k2_df"](f, down, parent, off, w, ct).reshape(b_, s_f, cin)
    assert np.abs(want[orphan]).max() > 0
    tp, to, tord = (torch.from_numpy(a) for a in (parent, off, order))
    wt = torch.from_numpy(w).transpose(1, 2).contiguous()
    got = sk.parent_gemm_plain(torch.from_numpy(ct).reshape(b_, s_c, cout), tp, to, wt,
                               -1, tord).numpy()
    _close(got[valid_f], want[valid_f])
    ft = torch.from_numpy(f).requires_grad_(True)
    flat = (lambda a: a[0]) if kind.startswith("flat") else (lambda a: a)
    dn = torch.from_numpy(down[:, 0] if kind.startswith("flat") else down)
    out = tops.sparse_conv(ft, dn, torch.from_numpy(w),
                           up=(flat(tp), flat(to), flat(tord)))
    out.backward(torch.from_numpy(ct))
    _close(ft.grad.numpy().reshape(b_, s_f, cin)[valid_f], want[valid_f])


@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k2_df_with_the_pad_row_skipped_would_differ_at_orphans(jax_ops, kind):
    """Why K2's dF may not skip the coarse pad row: its cotangent there is
    zero only through the conv's output mask, and an orphan reads it, so
    ``skip = S_c - 1`` zeroes rows that JAX does not."""
    parent, off, order, down, valid_f, valid_c = _level(kind, 1)
    orphan = _orphans(parent, valid_f, valid_c)
    b_, s_f = valid_f.shape
    s_c = valid_c.shape[1]
    rng = np.random.RandomState(40)
    f = (rng.randn(valid_f.size, 4) * valid_f.reshape(-1, 1)).astype(np.float32)
    w = (rng.randn(8, 4, 3) * 0.3).astype(np.float32)
    ct = rng.randn(valid_c.size, 3).astype(np.float32)
    want = jax_ops["k2_df"](f, down, parent, off, w, ct).reshape(b_, s_f, 4)
    wt = torch.from_numpy(w).transpose(1, 2).contiguous()
    ct3 = torch.from_numpy(ct).reshape(b_, s_c, 3)
    args = (torch.from_numpy(parent), torch.from_numpy(off), wt)
    skipped = sk.parent_gemm_plain(ct3, *args, s_c - 1, torch.from_numpy(order)).numpy()
    kept = sk.parent_gemm_plain(ct3, *args, -1, torch.from_numpy(order)).numpy()
    assert not skipped[orphan].any()
    assert np.abs(want[orphan]).min() > 0
    _close(kept[orphan], want[orphan])
    inner = valid_f & ~orphan
    np.testing.assert_array_equal(skipped[inner], kept[inner])


def test_parent_gemm_wrapper_on_the_cpu():
    """On a CPU tensor the wrapper is its twin, order and skip included (an
    order changes no row), and it refuses an order of another shape."""
    rng = np.random.RandomState(2)
    b_, s_c, s_f, cin, cout = 2, 9, 30, 5, 7
    x = torch.from_numpy(rng.randn(b_, s_c, cin).astype(np.float32))
    parent = torch.from_numpy(rng.randint(0, s_c, (b_, s_f)).astype(np.int32))
    off = torch.from_numpy(rng.randint(0, 8, (b_, s_f)).astype(np.int32))
    w = torch.from_numpy(rng.randn(8, cin, cout).astype(np.float32))
    order = torch.stack([torch.randperm(s_f, generator=torch.Generator().manual_seed(b))
                         for b in range(b_)]).int()
    plain = sk.parent_gemm_plain(x, parent, off, w)
    torch.testing.assert_close(sk.parent_gemm(x, parent, off, w, -1, order), plain,
                               rtol=0, atol=0)
    got = sk.parent_gemm(x, parent, off, w, 3, order)
    torch.testing.assert_close(got[parent != 3], plain[parent != 3], rtol=0, atol=0)
    assert not got[parent == 3].any() and (parent == 3).any()
    with pytest.raises(ValueError, match="order: shape"):
        sk.parent_gemm(x, parent, off, w, -1, order[:, 1:])


def _dup_cloud(rng, b_, distinct, n, scale=3.0):
    """[B, n, 3] f32 clouds of ``distinct`` points each present several
    times in a random order: the argmax ties at most picks."""
    out = np.empty((b_, n, 3), np.float32)
    for b in range(b_):
        base = (rng.rand(distinct, 3) * scale).astype(np.float32)
        out[b] = base[rng.permutation(np.arange(n) % distinct)]
    return out


@pytest.mark.parametrize("b_,distinct,n,npoint", [
    (2, 100, 400, 150),  # each point 4 times: ties at every pick past 100
    (2, 6, 6, 15),       # npoint > N: every distance ends at 0, the rest index 0
    (3, 250, 250, 64),   # B = 3
])
def test_fps_plain_matches_jax(jax_ops, b_, distinct, n, npoint):
    xyz = _dup_cloud(np.random.RandomState(n + b_), b_, distinct, n)
    got = dk.furthest_point_sample_plain(torch.from_numpy(xyz), npoint)
    np.testing.assert_array_equal(got.numpy(), jax_ops["fps"](xyz, npoint))
    if npoint > n:
        assert not got[:, n:].any()


# --------------------------------------------------------------------------
# on the card


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _card_close(got, want, what):
    err = float((got.double() - want.double()).abs().max())
    ref = float(want.double().abs().max())
    assert err <= ATOL + RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(32, 32), (96, 96), (256, 128), (37, 45), (64, 200)])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat"])
def test_parent_gemm_kernel_matches_twin(card, kind, cin, cout):
    """Every level's parent map, with the up order and without it, at both
    ``skip`` values, on a feature table with a non-zero pad row: the kernel
    against its twin, and two launches bit-equal.  The small pyramids give
    small grids, so the wrapper splits their offsets over blocks."""
    gen = torch.Generator(device=card).manual_seed(cin + cout)
    sk.reset_launches()
    n = 0
    for _, parent, off, order, _, _, valid_c in _up_levels(kind):
        b_, s_c = valid_c.shape
        p, o, od = (torch.from_numpy(a).to(card) for a in (parent, off, order))
        x = torch.randn(b_, s_c, cin, device=card, generator=gen)
        w = torch.randn(8, cin, cout, device=card, generator=gen)
        for skip in (-1, s_c - 1):
            for ordr in (od, None):
                got = sk.parent_gemm(x, p, o, w, skip, ordr)
                want = sk.parent_gemm_plain(x, p, o, w, skip)
                _card_close(got, want, f"{kind} S_c {s_c} skip {skip}")
                assert torch.equal(got, sk.parent_gemm(x, p, o, w, skip, ordr))
                if skip >= 0:
                    assert not got[p == skip].any()
                n += 2
    assert sk.parent_gemm.launches == n


@pytest.mark.cuda
def test_parent_gemm_kernel_at_a_large_grid(card):
    """A grid wide enough for one block a tile (no split), the up order of
    random parents, a ragged Cin that takes the 4-byte copies."""
    gen = torch.Generator(device=card).manual_seed(0)
    b_, s_c, s_f, cin, cout = 4, 3000, 20000, 35, 96
    parent = torch.randint(0, s_c, (b_, s_f), device=card, generator=gen, dtype=torch.int32)
    off = torch.randint(0, 8, (b_, s_f), device=card, generator=gen, dtype=torch.int32)
    order = torch.stack([torch.from_numpy(up_order(parent[b].cpu().numpy(),
                                                   off[b].cpu().numpy(), s_c - 1))
                         for b in range(b_)]).to(card)
    x = torch.randn(b_, s_c, cin, device=card, generator=gen)
    w = torch.randn(8, cin, cout, device=card, generator=gen)
    got = sk.parent_gemm(x, parent, off, w, s_c - 1, order)
    _card_close(got, sk.parent_gemm_plain(x, parent, off, w, s_c - 1), "large grid")


@pytest.mark.cuda
@pytest.mark.parametrize("b_,distinct,n,npoint", [
    (8, 2000, 8000, 512),     # cluster of 4, ties everywhere
    (8, 6144, 6144, 256),     # one CTA, 6 points a thread
    (8, 1024, 1024, 512),     # one CTA, 1 point a thread
    (3, 20000, 40000, 256),   # B = 3, the largest cluster that fits
    (2, 7, 7, 20),            # npoint > N
    (1, 100000, 100000, 32),  # past the registers: the shared-memory form
])
def test_fps_kernel_matches_twin(card, b_, distinct, n, npoint):
    xyz = torch.from_numpy(_dup_cloud(np.random.RandomState(n), b_, distinct, n,
                                      scale=8.0)).to(card)
    dk.reset_launches()
    got = dk.furthest_point_sample(xyz, npoint)
    torch.testing.assert_close(got, dk.furthest_point_sample_plain(xyz, npoint),
                               rtol=0, atol=0)
    assert torch.equal(got, dk.furthest_point_sample(xyz, npoint))
    assert dk.furthest_point_sample.launches == 2


@pytest.mark.cuda
def test_fps_cluster_sizes(card):
    """The cluster the wrapper takes: one CTA while its registers hold the
    cloud (6 points a thread), then at least 1024 points a CTA while the
    batch's clusters fit on the card at once, at most 16."""
    dev = card.index or 0
    assert dk.fps_cluster(8, 1024, dev) == 1
    assert dk.fps_cluster(8, 6144, dev) == 1
    assert dk.fps_cluster(8, 8000, dev) == 4
    assert dk.fps_cluster(8, 40000, dev) in (8, 16)
    assert dk.fps_cluster(3, 40000, dev) == 16
