"""K3's backward through the down map.

``ops._ConvTrChunk`` (K3, the k2s2 transposed conv) differentiates as K2's
forward transposed: dF[b,p] = sum_k ct[b, down[k,b,p]] W_k^T and dW_k =
sum_p F[b,p]^T ct[b, down[k,b,p]], gathered through ``down``, the down map
of the level the conv produces (``gather_gemm`` / ``gather_wgrad`` and
their bf16 forms, the fine pad row skipped), in place of JAX's scatter of
the cotangent into a stacked [8 S_c, Cout] table.  That holds only while
the down map is the exact inverse of the parent map (``up_parent``,
``up_offset``) below the pad rows.  Here:

  - the inverse property for every pyramid builder of the port (chunked and
    flat, each with and without truncation, the flat levels past the
    brick ones of a ``brick:2`` pyramid, and the 4-D ST nets' flat hybrid
    pyramids, whose (2, 2, 2, 1) down maps have 8 children and never halve
    time, with and without truncation), and the map ``ops.down_from_up``
    derives from the parent map (what ``sparse_conv_transpose`` gathers
    through when no ``down`` is passed) equal to the pyramid's;
  - dF and dW the same bit for bit through the pyramid's map and the
    derived one, f32 and bf16;
  - against ``jax.vjp`` of JAX's ``sparse_conv_transpose`` (the chunked
    ``_conv_tr_chunk``, the flat scan form), with orphans (fine voxels
    whose coarse parent truncation dropped) and a cotangent that is not
    zero at the fine pad rows: f32 dF at the valid coarse rows and dW within
    1e-5 of JAX's largest entry; bf16 dF within
    ``kernels.gather_gemm_bf16_bound`` of its exact (f64) sum, computed
    here as JAX's scatter, and within 2^-7 of JAX's largest entry, dW
    within 2^-7 of it (both sides round the same f32 sums, added in other
    orders); the port's dF exactly zero at every coarse pad row (JAX's
    holds the orphans' and pad rows' sum at the last one).

On a card (``cuda``-marked): one launch each of the gather_gemm and
gather_wgrad of the features' dtype and none of scatter_parent, through
either map, dF and dW against the twins'.  Sizes as
``tests/test_chunked.py``'s: three samples of 150-220 voxels.  JAX is
imported inside a fixture, so the card's machine, which has none, runs the
``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_k3_down_bwd.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import HYBRID_4D, build_pyramid

NB = 3
TRUNCATING = [660, 300, 120, 45]  # every level past 0 drops coarse voxels
ROOMY = [1800, 1800, 1200, 600]
TRUNCATING_4D = [900, 500, 150, 40]  # every level past 0 drops coarse voxels
ROOMY_4D = [1800, 1800, 1200, 600]
KINDS = ["chunked", "chunked truncated", "flat", "flat truncated", "brick:2", "flat 4-D",
         "flat 4-D truncated"]
F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
BF = torch.bfloat16


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _coords4(seed=0, n=(320, 260, 300), extent=12, frames=3):
    """NB samples of 4-D [b, x, y, z, t] points, t < ``frames``."""
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3 * frames, k, replace=False)
        xyzt = np.stack(np.unravel_index(flat, (extent,) * 3 + (frames,)), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyzt], axis=1))
    return np.concatenate(out).astype(np.int32)


def _levels(kind):
    """[dict(parent, offset, up_order [B, S_f], down [8, B, S_c], down_order
    [B, S_c] int32 tensors, valid_f [B, S_f], valid_c [B, S_c] bool)], one a
    level at which K3 runs (flat maps as B = 1, as the ops take them)."""
    if kind.startswith("chunked"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_chunked_pyramid(_coords(), 4, npads, num_batch=NB)[0].levels
    elif kind.startswith("flat 4-D"):
        npads = TRUNCATING_4D if kind.endswith("truncated") else ROOMY_4D
        levels = build_pyramid(_coords4(), 4, npads=npads, num_batch=NB,
                               **HYBRID_4D.pyramid_kwargs())[0].levels
    elif kind.startswith("flat"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_pyramid(_coords(), 4, npads=npads, num_batch=NB)[0].levels
    else:  # brick:2: K3 runs on the flat levels past the brick ones
        ds = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0,
                                  seed=0)
        levels = collate_pair([ds[0]], PadScheme(npad0=4096), npos=64,
                              rng=np.random.RandomState(7),
                              layout="brick:2").pyramid0.levels
    out = []
    for lv, lv1 in zip(levels, levels[1:]):
        if lv.up_offset is None:  # a brick level: its up conv is a gather
            continue
        b_ = lv.down_nbr.shape[1] if lv.down_nbr.ndim == 3 else 1

        def t(a, rows):
            return torch.from_numpy(np.asarray(a).astype(np.int32).reshape(rows, b_, -1))

        out.append(dict(parent=t(lv.up_parent, 1)[0], offset=t(lv.up_offset, 1)[0],
                        up_order=t(lv.up_order, 1)[0], down=t(lv.down_nbr, 8),
                        down_order=t(lv.down_order, 1)[0],
                        valid_f=torch.from_numpy(np.asarray(lv.valid).reshape(b_, -1) > 0),
                        valid_c=torch.from_numpy(np.asarray(lv1.valid).reshape(b_, -1) > 0)))
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_down_map_is_the_parent_maps_inverse(kind):
    """Every fine row whose parent is not the coarse pad row is the down
    map's entry at its (offset, parent) slot, and every entry that is not
    the fine pad row names such a row at that slot: no valid coarse row
    reads a pad or orphaned fine row, and the coarse pad rows read only the
    fine pad row.  ``down_from_up`` gives the same map, entry for entry."""
    levels = _levels(kind)
    assert levels
    orphans = 0
    for lv in levels:
        parent, off, down = lv["parent"].long(), lv["offset"].long(), lv["down"].long()
        b_, s_f = parent.shape
        s_c = down.shape[2]
        kept = parent != s_c - 1
        assert not kept[~lv["valid_f"]].any() and not lv["valid_c"][:, -1].any()
        for b in range(b_):
            i = torch.nonzero(kept[b])[:, 0]
            assert torch.equal(down[off[b, i], b, parent[b, i]], i)
            k, p = torch.nonzero(down[:, b] != s_f - 1, as_tuple=True)
            named = down[k, b, p]
            assert named.numel() == i.numel()
            assert torch.equal(parent[b, named], p) and torch.equal(off[b, named], k)
            assert (down[:, b, ~lv["valid_c"][b]] == s_f - 1).all()
        orphans += int((~kept & lv["valid_f"]).sum())
        derived = tops.down_from_up(lv["parent"], lv["offset"], 8, s_c)
        assert derived.dtype == torch.int32 and torch.equal(derived, lv["down"])
    assert (orphans > 0) == kind.endswith("truncated")


def _inputs(lv, dtype, seed, cin=6, cout=5):
    """(features masked by the coarse valid rows, weights, a cotangent that
    is not zero at any fine row, the pad rows included), flat [B S, C]."""
    rng = np.random.RandomState(seed)
    valid_c = lv["valid_c"].reshape(-1, 1)
    f = torch.from_numpy(rng.randn(valid_c.shape[0], cin).astype(np.float32)) * valid_c
    w = torch.from_numpy((0.3 * rng.randn(8, cin, cout)).astype(np.float32))
    ct = torch.from_numpy(rng.randn(lv["parent"].numel(), cout).astype(np.float32))
    return f.to(dtype), w.to(dtype), ct.to(dtype)


def _port(lv, f, w, ct, down=True):
    """(dF, dW) of the port's sparse_conv_transpose, through the pyramid's
    down map and live order or (``down=False``) the derived map."""
    flat = lv["parent"].shape[0] == 1
    maps = [lv["parent"], lv["offset"], lv["up_order"]]
    d = (lv["down"][:, 0], lv["down_order"][0]) if flat else (lv["down"], lv["down_order"])
    if flat:
        maps = [m[0] for m in maps]
    ft, wt = f.clone().requires_grad_(), w.clone().requires_grad_()
    tops.sparse_conv_transpose(ft, maps[0], maps[1], wt, up_order=maps[2],
                               down=d if down else None).backward(ct)
    return ft.grad, wt.grad


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", KINDS)
def test_pyramid_and_derived_maps_give_the_same_gradients(kind, dtype):
    for n, lv in enumerate(_levels(kind)):
        f, w, ct = _inputs(lv, dtype, seed=n)
        (df, dw), (df2, dw2) = _port(lv, f, w, ct), _port(lv, f, w, ct, down=False)
        assert df.dtype == dw.dtype == dtype
        assert torch.equal(df, df2) and torch.equal(dw, dw2)
        assert df.float().abs().max() > 0 and dw.float().abs().max() > 0


@pytest.fixture(scope="module")
def jax_k3():
    """(dF, dW) of ``jax.vjp`` of JAX's sparse_conv_transpose, f32 numpy:
    chunked [B, S_f] maps take ``_conv_tr_chunk``, flat ones the scan form;
    bf16 inputs run JAX's bf16 mode."""
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import ops as jops

    def j(t):
        a = t.float().numpy() if t.is_floating_point() else t.numpy()
        return jnp.asarray(a, jnp.bfloat16 if t.dtype == BF else None)

    def run(lv, f, w, ct):
        flat = lv["parent"].shape[0] == 1
        p, o = (lv["parent"][0], lv["offset"][0]) if flat else (lv["parent"], lv["offset"])
        with jax.default_matmul_precision("highest"):
            _, vjp = jax.vjp(lambda f, w: jops.sparse_conv_transpose(f, j(p), j(o), w),
                             j(f), j(w))
            df, dw = vjp(j(ct))
        return (np.asarray(jnp.asarray(df, jnp.float32)),
                np.asarray(jnp.asarray(dw, jnp.float32)))

    return run


def _within(got, want, rtol, what):
    err = float(np.abs(got - want).max())
    ref = float(np.abs(want).max())
    assert ref > 0 and err <= rtol * ref, f"{what}: {err:.3e} of {ref:.3e}"


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated", "brick:2"])
def test_k3_backward_matches_jax_f32(jax_k3, kind, level):
    """f32: dF at the valid coarse rows and dW within 1e-5 of JAX's largest
    entry, with orphans (the truncated kinds) and a cotangent at the fine
    pad rows; the port's dF zero at every coarse pad row."""
    lv = _levels(kind)[level]
    if kind.endswith("truncated"):
        orphaned = lv["valid_f"] & (lv["parent"] == lv["valid_c"].shape[1] - 1)
        assert orphaned.any(), "no orphans"
    f, w, ct = _inputs(lv, torch.float32, seed=10 + level)
    df, dw = _port(lv, f, w, ct)
    jdf, jdw = jax_k3(lv, f, w, ct)
    valid = lv["valid_c"].reshape(-1)
    _within(df[valid].numpy(), jdf[valid.numpy()], F32_RTOL, "dF")
    _within(dw.numpy(), jdw, F32_RTOL, "dW")
    assert not df[~valid].any() and np.abs(jdf[~valid.numpy()]).max() > 0


def _exact_df(lv, w, ct):
    """JAX's dF as its scatter form, in f64: each fine row whose parent is
    not the coarse pad row adds ct W_offset^T into its parent row; and the
    sum of the magnitudes of the same products.  [B S_c, Cin] each."""
    parent, off = lv["parent"].long(), lv["offset"].long()
    b_, s_f = parent.shape
    s_c = lv["down"].shape[2]
    kept = (parent != s_c - 1).reshape(-1)
    rows = (parent + s_c * torch.arange(b_)[:, None]).reshape(-1)[kept]
    ct64, w64 = ct.double()[kept], w.double().transpose(1, 2)
    o = off.reshape(-1)[kept]
    prod = torch.einsum("nd,ndc->nc", ct64, w64[o])
    size = torch.einsum("nd,ndc->nc", ct64.abs(), w64.abs()[o])
    zeros = torch.zeros(b_ * s_c, w.shape[1], dtype=torch.float64)
    return zeros.index_add(0, rows, prod), zeros.index_add(0, rows, size)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated", "brick:2"])
def test_k3_backward_matches_jax_bf16(jax_k3, kind, level):
    """bf16 (JAX's mixed precision: bf16 features, weights and cotangent):
    dF one rounding of the f32 sum, within ``gather_gemm_bf16_bound`` of
    the exact sum of JAX's scatter form at every valid coarse row and within
    2^-7 of JAX's largest entry; dW within 2^-7 of JAX's; dF zero at the
    coarse pad rows."""
    lv = _levels(kind)[level]
    f, w, ct = _inputs(lv, BF, seed=20 + level, cin=16, cout=24)
    df, dw = _port(lv, f, w, ct)
    assert df.dtype == dw.dtype == BF
    jdf, jdw = jax_k3(lv, f, w, ct)
    valid = lv["valid_c"].reshape(-1)
    _within(df[valid].float().numpy(), jdf[valid.numpy()], BF16_RTOL, "dF")
    _within(dw.float().numpy(), jdw, BF16_RTOL, "dW")
    assert not df[~valid].float().any()
    b_, s_f = lv["parent"].shape
    s_c = lv["down"].shape[2]
    ref, bound = sk.gather_gemm_bf16_bound(
        ct.reshape(b_, s_f, -1), lv["down"], range(8), 0, w.transpose(1, 2), None, s_c,
        s_f - 1, lv["down_order"])
    exact, size = _exact_df(lv, w, ct)
    ref, bound = ref.reshape(exact.shape), bound.reshape(exact.shape)
    np.testing.assert_allclose(ref.numpy(), exact.numpy(), rtol=0,
                               atol=1e-12 * float(size.max()))
    assert sk.bound_ratio(df[valid], exact[valid], bound[valid]) <= 1.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k3_backward_launches_the_gathers_on_card(kind, dtype):
    """On the card, K3's backward at each level launches one gather_gemm
    and one gather_wgrad of its dtype's form (the bf16 ones on the tensor
    cores) and no scatter_parent, through the pyramid's map and the derived
    one; dF and dW against the twins' (the CPU's): f32 within 1e-4 of the
    largest entry, bf16 within 2^-7 (two bf16 ulps: the sums run in another
    order)."""
    dev = _card()
    sfx = "_bf16" if dtype == BF else ""
    for n, lv in enumerate(_levels(kind)):
        f, w, ct = _inputs(lv, dtype, seed=30 + n, cin=32, cout=40)
        want = _port(lv, f, w, ct)
        lv_dev = {k: v.to(dev) for k, v in lv.items()}
        for down in (True, False):
            sk.reset_launches()
            got = _port(lv_dev, f.to(dev), w.to(dev), ct.to(dev), down=down)
            torch.cuda.synchronize()
            counts = {k: v for k, v in sk.launch_counts().items() if v}
            assert counts == {f"parent_gemm{sfx}": 1, f"gather_gemm{sfx}": 1,
                              f"gather_wgrad{sfx}": 1}, counts
            for g, w_ in zip(got, want):
                _within(g.cpu().float().numpy(), w_.float().numpy(),
                        1e-4 if dtype == torch.float32 else BF16_RTOL, "card")
