"""K3's backward scatter ``sparse.kernels.scatter_parent`` and K9's backward
``detect.kernels.three_interpolate_grad``.  On the CPU: on pyramids whose
truncation orphans fine voxels, the port's K3 backward (the scatter leaves
out the coarse pad slot) against ``jax.vjp`` of JAX's
``sparse_conv_transpose``, chunked and flat: dF at the valid coarse rows
and dW everywhere; on chunked, flat and brick:2 pyramids, every fine row
that the scatter keeps names its own (offset, parent) slot, so its stores
never race; both wrappers refuse index spaces of 2^31 or more, and
``three_interpolate_grad`` a sample whose index entries do not fit in a
block's shared memory.
On a card (``cuda``-marked): ``scatter_parent`` bit for bit against its
twin with pad and orphan rows present, and ``three_interpolate_grad``
against its twin, with known rows that no unknown point names (exact
zeros) and with every unknown point naming one known row.

Tolerances: against JAX (f32, "highest" matmul precision), 1e-5 of the
largest entry: both sides sum the same products in other orders.  On the
card, ``scatter_parent`` exact (each kept row is stored once, as the twin
adds it once to a zero), ``three_interpolate_grad`` to ATOL + RTOL times
the largest entry (the twin adds with atomics on the card), the bound
``chip_smoke.py`` holds it to.

JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_parent_interp.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu_torch.detect import kernels as dk
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid

NB = 3
TRUNCATING = [660, 300, 120, 45]  # every level past 0 drops coarse voxels
ROOMY = [1800, 1800, 1200, 600]
ATOL, RTOL = 1e-5, 1e-4


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _k3_levels(kind):
    """[(parent [B, S_f], offset [B, S_f], fine valid [B, S_f], coarse valid
    [B, S_c])] int32 / bool numpy, one a level at which K3 runs (flat maps
    as B = 1)."""
    if kind.startswith("chunked"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_chunked_pyramid(_coords(), 4, npads, num_batch=NB)[0].levels
        b_ = NB
    elif kind.startswith("flat"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_pyramid(_coords(), 4, npads=npads, num_batch=NB)[0].levels
        b_ = 1
    else:  # brick:2: K3 runs on the flat levels past the brick ones
        ds = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0,
                                  seed=0)
        levels = collate_pair([ds[0]], PadScheme(npad0=4096), npos=64,
                              rng=np.random.RandomState(7),
                              layout="brick:2").pyramid0.levels
        b_ = 1
    out = []
    for lv, lv1 in zip(levels, levels[1:]):
        if lv.up_offset is None:  # a brick level: its up conv is a gather
            continue
        out.append((np.asarray(lv.up_parent).astype(np.int32).reshape(b_, -1),
                    np.asarray(lv.up_offset).astype(np.int32).reshape(b_, -1),
                    np.asarray(lv.valid).reshape(b_, -1) > 0,
                    np.asarray(lv1.valid).reshape(b_, -1) > 0))
    return out


@pytest.mark.parametrize("kind", ["chunked", "chunked truncated", "flat",
                                  "flat truncated", "brick:2"])
def test_kept_fine_rows_name_distinct_slots(kind):
    """Every fine row whose parent is not the coarse pad row names its own
    ``off * S_c + parent``, so the kernel's stores never meet; the rows
    left out are the pad rows and the orphans, and the pad slot holds no
    valid coarse voxel."""
    levels = _k3_levels(kind)
    assert levels
    orphans = 0
    for parent, off, valid_f, valid_c in levels:
        s_c = valid_c.shape[1]
        kept = parent < s_c - 1
        assert not valid_c[:, -1].any()
        assert not kept[~valid_f].any(), "pad fine rows name the pad slot"
        for b in range(parent.shape[0]):
            slots = off[b][kept[b]] * s_c + parent[b][kept[b]]
            assert np.unique(slots).size == slots.size
            assert ((0 <= off[b]) & (off[b] < 8)).all()
        orphans += int((~kept & valid_f).sum())
    assert (orphans > 0) == kind.endswith("truncated")


@pytest.fixture(scope="module")
def jax_k3():
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import ops as jops

    def run(f, parent, off, w, ct):
        """(out, dF, dW) of JAX's sparse_conv_transpose: chunked [B, S_f]
        maps take ``_conv_tr_chunk``, flat [N] ones the scan form."""
        flat = parent.shape[0] == 1
        p, o = (parent[0], off[0]) if flat else (parent, off)
        with jax.default_matmul_precision("highest"):
            out, vjp = jax.vjp(lambda f, w: jops.sparse_conv_transpose(
                f, jnp.asarray(p), jnp.asarray(o), w), jnp.asarray(f), jnp.asarray(w))
            df, dw = vjp(jnp.asarray(ct))
        return np.asarray(out), np.asarray(df), np.asarray(dw)

    return run


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k3_backward_with_orphans_matches_jax(jax_k3, kind, level):
    """Truncation sends orphaned fine voxels, whose cotangent is not zero,
    to the coarse pad slot.  JAX adds them there, the port leaves them out:
    dF differs at the coarse pad rows only, dW nowhere (the pad features
    are zero)."""
    parent, off, valid_f, valid_c = _k3_levels(kind)[level]
    assert (valid_f & (parent == valid_c.shape[1] - 1)).any(), "no orphans"
    rng = np.random.RandomState(10 + level)
    cin, cout = 6, 5
    f = rng.randn(valid_c.size, cin).astype(np.float32) * valid_c.reshape(-1, 1)
    w = (rng.randn(8, cin, cout) * 0.3).astype(np.float32)
    ct = rng.randn(valid_f.size, cout).astype(np.float32) * valid_f.reshape(-1, 1)
    jout, jdf, jdw = jax_k3(f, parent, off, w, ct)
    ft = torch.from_numpy(f).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = tops.sparse_conv_transpose(ft, torch.from_numpy(parent),
                                     torch.from_numpy(off), wt)
    out.backward(torch.from_numpy(ct))
    _close(out.detach().numpy(), jout)
    tdf, pad = ft.grad.numpy(), ~valid_c.reshape(-1)
    _close(tdf[~pad], jdf[~pad])
    _close(wt.grad.numpy(), jdw)
    assert not tdf[pad].any() and np.abs(jdf[pad]).max() > 0


def _expanded(*shape, dtype=torch.float32):
    """A tensor of ``shape`` that holds one element (no memory to speak of)."""
    return torch.zeros((1,) * len(shape), dtype=dtype).expand(*shape)


@pytest.mark.parametrize("what", ["ct3", "out"])
def test_scatter_parent_refuses_index_spaces_of_2_31(what):
    ct3, s_c = {
        "ct3": (_expanded(2, 2 ** 15, 2 ** 15), 4),  # B S_f C = 2^31
        "out": (torch.zeros(1, 1, 2 ** 15), 2 ** 13),  # B 8 S_c C = 2^31
    }[what]
    b_, s_f = ct3.shape[:2]
    rows = torch.zeros(b_, s_f, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{what} spans"):
        sk.scatter_parent(ct3, rows, rows, 8, s_c)


@pytest.mark.parametrize("what", ["grad", "out"])
def test_three_interpolate_grad_refuses_index_spaces_of_2_31(what):
    grad, m = {
        "grad": (_expanded(2, 2 ** 15, 2 ** 15), 4),  # B N C = 2^31
        "out": (torch.zeros(1, 1, 2 ** 18), 2 ** 13),  # B m C = 2^31
    }[what]
    b_, n = grad.shape[:2]
    idx = torch.zeros(b_, n, 3, dtype=torch.int32)
    with pytest.raises(ValueError, match=f"{what} spans"):
        dk.three_interpolate_grad(grad, idx, torch.ones(b_, n, 3), m)


def test_three_interpolate_grad_refuses_entries_past_shared_memory():
    """A block keeps a sample's 3 N index entries in its 227 KB of shared
    memory; one unknown point past ``INTERP_MAX_N`` is refused, on either
    device."""
    n = dk.INTERP_MAX_N
    grad, idx, w = torch.ones(1, n + 1, 4), torch.zeros(1, n + 1, 3, dtype=torch.int32), torch.ones(1, n + 1, 3)
    assert dk.three_interpolate_grad(grad[:, :n], idx[:, :n], w[:, :n], 2).shape == (1, 2, 4)
    with pytest.raises(ValueError, match="shared memory"):
        dk.three_interpolate_grad(grad, idx, w, 2)


@pytest.mark.parametrize("n", [1, 512, 1024, 1000, dk.INTERP_MAX_N])
def test_three_interp_entries_cover_the_index_and_fit(n):
    """Each warp's share of the 3 N entries, in whole 32-entry steps; the
    block's lists and counts fit in its shared memory."""
    entries = dk.three_interp_entries(n)
    assert entries % 32 == 0 and dk.INTERP_ROWS * entries >= 3 * n
    assert dk.INTERP_ROWS * (entries - 32) < 3 * n
    assert 4 * dk.INTERP_ROWS * (entries + 65) <= dk.SMEM_PER_BLOCK


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_scatter_parent_bit_exact_on_card():
    """The truncated chunked and flat maps (pad and orphan rows present,
    every cotangent row non-zero) at C 3 (a lane a row), 32, 96, 128
    (float4 lanes) and 259 (scalar lanes), and C 128 from a cotangent that
    is not 16-byte aligned; one launch each."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(0)
    calls = []
    for kind in ("chunked truncated", "flat truncated"):
        parent, off, _, valid_c = _k3_levels(kind)[0]
        p, o = torch.from_numpy(parent).to(dev), torch.from_numpy(off).to(dev)
        for c in (3, 32, 96, 128, 259):
            ct = torch.randn(*parent.shape, c, device=dev, generator=gen)
            calls.append((ct, p, o, 8, valid_c.shape[1]))
        shifted = torch.randn(parent.size * 128 + 1, device=dev, generator=gen)[1:]
        calls.append((shifted.view(*parent.shape, 128), p, o, 8, valid_c.shape[1]))
    sk.reset_launches()
    for args in calls:
        got = sk.scatter_parent(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, sk.scatter_parent_plain(*args))
    assert sk.launch_counts()["scatter_parent"] == len(calls)


@pytest.mark.cuda
def test_three_interpolate_grad_matches_twin_on_card():
    """M 1, 256 and 512 at C 3, 256 (float4 lanes) and 259 (scalar lanes),
    at B 8 and 2; odd known rows that no unknown point names (exact zeros),
    and every unknown point naming one known row; N 8192 and
    ``INTERP_MAX_N`` (shared memory past 48 KB, up to the block's limit)."""
    dev = _card()
    gen = torch.Generator(device=dev).manual_seed(1)
    cases = [(b_, max(2 * m, 64), m, c) for b_ in (8, 2) for m in (1, 256, 512)
             for c in (3, 256, 259)]
    cases += [(1, 8192, 4096, 256), (1, dk.INTERP_MAX_N, 64, 3)]
    dk.reset_launches()
    for b_, n, m, c in cases:
        grad = torch.randn(b_, n, c, device=dev, generator=gen)
        weight = torch.rand(b_, n, 3, device=dev, generator=gen)
        even = 2 * torch.randint(0, (m + 1) // 2, (b_, n, 3), device=dev, generator=gen)
        for idx in (even.to(torch.int32),
                    torch.full((b_, n, 3), m // 2, dtype=torch.int32, device=dev)):
            got = dk.three_interpolate_grad(grad, idx, weight, m)
            want = dk.three_interpolate_grad_plain(grad, idx, weight, m)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            assert err <= ATOL + RTOL * float(want.abs().max()), (b_, n, m, c, err)
            named = torch.zeros(b_, m, dtype=torch.bool, device=dev)
            named.scatter_(1, idx.reshape(b_, -1).long(), True)
            assert not got[~named].any(), "unnamed known rows must be exact zeros"
    assert dk.launch_counts()["three_interpolate_grad"] == 2 * len(cases)
