"""``parent_gemm_bf16`` on the tensor cores (``parent_gemm_mma_kernel``).

The bf16 form of ``parent_gemm`` (K3's forward, K2's dF in bf16) sums each
row's bf16 x bf16 products with ``mma.sync`` in another order of f32 adds
than its twin's, so an output is held to ``parent_gemm_bf16_bound``: the
exact (f64) sum, within one bf16 rounding plus gamma(Cin) of the sum of the
products' magnitudes.  K2's dF reads the forward's weights in place
(``trans_w``) instead of a transposed copy.  Here, on the CPU:

  - the bound's exact sum equals an f64 numpy loop over the rows, and the
    twin (an f32 sum rounded once) lies within the bound, on the parent
    maps of chunked, flat (voxel) and brick:2 pyramids (its flat levels),
    truncated (orphans) and not, with K3's ``skip = S_c - 1`` and K2's
    ``skip = -1``, on W and (``trans_w``) on the forward's W read
    transposed;
  - the bound refuses three wrong outputs: a row computed with another
    offset's weights, one offset's rows left out, and every product
    rounded to bf16 before the sum;
  - K2's bf16 dF through ``ops.sparse_conv`` passes the weights themselves
    with ``trans_w`` (no transposed copy) and equals ``parent_gemm_bf16``
    on the copied W^T, bit for bit; the f32 ``parent_gemm`` takes the same
    call form and gives the bits of the call on the copied W^T;
  - against ``jax.vjp`` of JAX's K2 in bf16 (one JAX compile, a chunked
    pyramid whose truncation orphans fine voxels, a cotangent that is not
    zero at the coarse pad row): the port's dF and JAX's within the bound
    of the exact sum at every valid fine row, the orphans included, where
    JAX's is not zero: so ``skip = S_c - 1`` (zeros there) would be wrong,
    which only JAX shows.

On a card (``cuda``-marked): the ``trans_w`` form at every Cout tile of
``gm::q_for`` (Cout 32, 64, 96, 128 and 256) and ragged widths, within
the bound, the same bits twice, and equal bit for bit to the kernel on the
copied W^T (the same fragments reach the same mma); one launch a call;
the f32 form's ``trans_w`` the f32 kernel's bits on the copied W^T.
Sizes as ``tests/test_chunked.py``'s: three samples of 150-220 voxels.
JAX is imported inside a fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_parent_mma.py"""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu_torch.sparse import kernels as sk
from pointcontrast_tpu_torch.sparse import ops as tops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid

NB = 3
TRUNCATING = [660, 300, 120, 45]  # every level past 0 drops coarse voxels
ROOMY = [1800, 1800, 1200, 600]
KINDS = ["chunked", "chunked truncated", "flat truncated", "brick:2"]
BF16_RTOL = 2.0 ** -7  # one bf16 ulp at the largest magnitude
BF = torch.bfloat16


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _levels(kind):
    """[dict(parent, offset, order [B, S_f], down [8, B, S_c] int32 tensors,
    valid_f [B, S_f], valid_c [B, S_c] bool)], one a level with a parent
    map (flat maps as B = 1, as the ops take them)."""
    if kind.startswith("chunked"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_chunked_pyramid(_coords(), 4, npads, num_batch=NB)[0].levels
    elif kind.startswith("flat"):
        npads = TRUNCATING if kind.endswith("truncated") else ROOMY
        levels = build_pyramid(_coords(), 4, npads=npads, num_batch=NB)[0].levels
    else:  # brick:2: the flat levels past the brick ones carry parent maps
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
                        order=t(lv.up_order, 1)[0], down=t(lv.down_nbr, 8),
                        valid_f=torch.from_numpy(np.asarray(lv.valid).reshape(b_, -1) > 0),
                        valid_c=torch.from_numpy(np.asarray(lv1.valid).reshape(b_, -1) > 0)))
    assert out
    return out


def _operands(lv, cin, cout, seed, trans_w=False, pad_row=True):
    """(x3 [B, S_c, Cin] bf16, w bf16: [8, Cin, Cout], or [8, Cout, Cin]
    under ``trans_w``): x3 random at the valid coarse rows, and at the
    coarse pad row too where ``pad_row`` (K2's cotangent, which only the
    output mask zeroes there), zero at the other pad rows."""
    rng = np.random.RandomState(seed)
    keep = lv["valid_c"].clone()
    keep[:, -1] |= pad_row
    x3 = torch.from_numpy(rng.randn(*keep.shape, cin).astype(np.float32)) * keep[..., None]
    w = torch.from_numpy((0.3 * rng.randn(8, cin, cout)).astype(np.float32))
    return x3.to(BF), (w.transpose(1, 2).contiguous() if trans_w else w).to(BF)


def _numpy_exact(x3, parent, off, w, skip, trans_w):
    """The exact (f64) sum of each row's products, a loop over the rows."""
    x = x3.double().numpy()
    w = w.double().numpy()
    w = w.transpose(0, 2, 1) if trans_w else w
    p, o = parent.numpy(), off.numpy()
    out = np.zeros(p.shape + (w.shape[2],))
    for b in range(p.shape[0]):
        for i in range(p.shape[1]):
            if p[b, i] != skip:
                out[b, i] = x[b, p[b, i]] @ w[o[b, i]]
    return out


@pytest.mark.parametrize("trans_w", [False, True], ids=["w", "trans_w"])
@pytest.mark.parametrize("skip", ["pad", "none"])
@pytest.mark.parametrize("kind", KINDS)
def test_bound_holds_the_twin(kind, skip, trans_w):
    """At every level: the bound's reference is the exact sum, skipped rows
    (K3's coarse pad row) exact zeros, and the twin within the bound (its
    largest ratio not slack by orders of magnitude)."""
    worst = 0.0
    for n, lv in enumerate(_levels(kind)):
        s_c = lv["valid_c"].shape[1]
        sk_ = s_c - 1 if skip == "pad" else -1
        x3, w = _operands(lv, 40, 24, seed=n, trans_w=trans_w, pad_row=skip == "none")
        args = (x3, lv["parent"], lv["offset"], w, sk_, lv["order"], trans_w)
        ref, bound = sk.parent_gemm_bf16_bound(*args)
        np.testing.assert_allclose(
            ref.numpy(), _numpy_exact(x3, lv["parent"], lv["offset"], w, sk_, trans_w),
            rtol=0, atol=1e-12)
        if skip == "pad":
            assert not ref[lv["parent"] == s_c - 1].any() and not bound[
                lv["parent"] == s_c - 1].any()
        got = sk.parent_gemm_bf16(*args)
        assert got.dtype == BF and got.shape == ref.shape
        worst = max(worst, sk.bound_ratio(got, ref, bound))
    assert 1e-3 < worst <= 1.0, worst


@pytest.mark.parametrize("control", ["wrong offset", "offset left out",
                                     "products rounded"])
def test_bound_refuses_wrong_outputs(control):
    """Three outputs a broken kernel could give, each outside the bound:
    one live row computed with the next offset's weights; the rows of one
    offset never computed (zeros); every product rounded to bf16 before an
    exact sum (the sum rounded once more)."""
    lv = _levels("chunked truncated")[0]
    x3, w = _operands(lv, 64, 32, seed=5)
    parent, off = lv["parent"], lv["offset"]
    s_c = lv["valid_c"].shape[1]
    args = (x3, parent, off, w, s_c - 1)
    ref, bound = sk.parent_gemm_bf16_bound(*args)
    assert sk.bound_ratio(sk.parent_gemm_bf16(*args), ref, bound) <= 1.0
    live = parent != s_c - 1
    if control == "wrong offset":
        bad_off = off.clone()
        b, i = (int(v[0]) for v in torch.nonzero(live, as_tuple=True))
        bad_off[b, i] = (bad_off[b, i] + 1) % 8
        wrong = sk.parent_gemm_bf16_plain(x3, parent, bad_off, w, s_c - 1)
    elif control == "offset left out":
        wrong = sk.parent_gemm_bf16_plain(*args)
        wrong[live & (off == 3)] = 0
        assert (live & (off == 3)).any()
    else:
        rows = sk.take_rows(x3.double(), parent.long())
        prod = rows[..., None] * w.double()[off.long()]  # [B, S_f, Cin, Cout]
        wrong = prod.to(BF).double().sum(2).to(BF)
        wrong[~live] = 0
    assert sk.bound_ratio(wrong, ref, bound) > 1.0


def _k2_df(lv, w, ct3, trans_calls=None):
    """dF of the port's K2 (``ops.sparse_conv`` with ``up``) in bf16, [B,
    S_f, Cin]; ``trans_calls``, a list, gets the (w, trans_w) that each
    parent_gemm_bf16 call received."""
    b_, s_f = lv["parent"].shape
    flat = b_ == 1
    maps = [lv["parent"], lv["offset"], lv["order"]]
    down = lv["down"][:, 0] if flat else lv["down"]
    if flat:
        maps = [m[0] for m in maps]
    f = torch.zeros(b_ * s_f, w.shape[1], dtype=BF, device=ct3.device, requires_grad=True)
    original = tops.parent_gemm_bf16

    def spy(*args, **kw):
        trans_calls.append((args[3], kw.get("trans_w", False)))
        return original(*args, **kw)

    if trans_calls is not None:
        tops.parent_gemm_bf16 = spy
    try:
        tops.sparse_conv(f, down, w, up=tuple(maps)).backward(ct3.reshape(-1, w.shape[2]))
    finally:
        tops.parent_gemm_bf16 = original
    return f.grad.reshape(b_, s_f, -1)


@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_k2_bf16_df_reads_w_in_place(kind):
    """K2's bf16 backward hands parent_gemm_bf16 the forward's weights
    themselves with ``trans_w`` (no transposed copy), and its dF equals
    parent_gemm_bf16 on the copied W^T, bit for bit, at every level."""
    for n, lv in enumerate(_levels(kind)):
        ct3, wt = _operands(lv, 24, 40, seed=20 + n)  # wt: [8, Cout, Cin] of K2
        w = wt.transpose(1, 2).contiguous()  # the forward's [8, Cin, Cout]
        calls = []
        got = _k2_df(lv, w, ct3, calls)
        (passed, trans), = calls
        assert trans is True and passed.data_ptr() == w.data_ptr()
        assert passed.shape == w.shape and passed.stride() == w.stride()
        want = sk.parent_gemm_bf16(ct3, lv["parent"], lv["offset"], wt, -1, lv["order"])
        assert got.dtype == BF and torch.equal(got, want)
        assert got.float().abs().max() > 0


@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_f32_trans_w_form_is_the_copied_form(kind):
    """The f32 parent_gemm takes K2's dF in the same call form as the bf16
    one (the forward's W with ``trans_w``) and gives the bits of the call
    on the copied W^T, at every level, with and without ``skip``."""
    for n, lv in enumerate(_levels(kind)):
        ct3, wt = (t.float() for t in _operands(lv, 24, 40, seed=50 + n))
        w = wt.transpose(1, 2).contiguous()
        s_c = lv["valid_c"].shape[1]
        for skip in (-1, s_c - 1):
            maps = (lv["parent"], lv["offset"])
            got = sk.parent_gemm(ct3, *maps, w, skip, lv["order"], trans_w=True)
            want = sk.parent_gemm(ct3, *maps, wt, skip, lv["order"])
            assert got.dtype == torch.float32 and torch.equal(got, want)
            assert got.abs().max() > 0


@pytest.fixture(scope="module")
def jax_k2():
    """(level, ct3, w, JAX's dF [B, S_f, Cin] f32 numpy): ``jax.vjp`` of
    JAX's chunked K2 (``_conv_chunk_down2``) in bf16, one compile, on the
    truncated chunked pyramid's level 0, whose orphans read the cotangent's
    coarse pad row."""
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import ops as jops

    lv = _levels("chunked truncated")[0]
    ct3, wt = _operands(lv, 32, 48, seed=30)
    w = wt.transpose(1, 2).contiguous()
    b_, s_f = lv["parent"].shape
    down, parent, off = (jnp.asarray(lv[k].numpy()) for k in ("down", "parent", "offset"))

    def bf(t):
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)

    @jax.jit
    def df(ct, w):
        f = jnp.zeros((b_ * s_f, w.shape[1]), jnp.bfloat16)
        _, vjp = jax.vjp(lambda f: jops.sparse_conv(f, down, w, up=(parent, off)), f)
        return vjp(ct)[0]

    with jax.default_matmul_precision("highest"):
        out = df(bf(ct3.reshape(-1, ct3.shape[2])), bf(w))
    return lv, ct3, w, np.array(jnp.asarray(out, jnp.float32)).reshape(b_, s_f, -1)


def test_k2_bf16_df_matches_jax_at_the_orphans(jax_k2):
    """JAX's bf16 K2 dF and the port's (through ops, ``trans_w``) are each
    one rounding of an f32 sum: both within the bound of the exact sum at
    every valid fine row, and within 2^-7 of JAX's largest entry.  The
    orphans (parent: the coarse pad row) read the cotangent's pad row, so
    JAX's dF is not zero there, and the kernel with ``skip = S_c - 1``
    (zeros at the orphans) would differ: K2's dF passes -1."""
    lv, ct3, w, want = jax_k2
    parent, off = lv["parent"], lv["offset"]
    s_c = lv["valid_c"].shape[1]
    valid = lv["valid_f"]
    orphan = valid & (parent == s_c - 1)
    assert orphan.any(), "no orphans"
    assert np.abs(want[orphan.numpy()]).min() > 0
    got = _k2_df(lv, w, ct3)
    args = (ct3, parent, off, w, -1, lv["order"], True)
    ref, bound = sk.parent_gemm_bf16_bound(*args)
    for out in (got, torch.from_numpy(want).to(BF)):
        assert sk.bound_ratio(out[valid], ref[valid], bound[valid]) <= 1.0
    err = float((got[valid].float() - torch.from_numpy(want)[valid]).abs().max())
    assert err <= BF16_RTOL * float(np.abs(want).max())
    skipped = sk.parent_gemm_bf16(ct3, parent, off, w, s_c - 1, lv["order"], True)
    assert not skipped[orphan].float().any()
    inner = valid & ~orphan
    assert torch.equal(skipped[inner], got[inner])


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(32, 32), (64, 64), (128, 96), (256, 128),
                                      (96, 256), (37, 20), (20, 37)])
def test_trans_w_form_on_card(cin, cout):
    """K2's dF form: x3 [B, S_c, Cin] (the cotangent), w [8, Cout, Cin]
    (the forward's weights), Cout the output width: at every gm::q_for
    tile (Cout 32, 64, 96, 128, 256 -> Q 1-4) and at ragged widths (the
    2-byte loads, the scalar stores), on chunked levels 0 and 2 and a flat
    level, with and without the up order: within the bound of the exact
    sum, the same bits twice, and equal to the untransposed form on the
    copied W^T; one launch each."""
    dev = _card()
    for kind, level in (("chunked", 0), ("chunked truncated", 2), ("flat truncated", 0)):
        lv = {k: v.to(dev) for k, v in _levels(kind)[level].items()}
        ct3, w = _operands({k: v.cpu() for k, v in lv.items()}, cin, cout,
                           seed=cin + cout, trans_w=True)
        ct3, w = ct3.to(dev), w.to(dev)
        for order in (lv["order"], None):
            args = (ct3, lv["parent"], lv["offset"], w, -1, order, True)
            sk.reset_launches()
            got = sk.parent_gemm_bf16(*args)
            assert sk.parent_gemm_bf16.launches == 1
            ratio = sk.bound_ratio(got, *sk.parent_gemm_bf16_bound(*args))
            assert ratio <= 1.0, f"{kind} {level}: {ratio:.3e}"
            assert torch.equal(got, sk.parent_gemm_bf16(*args)), "not the same twice"
            plain = sk.parent_gemm_bf16(ct3, lv["parent"], lv["offset"],
                                        w.transpose(1, 2).contiguous(), -1, order)
            assert torch.equal(got, plain), f"{kind} {level}: W^T read in place differs"


@pytest.mark.cuda
def test_f32_trans_w_form_on_card():
    """The f32 parent_gemm's ``trans_w`` form on the card: the bits of the
    f32 kernel on the copied W^T, one kernel launch a call."""
    dev = _card()
    for kind, level in (("chunked truncated", 0), ("flat truncated", 0)):
        lv_cpu = _levels(kind)[level]
        lv = {k: v.to(dev) for k, v in lv_cpu.items()}
        ct3, wt = (t.float().to(dev) for t in _operands(lv_cpu, 64, 96, seed=60))
        w = wt.transpose(1, 2).contiguous()
        maps = (lv["parent"], lv["offset"])
        sk.reset_launches()
        got = sk.parent_gemm(ct3, *maps, w, -1, lv["order"], trans_w=True)
        assert sk.parent_gemm.launches == 1
        assert torch.equal(got, sk.parent_gemm(ct3, *maps, wt, -1, lv["order"]))


@pytest.mark.cuda
def test_k3_forward_and_k2_df_launch_the_tensor_core_form_on_card():
    """Through the ops on the card, K3's forward and K2's dF in bf16 launch
    parent_gemm_bf16 once each and no f32 parent_gemm; K2's dF as the twin's
    within the bound (the twin on the CPU)."""
    dev = _card()
    lv = _levels("chunked truncated")[0]
    ct3, wt = _operands(lv, 32, 64, seed=40)
    w = wt.transpose(1, 2).contiguous()
    want = _k2_df(lv, w, ct3)
    lv_dev = {k: v.to(dev) for k, v in lv.items()}
    sk.reset_launches()
    got = _k2_df(lv_dev, w.to(dev), ct3.to(dev))
    f3, wf = _operands(lv, 32, 64, seed=41, pad_row=False)
    tops.sparse_conv_transpose(f3.to(dev).reshape(-1, 32), lv_dev["parent"],
                               lv_dev["offset"], wf.to(dev), up_order=lv_dev["order"])
    torch.cuda.synchronize()
    assert sk.parent_gemm_bf16.launches == 2 and sk.parent_gemm.launches == 0
    args = (ct3, lv["parent"], lv["offset"], w, -1, lv["order"], True)
    ref, bound = sk.parent_gemm_bf16_bound(*args)
    assert sk.bound_ratio(got.cpu(), ref, bound) <= 1.0
    assert sk.bound_ratio(want, ref, bound) <= 1.0
