"""The ``skip`` rows of ``gather_gemm`` and ``gather_wgrad``: the sparse
ops pass a chunk's pad row (the last), which is zero by contract, so the
card spends no products on it.  Here, on the CPU:

  (a) the twins honour the argument: on chunked and flat pyramids from the
      port's collate and on a 4-D ST net's flat hybrid pyramid (29-tap
      block maps, 8-child down maps), with an arbitrary skipped row, the
      twin with ``skip`` equals the twin without it where that row is zero,
      and differs exactly where it is gathered when it is not;
  (b) the contract: every gather that passes a skip row sees that row at
      exactly zero in one forward and backward pass of a narrow
      Res16UNet34C-shaped net, K1's backward cotangents included;
  (c) that net's forward and every parameter gradient, with the skips on,
      match the JAX package's (one compile), at the parity tolerance of
      ``tests/test_torch_model.py`` (f32, JAX matmuls at "highest");
  (d) the bf16 forms the same way, K4's bf16 dF (``scatter_gemm_bf16``,
      whose ``skip`` is a destination) among them, in a training pass of a
      narrow bf16 ResNet;
  (e) K3's backward, which gathers the cotangent through the down map and
      skips its fine pad row: a cotangent that is not zero at the fine pad
      rows moves no valid coarse row of dF and no entry of dW."""
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.data.collate import collate_pair as j_collate_pair
from pointcontrast_tpu.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu.nn import res16unet as jr16
from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.nn import res16unet as tr16
from pointcontrast_tpu_torch.sparse import kernels, ops
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.tools.workload import SemsegScenes, st_semseg_batch

TOL = dict(rtol=2e-4, atol=2e-4)
OUT = 8
# Res16UNet34C's depth (LAYERS 2, 3, 4, 6, 2, 2, 2, 2) at narrow widths
_NARROW = dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 16, 8, 8))
JNet = type("JNarrow34C", (jr16.Res16UNet34C,), dict(_NARROW))
TNet = type("TNarrow34C", (tr16.Res16UNet34C,), dict(_NARROW))


def _samples():
    ds = SyntheticPairDataset(num_pairs=2, points_per_frame=1500, room_size=1.2, seed=0)
    return [ds[i] for i in range(2)]


@pytest.fixture(scope="module")
def batches():
    """{layout: the port's pair batch on the CPU; "hybrid": a 4-D ST
    pyramid as ``pyramid0``}."""
    out = {layout: collate_pair(_samples(), PadScheme(npad0=4096), npos=64,
                                rng=np.random.RandomState(1), layout=layout).to("cpu")
           for layout in ("chunked", "voxel")}
    scenes = SemsegScenes(scenes=2, points=300, room=1.0, voxel=0.05)
    st = st_semseg_batch(scenes, npad0=2048, pad_ratios=(1.0, 0.8, 0.6, 0.4, 0.2),
                         model="STRes16UNet14")
    out["hybrid"] = types.SimpleNamespace(pyramid0=st.to("cpu").pyramid)
    return out


def _level_maps(batch, level):
    """(nbr [K, B, S], down_nbr [8, B, S_out], S, S_out) of a level, a
    flat pyramid's maps taken as one chunk, as the ops take them."""
    lv, nxt = batch.pyramid0.levels[level], batch.pyramid0.levels[level + 1]
    nb = batch.pyramid0.num_batch if lv.nbr.dim() == 3 else 1
    nbr = lv.nbr if lv.nbr.dim() == 3 else lv.nbr[:, None]
    down = lv.down_nbr if lv.down_nbr.dim() == 3 else lv.down_nbr[:, None]
    return nbr, down, lv.valid.shape[0] // nb, nxt.valid.shape[0] // nb


def _gathered_row(nbr, down):
    """A row index, not the pad row, that both maps gather in every chunk."""
    hit = None
    for b in range(nbr.shape[1]):
        rows = set(nbr[:, b].reshape(-1).tolist()) & set(down[:, b].reshape(-1).tolist())
        hit = (rows if hit is None else hit & rows) - {nbr.shape[2] - 1}
    return min(hit)


def _case(case, nbr, down, s, s_out, x3, w, rng):
    """(twin, its args without skip, the skip keyword, the position in the
    args of the table the map gathers the skipped row from)."""
    b_ = x3.shape[0]
    k = nbr.shape[0]
    if case == "gemm":
        return (kernels.gather_gemm_plain, (x3, nbr, range(k), 0, w, None, s), "skip", 0)
    if case == "gemm centre":  # the tap whose map is the identity
        centre = int((nbr == torch.arange(s)).sum((1, 2)).argmax())
        taps = [i for i in range(k) if i != centre]
        return (kernels.gather_gemm_plain,
                (x3, nbr, taps, 0, w[taps], w[centre], s), "skip", 0)
    if case == "gemm down":
        return (kernels.gather_gemm_plain,
                (x3, down, range(8), 0, w[:8], None, s_out), "skip", 0)
    g3 = torch.from_numpy(rng.randn(b_, s, 5).astype(np.float32))
    if case == "wgrad g":  # K1's dW: the cotangent through the map
        return (kernels.gather_wgrad_plain,
                (g3, None, None, 0, x3, nbr, range(k), 0, k, s), "skip_g", 4)
    # K2's dW: the features through the down map
    g3 = g3[:, :s_out].contiguous()
    return (kernels.gather_wgrad_plain,
            (x3, down, range(8), 0, g3, None, None, 0, 8, s_out), "skip_a", 0)


@pytest.mark.parametrize("layout", ["chunked", "voxel", "hybrid"])
@pytest.mark.parametrize("case", ["gemm", "gemm centre", "gemm down", "wgrad g",
                                  "wgrad a"])
def test_twins_leave_out_the_skip_row(batches, layout, case):
    """With the skipped row zero, skipping it changes nothing (bit for
    bit); with it non-zero, the result changes, and for the gemm exactly at
    the output rows that gather it."""
    rng = np.random.RandomState(2)
    nbr, down, s, s_out = _level_maps(batches[layout], 0)
    skip = _gathered_row(nbr, down)
    b_ = nbr.shape[1]
    x3 = torch.from_numpy(rng.randn(b_, s, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(nbr.shape[0], 4, 6).astype(np.float32))
    fn, args, key, at = _case(case, nbr, down, s, s_out, x3, w, rng)
    zeroed = x3.clone()
    zeroed[:, skip] = 0.0
    args0 = args[:at] + (zeroed,) + args[at + 1:]
    assert torch.equal(fn(*args0, **{key: skip}), fn(*args0))
    plain, skipped = fn(*args), fn(*args, **{key: skip})
    assert not torch.equal(plain, skipped)
    if case.startswith("gemm"):
        m, taps = args[1], list(args[2])
        hits = torch.zeros(plain.shape[:2], dtype=torch.bool)
        for t in taps:
            hits |= m[t] == skip
        if case == "gemm centre":
            hits[:, skip] = True
        changed = (plain != skipped).any(-1)
        assert torch.equal(changed, hits)


@pytest.mark.parametrize("layout", ["chunked", "voxel"])
def test_skipped_rows_are_zero_in_a_training_pass(batches, layout, monkeypatch):
    """Every gather_gemm / gather_wgrad call of one train-mode forward and
    backward finds its skip rows exactly zero in every chunk; K1's backward
    runs and its cotangent's last row is zero in every chunk."""
    seen = {"gemm": 0, "ordered": 0, "wgrad": 0, "k1 backward": 0}

    def zero_row(t3, row):
        return row < 0 or not t3[:, row].any()

    def gemm(x3, map_, taps, stride, w, wc, s_out, skip=-1, order=None):
        assert zero_row(x3, skip), f"gather_gemm: row {skip} is not zero"
        seen["gemm"] += skip >= 0
        if map_ is not None:  # every map comes with the pyramid's live order
            assert order is not None and order.shape == map_.shape[1:]
            assert torch.equal(order.sort(-1).values,
                               torch.arange(s_out, dtype=order.dtype).expand_as(order))
            seen["ordered"] += 1
        return kernels.gather_gemm(x3, map_, taps, stride, w, wc, s_out, skip, order)

    def wgrad(a3, a_map, a_taps, a_stride, g3, *args, skip_a=-1, skip_g=-1):
        assert zero_row(a3, skip_a) and zero_row(g3, skip_g)
        seen["wgrad"] += skip_a >= 0 or skip_g >= 0
        return kernels.gather_wgrad(a3, a_map, a_taps, a_stride, g3, *args,
                                    skip_a=skip_a, skip_g=skip_g)

    k1_backward = ops._ConvChunkFused.backward

    def recorded(ctx, ct):
        _, b_, s = ctx.saved_tensors[1].shape
        assert not ct.reshape(b_, s, -1)[:, s - 1].any(), "K1 cotangent pad row"
        seen["k1 backward"] += 1
        return k1_backward(ctx, ct)

    monkeypatch.setattr(ops, "gather_gemm", gemm)
    monkeypatch.setattr(ops, "gather_wgrad", wgrad)
    monkeypatch.setattr(ops._ConvChunkFused, "backward", staticmethod(recorded))
    batch = batches[layout]
    net = TNet(in_channels=3, out_channels=OUT, normalize_feature=True,
               generator=torch.Generator().manual_seed(0))
    out = net.train()(batch.feats0, batch.pyramid0)
    proj = torch.from_numpy(np.random.RandomState(3).randn(OUT).astype(np.float32))
    (torch.sin(3.0 * out) * proj).sum().backward()
    assert min(seen.values()) > 0, seen


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def jax_run():
    """The narrow net's train-mode output and parameter gradients in JAX, on
    the JAX collate of the same samples (byte-identical to the port's)."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jb = j_collate_pair(_samples(), JPadScheme(npad0=4096), npos=64,
                        rng=np.random.RandomState(1), fuse_frames=True, layout="chunked")
    jmodel = JNet(in_channels=3, out_channels=OUT, normalize_feature=True)
    variables = jax.jit(lambda r: jmodel.init(r, jb.feats0, jb.pyramid0, train=False))(
        jax.random.PRNGKey(0))
    proj = np.random.RandomState(3).randn(OUT).astype(np.float32)

    def loss(params):
        out, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              jb.feats0, jb.pyramid0, train=True,
                              mutable=["batch_stats"])
        return (jnp.sin(3.0 * out) * proj).sum(), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    return dict(params=jax.device_get(variables["params"]),
                stats=jax.device_get(variables["batch_stats"]), proj=proj,
                out=np.asarray(out), grads=jax.device_get(grads))


def test_narrow_34c_with_skips_matches_jax(batches, jax_run):
    """Train-mode forward and every parameter gradient of a scalar loss,
    through the ops that pass the skip rows."""
    batch = batches["chunked"]
    net = load_jax_params(TNet(in_channels=3, out_channels=OUT, normalize_feature=True),
                          jax_run["params"], jax_run["stats"])
    net.train().zero_grad(set_to_none=True)
    out = net(batch.feats0, batch.pyramid0)
    (torch.sin(3.0 * out) * torch.from_numpy(jax_run["proj"])).sum().backward()
    got = out.detach().numpy()
    np.testing.assert_allclose(got, jax_run["out"], **TOL)
    assert not got[batch.pyramid0.levels[0].valid.numpy() == 0].any()
    named = dict(net.named_parameters())
    checked = 0
    for path, g in _flat(jax_run["grads"]):
        g = np.asarray(g)
        name = torch_name(path, net)
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(named[name].grad.numpy(), g, rtol=TOL["rtol"],
                                   atol=TOL["atol"] * scale, err_msg=name)
        checked += 1
    assert checked == len(named)


def _bf16_case(case, nbr, down, s, s_out, x3, w, rng):
    """``_case`` on bf16 tables and weights, through the bf16 forms' twins
    (a case ending in "per tap": gather_gemm_bf16's ``round_each_tap``)."""
    per_tap = case.endswith(" per tap")
    fn, args, key, at = _case(case.removesuffix(" per tap"), nbr, down, s, s_out, x3, w, rng)
    bf = tuple(a.to(torch.bfloat16) if torch.is_tensor(a) and a.is_floating_point() else a
               for a in args)
    twin = getattr(kernels, fn.__name__.replace("_plain", "_bf16_plain"))
    if per_tap:
        twin = functools.partial(twin, round_each_tap=True)
    return twin, bf, key, at


@pytest.mark.parametrize("layout", ["chunked", "voxel", "hybrid"])
@pytest.mark.parametrize("case", ["gemm", "gemm centre", "gemm down", "wgrad g",
                                  "wgrad a", "gemm per tap", "gemm centre per tap",
                                  "gemm down per tap"])
def test_bf16_twins_leave_out_the_skip_row(batches, layout, case):
    """The same for the bf16 forms' twins on bf16 tables, each tap's
    product rounded or not: with the skipped row zero, skipping it changes
    no bit; with it non-zero, the gemm's result changes exactly at the
    output rows that gather it."""
    rng = np.random.RandomState(2)
    nbr, down, s, s_out = _level_maps(batches[layout], 0)
    skip = _gathered_row(nbr, down)
    b_ = nbr.shape[1]
    x3 = torch.from_numpy(rng.randn(b_, s, 4).astype(np.float32))
    w = torch.from_numpy(rng.randn(nbr.shape[0], 4, 6).astype(np.float32))
    fn, args, key, at = _bf16_case(case, nbr, down, s, s_out, x3, w, rng)
    zeroed = args[at].clone()
    zeroed[:, skip] = 0.0
    args0 = args[:at] + (zeroed,) + args[at + 1:]
    assert torch.equal(fn(*args0, **{key: skip}), fn(*args0))
    plain, skipped = fn(*args), fn(*args, **{key: skip})
    assert not torch.equal(plain, skipped)
    if case.startswith("gemm"):
        assert plain.dtype == torch.bfloat16
        m, taps = args[1], list(args[2])
        hits = torch.zeros(plain.shape[:2], dtype=torch.bool)
        for t in taps:
            hits |= m[t] == skip
        if case.startswith("gemm centre"):
            hits[:, skip] = True
        changed = (plain != skipped).any(-1)
        assert not (changed & ~hits).any()  # bf16 rounding may hide a change


@pytest.mark.parametrize("layout", ["chunked", "voxel"])
def test_skipped_rows_are_zero_in_a_bf16_training_pass(batches, layout, monkeypatch):
    """The bf16 net (the layers' bf16 casts, ``dtype=bfloat16``): every
    gather_gemm_bf16 / gather_wgrad_bf16 call of one train-mode forward and
    backward finds its skip rows exactly zero, on bf16 tables only: K3's
    backward gathers its bf16 cotangent through the pyramid's down map (no
    f32 gather_gemm, no f32 G); the voxel layout's forwards round each tap,
    the chunked layout's never."""
    seen = {"gemm": 0, "wgrad": 0, "k3 backward": 0}
    per_tap = []

    def zero_row(t3, row):
        return row < 0 or not t3[:, row].any()

    def gemm(x3, map_, taps, stride, w, wc, s_out, skip=-1, order=None,
             round_each_tap=False):
        assert x3.dtype == torch.bfloat16 and zero_row(x3, skip)
        seen["gemm"] += skip >= 0
        per_tap.append(round_each_tap)
        return kernels.gather_gemm_bf16(x3, map_, taps, stride, w, wc, s_out, skip, order,
                                        round_each_tap=round_each_tap)

    def gemm_f32(*args, **kwargs):
        raise AssertionError("an f32 gather_gemm in a bf16 pass")

    def wgrad(a3, a_map, a_taps, a_stride, g3, *args, skip_a=-1, skip_g=-1):
        assert a3.dtype == g3.dtype == torch.bfloat16
        assert zero_row(a3, skip_a) and zero_row(g3, skip_g)
        seen["wgrad"] += skip_a >= 0 or skip_g >= 0
        return kernels.gather_wgrad_bf16(a3, a_map, a_taps, a_stride, g3, *args,
                                         skip_a=skip_a, skip_g=skip_g)

    k3_backward = ops._ConvTrChunk.backward

    def recorded(ctx, ct):
        down, order = ctx.saved_tensors[4:6]
        assert down is not None and order is not None, "the net passes the level's down map"
        seen["k3 backward"] += 1
        return k3_backward(ctx, ct)

    monkeypatch.setattr(ops, "gather_gemm_bf16", gemm)
    monkeypatch.setattr(ops, "gather_gemm", gemm_f32)
    monkeypatch.setattr(ops, "gather_wgrad_bf16", wgrad)
    monkeypatch.setattr(ops._ConvTrChunk, "backward", staticmethod(recorded))
    batch = batches[layout]
    net = TNet(in_channels=3, out_channels=OUT, normalize_feature=True,
               generator=torch.Generator().manual_seed(0), dtype=torch.bfloat16)
    out = net.train()(batch.feats0, batch.pyramid0)
    assert out.dtype == torch.bfloat16
    proj = torch.from_numpy(np.random.RandomState(3).randn(OUT).astype(np.float32))
    (torch.sin(3.0 * out.float()) * proj).sum().backward()
    assert min(seen.values()) > 0 and seen["k3 backward"] == 4, seen
    assert any(per_tap) == (layout == "voxel") and not all(per_tap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["chunked", "voxel"])
def test_k3_backward_leaves_out_the_fine_pad_rows(batches, layout, dtype):
    """K3's backward (dF and dW gathered through the down map, whose missing
    children name the fine pad row ``S_f - 1``, passed as ``skip``): a
    cotangent that is not zero at the fine pad rows gives the same dF at
    every valid coarse row, and the same dW, bit for bit, as one zeroed
    there (JAX adds those rows into its stacked ``dy``'s pad slot, which
    reaches only dF's pad row); with the pyramid's map and with the one
    derived from the parent map, which are equal."""
    rng = np.random.RandomState(5)
    pyr = batches[layout].pyramid0
    lv, lv1 = pyr.levels[1], pyr.levels[2]
    valid_c, valid_f = lv1.valid > 0, lv.valid > 0
    f = torch.from_numpy(rng.randn(valid_c.shape[0], 6).astype(np.float32))
    f = (f * valid_c[:, None]).to(dtype)
    w = torch.from_numpy((0.3 * rng.randn(8, 6, 5)).astype(np.float32)).to(dtype)
    ct = torch.from_numpy(rng.randn(valid_f.shape[0], 5).astype(np.float32)).to(dtype)
    assert ct[~valid_f].float().abs().min() > 0
    grads = []
    for down in ((lv.down_nbr, lv.down_order), None):
        for c in (ct, ct * valid_f[:, None].to(dtype)):
            ft, wt = f.clone().requires_grad_(), w.clone().requires_grad_()
            ops.sparse_conv_transpose(ft, lv.up_parent, lv.up_offset, wt,
                                      up_order=lv.up_order, down=down).backward(c)
            grads.append((ft.grad[valid_c], wt.grad))
    for df, dw in grads[1:]:
        assert torch.equal(df, grads[0][0]) and torch.equal(dw, grads[0][1])
    assert grads[0][0].float().abs().max() > 0 and grads[0][1].float().abs().max() > 0


@pytest.mark.parametrize("layout", ["chunked", "voxel"])
def test_bf16_scatter_twin_leaves_out_the_skip_row(batches, layout):
    """K4's bf16 dF twin (``scatter_gemm_bf16``'s, the exact sum rounded
    once) honours ``skip``, a destination: with it, that row gets nothing
    (exact +0) and every other row the same bits; without it, the row takes
    the products of the cotangent rows whose map entry names it."""
    rng = np.random.RandomState(4)
    nbr, down, s, s_out = _level_maps(batches[layout], 0)
    skip = _gathered_row(nbr, down)
    b_, k = nbr.shape[1], nbr.shape[0]
    g3 = torch.from_numpy(rng.randn(b_, s, 6).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.randn(k, 4, 6).astype(np.float32)).to(torch.bfloat16)
    fn = kernels.scatter_gemm_bf16_plain
    with_skip, without = fn(g3, nbr, range(k), w, s, skip), fn(g3, nbr, range(k), w, s, -1)
    assert with_skip.dtype == torch.bfloat16
    assert not with_skip[:, skip].float().any() and without[:, skip].float().any()
    rest = torch.ones(s, dtype=torch.bool)
    rest[skip] = False
    assert torch.equal(with_skip[:, rest], without[:, rest])


def test_skipped_rows_are_zero_in_a_bf16_resnet_pass(monkeypatch):
    """A narrow bf16 ResNet (K4 on the k3s2 and 1-tap maps, the bf16 sum
    pool): every gather_gemm_bf16 / gather_wgrad_bf16 call of one
    train-mode forward and backward finds its skip rows exactly zero, and
    every scatter_gemm_bf16 call (K4's dF) skips the features' pad row,
    which is exactly zero (the forward gathered nothing from it)."""
    from pointcontrast_tpu_torch.nn import resnet as tresnet
    from pointcontrast_tpu_torch.nn import resnet_block as tblocks
    from pointcontrast_tpu_torch.tools.workload import SemsegScenes, resnet_batch

    seen = {"gemm": 0, "wgrad": 0, "scatter": 0}
    features = {}

    def zero_row(t3, row):
        return row < 0 or not t3[:, row].any()

    def gemm(x3, map_, taps, stride, w, wc, s_out, skip=-1, order=None, **kw):
        assert x3.dtype == torch.bfloat16 and zero_row(x3, skip)
        seen["gemm"] += skip >= 0
        if map_ is not None and wc is None:  # K4's forward: its features, by map
            features[id(map_)] = x3
        return kernels.gather_gemm_bf16(x3, map_, taps, stride, w, wc, s_out, skip, order,
                                        **kw)

    def wgrad(a3, a_map, a_taps, a_stride, g3, *args, skip_a=-1, skip_g=-1):
        assert a3.dtype == torch.bfloat16 and zero_row(a3, skip_a) and zero_row(g3, skip_g)
        seen["wgrad"] += skip_a >= 0 or skip_g >= 0
        return kernels.gather_wgrad_bf16(a3, a_map, a_taps, a_stride, g3, *args,
                                         skip_a=skip_a, skip_g=skip_g)

    def scatter(g3, map_, taps, w, s_in, skip, order=None):
        f3 = features[id(map_)]
        assert skip == s_in - 1 == f3.shape[1] - 1 and zero_row(f3, skip)
        seen["scatter"] += 1
        return kernels.scatter_gemm_bf16(g3, map_, taps, w, s_in, skip, order)

    monkeypatch.setattr(ops, "gather_gemm_bf16", gemm)
    monkeypatch.setattr(ops, "gather_wgrad_bf16", wgrad)
    monkeypatch.setattr(ops, "scatter_gemm_bf16", scatter)
    batch = resnet_batch(SemsegScenes(scenes=2, points=2500, room=2.4, voxel=0.05),
                         npad0=4096).to("cpu")
    net = type("TTiny", (tresnet.ResNetBase,),
               dict(BLOCK=tblocks.BasicBlock, INIT_DIM=8, PLANES=(8, 16, 16, 16),
                    LAYERS=(1, 2, 1, 1)))(in_channels=3, out_channels=OUT,
                                          dtype=torch.bfloat16)
    out = net.train()(batch.feats, batch.pyramid)
    assert out.dtype == torch.bfloat16
    proj = torch.from_numpy(np.random.RandomState(3).randn(OUT).astype(np.float32))
    (torch.sin(3.0 * out.float()) * proj).sum().backward()
    assert seen["scatter"] == 12 and min(seen.values()) > 0, seen
