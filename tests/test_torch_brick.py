"""The brick layout of the port against the JAX package, on the CPU: the
plans, the hybrid brick pyramid (byte for byte, with ``rows0`` and
``orphan0``), ``brick_conv`` through the kernels' plain twins (values and
gradients), ``brick_down_conv`` and ``brick_up_conv`` including the hybrid
boundary, the bounds check of brick levels, Res16UNet14A on ``brick:2``
(against JAX and against the port's own voxel output), the brick collates
and MinkUNetHyper's refusal.

Inputs are made with numpy from seeds and go through both packages, f32,
JAX matmuls at "highest".  Tolerances: single ops 1e-5 of the largest
magnitude (the same products summed in other orders); the network 2e-4,
as ``tests/test_torch_model.py``; brick against voxel 5e-4, as JAX's
``tests/test_brick.py`` holds its own two layouts.  Valid rows are
compared; empty slots and pad bricks of every output must be exactly 0."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.data.collate import collate_pair as j_collate_pair
from pointcontrast_tpu.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu.nn.registry import load_model as j_load_model
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate_semseg
from pointcontrast_tpu.sparse import brick as jbrick
from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    check_pyramid_bounds,
    collate_pair,
)
from pointcontrast_tpu_torch.nn.registry import load_model
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.sparse import brick, kernels
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.tools.workload import SemsegScenes

CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0, chromatic_sigma=12.0)
FIELDS = ("valid", "batch", "down_nbr", "up_parent", "up_offset", "nbr", "nbr0")
NPADS = [560, 520, 300, 100, 40, 16]


def _coords(seed=0, n=(200, 150, 170), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    if isinstance(a, jbrick.BrickMap):
        assert isinstance(b, brick.BrickMap) and tuple(a.plan) == tuple(b.plan), what
        return _same(a.nbr, b.nbr, what + ".nbr")
    if isinstance(a, jbrick.BrickDownMap):
        assert isinstance(b, brick.BrickDownMap) and a.num_slots == b.num_slots, what
        return _same(a.place, b.place, what + ".place")
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _same_pyramid(jp, tp, tag=""):
    assert jp.num_batch == tp.num_batch
    for l, (jl, tl) in enumerate(zip(jp.levels, tp.levels, strict=True)):
        for f in FIELDS:
            _same(getattr(jl, f), getattr(tl, f), f"{tag} level {l} {f}")
        assert jl.rev == tl.rev and jl.rev0 == tl.rev0, (tag, l)


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_plans_equal_jax(kernel_size):
    jp = jbrick.build_plan(kernel_size)
    tp = brick.build_plan(kernel_size)
    assert tuple(jp) == tuple(tp)
    assert brick._tap_reversal(tp) == jbrick._tap_reversal(jp)
    # every output slot sees every tap once: 8 x K (s, p) pairs
    pairs = sum(t >= 0 for _, _, tm in brick.slot_steps(tp) for r in tm for t in r)
    assert pairs == 8 * tp.num_taps


@pytest.mark.parametrize("scheme", [dict(npad0=4096), dict(npad0=131072, num_levels=5),
                                    dict(npad0=8192, num_levels=2,
                                         level_ratios=(1.0, 0.4, 0.2))])
def test_pad_scheme_npads_for_equals_jax(scheme):
    """The brick layout's ``num_levels + 1`` pads (and two more, where the
    ratios run out and the last shrink factor extrapolates)."""
    for n in (scheme.get("num_levels", 5), scheme.get("num_levels", 5) + 1,
              scheme.get("num_levels", 5) + 3):
        assert PadScheme(**scheme).npads_for(n) == JPadScheme(**scheme).npads_for(n)
    assert PadScheme.scannet(131072).npads_for(6) == JPadScheme.scannet(131072).npads_for(6)


@pytest.mark.parametrize("brick_levels,conv0", [(1, 3), (2, 3), (None, 3), (2, 5)])
def test_brick_pyramid_is_byte_identical(brick_levels, conv0):
    """Levels, rows0 and orphan0, at 1, 2 and all brick levels (tight pads:
    coarse truncation orphans voxels)."""
    c = _coords(1)
    kw = dict(num_levels=5, npads=[560, 400, 200, 60, 30, 10], num_batch=3,
              conv0_kernel_size=conv0, brick_levels=brick_levels)
    jp, jmeta, jrows, jorph = jbrick.build_brick_pyramid(c, **kw)
    tp, tmeta, trows, torph = brick.build_brick_pyramid(c, **kw)
    _same_pyramid(jp, tp, f"brick:{brick_levels}")
    _same(jrows, trows, "rows0")
    _same(jorph, torph, "orphan0")
    assert torph.any() and jmeta.truncated == tmeta.truncated
    check_pyramid_bounds(tp)


@pytest.fixture(scope="module")
def pyramids():
    """A brick:2 pyramid of 5 levels without truncation, from both packages."""
    c = _coords()
    kw = dict(num_levels=5, npads=NPADS, num_batch=3, brick_levels=2)
    jp, jmeta, rows0, orphan0 = jbrick.build_brick_pyramid(c, **kw)
    tp = brick.build_brick_pyramid(c, **kw)[0]
    assert not orphan0.any() and not jmeta.truncated
    return jp, tp, rows0


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int(valid.sum()), c)
    return f


def _i(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale, err_msg=what)


def _check(jfn, tfn, args, ct, valid_in, valid_out):
    """Values and the gradients of every argument; the features' (first
    argument) at valid rows only."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(ct))
    targs = [_t(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    tout.backward(_t(ct))
    tout = tout.detach().numpy()
    _close(tout, np.asarray(jout), "values")
    assert np.all(tout[valid_out == 0] == 0), "empty slots must stay exactly 0"
    ok = valid_in > 0
    _close(targs[0].grad.numpy()[ok], np.asarray(jgrads[0])[ok], "dF")
    for i in range(1, len(args)):
        _close(targs[i].grad.numpy(), np.asarray(jgrads[i]), f"grad {i}")


@pytest.mark.parametrize("level,cin,cout,kernel", [(0, 3, 8, 3), (0, 6, 5, 5),
                                                   (1, 5, 7, 3)])
def test_brick_conv_matches_jax(pyramids, level, cin, cout, kernel):
    """``brick_conv`` (the plain twins of brick_gemm and brick_wgrad) against
    JAX's custom-VJP brick conv: values, dF, dW and the bias gradient."""
    jp, tp, _ = pyramids
    tl, jl = tp.levels[level], jp.levels[level]
    rng = np.random.RandomState(level * 10 + cin)
    plan = brick.build_plan(kernel)
    k = plan.num_taps
    f = _feats(rng, tl.valid, cin)
    w = rng.randn(k, cin, cout).astype(np.float32) * 0.3
    b = rng.randn(cout).astype(np.float32)
    ct = _feats(rng, tl.valid, cout)
    jnbr = jnp.asarray(np.asarray(jl.nbr.nbr, np.int32))
    nbr, valid = _i(tl.nbr.nbr), _t(tl.valid)
    jplan = jbrick.build_plan(kernel)
    _check(lambda f, w, b: jbrick.brick_conv(f, jnbr, w, jplan, bias=b,
                                             valid_out=jl.valid),
           lambda f, w, b: brick.brick_conv(f, nbr, w, plan, bias=b, valid_out=valid),
           (f, w, b), ct, tl.valid, tl.valid)


def test_brick_kernel_twins_are_jax_core(pyramids):
    """The two kernels' plain twins against JAX ``_brick_core`` and the dW
    of its custom backward, unmasked (empty slots get their neighbours'
    sums), and the CPU wrappers launch nothing."""
    jp, tp, _ = pyramids
    tl = tp.levels[0]
    rng = np.random.RandomState(4)
    plan = brick.build_plan(3)
    f = _feats(rng, tl.valid, 4)
    w = rng.randn(27, 4, 6).astype(np.float32)
    ct = rng.randn(tl.valid.shape[0], 6).astype(np.float32)
    jnbr = jnp.asarray(np.asarray(tl.nbr.nbr, np.int32))
    want = np.asarray(jbrick._brick_core(jnp.asarray(f), jnbr, jnp.asarray(w),
                                         jbrick.build_plan(3)))
    steps = brick.slot_steps(plan)
    kernels.reset_launches()
    got = kernels.brick_gemm(_t(f), _i(tl.nbr.nbr), steps, _t(w)).numpy()
    _close(got, want, "brick_gemm")
    _, _, jdw = jbrick._brick_sym_bwd(
        jbrick.build_plan(3), jbrick._tap_reversal(jbrick.build_plan(3)),
        (jnp.asarray(f), jnbr, jnp.asarray(w)), jnp.asarray(ct))
    dw = kernels.brick_wgrad(_t(f), _i(tl.nbr.nbr), steps, _t(ct), 27).numpy()
    _close(dw, np.asarray(jdw), "brick_wgrad")
    assert kernels.launch_counts()["brick_gemm"] == 0
    assert kernels.launch_counts()["brick_wgrad"] == 0


@pytest.mark.parametrize("level", [0, 1])
def test_brick_down_conv_matches_jax(pyramids, level):
    """Level 0 -> 1 places the matmul rows into level 1's bricks; level
    1 -> 2 is the hybrid boundary (``place=None``)."""
    jp, tp, _ = pyramids
    tl, tl1, jl = tp.levels[level], tp.levels[level + 1], jp.levels[level]
    assert (tl.down_nbr.place is None) == (level == 1)
    rng = np.random.RandomState(40 + level)
    f = _feats(rng, tl.valid, 5)
    w = rng.randn(8, 5, 7).astype(np.float32) * 0.3
    b = rng.randn(7).astype(np.float32)
    ct = _feats(rng, tl1.valid, 7)
    jplace = None if level == 1 else jnp.asarray(np.asarray(jl.down_nbr.place, np.int32))
    place = None if level == 1 else _i(tl.down_nbr.place)
    _check(lambda f, w, b: jbrick.brick_down_conv(f, jplace, w, bias=b,
                                                  valid_out=jp.levels[level + 1].valid),
           lambda f, w, b: brick.brick_down_conv(f, place, w, bias=b,
                                                 valid_out=_t(tl1.valid)),
           (f, w, b), ct, tl.valid, tl1.valid)


@pytest.mark.parametrize("level", [0, 1])
def test_brick_up_conv_matches_jax(pyramids, level):
    """Level 1 -> 0 gathers the parents' brick rows; level 2 -> 1 is the
    hybrid boundary (``up_gather=None``: the flat rows are the bricks)."""
    jp, tp, _ = pyramids
    tl, tl1, jl = tp.levels[level], tp.levels[level + 1], jp.levels[level]
    assert (tl.up_parent is None) == (level == 1)
    rng = np.random.RandomState(50 + level)
    f = _feats(rng, tl1.valid, 6)
    w = rng.randn(8, 6, 4).astype(np.float32) * 0.3
    ct = _feats(rng, tl.valid, 4)
    jupg = None if level == 1 else jnp.asarray(np.asarray(jl.up_parent, np.int32))
    upg = None if level == 1 else _i(tl.up_parent)
    _check(lambda f, w: jbrick.brick_up_conv(f, jupg, w, valid_out=jl.valid),
           lambda f, w: brick.brick_up_conv(f, upg, w, valid_out=_t(tl.valid)),
           (f, w), ct, tl1.valid, tl.valid)


@pytest.mark.parametrize("what", ["nbr", "place", "up_parent", "batch"])
def test_bounds_check_covers_brick_levels(pyramids, what):
    """Each brick map against the table it indexes: ``nbr < NB``,
    ``place < NB`` (the matmul's rows), the up-gather below the next
    level's rows, ``batch <= B`` at slot resolution."""
    _, tp, _ = pyramids
    rows = check_pyramid_bounds(tp)
    lv = tp.levels[0]
    nb = rows[0] // 8
    assert rows[:3] == [8 * NPADS[1], 8 * NPADS[2], NPADS[2]]
    holder, field, bound = {
        "nbr": (lv.nbr, "nbr", nb),
        "place": (lv.down_nbr, "place", nb),
        "up_parent": (lv, "up_parent", rows[1]),
        "batch": (lv, "batch", tp.num_batch + 1),
    }[what]
    keep = getattr(holder, field)
    bad = np.asarray(keep).astype(np.int32)
    bad.reshape(-1)[3] = bound
    setattr(holder, field, bad)
    try:
        with pytest.raises(ValueError, match=what):
            check_pyramid_bounds(tp)
    finally:
        setattr(holder, field, keep)
    check_pyramid_bounds(tp)


# --------------------------------------------------------------------------
# Res16UNet14A on brick:2


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def net():
    """One pair collated in the voxel and the brick:2 layouts by both
    packages; JAX's train-mode forward and parameter gradients on brick:2
    (one jitted program) and its eval output on voxel."""
    ds = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0,
                              seed=0)
    sample = ds[0]
    batches = {}
    for layout in ("voxel", "brick:2"):
        jb = j_collate_pair([sample], JPadScheme(npad0=4096), npos=64,
                            rng=np.random.RandomState(7), fuse_frames=True,
                            layout=layout)
        tb = collate_pair([sample], PadScheme(npad0=4096), npos=64,
                          rng=np.random.RandomState(7), layout=layout)
        batches[layout] = (jb, tb)
    jb, _ = batches["brick:2"]
    jmodel = j_load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                          normalize_feature=True)
    variables = jax.jit(lambda r, f: jmodel.init(r, f, jb.pyramid0, train=False))(
        jax.random.PRNGKey(0), jb.feats0)
    params = jax.device_get(variables["params"])
    stats = jax.device_get(variables["batch_stats"])
    proj = np.random.RandomState(3).randn(8).astype(np.float32)

    @jax.jit
    def jloss(params, feats, pyramid):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, feats, pyramid,
                              train=True, mutable=["batch_stats"])
        return (jnp.sin(out * 3.0) * proj).sum(), out

    (_, jout), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        params, jb.feats0, jb.pyramid0)
    tmodel = load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                        normalize_feature=True)
    load_jax_params(tmodel, {k: dict(v) for k, v in params.items()}, stats)
    return dict(batches=batches, tmodel=tmodel, proj=proj, jout=np.asarray(jout),
                jgrads=jax.device_get(jgrads))


def test_collate_pair_brick_is_byte_identical(net):
    for layout, (jb, tb) in net["batches"].items():
        for f in ("feats0", "q_idx", "k_idx", "pair_valid", "truncated_voxels"):
            _same(getattr(jb, f), getattr(tb, f), f"{layout} {f}")
        _same_pyramid(jb.pyramid0, tb.pyramid0, layout)
        tb.to("cpu")


def test_res16unet_on_brick2_matches_jax(net):
    """Train-mode forward and every parameter gradient of a scalar loss."""
    _, tb = net["batches"]["brick:2"]
    batch = tb.to("cpu")
    tmodel = net["tmodel"]
    tmodel.train(True)
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(batch.feats0, batch.pyramid0)
    (torch.sin(out * 3.0) * _t(net["proj"])).sum().backward()
    got = out.detach().numpy()
    np.testing.assert_allclose(got, net["jout"], rtol=2e-4, atol=2e-4)
    assert np.all(got[batch.pyramid0.levels[0].valid.numpy() == 0] == 0)
    named = dict(tmodel.named_parameters())
    for path, g in _flatten(net["jgrads"]):
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(named[torch_name(path)].grad.numpy(), g,
                                   rtol=2e-4, atol=2e-4 * scale,
                                   err_msg=torch_name(path))
    tmodel.zero_grad(set_to_none=True)


def test_res16unet_brick_equals_voxel(net):
    """The port's eval output at the NCE anchors, brick:2 against voxel,
    same weights (JAX's ``test_res16unet_brick_equals_voxel``)."""
    _, tv = net["batches"]["voxel"]
    _, tb = net["batches"]["brick:2"]
    tmodel = net["tmodel"].eval()
    with torch.no_grad():
        bv, bb = tv.to("cpu"), tb.to("cpu")
        qv = tmodel(bv.feats0, bv.pyramid0)[bv.q_idx]
        qb = tmodel(bb.feats0, bb.pyramid0)[bb.q_idx]
    sel = bv.pair_valid > 0
    assert torch.equal(bv.pair_valid, bb.pair_valid) and int(sel.sum()) > 0
    np.testing.assert_allclose(qb[sel].numpy(), qv[sel].numpy(), rtol=5e-4, atol=5e-4)


@pytest.mark.parametrize("crf", [None, CRF])
def test_collate_semseg_brick_is_byte_identical(crf):
    """Features, labels and the CRF map at the brick rows (``rows=``)."""
    samples = SemsegScenes(scenes=3, points=1500, room=1.2, voxel=0.05).samples
    kw = dict(ignore_label=255, shift_coords=True, limit_numpoints=0,
              layout="brick", crf=crf, num_chunks=4)
    jb = j_collate_semseg(samples, JPadScheme(npad0=4096), rng=np.random.RandomState(5),
                          **kw)
    tb = collate_semseg(samples, PadScheme(npad0=4096), rng=np.random.RandomState(5), **kw)
    for f in ("feats", "labels", "truncated_voxels", "crf_nbr"):
        _same(getattr(jb, f), getattr(tb, f), f)
    _same_pyramid(jb.pyramid, tb.pyramid, "semseg")
    assert sum(isinstance(l.nbr, brick.BrickMap) for l in tb.pyramid.levels) == 2
    tb.to("cpu")


def test_hyper_refuses_brick_levels():
    samples = SemsegScenes(scenes=2, points=800, room=1.0, voxel=0.05).samples
    batch = collate_semseg(samples, PadScheme(npad0=2048), layout="brick",
                           rng=np.random.RandomState(0)).to("cpu")
    model = load_model("MinkUNetHyper14INBN")(in_channels=3, out_channels=5)
    with pytest.raises(ValueError, match="layout='voxel'"):
        model(batch.feats, batch.pyramid)
