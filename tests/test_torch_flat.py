"""The voxel (flat) layout of the port against the JAX package, on the CPU:
the flat same-level conv (JAX ``_conv_sym``), the flat k2s2 down conv
(JAX ``_conv_core`` autodiff), the flat transposed conv, the flat pooling
ops, the per-level bounds check, Res16UNet14A on a flat pyramid, and the
byte-identical voxel collates (pair, semseg with and without the CRF map,
detection).

Inputs are made with numpy from seeds and go through both packages, f32,
JAX matmuls at "highest".  Tolerances: single ops 1e-5 of the largest
magnitude (JAX's flat ``_conv_core`` multiplies, then gathers; the port
gathers, then multiplies: the same sums, rounded in another order); the
network 2e-4 (train-mode BN amplifies summation-order noise), as
``tests/test_torch_model.py``.  Valid rows are compared; pad rows of every
output must be exactly 0 (pad-row gradients are garbage by design)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.data.collate import collate_pair as j_collate_pair
from pointcontrast_tpu.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu.detect.datasets import SyntheticDetectionDataset as JDet
from pointcontrast_tpu.detect.datasets import collate_detection as j_collate_det
from pointcontrast_tpu.nn.registry import load_model as j_load_model
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate_semseg
from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu.sparse.topology import build_pyramid as j_build
from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    PairBatch,
    check_pyramid_bounds,
    collate_pair,
)
from pointcontrast_tpu_torch.detect.datasets import SyntheticDetectionDataset
from pointcontrast_tpu_torch.detect.datasets import collate_detection
from pointcontrast_tpu_torch.nn.registry import load_model
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.sparse import ops
from pointcontrast_tpu_torch.sparse.topology import build_pyramid
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.tools.workload import SemsegScenes

CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0, chromatic_sigma=12.0)
FIELDS = ("nbr", "valid", "batch", "down_nbr", "up_parent", "up_offset", "nbr0")


def _coords(seed=0, n=(150, 90, 120), extent=24):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyramids():
    c = _coords()
    jp, jmeta = j_build(c, 5, npads=[420, 400, 300, 120, 40], num_batch=3)
    tp, tmeta = build_pyramid(c, 5, npads=[420, 400, 300, 120, 40], num_batch=3)
    assert not jmeta.truncated and not tmeta.truncated
    return jp, tp


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _same_pyramid(jp, tp, tag=""):
    assert jp.num_batch == tp.num_batch
    for l, (jl, tl) in enumerate(zip(jp.levels, tp.levels, strict=True)):
        for f in FIELDS:
            _same(getattr(jl, f), getattr(tl, f), f"{tag} level {l} {f}")
        assert jl.rev == tl.rev and jl.rev0 == tl.rev0, (tag, l)


@pytest.mark.parametrize("first_nbr_level", [0, 1])
def test_flat_pyramid_is_byte_identical(first_nbr_level):
    """``build_pyramid`` with and without ``first_nbr_level`` (the brick
    layout's), with the stem's 5^3 map."""
    c = _coords(3)
    kw = dict(npads=[420, 400, 300, 120, 40], num_batch=3, conv0_kernel_size=5,
              first_nbr_level=first_nbr_level)
    _same_pyramid(j_build(c, 5, **kw)[0], build_pyramid(c, 5, **kw)[0])


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
    """Values and the gradients of every argument of both functions; the
    first argument's (features) at valid rows only."""
    jout, vjp = jax.vjp(jfn, *[jnp.asarray(a) for a in args])
    jgrads = vjp(jnp.asarray(ct))
    targs = [_t(a).requires_grad_(True) for a in args]
    tout = tfn(*targs)
    tout.backward(_t(ct))
    tout = tout.detach().numpy()
    _close(tout, np.asarray(jout), "values")
    assert np.all(tout[valid_out == 0] == 0), "pad rows must stay exactly 0"
    ok = valid_in > 0
    _close(targs[0].grad.numpy()[ok], np.asarray(jgrads[0])[ok], "dF")
    for i in range(1, len(args)):
        _close(targs[i].grad.numpy(), np.asarray(jgrads[i]), f"grad {i}")


@pytest.mark.parametrize("level,cin,cout", [(0, 3, 8), (0, 6, 5), (2, 5, 7)])
def test_flat_conv_sym_matches_jax(pyramids, level, cin, cout):
    """A flat same-level map with ``rev`` and ``valid_out``: JAX
    ``_conv_sym``; the port's K1 at B = 1.  Values and all three gradients
    (features, weights, bias)."""
    jp, tp = pyramids
    jl, tl = jp.levels[level], tp.levels[level]
    rng = np.random.RandomState(level * 10 + cin)
    f = _feats(rng, tl.valid, cin)
    w = rng.randn(27, cin, cout).astype(np.float32) * 0.3
    b = rng.randn(cout).astype(np.float32)
    ct = _feats(rng, tl.valid, cout)
    jnbr = jnp.asarray(np.asarray(jl.nbr, np.int32))
    nbr, valid = _i(tl.nbr), _t(tl.valid)
    _check(lambda f, w, b: jops.sparse_conv(f, jnbr, w, bias=b, valid_out=jl.valid,
                                            rev=jl.rev),
           lambda f, w, b: ops.sparse_conv(f, nbr, w, bias=b, valid_out=valid,
                                           rev=tl.rev),
           (f, w, b), ct, tl.valid, tl.valid)


@pytest.mark.parametrize("level,cin,cout", [(0, 6, 5), (1, 4, 9)])
def test_flat_down_conv_matches_jax(pyramids, level, cin, cout):
    """The flat k2s2 down conv: JAX ``_conv_core`` and its autodiff; the
    port's K2 at B = 1 (dF through the parent map, no scatter)."""
    jp, tp = pyramids
    jl, tl, tl1 = jp.levels[level], tp.levels[level], tp.levels[level + 1]
    rng = np.random.RandomState(100 + level)
    f = _feats(rng, tl.valid, cin)
    w = rng.randn(8, cin, cout).astype(np.float32) * 0.3
    ct = _feats(rng, tl1.valid, cout)
    jdown = jnp.asarray(np.asarray(jl.down_nbr, np.int32))
    jv1 = jp.levels[level + 1].valid
    up = (_i(tl.up_parent), _i(tl.up_offset))
    down, v1 = _i(tl.down_nbr), _t(tl1.valid)
    _check(lambda f, w: jops.sparse_conv(f, jdown, w, valid_out=jv1,
                                         up=(jl.up_parent, jl.up_offset)),
           lambda f, w: ops.sparse_conv(f, down, w, valid_out=v1, up=up),
           (f, w), ct, tl.valid, tl1.valid)


@pytest.mark.parametrize("level,cin,cout", [(0, 5, 3), (2, 8, 6)])
def test_flat_transpose_matches_jax(pyramids, level, cin, cout):
    """The flat k2s2 transposed conv (JAX's scan over offsets and its
    autodiff); the port's K3 at B = 1."""
    jp, tp = pyramids
    jl, tl, tl1 = jp.levels[level], tp.levels[level], tp.levels[level + 1]
    rng = np.random.RandomState(200 + level)
    f = _feats(rng, tl1.valid, cin)
    w = rng.randn(8, cin, cout).astype(np.float32) * 0.3
    b = rng.randn(cout).astype(np.float32)
    ct = _feats(rng, tl.valid, cout)
    jupp = jnp.asarray(np.asarray(jl.up_parent, np.int32))
    jupo = jnp.asarray(np.asarray(jl.up_offset, np.int32))
    upp, upo, valid = _i(tl.up_parent), _i(tl.up_offset), _t(tl.valid)
    _check(lambda f, w, b: jops.sparse_conv_transpose(f, jupp, jupo, w, bias=b,
                                                      valid_out=jl.valid),
           lambda f, w, b: ops.sparse_conv_transpose(f, upp, upo, w, bias=b,
                                                     valid_out=valid),
           (f, w, b), ct, tl1.valid, tl.valid)


@pytest.mark.parametrize("op", ["sum_pool", "avg_pool", "avg_unpool"])
@pytest.mark.parametrize("level", [0, 2])
def test_flat_pooling_matches_jax(pyramids, op, level):
    """The flat K5 ops on ``gather_sum`` / ``scatter_sum`` at B = 1, values
    and gradients; the scatter leaves out the one pad row of the batch."""
    jp, tp = pyramids
    jl, tl, tl1 = jp.levels[level], tp.levels[level], tp.levels[level + 1]
    rng = np.random.RandomState(300 + level)
    jdown = jnp.asarray(np.asarray(jl.down_nbr, np.int32))
    down = _i(tl.down_nbr)
    if op == "avg_unpool":
        f, ct, vin, vout = _feats(rng, tl1.valid, 6), _feats(rng, tl.valid, 6), tl1.valid, tl.valid
        jupp = jnp.asarray(np.asarray(jl.up_parent, np.int32))
        upp = _i(tl.up_parent)
        jfn = lambda x: jops.sparse_avg_unpool(x, jupp, jl.valid)  # noqa: E731
        tfn = lambda x: ops.sparse_avg_unpool(x, upp, _t(tl.valid))  # noqa: E731
    else:
        f, ct, vin, vout = _feats(rng, tl.valid, 6), _feats(rng, tl1.valid, 6), tl.valid, tl1.valid
        if op == "sum_pool":
            jfn = lambda x: jops.sparse_sum_pool(x, jdown, jp.levels[level + 1].valid)  # noqa: E731
            tfn = lambda x: ops.sparse_sum_pool(x, down, _t(tl1.valid))  # noqa: E731
        else:
            jfn = lambda x: jops.sparse_avg_pool(  # noqa: E731
                x, jdown, jl.valid, jp.levels[level + 1].valid)
            tfn = lambda x: ops.sparse_avg_pool(x, down, _t(tl.valid), _t(tl1.valid))  # noqa: E731
    _check(jfn, tfn, (f,), ct, vin, vout)


@pytest.mark.parametrize("what", ["nbr", "down_nbr", "up_parent", "up_offset", "batch"])
def test_bounds_check_is_per_level(pyramids, what):
    """``check_pyramid_bounds`` accepts a good flat pyramid (returning each
    level's rows) and rejects one index past its own level's table, though
    it would still lie inside level 0's."""
    _, tp = pyramids
    assert check_pyramid_bounds(tp) == [420, 400, 300, 120, 40]
    lv = tp.levels[2]
    keep = getattr(lv, what)
    bad = np.asarray(keep).astype(np.int32)
    bound = {"nbr": 300, "down_nbr": 300, "up_parent": 120, "up_offset": 8,
             "batch": tp.num_batch + 1}[what]
    bad.reshape(-1)[5] = bound
    setattr(lv, what, bad)
    try:
        with pytest.raises(ValueError, match=what):
            check_pyramid_bounds(tp)
    finally:
        setattr(lv, what, keep)
    check_pyramid_bounds(tp)


# --------------------------------------------------------------------------
# Res16UNet14A on a flat pyramid (ROADMAP item 2a's done criterion)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _perturb(tree, rng, positive=False):
    """Random BN statistics/affines (a fresh init has scale 1, bias 0)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, positive)
            continue
        v = np.asarray(v)
        if positive and k == "var":
            out[k] = (v * rng.uniform(0.5, 1.5, v.shape)).astype(np.float32)
        else:
            out[k] = (v + rng.uniform(-0.2, 0.2, v.shape)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def net(pyramids):
    jp, tp = pyramids
    rng = np.random.RandomState(11)
    feats = _feats(rng, tp.levels[0].valid, 3)
    jmodel = j_load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                          normalize_feature=True)
    variables = jax.jit(lambda r, f: jmodel.init(r, f, jp, train=False))(
        jax.random.PRNGKey(0), feats)
    params = _perturb({k: dict(v) for k, v in jax.device_get(variables["params"]).items()},
                      rng)
    stats = _perturb(jax.device_get(variables["batch_stats"]), rng, positive=True)
    tmodel = load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                        normalize_feature=True)
    load_jax_params(tmodel, params, stats)
    host = PairBatch(feats0=feats, pyramid0=tp, q_idx=np.zeros(1, np.int32),
                     k_idx=np.zeros(1, np.int32), pair_valid=np.zeros(1, np.float32),
                     truncated_voxels=np.zeros((), np.float32))
    proj = rng.randn(8).astype(np.float32)

    def jloss(params):
        out, mut = jmodel.apply({"params": params, "batch_stats": stats}, feats, jp,
                                train=True, mutable=["batch_stats"])
        return (jnp.sin(out * 3.0) * proj).sum(), out

    # compiled: op by op, this took ~90 s of CPU
    (_, jout), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    return dict(tmodel=tmodel, batch=host.to("cpu"), proj=proj,
                jout=np.asarray(jout), jgrads=jax.device_get(jgrads))


def test_res16unet_on_flat_pyramid_matches_jax(net):
    """Train-mode forward and every parameter gradient of a scalar loss."""
    tmodel, batch = net["tmodel"], net["batch"]
    tmodel.train(True)
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(batch.feats0, batch.pyramid0)
    (torch.sin(out * 3.0) * _t(net["proj"])).sum().backward()
    got = out.detach().numpy()
    np.testing.assert_allclose(got, net["jout"], rtol=2e-4, atol=2e-4)
    assert np.all(got[batch.pyramid0.levels[0].valid.numpy() == 0] == 0)
    named = dict(tmodel.named_parameters())
    checked = 0
    for path, g in _flatten(net["jgrads"]):
        g = np.asarray(g)
        t = named[torch_name(path)].grad.numpy()
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(t, g, rtol=2e-4, atol=2e-4 * scale,
                                   err_msg=torch_name(path))
        checked += 1
    assert checked == len(named)


# --------------------------------------------------------------------------
# byte-identical voxel collates


def test_collate_pair_voxel_is_byte_identical():
    ds = SyntheticPairDataset(num_pairs=4, points_per_frame=1500, room_size=1.2, seed=0)
    samples = [ds[i] for i in range(2)]
    jb = j_collate_pair(samples, JPadScheme(npad0=4096), npos=64,
                        rng=np.random.RandomState(1), fuse_frames=True, layout="voxel")
    tb = collate_pair(samples, PadScheme(npad0=4096), npos=64,
                      rng=np.random.RandomState(1), layout="voxel")
    for f in ("feats0", "q_idx", "k_idx", "pair_valid", "truncated_voxels"):
        _same(getattr(jb, f), getattr(tb, f), f)
    _same_pyramid(jb.pyramid0, tb.pyramid0, "pair")
    dev = tb.to("cpu")
    assert dev.pyramid0.levels[0].nbr.dtype == torch.int32
    assert dev.pyramid0.levels[0].nbr.shape == (27, 4097)


@pytest.mark.parametrize("crf", [None, CRF])
def test_collate_semseg_voxel_is_byte_identical(crf):
    """The voxel layout's CRF map is built over the global rows."""
    samples = SemsegScenes(scenes=3, points=1500, room=1.2, voxel=0.05).samples
    kw = dict(ignore_label=255, shift_coords=True, limit_numpoints=0,
              layout="voxel", crf=crf)
    jb = j_collate_semseg(samples, JPadScheme(npad0=4096), rng=np.random.RandomState(5),
                          **kw)
    tb = collate_semseg(samples, PadScheme(npad0=4096), rng=np.random.RandomState(5), **kw)
    assert jb.num_samples == tb.num_samples == 3
    for f in ("feats", "labels", "truncated_voxels", "crf_nbr"):
        _same(getattr(jb, f), getattr(tb, f), f)
    _same_pyramid(jb.pyramid, tb.pyramid, "semseg")
    dev = tb.to("cpu")
    assert dev.feats.shape[0] == 4097 and (crf is None) == (dev.crf_nbr is None)


def test_collate_detection_voxel_is_byte_identical():
    """Orphaned points (their voxel dropped by the budget) point at the
    global pad row."""
    jds = JDet(num_scenes=2, num_points=3000, seed=0)
    tds = SyntheticDetectionDataset(num_scenes=2, num_points=3000, seed=0)
    kw = dict(voxel_size=0.05, layout="voxel")
    jb = j_collate_det([jds[0], jds[1]], scheme=JPadScheme(npad0=1024), **kw)
    tb = collate_detection([tds[0], tds[1]], scheme=PadScheme(npad0=1024), **kw)
    for f in ("point_clouds", "voxel_feats", "point_voxel_idx", "vote_label"):
        _same(getattr(jb, f), getattr(tb, f), f)
    _same_pyramid(jb.voxel_pyramid, tb.voxel_pyramid, "detection")
    npad0 = PadScheme(npad0=1024).npads[0]
    assert int((tb.point_voxel_idx == npad0 - 1).sum()) > 0  # the budget dropped voxels
    tb.to("cpu")
    bad = tb.point_voxel_idx.copy()
    bad[1, 3] = npad0
    with pytest.raises(ValueError, match="point_voxel_idx"):
        type(tb)(**{**tb.__dict__, "point_voxel_idx": bad}).to("cpu")
