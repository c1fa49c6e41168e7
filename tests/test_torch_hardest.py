"""The port's hardest-contrastive pretraining against the JAX package's, on
the CPU (JAX at "highest" matmul precision), on numpy inputs from seeds:

  - ``_packed_bit``: exact, at a candidate count that is not a multiple of 8;
  - ``_pdist`` and ``hardest_contrastive_loss`` in f32, at the cases of
    ``tests/test_losses.py::TestHardestContrastive`` (collision bitmaps from
    the true pairs, which drop anchors), with padded positives and with
    invalid candidates: the argmins equal, the distances, ``pos_loss`` and
    ``neg_loss`` within rtol 1e-5, the gradients of both feature tables
    within 1e-5 of their largest magnitude;
  - the bf16 loss on bf16-rounded features.  The rounding rule is that of
    the jitted JAX loss on XLA's CPU backend (the train step is jitted),
    found by comparing its intermediates with numpy emulations: the squared
    norms ``jnp.sum(a * a, 1)`` keep the products exact, add them in f32 and
    round the sum once (the op-by-op JAX rounds each product instead); the
    positive distance rounds the difference, keeps its squares exact and
    rounds the row sum once; ``pos_thresh`` is rounded to bf16 before the
    subtraction, whose result is rounded; the masked sum is rounded once and
    divided by the bf16 count (4095 valid positives count 4096).  Held
    bit-equal: the squared norms, the positive distances and ``pos_loss``
    (bf16); ``neg_loss`` is f32 (f32 products of the bf16 rows, summed in
    another order): rtol 1e-5;
  - ``sample_hardest_contrastive`` and ``_collision_bitmap``: byte-equal,
    with no matches and with fewer points than ``num_hn`` too;
  - ``collate_pair(mode="hardest")``: every loss field, the features and the
    truncation count byte-equal in the chunked, voxel and brick:2 layouts,
    on a scheme that fits and one that truncates (orphans dropped);
  - ``PairBatch.to`` refuses a corrupted ``pos1_idx`` or ``cand0_idx`` and a
    bitmap of the wrong width;
  - one hardest step of Res16UNet14's blocks at narrow widths with JAX's
    weights (a flax tree from a seed, carried by ``tools/from_jax.py``),
    with the tolerances of ``tests/test_torch_pretrain.py``'s NCE step: the loss rtol 1e-5, the
    parameters after SGD rtol and atol 1e-4; the count of hardest-negative
    picks that differ from JAX's is printed (one JAX compile)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data import PadScheme as JPadScheme
from pointcontrast_tpu.data import SyntheticPairDataset as JDataset
from pointcontrast_tpu.data import collate as jcollate
from pointcontrast_tpu.losses import contrastive as jloss
from pointcontrast_tpu.nn.res16unet import Res16UNet14 as JRes16UNet14
from pointcontrast_tpu.train import PretrainConfig as JConfig
from pointcontrast_tpu.train import make_train_step as j_make_train_step
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu.train.state import TrainState
from pointcontrast_tpu_torch.data import PadScheme, SyntheticPairDataset
from pointcontrast_tpu_torch.data import collate as tcollate
from pointcontrast_tpu_torch.losses import contrastive as tloss
from pointcontrast_tpu_torch.nn.res16unet import Res16UNet14
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.train import PretrainConfig, make_train_step, optim

LOSS_FIELDS = tcollate.HARDEST_FIELDS


def _same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype,
                                                       a.shape, b.shape)
    assert a.tobytes() == b.tobytes(), what


def test_packed_bit_is_exact():
    rng = np.random.RandomState(0)
    p, h = 300, 37  # 5 bytes a row, the last one partly used
    bits = rng.rand(p, h) < 0.3
    packed = np.packbits(bits, axis=1, bitorder="little")
    col = rng.randint(0, h, p)
    got = tloss._packed_bit(torch.from_numpy(packed), torch.from_numpy(col))
    want = jloss._packed_bit(jnp.asarray(packed), jnp.asarray(col))
    np.testing.assert_array_equal(got.numpy(), bits[np.arange(p), col])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _loss_case(case):
    """Features and sampled indices as TestHardestContrastive builds them:
    random true pairs (anchors repeated), positives drawn from them,
    candidates from each frame, bitmaps of the true pairs among them."""
    rng = np.random.RandomState(2)
    n0, n1, c, p, h = 80, 90, 6, 20, 30
    f0 = rng.randn(n0, c).astype(np.float32)
    f1 = rng.randn(n1, c).astype(np.float32)
    all_pairs = np.stack([rng.randint(0, n0, 60), rng.randint(0, n1, 60)], axis=1)
    pos = all_pairs[rng.choice(60, p, replace=False)]
    cand0 = rng.choice(n0, h, replace=False)
    cand1 = rng.choice(n1, h, replace=False)
    # make a third of the anchors' nearest candidates true pairs: the
    # collision bitmaps then drop them from the negative loss
    for i in range(0, p, 3):
        j = np.argmin(((f0[pos[i, 0]] - f1[cand1]) ** 2).sum(1))
        all_pairs = np.concatenate([all_pairs, [[pos[i, 0], cand1[j]]]])
        k = np.argmin(((f1[pos[i, 1]] - f0[cand0]) ** 2).sum(1))
        all_pairs = np.concatenate([all_pairs, [[cand0[k], pos[i, 1]]]])
    pair_set = {tuple(q) for q in all_pairs}
    collide0 = np.array([[(pos[i, 0], cand1[j]) in pair_set for j in range(h)]
                         for i in range(p)])
    collide1 = np.array([[(cand0[j], pos[i, 1]) in pair_set for j in range(h)]
                         for i in range(p)])
    pos_valid = np.ones(p, np.float32)
    cand0_valid = np.ones(h, np.float32)
    cand1_valid = np.ones(h, np.float32)
    if case == "padded_positives":
        pos_valid[13:] = 0
        pos[13:] = 0
    if case == "invalid_candidates":
        cand0_valid[21:] = 0
        cand1_valid[9:] = 0
    return (f0, f1, pos[:, 0].astype(np.int32), pos[:, 1].astype(np.int32), pos_valid,
            cand0.astype(np.int32), cand0_valid, cand1.astype(np.int32), cand1_valid,
            np.packbits(collide0, axis=1, bitorder="little"),
            np.packbits(collide1, axis=1, bitorder="little"))


def _torch_args(arrays):
    return [torch.from_numpy(a.astype(np.int64)) if a.dtype == np.int32
            else torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", ["collisions", "padded_positives", "invalid_candidates"])
def test_f32_loss_and_gradients_match_jax(case):
    arrays = _loss_case(case)
    f0, f1 = arrays[:2]
    jargs = [jnp.asarray(a) for a in arrays[2:]]

    def jtotal(f0, f1):
        pos, neg = jloss.hardest_contrastive_loss(f0, f1, *jargs)
        return pos + neg, (pos, neg)

    (_, (jpos, jneg)), jgrads = jax.jit(jax.value_and_grad(
        jtotal, argnums=(0, 1), has_aux=True))(jnp.asarray(f0), jnp.asarray(f1))
    t0 = torch.from_numpy(f0).requires_grad_()
    t1 = torch.from_numpy(f1).requires_grad_()
    targs = _torch_args(arrays[2:])
    tpos, tneg, picks = tloss.hardest_contrastive_loss(t0, t1, *targs,
                                                       return_hardest=True)
    (tpos + tneg).backward()

    pos0, pos1, _, cand0, cand0_valid, cand1, cand1_valid = arrays[2:9]
    jd01 = np.asarray(jloss._pdist(jnp.asarray(f0[pos0]), jnp.asarray(f1[cand1])))
    td01 = tloss._pdist(torch.from_numpy(f0[pos0]), torch.from_numpy(f1[cand1]))
    np.testing.assert_allclose(td01.numpy(), jd01, rtol=1e-5)
    for d, (pos_f, cands, valid, fc) in zip(
            picks, ((f0[pos0], cand1, cand1_valid, f1),
                              (f1[pos1], cand0, cand0_valid, f0))):
        jd = np.where(valid[None] > 0,
                      np.asarray(jloss._pdist(jnp.asarray(pos_f), jnp.asarray(fc[cands]))),
                      1e9)
        np.testing.assert_array_equal(d.numpy(), jd.argmin(1))
    if case == "collisions":
        pos_valid, collides = targs[2], targs[7:9]
        dropped = [int(((pos_valid > 0) & tloss._packed_bit(c, i)).sum())
                   for c, i in zip(collides, picks)]
        assert min(dropped) > 0, dropped
    np.testing.assert_allclose(tpos.item(), float(jpos), rtol=1e-5)
    np.testing.assert_allclose(tneg.item(), float(jneg), rtol=1e-5)
    for t, j in zip((t0.grad, t1.grad), jgrads):
        j = np.asarray(j)
        assert np.abs(t.numpy() - j).max() <= 1e-5 * np.abs(j).max()


def test_bf16_loss_follows_the_jitted_jax_roundings():
    rng = np.random.RandomState(5)
    n, c, p, h = 3000, 32, 4096, 1024
    f = rng.randn(n, c).astype(np.float32)
    f *= 0.6 / np.linalg.norm(f, axis=1, keepdims=True)
    fb = jnp.asarray(f).astype(jnp.bfloat16)
    tf = torch.from_numpy(np.array(fb.astype(jnp.float32))).to(torch.bfloat16)
    pos0, pos1 = rng.randint(0, n, p), rng.randint(0, n, p)
    pos_valid = (np.arange(p) < p - 1).astype(np.float32)  # 4095: counts 4096
    cand = rng.choice(n, h, replace=False)
    valid = np.ones(h, np.float32)
    bits = np.packbits(rng.rand(p, h) < 0.01, axis=1, bitorder="little")
    arrays = (pos0.astype(np.int32), pos1.astype(np.int32), pos_valid,
              cand.astype(np.int32), valid, cand.astype(np.int32), valid, bits, bits)

    def bits_of(a):
        return np.asarray(a).view(np.uint16)

    jsq = jax.jit(lambda a: jnp.sum(a * a, axis=1))(fb)
    _same_bytes(bits_of(tloss._sum_squares(tf).view(torch.int16).numpy()),
                bits_of(jsq), "squared norms")
    jd2 = jax.jit(lambda a: jnp.sum(jnp.square(a[pos0] - a[pos1]), axis=1))(fb)
    _same_bytes(bits_of(tloss._sum_squares(tf[pos0] - tf[pos1]).view(torch.int16).numpy()),
                bits_of(jd2), "positive distances")
    jpos, jneg = jax.jit(jloss.hardest_contrastive_loss)(
        fb, fb, *[jnp.asarray(a) for a in arrays])
    tpos, tneg = tloss.hardest_contrastive_loss(tf, tf, *_torch_args(arrays))
    assert tpos.dtype == torch.bfloat16 and jpos.dtype == jnp.bfloat16
    assert tneg.dtype == torch.float32 and jneg.dtype == jnp.float32
    assert float(tpos) == float(jpos)
    np.testing.assert_allclose(float(tneg), float(jneg), rtol=1e-5)


def _matches(rng, n0, n1, m):
    return np.stack([rng.randint(0, n0, m), rng.randint(0, n1, m)], 1).astype(np.int64)


@pytest.mark.parametrize("case", ["matches", "no_matches", "few_points"])
def test_sampling_and_bitmaps_byte_equal(case):
    n0, n1, num_pos, num_hn = {"few_points": (40, 25, 64, 32)}.get(case, (500, 450, 64, 32))
    matches = _matches(np.random.RandomState(3), n0, n1, 0 if case == "no_matches" else 300)
    got = tcollate.sample_hardest_contrastive(matches, n0, n1, num_pos, num_hn,
                                              np.random.RandomState(11))
    want = jcollate.sample_hardest_contrastive(matches, n0, n1, num_pos, num_hn,
                                               np.random.RandomState(11))
    assert set(got) == set(want) == set(LOSS_FIELDS)
    for k in LOSS_FIELDS:
        _same_bytes(got[k], want[k], k)
    if case != "no_matches":
        assert np.unpackbits(got["collide0"]).any()
    cands = got["cand1_idx"]
    _same_bytes(tcollate._collision_bitmap(matches[:, 0], matches[:, 1], got["pos0_idx"],
                                           cands, min(n1, num_hn), n1),
                jcollate._collision_bitmap(matches[:, 0], matches[:, 1], got["pos0_idx"],
                                           cands, min(n1, num_hn), n1), "bitmap")


SCHEMES = {"fits": lambda P: P(npad0=4096, level_ratios=(1.0,) * 5),
           "truncates": lambda P: P.scannet(npad0=4096)}


def _both_batches(layout, scheme="fits"):
    kw = dict(mode="hardest", npos=16, num_pos=128, num_hn=64, fuse_frames=True,
              layout=layout)
    jds = JDataset(num_pairs=2, points_per_frame=400, seed=0)
    tds = SyntheticPairDataset(num_pairs=2, points_per_frame=400, seed=0)
    jb = jcollate.collate_pair([jds[0], jds[1]], SCHEMES[scheme](JPadScheme),
                               rng=np.random.RandomState(7), **kw)
    tb = tcollate.collate_pair([tds[0], tds[1]], SCHEMES[scheme](PadScheme),
                               rng=np.random.RandomState(7), **kw)
    return jb, tb


@pytest.mark.parametrize("scheme", sorted(SCHEMES))
@pytest.mark.parametrize("layout", ["chunked", "voxel", "brick:2"])
def test_collate_hardest_byte_equal(layout, scheme):
    jb, tb = _both_batches(layout, scheme)
    for name in ("feats0", "truncated_voxels") + LOSS_FIELDS:
        _same_bytes(getattr(tb, name), getattr(jb, name), name)
    assert tb.q_idx is None and jb.q_idx is None
    for jl, tl in zip(jb.pyramid0.levels, tb.pyramid0.levels):
        _same_bytes(tl.valid, jl.valid, "valid")
    if scheme == "truncates" and layout != "voxel":
        assert float(tb.truncated_voxels) > 0
    moved = tb.to("cpu")
    assert moved.pos0_idx.dtype == torch.int64 and moved.collide1.dtype == torch.uint8
    np.testing.assert_array_equal(moved.cand1_idx.numpy(), tb.cand1_idx)


@pytest.mark.parametrize("what", ["pos1_idx", "cand0_idx", "collide0"])
def test_to_refuses_corrupt_hardest_fields(what):
    _, tb = _both_batches("chunked")
    if what == "collide0":
        tb.collide0 = np.zeros((tb.collide0.shape[0], tb.collide0.shape[1] + 1), np.uint8)
    else:
        a = getattr(tb, what).copy()
        a[3] = tb.feats0.shape[0]
        setattr(tb, what, a)
    with pytest.raises(ValueError, match=what):
        tb.to("cpu")


_NARROW = dict(PLANES=(4, 8, 16, 32, 32, 16, 8, 8), INIT_DIM=4)


class JNarrow14(JRes16UNet14):
    PLANES, INIT_DIM = _NARROW["PLANES"], _NARROW["INIT_DIM"]


class TNarrow14(Res16UNet14):
    PLANES, INIT_DIM = _NARROW["PLANES"], _NARROW["INIT_DIM"]


def _jax_state(model, tx, batch):
    """A JAX train state with weights from a seed, shaped by tracing
    ``model.init`` (no compile): conv kernels N(0, 1 / fan_in), the norms'
    scales and biases near 1 and 0, running statistics 0 and 1."""
    shapes = jax.eval_shape(functools.partial(model.init, train=False),
                            jax.random.PRNGKey(0), batch.feats0, batch.pyramid0)
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return rng.randn(*shape).astype(np.float32) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "bias"):
            return (float(name == "scale") + 0.1 * rng.randn(*shape)).astype(np.float32)
        return np.full(shape, float(name == "var"), np.float32)

    params, stats = (jax.tree_util.tree_map_with_path(fill, shapes[k])
                     for k in ("params", "batch_stats"))
    return TrainState(step=0, params=jax.tree.map(jnp.asarray, params),
                      batch_stats=jax.tree.map(jnp.asarray, stats),
                      opt_state=tx.init(params), tx=tx, apply_fn=model.apply)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_hardest_step_matches_jax():
    """One SGD step of the hardest mode on a 2-pair chunked batch (as
    tests/test_chunked.py's hardest-mode layout test collates it), from
    the same weights on both sides, made on JAX's side from a seed and
    carried across: the loss and its two terms, then every parameter."""
    kw = dict(mode="hardest", npos=16, num_pos=128, num_hn=64, fuse_frames=True,
              layout="chunked")
    jds = JDataset(num_pairs=2, points_per_frame=400, seed=0)
    tds = SyntheticPairDataset(num_pairs=2, points_per_frame=400, seed=0)
    jb = jcollate.collate_pair([jds[0], jds[1]], JPadScheme(npad0=4096, level_ratios=(1.0,) * 5),
                               rng=np.random.RandomState(7), **kw)
    tb = tcollate.collate_pair([tds[0], tds[1]], PadScheme(npad0=4096, level_ratios=(1.0,) * 5),
                               rng=np.random.RandomState(7), **kw)
    jcfg = JConfig(mode="hardest", lr=0.1)
    tx = j_optim.make_optimizer(
        "sgd", jcfg.lr, j_optim.exp_lr(jcfg.exp_gamma, jcfg.lr_update_freq, stepped=True), jcfg)
    jmodel = JNarrow14(in_channels=3, out_channels=8, normalize_feature=True)
    state = _jax_state(jmodel, tx, jb)
    params0 = jax.device_get(state.params)
    stats0 = jax.device_get(state.batch_stats)

    def jstep_and_picks(state, batch):
        f, _ = state.apply_fn({"params": state.params, "batch_stats": state.batch_stats},
                              batch.feats0, batch.pyramid0, train=True,
                              mutable=["batch_stats"])
        picks = []
        for a, a_idx, c, c_idx, c_valid in (
                (f, batch.pos0_idx, f, batch.cand1_idx, batch.cand1_valid),
                (f, batch.pos1_idx, f, batch.cand0_idx, batch.cand0_valid)):
            d = jnp.where(c_valid[None] > 0, jloss._pdist(a[a_idx], c[c_idx]), 1e9)
            picks.append(jnp.argmin(d, axis=1))
        return j_make_train_step(jcfg)(state, batch), picks

    (state, metrics), jpicks = jax.jit(jstep_and_picks)(state, jb)

    model = load_jax_params(TNarrow14(in_channels=3, out_channels=8,
                                      normalize_feature=True), params0, stats0)
    tcfg = PretrainConfig(mode="hardest", lr=0.1)
    opt = optim.make_optimizer(model, tcfg)
    sched = optim.make_scheduler(opt, tcfg)
    tb = tb.to("cpu")
    got = make_train_step(tcfg)(model, opt, sched, tb, return_hardest=True)
    flips = sum(int((t.numpy() != np.asarray(j)).sum())
                for t, j in zip(got["hardest"], jpicks))
    dropped = [int(((tb.pos_valid > 0) & tloss._packed_bit(c, i)).sum())
               for c, i in zip((tb.collide0, tb.collide1), got["hardest"])]
    print(f"hardest picks differing from JAX's: {flips} of {2 * len(tb.pos0_idx)} "
          f"(losses held to rtol 1e-5), dropped by the bitmaps: {dropped}")
    for k in ("loss", "pos_loss", "neg_loss"):
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-5, err_msg=k)
    named = dict(model.named_parameters())
    for path, p in _flat(jax.device_get(state.params)):
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(),
                                   np.asarray(p), rtol=1e-4, atol=1e-4,
                                   err_msg=torch_name(path))
