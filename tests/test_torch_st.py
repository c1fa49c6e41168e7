"""The 4-D spatio-temporal (ST) nets of the port against the JAX package,
on the CPU.

  - ``build_pyramid`` on 4-D coords (``tests/test_model_zoo.py``'s
    ``_pyramid_4d``: 900 points in a 30^3 x 3 grid) byte-equal to JAX's:
    the hybrid region (29-tap block maps, the (3, 3, 3, 1) stem map) and
    the hypercube (81 taps), both with stride axes (1, 1, 1, 0), with and
    without ``build_down3``, a k = 5 stem and a truncating case;
  - the registry's ST names equal JAX's (28 classes), with JAX's depths,
    widths and blocks; ``Geometry.volumes`` equal to the tap counts of the
    maps ``build_pyramid`` makes, so a net and its pyramid cannot disagree;
  - ``STRes16UNet14``, ``STResTesseractUNet14`` and ``STResNet14`` at
    narrow widths (their depths and kernels), with the same parameters on
    both sides (``tools.from_jax``; BN affines perturbed), at input seeds
    3 and 13, against JAX evaluated in float64: the port's float32
    train-mode output and every float32 parameter gradient of a scalar
    loss within 1e-4 of the largest magnitude of JAX's, its float64 ones
    within 1e-10 (one jitted JAX value_and_grad a net).  JAX's modules
    name float32 for their BN statistics and conv accumulators, so the
    test evaluates them in float64 with x64 on and ``jnp.float32`` read as
    float64 in the two modules that name it (``_Wide``); the port's
    statistics widen with their input.  The float64 parity holds at any
    seed.  The float32 gradients do not: a ReLU gate within f32 rounding
    of zero moves them (ROADMAP Queue 3, "ReLU gates near zero"); over
    seeds 1-10 and 13 they hold at every seed but STResNet14's 7
    (2.7e-3);
  - ``STRes16UNet14`` in bf16: each valid output row within cosine 0.999
    of JAX's bf16 row, the bound ``tests/test_torch_bf16.py`` holds the
    bf16 Res16UNet to, pad rows exactly zero;
  - a 29-tap kernel loaded into an 81-tap net raises naming the parameter;
    ``check_pyramid_bounds`` rejects an ``up_offset`` of 8 on a (2, 2, 2,
    1) level;
  - ``SemsegTrainer`` on a small 4-D workload batch (``tools.workload``)
    and the semseg CLI's refusal of an ST net (JAX's app trains its 3-D
    base net under the ST name)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.nn import layers as jlayers
from pointcontrast_tpu.nn.registry import MODELS as J_MODELS
from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu.sparse.quantize import sparse_quantize
from pointcontrast_tpu.sparse.topology import build_pyramid as j_build
from pointcontrast_tpu_torch.apps import semseg as app
from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds, pyramid_to
from pointcontrast_tpu_torch.nn.registry import MODELS, load_model
from pointcontrast_tpu_torch.nn.res16unet import Res16UNet14, STResTesseract16UNetBase
from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer
from pointcontrast_tpu_torch.sparse.topology import (
    HYBRID_4D,
    TESSERACT_4D,
    build_pyramid,
)
from pointcontrast_tpu_torch.tools import workload as W
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name

FIELDS = ("nbr", "valid", "batch", "down_nbr", "down_nbr3", "up_parent", "up_offset", "nbr0")
RTOL = 1e-4
F64_RTOL = 1e-10
COS_MIN = 0.999
OUT = 5
SEEDS = (3, 13)  # the inputs' seeds
# the nets held to JAX, the levels each needs and the narrow widths both
# sides take (the depths and kernels are the nets')
NETS = {"STRes16UNet14": 5, "STResTesseractUNet14": 4, "STResNet14": 6}
WIDTHS = {"STRes16UNet14": dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 16, 8, 8)),
          "STResTesseractUNet14": dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 8, 8)),
          "STResNet14": dict(INIT_DIM=8, PLANES=(8, 16, 16, 16))}


def _coords4(n=900, seed=0):
    """``tests/test_model_zoo.py``'s 4-D points: one sample, 30^3 x 3."""
    rng = np.random.RandomState(seed)
    c = np.concatenate([np.zeros((n, 1), int), rng.randint(0, 30, (n, 3)),
                        rng.randint(0, 3, (n, 1))], 1)
    return c[sparse_quantize(c, return_index=True)].astype(np.int32)


def _same(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("case", ["hybrid", "hybrid down3", "hypercube", "hypercube down3",
                                  "hybrid stem5", "hybrid truncated"])
def test_4d_pyramid_is_byte_identical(case):
    geometry = TESSERACT_4D if case.startswith("hypercube") else HYBRID_4D
    kw = dict(geometry.pyramid_kwargs(), build_down3="down3" in case or "truncated" in case)
    if case.endswith("stem5"):
        kw["conv0_kernel_size"] = 5
    if case.endswith("truncated"):
        kw["npads"] = [1024, 512, 64, 64, 16]
    c = _coords4()
    (jp, jm), (tp, tm) = j_build(c, 5, **kw), build_pyramid(c, 5, **kw)
    assert jm.counts == tm.counts and jm.truncated == tm.truncated
    assert bool(tm.truncated) == case.endswith("truncated")
    for l, (jl, tl) in enumerate(zip(jp.levels, tp.levels, strict=True)):
        for f in FIELDS:
            _same(getattr(jl, f), getattr(tl, f), f"{case} level {l} {f}")
        assert jl.rev == tl.rev and jl.rev0 == tl.rev0, (case, l)
    lv = tp.levels[0]
    vol = geometry.volumes(kw.get("conv0_kernel_size", 3))
    assert lv.nbr.shape[0] == vol["block"] == (29 if geometry is HYBRID_4D else 81)
    assert (lv.nbr0 if lv.nbr0 is not None else lv.nbr).shape[0] == vol["stem"]
    assert lv.down_nbr.shape[0] == vol["down"] == 8
    if kw["build_down3"]:
        assert lv.down_nbr3.shape[0] == vol["down3"] == 81
    check_pyramid_bounds(tp)  # every live order a permutation, every map in range


def test_registry_st_names_equal_jax():
    names = sorted(n for n in MODELS if n.startswith("ST"))
    assert names == sorted(n for n in J_MODELS if n.startswith("ST"))
    assert len(names) == 28
    for name in names:
        t, j = MODELS[name], J_MODELS[name]
        assert t.LAYERS == j.LAYERS and t.PLANES == j.PLANES, name
        assert t.BLOCK.__name__ == j.BLOCK.__name__, name
        assert t.GEOMETRY is (TESSERACT_4D if "Tesseract" in name else HYBRID_4D), name
    assert all(MODELS[n].GEOMETRY.dimension == 3 for n in MODELS if not n.startswith("ST"))


def test_nets_take_their_tap_counts_from_the_geometry():
    """A net's conv weights have the taps of the maps its geometry builds."""
    taps = {name: sorted({p.shape[0] for p in load_model(name)(3, OUT).parameters()
                          if p.dim() == 3})
            for name in ("STRes16UNet14", "STResTesseractUNet14", "STResNet14",
                         "STResTesseractNet14")}
    assert taps == {"STRes16UNet14": [8, 27, 29], "STResTesseractUNet14": [8, 81],
                    "STResNet14": [1, 27, 29, 81], "STResTesseractNet14": [1, 81]}
    assert load_model("STRes16UNet14")(3, OUT, conv1_kernel_size=5).conv0p1s1.weight.shape[0] \
        == 125


# --------------------------------------------------------------------------
# the nets against JAX


class _Wide:
    """``jax.numpy`` with ``float32`` read as ``float64``.  JAX's layers and
    sparse ops name float32 for their BN statistics and conv accumulators,
    so with x64 on and this in their ``jnp``'s place they evaluate wholly
    in float64: the exact reference the port's float64 nets are held to."""

    def __getattr__(self, name):
        return jnp.float64 if name == "float32" else getattr(jnp, name)


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _pyramids(name, levels):
    kw = dict(MODELS[name].GEOMETRY.pyramid_kwargs(), build_down3=levels > 5)
    c = _coords4()
    jp, jm = j_build(c, levels, **kw)
    tp, _ = build_pyramid(c, levels, **kw)
    check_pyramid_bounds(tp)
    return jp, pyramid_to(tp, "cpu"), jm


def _narrow(models, name, base=None):
    """``name``'s class from the registry ``models`` at WIDTHS[name]."""
    return type(name, (base or models[name],), WIDTHS[name])


def _params(jmodel, jp, npad):
    """JAX's (params, batch_stats) trees for ``jmodel``, float64 numpy: the
    shapes of its init (traced, not run), He-normal kernels, BN scales
    1 + 0.1 N(0, 1), BN and conv biases 0.1 N(0, 1), running stats 0 / 1."""
    rng = np.random.RandomState(0)
    shapes = jax.eval_shape(lambda f: jmodel.init(jax.random.PRNGKey(0), f, jp, train=False),
                            jax.ShapeDtypeStruct((npad, 3), jnp.float32))

    def fill(path, s):
        leaf = path[-1].key
        if path[0].key == "batch_stats":
            return (np.ones if leaf == "var" else np.zeros)(s.shape)
        if leaf == "scale":
            return 1.0 + 0.1 * rng.randn(*s.shape)
        if leaf == "bias":
            return 0.1 * rng.randn(*s.shape)
        return rng.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return tree["params"], tree["batch_stats"]


def _inputs(jm, seed):
    rng = np.random.RandomState(seed)
    feats = np.zeros((jm.npads[0], 3))
    feats[:jm.counts[0]] = rng.randn(jm.counts[0], 3)
    return feats, rng.randn(OUT)


def _jax_run(name):
    """The parameters, the port's pyramid and, for each of SEEDS, the
    inputs (features, the loss's projection) and JAX's float64 train-mode
    output and gradients of sum(sin(3 out) proj): one jitted JAX
    value_and_grad, compiled once."""
    jp, tp, jm = _pyramids(name, NETS[name])
    jmodel = _narrow(J_MODELS, name)(in_channels=3, out_channels=OUT, dimension=4)
    params, stats = _params(jmodel, jp, jm.npads[0])

    def loss(params, feats, proj):
        out, _ = jmodel.apply({"params": params, "batch_stats": stats}, feats, jp,
                              train=True, mutable=["batch_stats"])
        return (jnp.sin(out * 3.0) * proj).sum(), out

    step = jax.jit(jax.value_and_grad(loss, has_aux=True))
    seeds = {}
    with jax.enable_x64(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(jlayers, "jnp", _Wide())
        mp.setattr(jops, "jnp", _Wide())
        for seed in SEEDS:
            feats, proj = _inputs(jm, seed)
            (_, out), grads = step(params, feats, proj)
            assert out.dtype == jnp.float64
            seeds[seed] = dict(feats=feats, proj=proj, out=np.asarray(out),
                               grads=jax.device_get(grads))
    return dict(params=params, stats=stats, pyramid=tp, jm=jm, jp=jp, jmodel=jmodel,
                seeds=seeds)


@pytest.fixture(scope="module")
def runs():
    """{net: (its JAX run, the port's float64 net, {seed: the port's float64
    and float32 outputs and parameter gradients})}, filled on first use:
    one JAX compile a net."""
    cache = {}

    def get(name):
        if name not in cache:
            run = _jax_run(name)
            net64 = load_jax_params(_narrow(MODELS, name)(3, OUT).double(), run["params"],
                                    run["stats"], dtype=np.float64).train()
            net32 = load_jax_params(_narrow(MODELS, name)(3, OUT), run["params"],
                                    run["stats"]).train()
            port = {}
            for seed, r in run["seeds"].items():
                net64.zero_grad(set_to_none=True)
                out = net64(torch.from_numpy(r["feats"]), run["pyramid"])
                (torch.sin(out * 3.0) * torch.from_numpy(r["proj"])).sum().backward()
                out32 = net32(torch.from_numpy(r["feats"]).float(), run["pyramid"])
                net32.zero_grad(set_to_none=True)
                (torch.sin(out32 * 3.0) * torch.from_numpy(r["proj"]).float()).sum().backward()
                port[seed] = {
                    "out64": out.detach().numpy(), "out32": out32.detach().numpy(),
                    "grads64": {k: p.grad.numpy() for k, p in net64.named_parameters()},
                    "grads32": {k: p.grad.numpy() for k, p in net32.named_parameters()}}
            cache[name] = (run, net64, port)
        return cache[name]

    return get


def _valid_out(run, name):
    return run["pyramid"].levels[-1 if name.startswith("STResNet") else 0].valid.numpy() > 0


@pytest.mark.parametrize("name", list(NETS))
def test_st_forward_matches_jax(runs, name):
    """The port's float32 train-mode output within RTOL of the largest
    magnitude of JAX's float64 output, and its float64 output within
    F64_RTOL, at each of SEEDS; pad rows exactly zero."""
    run, _, port = runs(name)
    valid = _valid_out(run, name)
    assert valid.any()
    for seed, p in port.items():
        got64, got32, want = p["out64"], p["out32"], run["seeds"][seed]["out"]
        assert got32.dtype == np.float32 and got32.shape == want.shape
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got32, want, rtol=0, atol=RTOL * scale, err_msg=str(seed))
        np.testing.assert_allclose(got64, want, rtol=0, atol=F64_RTOL * scale,
                                   err_msg=str(seed))
        assert not got32[~valid].any() and not got64[~valid].any()


@pytest.mark.parametrize("name", list(NETS))
def test_st_param_grads_match_jax(runs, name):
    """Every parameter gradient of the port's float64 net within F64_RTOL,
    and of its float32 net within RTOL, of the largest magnitude of JAX's
    float64 gradient, at each of SEEDS."""
    run, net, port = runs(name)
    for seed, p in port.items():
        checked = 0
        for path, g in _flatten(run["seeds"][seed]["grads"]):
            g = np.asarray(g)
            key = torch_name(path, net)
            scale = max(float(np.abs(g).max()), 1e-12)
            np.testing.assert_allclose(p["grads64"][key], g, rtol=0, atol=F64_RTOL * scale,
                                       err_msg=f"{key} seed {seed} float64")
            np.testing.assert_allclose(p["grads32"][key], g, rtol=0, atol=RTOL * scale,
                                       err_msg=f"{key} seed {seed} float32")
            checked += 1
        assert checked == len(p["grads64"]) == len(p["grads32"])


def _row_cos(a, b):
    return (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))


def test_st_bf16_forward_matches_jax(runs):
    """JAX's parameters in the port's bf16 STRes16UNet14 at the first of
    SEEDS: each valid output row within cosine COS_MIN of JAX's bf16 row,
    as ``tests/test_torch_bf16.py`` holds the bf16 Res16UNet's (the voxel
    layout's rounding points: each tap of the flat forwards rounded), pad
    rows exactly zero.  Printed: the whole output's cosine, and each
    side's least row cosine against the float64 output."""
    run, _, _ = runs("STRes16UNet14")
    seed = SEEDS[0]
    r = run["seeds"][seed]
    jmodel = _narrow(J_MODELS, "STRes16UNet14")(in_channels=3, out_channels=OUT,
                                                dimension=4, dtype=jnp.bfloat16)
    params = jax.tree_util.tree_map(np.float32, run["params"])
    stats = jax.tree_util.tree_map(np.float32, run["stats"])
    want = jax.jit(lambda p, f: jmodel.apply({"params": p, "batch_stats": stats}, f,
                                             run["jp"], train=True,
                                             mutable=["batch_stats"])[0])(
        params, r["feats"].astype(np.float32))
    want = np.asarray(jnp.asarray(want, jnp.float32))
    net = load_jax_params(_narrow(MODELS, "STRes16UNet14")(3, OUT, dtype=torch.bfloat16),
                          run["params"], run["stats"]).train()
    with torch.no_grad():
        out = net(torch.from_numpy(r["feats"]).float(), run["pyramid"])
    assert out.dtype == torch.bfloat16
    got = out.float().numpy()
    valid = _valid_out(run, "STRes16UNet14")
    assert not got[~valid].any() and not want[~valid].any()
    a, b, exact = (x[valid].astype(np.float64) for x in (got, want, r["out"]))
    cos = (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b))
    rows = _row_cos(a, b)
    print(f"bf16 cosine {cos:.7f}, least row {rows.min():.6f}; against float64, least "
          f"row port {_row_cos(a, exact).min():.6f} JAX {_row_cos(b, exact).min():.6f}")
    assert rows.min() >= COS_MIN, f"least row cosine {rows.min():.6f}"


def test_loading_a_29_tap_kernel_into_81_taps_names_it(runs):
    run, _, _ = runs("STRes16UNet14")
    tesseract = type("STResTesseract16UNet14", (STResTesseract16UNetBase, Res16UNet14),
                     WIDTHS["STRes16UNet14"])
    with pytest.raises(RuntimeError, match=r"size mismatch for block1_0\.conv1\.weight"):
        load_jax_params(tesseract(3, OUT), run["params"], run["stats"])


def test_bounds_check_takes_the_4d_down_maps_taps():
    """``up_offset`` must stay below the (2, 2, 2, 1) down map's 8 taps, not
    2^4; the 4-D maps and live orders pass as built."""
    pyr, _ = build_pyramid(_coords4(), 5, build_down3=True, **HYBRID_4D.pyramid_kwargs())
    check_pyramid_bounds(pyr)
    lv = pyr.levels[1]
    assert lv.down_nbr.shape[0] == 8 and int(lv.up_offset.max()) == 7
    lv.up_offset[0] = 8
    with pytest.raises(ValueError, match="level 1 up_offset"):
        check_pyramid_bounds(pyr)
    lv.up_offset[0] = 0
    lv.down3_order[0], lv.down3_order[1] = lv.down3_order[1], lv.down3_order[1]
    with pytest.raises(ValueError, match="down3_order"):
        check_pyramid_bounds(pyr)


# --------------------------------------------------------------------------
# the workload, the trainer and the CLI


def _tiny_scenes():
    return W.SemsegScenes(scenes=2, points=400, room=1.0, voxel=0.05)


@pytest.fixture(scope="module")
def st_batch():
    return W.st_semseg_batch(_tiny_scenes(), npad0=2048,
                             pad_ratios=(1.0, 0.8, 0.6, 0.4, 0.2), model="STRes16UNet14")


def test_st_workload_batch(st_batch):
    """Two sequences of three frames, each frame its room shifted by
    t * ST_SHIFT: every frame holds its room's voxels, time is never
    halved, and the batch is a flat 4-D hybrid pyramid."""
    pyr = st_batch.pyramid
    lv0 = pyr.levels[0]
    assert pyr.num_batch == 2 and lv0.nbr.shape[0] == 29 and lv0.nbr0.shape[0] == 27
    rows = st_batch.to("cpu")  # bounds-checked
    assert rows.feats.shape == (2049, 3) and float(st_batch.truncated_voxels) == 0
    n = int(lv0.valid.sum())
    assert n == 3 * sum(len(c) for c, _, _ in _tiny_scenes().samples)
    assert (st_batch.labels[:n] != 255).all() and (st_batch.labels[n:] == 255).all()
    assert lv0.down_nbr.shape[0] == 8 and lv0.up_offset[:n].max() < 8
    net = W.semseg_model(seed=0, model="STRes16UNet14")
    assert net.conv0p1s1.weight.shape == (27, 3, 32) and net.final.weight.shape == (256, 20)


def test_semseg_trainer_takes_the_4d_batch(st_batch, tmp_path):
    """Two SemsegTrainer steps of STRes16UNet14 (narrow widths) on the 4-D
    batch, f32 and bf16: finite losses, logits at the level-0 rows, pad
    rows zero."""
    narrow = type("NarrowSTRes16UNet14", (MODELS["STRes16UNet14"],),
                  dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 16, 8, 8)))
    for dtype in (None, torch.bfloat16):
        model = narrow(3, W.SEMSEG_CLASSES, bn_momentum=0.02, dtype=dtype,
                       generator=torch.Generator().manual_seed(0))
        cfg = SemsegConfig(max_iter=2, stat_freq=1, save_freq=10 ** 6,
                           checkpoint_dir=str(tmp_path / str(dtype)))
        trainer = SemsegTrainer(model, iter([st_batch] * 3), None, cfg, W.SEMSEG_CLASSES,
                                "cpu")
        history = trainer.train(2)
        assert [i for i, _ in history] == [1, 2]
        assert all(np.isfinite(m["loss"]) for _, m in history)
        batch = st_batch.to("cpu")
        trainer.model.eval()
        with torch.no_grad():
            out = trainer.model(batch.feats, batch.pyramid)
        valid = batch.pyramid.levels[0].valid > 0
        assert out.shape == (batch.feats.shape[0], W.SEMSEG_CLASSES)
        assert bool(torch.isfinite(out).all()) and not out[~valid].float().any()


CLI = ["data.dataset=SyntheticSemsegDataset", "net.dtype=float32", "data.layout=voxel",
       "data.batch_size=2", "data.npad0=4096", "optimizer.max_iter=2",
       "distributed.num_devices=1"]


@pytest.mark.parametrize("model", ["STRes16UNet14", "STResTesseractUNet14", "STResNet14"])
def test_semseg_cli_refuses_st_nets(tmp_path, model):
    with pytest.raises(ValueError, match=rf"net.model={model} .*needs 4-D inputs"):
        app.main(CLI + [f"net.model={model}", f"train.out_dir={tmp_path}"], device="cpu")
    assert not (tmp_path / "weights").exists()
