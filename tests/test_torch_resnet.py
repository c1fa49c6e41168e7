"""The port's ResNet family and SE blocks against the JAX package's, on the
CPU: narrow ResNets of both block types (the strided first blocks run K4 on
the k3s2 ``down_nbr3`` map and the 1-tap downsample map, the stem's output
goes through the k2s2 sum pool), defined here on both sides over one
6-level chunked pyramid built with ``build_down3``, and ``SEBasicBlock`` /
``SEBottleneck`` on one level.  Weights load strictly from the JAX
variables; train-mode outputs, running statistics and parameter gradients
of a scalar loss, then eval-mode outputs with the updated statistics.  A
tree of another block type must fail the strict load.

Tolerances (f32, JAX at "highest" matmul precision): outputs and running
statistics rtol/atol 2e-4, as ``tests/test_torch_semseg_model.py`` holds
the ResUNets (train-mode BN amplifies summation-order noise); gradients
rtol 2e-4 and atol 2e-4 of each tensor's largest entry, as
``tests/test_torch_model.py``, except where the gradient is zero in exact
arithmetic (an instance norm's affine right before a BatchNorm, which
removes any per-channel shift and scale): there both sides hold only
summation noise, and each is held below 2e-4 of the model's largest
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.nn import resnet as jresnet
from pointcontrast_tpu.nn import resnet_block as jblocks
from pointcontrast_tpu.nn import senet_block as jse
from pointcontrast_tpu.sparse.chunk import build_chunked_pyramid as j_build
from pointcontrast_tpu_torch.data.collate import PadScheme, pyramid_to
from pointcontrast_tpu_torch.nn import resnet as tresnet
from pointcontrast_tpu_torch.nn import resnet_block as tblocks
from pointcontrast_tpu_torch.nn import senet_block as tse
from pointcontrast_tpu_torch.nn.registry import MODELS
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.tools.from_jax import (
    jax_state_dict,
    load_jax_params,
    torch_name,
)
from pointcontrast_tpu_torch.tools.workload import SemsegScenes

TOL = dict(rtol=2e-4, atol=2e-4)
CLASSES = 5
_SIZES = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16), LAYERS=(1, 2, 1, 1))
NETS = {
    "basic": (type("JTiny", (jresnet.ResNetBase,), dict(BLOCK=jblocks.BasicBlock, **_SIZES)),
              type("TTiny", (tresnet.ResNetBase,), dict(BLOCK=tblocks.BasicBlock, **_SIZES))),
    "bottleneck": (type("JTiny", (jresnet.ResNetBase,),
                        dict(BLOCK=jblocks.Bottleneck, **_SIZES)),
                   type("TTiny", (tresnet.ResNetBase,),
                        dict(BLOCK=tblocks.Bottleneck, **_SIZES))),
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def inputs():
    """Two synthetic scenes at 5 cm, their 6-level chunked pyramids (with
    ``down_nbr3``) from both packages, and normalised colours at the rows."""
    samples = SemsegScenes(scenes=2, points=2500, room=2.4, voxel=0.05).samples
    coords = np.concatenate([np.concatenate([np.full((len(c), 1), b), c], 1)
                             for b, (c, _, _) in enumerate(samples)]).astype(np.int32)
    colours = np.concatenate([f for _, f, _ in samples]) / 255.0 - 0.5
    npads = PadScheme.scannet(4096, 6).npads
    jp = j_build(coords, 6, npads, num_batch=2, build_down3=True)[0]
    tp, _, rows, orphan = build_chunked_pyramid(coords, 6, npads, num_batch=2,
                                                build_down3=True)
    assert not orphan.any() and (tp.levels[5].valid > 0).sum() >= 2
    feats = np.zeros((tp.levels[0].valid.shape[0], 3), np.float32)
    feats[rows] = colours
    return dict(jp=jp, tp=pyramid_to(tp, "cpu"), feats=feats)


def _loss_proj(n_out):
    return np.random.RandomState(5).randn(n_out).astype(np.float32)


def _jax_run(jmodel, call, proj):
    """(params, stats, train out, new stats, grads, eval out) of the flax
    module ``jmodel`` applied to ``call(train)``'s arguments, the gradients
    of sum(sin(3 out) proj) in train mode."""
    jax.config.update("jax_default_matmul_precision", "highest")
    variables = jax.jit(lambda r: jmodel.init(r, *call(train=False)))(
        jax.random.PRNGKey(0))

    def loss(params):
        out, mut = jmodel.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]},
                                *call(train=True), mutable=["batch_stats"])
        return (jnp.sin(out * 3.0) * proj).sum(), (out, mut["batch_stats"])

    (_, (out, new_stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        variables["params"])
    eval_out = jax.jit(lambda p, s: jmodel.apply({"params": p, "batch_stats": s},
                                                 *call(train=False)))(
        variables["params"], new_stats)
    return dict(params=jax.device_get(variables["params"]),
                stats=jax.device_get(variables["batch_stats"]),
                out=np.asarray(out), new_stats=jax.device_get(new_stats),
                grads=jax.device_get(grads), eval_out=np.asarray(eval_out))


def _torch_check(model, j, run, proj, valid, zero_grads=()):
    """Load ``j``'s variables into ``model`` and hold it to them; ``run()``
    applies the model to the same inputs.  Parameters whose name holds one
    of ``zero_grads`` have a zero gradient in exact arithmetic."""
    load_jax_params(model, j["params"], j["stats"])
    model.train()
    out = run()
    (torch.sin(out * 3.0) * torch.from_numpy(proj)).sum().backward()
    got = out.detach().numpy()
    np.testing.assert_allclose(got[valid], j["out"][valid], **TOL)
    assert not got[~valid].any(), "pad rows must stay exactly 0"
    buffers = dict(model.named_buffers())
    for path, v in _flat(j["new_stats"]):
        name = torch_name(path, model)
        np.testing.assert_allclose(buffers[name].numpy(), v, err_msg=name, **TOL)
    named = dict(model.named_parameters())
    largest = max(float(np.abs(g).max()) for _, g in _flat(j["grads"]))
    checked = 0
    for path, g in _flat(j["grads"]):
        name = torch_name(path, model)
        t = named[name].grad.numpy()
        if t.shape != g.shape:  # an nn.Linear weight: [out, in]
            t = t.T
        if any(z in name for z in zero_grads):
            assert max(np.abs(t).max(), np.abs(g).max()) <= 2e-4 * largest, name
        else:
            scale = max(float(np.abs(g).max()), 1e-3)
            np.testing.assert_allclose(t, g, rtol=2e-4, atol=2e-4 * scale,
                                       err_msg=name)
        checked += 1
    assert checked == len(named)
    model.eval()
    with torch.no_grad():
        got = run().numpy()
    np.testing.assert_allclose(got[valid], j["eval_out"][valid], **TOL)


@pytest.fixture(scope="module", params=sorted(NETS))
def resnet_run(request, inputs):
    jcls, tcls = NETS[request.param]
    jmodel = jcls(in_channels=3, out_channels=CLASSES)
    proj = _loss_proj(CLASSES)
    j = _jax_run(jmodel, lambda train: (inputs["feats"], inputs["jp"], train), proj)
    return dict(name=request.param, tcls=tcls, j=j, proj=proj)


def test_resnet_matches_jax(resnet_run, inputs):
    r = resnet_run
    tp = inputs["tp"]
    model = r["tcls"](in_channels=3, out_channels=CLASSES)
    feats = torch.from_numpy(inputs["feats"])
    valid = tp.levels[5].valid.numpy() > 0
    assert r["j"]["out"].shape == (tp.levels[5].valid.shape[0], CLASSES)
    _torch_check(model, r["j"], lambda: model(feats, tp), r["proj"], valid)


def test_resnet_strict_load_renames_by_block(resnet_run):
    r = resnet_run
    model = r["tcls"](in_channels=3, out_channels=CLASSES)
    names = set(jax_state_dict(r["j"]["params"], r["j"]["stats"], model=model))
    assert names == set(model.state_dict())
    assert "layer1_0.downsample_conv.weight" in names
    assert model.state_dict()["layer1_0.downsample_conv.weight"].shape[0] == 1
    # layer2_1 is a stride-1 block: flax auto-names renamed by its class
    assert ("layer2_1.conv1.weight" if r["name"] == "basic"
            else "layer2_1.conv3.weight") in names
    other = "bottleneck" if r["name"] == "basic" else "basic"
    with pytest.raises((KeyError, RuntimeError)):
        load_jax_params(NETS[other][1](in_channels=3, out_channels=CLASSES),
                        r["j"]["params"], r["j"]["stats"])


def test_resnet_needs_down3_maps(inputs):
    tp = inputs["tp"]
    cut = type(tp)(levels=tp.levels[:5], num_batch=tp.num_batch)
    model = NETS["basic"][1](in_channels=3, out_channels=CLASSES)
    with pytest.raises(ValueError, match="build_down3"):
        model(torch.from_numpy(inputs["feats"]), cut)


SE = {  # block, inplanes, planes: a downsample shortcut and an identity one
    "basic": (jse.SEBasicBlock, tse.SEBasicBlock, 6, 8),
    "bottleneck": (jse.SEBottleneck, tse.SEBottleneck, 16, 4),
}


@pytest.mark.parametrize("name", sorted(SE))
def test_se_blocks_match_jax(name, inputs):
    jcls, tcls, inplanes, planes = SE[name]
    jp, tp = inputs["jp"], inputs["tp"]
    jl, tl = jp.levels[1], tp.levels[1]
    rng = np.random.RandomState(8)
    valid = tl.valid.numpy() > 0
    x = np.zeros((valid.shape[0], inplanes), np.float32)
    x[valid] = rng.randn(int(valid.sum()), inplanes)
    jblock = jcls(planes=planes, reduction=4)
    proj = _loss_proj(planes * jcls.expansion)

    def call(train):
        return (x, jl.nbr, jl.valid, train, jl.batch, 2, jl.rev)

    j = _jax_run(jblock, call, proj)
    block = tcls(inplanes, planes, 27, reduction=4)
    assert block.se.fc1.weight.shape == (planes * tcls.expansion // 4,
                                         planes * tcls.expansion)
    xt = torch.from_numpy(x)
    _torch_check(block, j, lambda: block(xt, tl.nbr, tl.valid, tl.rev, tl.batch, 2),
                 proj, valid)
    other = tse.SEBottleneck if tcls is tse.SEBasicBlock else tse.SEBasicBlock
    with pytest.raises((KeyError, RuntimeError)):
        load_jax_params(other(inplanes, planes, 27, reduction=4), j["params"],
                        j["stats"])


def test_registry_has_the_resnet_family():
    for name in ("ResNet14", "ResNet18", "ResNet34", "ResNet50", "ResNet101"):
        assert MODELS[name].LAYERS == getattr(jresnet, name).LAYERS, name
        assert MODELS[name].BLOCK.__name__ == getattr(jresnet, name).BLOCK.__name__
    assert "ResNetBase" not in MODELS
