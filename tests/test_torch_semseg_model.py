"""The port's ResUNet family against the JAX package's, on the CPU: narrow
ResUNets of each block type (BasicBlock, Bottleneck, BasicBlockINBN) and a
Bottleneck Res16UNet, defined here on both sides, loaded strictly from the
JAX variables; train-mode outputs and running statistics, then eval-mode
outputs with the updated statistics.  Also the weight bridge's per-block
rename, which must fail loudly on a tree of another block type.

Tolerances (f32, JAX at "highest" matmul precision): outputs and running
statistics rtol/atol 2e-4, as ``tests/test_torch_model.py`` holds the
Res16UNet: train-mode BN (and instance norm) amplify summation-order
noise."""
import jax
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.nn import res16unet as jr16
from pointcontrast_tpu.nn import resnet_block as jblocks
from pointcontrast_tpu.nn import resunet as jres
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.nn import res16unet as tr16
from pointcontrast_tpu_torch.nn import resnet_block as tblocks
from pointcontrast_tpu_torch.nn import resunet as tres
from pointcontrast_tpu_torch.nn.registry import MODELS
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.tools.from_jax import (
    jax_state_dict,
    load_jax_params,
    torch_name,
)
from pointcontrast_tpu_torch.tools.workload import SemsegScenes

TOL = dict(rtol=2e-4, atol=2e-4)
CLASSES = 5
_UNET = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16, 16, 8, 8), LAYERS=(1, 2, 1, 1, 1, 1))
_UNET16 = dict(INIT_DIM=4, PLANES=(4, 8, 8, 8, 8, 8, 4, 4), LAYERS=(1,) * 8)


def _pair(jbase, tbase, jblock, tblock, sizes):
    j = type("JTiny", (jbase,), dict(BLOCK=jblock, **sizes))
    t = type("TTiny", (tbase,), dict(BLOCK=tblock, **sizes))
    return j, t


NETS = {
    "resunet_basic": _pair(jres.MinkUNetBase, tres.MinkUNetBase, jblocks.BasicBlock,
                           tblocks.BasicBlock, _UNET),
    "resunet_bottleneck": _pair(jres.MinkUNetBase, tres.MinkUNetBase,
                                jblocks.Bottleneck, tblocks.Bottleneck, _UNET),
    "resunet_inbn": _pair(jres.MinkUNetBase, tres.MinkUNetBase,
                          jblocks.BasicBlockINBN, tblocks.BasicBlockINBN, _UNET),
    "res16unet_bottleneck": _pair(jr16.Res16UNetBase, tr16.Res16UNetBase,
                                  jblocks.Bottleneck, tblocks.Bottleneck, _UNET16),
}


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def batches():
    samples = SemsegScenes(scenes=2, points=1500, room=1.2, voxel=0.05).samples
    kw = dict(rng=np.random.RandomState(0), num_chunks=2)
    return (j_collate(samples, JPadScheme(npad0=4096), layout="chunked", **kw),
            collate_semseg(samples, PadScheme(npad0=4096), **kw))


@pytest.fixture(scope="module", params=sorted(NETS))
def run(request, batches):
    jax.config.update("jax_default_matmul_precision", "highest")
    jcls, tcls = NETS[request.param]
    jb, tb = batches
    jmodel = jcls(in_channels=3, out_channels=CLASSES)
    variables = jax.jit(lambda r: jmodel.init(r, jb.feats, jb.pyramid, train=False))(
        jax.random.PRNGKey(0))
    train_out, mut = jax.jit(lambda v: jmodel.apply(
        v, jb.feats, jb.pyramid, train=True, mutable=["batch_stats"]))(variables)
    new_vars = {"params": variables["params"], "batch_stats": mut["batch_stats"]}
    eval_out = jax.jit(lambda v: jmodel.apply(v, jb.feats, jb.pyramid, train=False))(
        new_vars)
    return dict(name=request.param, tcls=tcls, tb=tb,
                params=jax.device_get(variables["params"]),
                stats=jax.device_get(variables["batch_stats"]),
                new_stats=jax.device_get(mut["batch_stats"]),
                train_out=np.asarray(train_out), eval_out=np.asarray(eval_out))


def test_forward_matches_jax(run):
    model = load_jax_params(run["tcls"](in_channels=3, out_channels=CLASSES),
                            run["params"], run["stats"])
    db = run["tb"].to("cpu")
    valid = db.pyramid.levels[0].valid.numpy() > 0
    with torch.no_grad():
        out = model.train()(db.feats, db.pyramid).numpy()
    np.testing.assert_allclose(out[valid], run["train_out"][valid], **TOL)
    assert not out[~valid].any()
    buffers = dict(model.named_buffers())
    for path, v in _flat(run["new_stats"]):
        name = torch_name(path, model)
        np.testing.assert_allclose(buffers[name].numpy(), v, err_msg=name, **TOL)
    with torch.no_grad():
        out = model.eval()(db.feats, db.pyramid).numpy()
    np.testing.assert_allclose(out[valid], run["eval_out"][valid], **TOL)


def test_strict_load_renames_by_block(run):
    model = run["tcls"](in_channels=3, out_channels=CLASSES)
    n_jax = sum(1 for _ in _flat(run["params"])) + sum(1 for _ in _flat(run["stats"]))
    assert len(model.state_dict()) == n_jax
    names = set(jax_state_dict(run["params"], run["stats"], model=model))
    assert names == set(model.state_dict())
    first = {"resunet_basic": "block1_0.conv1.weight",
             "resunet_bottleneck": "block1_0.conv2.weight",  # its SparseConv_0
             "resunet_inbn": "block1_0.norm1.inorm.weight",
             "res16unet_bottleneck": "block1_0.conv3.weight"}[run["name"]]
    assert first in names
    if run["name"] == "resunet_inbn":
        assert "block2_0.downsample_norm.bnorm.running_var" in names
    # a tree of another block type fails loudly
    other = ("resunet_basic" if run["name"] != "resunet_basic"
             else "resunet_bottleneck")
    with pytest.raises((KeyError, RuntimeError)):
        load_jax_params(NETS[other][1](in_channels=3, out_channels=CLASSES),
                        run["params"], run["stats"])


def test_registry_has_the_resunet_family():
    for name in ("ResUNet14", "ResUNet18", "ResUNet34", "ResUNet50", "ResUNet101",
                 "ResUNet14D", "ResUNet18D", "ResUNet34D", "ResUNet34E",
                 "ResUNet34F", "ResUNet18INBN", "Res16UNet50", "Res16UNet101",
                 "Res16UNet34C"):
        assert name in MODELS, name
    assert MODELS["ResUNet18INBN"].BLOCK is tblocks.BasicBlockINBN
    assert MODELS["ResUNet34E"].PLANES == jres.ResUNet34E.PLANES
