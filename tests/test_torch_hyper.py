"""The port's MinkUNetHyper14INBN against the JAX package's, on the CPU: a
narrow net of the class (its hypercolumn chains ``sparse_avg_unpool`` from
levels 2 and 1 down to level 0), loaded strictly from the JAX variables,
train-mode outputs, running statistics and parameter gradients (the
instance norms' affines, right before a BatchNorm, have zero gradients in
exact arithmetic and are held near zero on both sides), then
eval-mode outputs; one ``SemsegTrainer`` step against JAX's semseg train
step from the same variables; and the ``semseg`` CLI with
``net.model=MinkUNetHyper14INBN``, which refuses the ResNets (their logits
sit at level 5, not at the labelled rows).

Tolerances (f32, JAX at "highest" matmul precision): the model as
``tests/test_torch_resnet.py`` (2e-4, gradients against each tensor's
largest entry); the step as ``tests/test_torch_semseg_train.py`` (loss rtol
1e-5, parameters and running statistics rtol/atol 1e-4)."""
import itertools
import os

import jax
import numpy as np
import pytest

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from test_torch_resnet import _flat, _jax_run, _loss_proj, _torch_check
from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.nn import resunet as jres
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate
from pointcontrast_tpu.semseg.train import SemsegConfig as JConfig
from pointcontrast_tpu.semseg.train import make_semseg_train_step as j_make_step
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu.train.state import create_train_state
from pointcontrast_tpu_torch.apps import semseg as app
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.nn import resunet as tres
from pointcontrast_tpu_torch.nn.registry import MODELS
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name

CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)
_SIZES = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16, 16, 8, 8))
JTiny = type("JTiny", (jres.MinkUNetHyper14INBN,), _SIZES)
TTiny = type("TTiny", (tres.MinkUNetHyper14INBN,), _SIZES)
CLI = ["data.dataset=SyntheticSemsegDataset", "net.dtype=float32",
       "data.layout=chunked", "data.batch_size=2", "data.npad0=4096",
       "optimizer.max_iter=1", "train.stat_freq=1", "train.val_freq=1",
       "train.save_freq=100", "distributed.num_devices=1"]


@pytest.fixture(scope="module")
def batches():
    from pointcontrast_tpu_torch.tools.workload import SemsegScenes

    samples = SemsegScenes(scenes=2, points=1500, room=1.2, voxel=0.05,
                           classes=CLASSES).samples
    kw = dict(rng=np.random.RandomState(0), num_chunks=2, layout="chunked")
    return (j_collate(samples, JPadScheme(npad0=4096), **kw),
            collate_semseg(samples, PadScheme(npad0=4096), **kw))


def test_hyper_matches_jax(batches):
    jb, tb = batches
    proj = _loss_proj(CLASSES)
    j = _jax_run(JTiny(in_channels=3, out_channels=CLASSES),
                 lambda train: (jb.feats, jb.pyramid, train), proj)
    model = TTiny(in_channels=3, out_channels=CLASSES)
    assert model.final_fc.weight.shape[0] == 8 + 8 + 8 + 16  # [out, skip0, b6, b5]
    db = tb.to("cpu")
    valid = db.pyramid.levels[0].valid.numpy() > 0
    _torch_check(model, j, lambda: model(db.feats, db.pyramid), proj, valid,
                 zero_grads=(".inorm.",))


def test_trainer_step_matches_jax(batches, tmp_path):
    jax.config.update("jax_default_matmul_precision", "highest")
    jb, tb = batches
    cfg = dict(lr=0.1, max_iter=60)
    jcfg = JConfig(**cfg)
    tx = j_optim.make_optimizer("sgd", jcfg.lr, j_optim.make_scheduler("polylr", jcfg),
                                jcfg)
    jmodel = JTiny(in_channels=3, out_channels=CLASSES)
    state = create_train_state(jax.random.PRNGKey(0), jmodel, tx,
                               (jb.feats, jb.pyramid))
    init = (jax.device_get(state.params), jax.device_get(state.batch_stats))
    state, metrics = jax.jit(lambda s, b: j_make_step(jcfg)(s, b))(state, jb)

    model = load_jax_params(TTiny(in_channels=3, out_channels=CLASSES), *init)
    tcfg = SemsegConfig(stat_freq=1, checkpoint_dir=str(tmp_path), **cfg)
    trainer = SemsegTrainer(model, itertools.repeat(tb), None, tcfg, CLASSES, "cpu")
    (it, scalars), = trainer.train(1)
    assert it == 1
    np.testing.assert_allclose(scalars["loss"], float(metrics["loss"]), rtol=1e-5)
    assert scalars["acc"] == pytest.approx(float(metrics["acc"]), abs=1e-6)
    named = dict(model.named_parameters())
    for path, v in _flat(jax.device_get(state.params)):
        name = torch_name(path, model)
        np.testing.assert_allclose(named[name].detach().numpy(), v, err_msg=name, **TOL)
    buffers = dict(model.named_buffers())
    for path, v in _flat(jax.device_get(state.batch_stats)):
        name = torch_name(path, model)
        np.testing.assert_allclose(buffers[name].numpy(), v, err_msg=name, **TOL)


def test_cli_trains_the_hyper_net(tmp_path):
    trainer, history = app.main(CLI + ["net.model=MinkUNetHyper14INBN",
                                       f"train.out_dir={tmp_path}"], device="cpu")
    assert type(trainer.model).__name__ == "MinkUNetHyper14INBN"
    assert [i for i, _ in history] == [1] and np.isfinite(history[0][1]["loss"])
    assert 0.0 <= trainer.best_miou <= 100.0
    assert (tmp_path / "weights" / "checkpoint_1.pth").exists()


@pytest.mark.parametrize("model", ["ResNet14", "ResNet50"])
def test_cli_refuses_the_resnets(tmp_path, model):
    with pytest.raises(ValueError, match="level 5"):
        app.main(CLI + [f"net.model={model}", f"train.out_dir={tmp_path}"],
                 device="cpu")
    assert not os.path.exists(tmp_path / "weights")


def test_registry_has_the_hyper_net():
    cls = MODELS["MinkUNetHyper14INBN"]
    assert cls.LAYERS == jres.MinkUNetHyper14INBN.LAYERS
    assert cls.PLANES == jres.MinkUNetHyper14INBN.PLANES
    assert cls.INIT_DIM == jres.MinkUNetHyper14INBN.INIT_DIM
    assert "MinkUNetHyper" not in MODELS
