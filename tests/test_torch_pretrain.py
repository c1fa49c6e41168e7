"""The port's pretraining step against the JAX ``make_train_step``: one
step's NCE loss, a 3-step trajectory of losses and parameters, the stepped
ExpLR values, and the trainer's JSONL metrics and save/resume.

Tolerances (f32, JAX at "highest" matmul precision): the first loss rtol
1e-5; later losses rtol 1e-4 and parameters atol 1e-4 (three SGD steps at
lr 0.1 through train-mode BN amplify summation-order noise)."""
import json

import jax
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data import PadScheme as JPadScheme
from pointcontrast_tpu.data import SyntheticPairDataset as JDataset
from pointcontrast_tpu.data import collate_pair as j_collate
from pointcontrast_tpu.nn.res16unet import Res16UNetBase as JBase
from pointcontrast_tpu.nn.resnet_block import BasicBlock as JBlock
from pointcontrast_tpu.train import PretrainConfig as JConfig
from pointcontrast_tpu.train import make_train_step as j_make_train_step
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu.train.state import create_train_state
from pointcontrast_tpu_torch.data import PadScheme, SyntheticPairDataset, collate_pair
from pointcontrast_tpu_torch.nn.res16unet import Res16UNetBase
from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.train import (
    PretrainConfig,
    PretrainTrainer,
    latest_checkpoint,
    make_train_step,
)
from pointcontrast_tpu_torch.train import optim

_TINY = dict(LAYERS=(1,) * 8, PLANES=(4, 8, 16, 32, 32, 16, 8, 8), INIT_DIM=4)


class JTiny(JBase):
    BLOCK = JBlock
    LAYERS, PLANES, INIT_DIM = _TINY["LAYERS"], _TINY["PLANES"], _TINY["INIT_DIM"]


class TTiny(Res16UNetBase):
    BLOCK = BasicBlock
    LAYERS, PLANES, INIT_DIM = _TINY["LAYERS"], _TINY["PLANES"], _TINY["INIT_DIM"]


LR_FREQ = 2  # small, so the 3 steps cross an ExpLR step


def _batches(collate, ds_cls, scheme_cls):
    ds = ds_cls(num_pairs=4, points_per_frame=400, seed=0)
    scheme = scheme_cls(npad0=4096, level_ratios=(1.0,) * 5)
    rng = np.random.RandomState(1)
    return [collate([ds[2 * i], ds[2 * i + 1]], scheme, mode="nce", npos=128,
                    rng=rng, fuse_frames=True, layout="chunked")
            for i in range(2)]


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def runs():
    jbatches = _batches(j_collate, JDataset, JPadScheme)
    tbatches = _batches(collate_pair, SyntheticPairDataset, PadScheme)
    jcfg = JConfig(mode="nce", npos=128, lr=0.1, lr_update_freq=LR_FREQ)
    schedule = j_optim.exp_lr(jcfg.exp_gamma, LR_FREQ, stepped=True)
    tx = j_optim.make_optimizer("sgd", jcfg.lr, schedule, jcfg)
    jmodel = JTiny(in_channels=3, out_channels=8, normalize_feature=True)
    state = create_train_state(jax.random.PRNGKey(0), jmodel, tx,
                               (jbatches[0].feats0, jbatches[0].pyramid0))
    params0 = jax.device_get(state.params)
    stats0 = jax.device_get(state.batch_stats)
    jstep = jax.jit(lambda s, b: j_make_train_step(jcfg)(s, b))
    jlosses = []
    for i in range(3):
        state, m = jstep(state, jbatches[i % 2])
        jlosses.append(float(m["loss"]))

    tmodel = TTiny(in_channels=3, out_channels=8, normalize_feature=True)
    load_jax_params(tmodel, params0, stats0)
    tcfg = PretrainConfig(lr=0.1, lr_update_freq=LR_FREQ)
    opt = optim.make_optimizer(tmodel, tcfg)
    sched = optim.make_scheduler(opt, tcfg)
    step = make_train_step(tcfg)
    dev = [b.to("cpu") for b in tbatches]
    tlosses = [float(step(tmodel, opt, sched, dev[i % 2])["loss"])
               for i in range(3)]
    return dict(jlosses=jlosses, tlosses=tlosses, jparams=jax.device_get(state.params),
                tmodel=tmodel, tbatches=tbatches, params0=params0, stats0=stats0)


def test_first_step_loss_matches_jax(runs):
    np.testing.assert_allclose(runs["tlosses"][0], runs["jlosses"][0], rtol=1e-5)


def test_three_step_trajectory_matches_jax(runs):
    np.testing.assert_allclose(runs["tlosses"], runs["jlosses"], rtol=1e-4)
    named = dict(runs["tmodel"].named_parameters())
    for path, p in _flat(runs["jparams"]):
        np.testing.assert_allclose(named[torch_name(path)].detach().numpy(),
                                   np.asarray(p), rtol=1e-4, atol=1e-4,
                                   err_msg=torch_name(path))


def test_stepped_explr_matches_jax():
    cfg = PretrainConfig(lr=0.1, exp_gamma=0.9, lr_update_freq=3)
    opt = optim.make_optimizer(torch.nn.Linear(2, 2), cfg)
    sched = optim.make_scheduler(opt, cfg)
    jfac = j_optim.exp_lr(0.9, 3, stepped=True)
    for s in range(10):
        np.testing.assert_allclose(sched.get_last_lr()[0], 0.1 * float(jfac(s)),
                                   rtol=1e-6)
        opt.step()
        sched.step()


def test_trainer_logs_saves_and_resumes(runs, tmp_path):
    cfg = PretrainConfig(lr=0.1, stat_freq=1, save_freq=2,
                         lr_update_freq=LR_FREQ, checkpoint_dir=str(tmp_path))
    model = TTiny(in_channels=3, out_channels=8, normalize_feature=True)
    load_jax_params(model, runs["params0"], runs["stats0"])
    trainer = PretrainTrainer(model, runs["tbatches"] * 2, cfg, "cpu")
    history = trainer.train(3)
    assert [i for i, _ in history] == [1, 2, 3]
    # same weights, batches and schedule as the step-by-step run above
    np.testing.assert_allclose([m["loss"] for _, m in history],
                               runs["tlosses"], rtol=1e-6)
    lines = [json.loads(l)
             for l in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [l["iter"] for l in lines] == [1, 2, 3]
    assert latest_checkpoint(str(tmp_path)).endswith("checkpoint_3.pth")

    resumed = PretrainTrainer(
        TTiny(in_channels=3, out_channels=8, normalize_feature=True),
        runs["tbatches"], cfg, "cpu")
    assert resumed.curr_iter == 3
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    assert resumed.sched.get_last_lr() == trainer.sched.get_last_lr()
    assert resumed.train(1)[0][0] == 4
