"""Shared set-up of the port's VoteNet parity tests
(``test_torch_votenet.py`` and ``test_torch_votenet_steps.py``): a small
VoteNet (Res16UNet14A sparse-conv backbone, 2 scenes x 2000 points, 5 cm
voxels, 16 proposals by vote FPS) from both packages, and a module fixture
``run`` with the JAX package's batch, three Adam steps, their end_points
and the eval-mode end_points after the first step."""
import jax
import numpy as np
import optax
import pytest

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.detect.datasets import (
    SyntheticDetectionDataset as JDataset,
)
from pointcontrast_tpu.detect.datasets import collate_detection as j_collate
from pointcontrast_tpu.detect.loss import get_loss as j_get_loss
from pointcontrast_tpu.detect.train import _batch_to_inputs, _batch_to_labels
from pointcontrast_tpu.detect.votenet import VoteNet as JVoteNet
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.detect.datasets import (
    SyntheticDetectionDataset,
    collate_detection,
)
from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, load_optax_adam
from pointcontrast_tpu_torch.tools.workload import votenet_model

RATIOS = (1.0, 1.0, 0.5, 0.25, 0.12)
PROPOSALS = 16
LR = 1e-3
BN_MOMENTUM = 0.5  # get_bn_momentum at epoch 0
TOL = dict(rtol=2e-4, atol=2e-4)
INT_FIELDS = ("seed_inds", "fp2_inds", "aggregated_vote_inds")


def _batch(collate, ds_cls, scheme_cls):
    ds = ds_cls(num_scenes=2, num_objects=4, num_points=2000, seed=0)
    return collate([ds[0], ds[1]], voxel_size=0.05,
                   scheme=scheme_cls(npad0=4096, level_ratios=RATIOS),
                   layout="chunked"), ds.dc


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _np_tree(tree):
    return jax.tree.map(lambda x: np.array(x), tree)


@pytest.fixture(scope="module")
def run():
    jax.config.update("jax_default_matmul_precision", "highest")
    jbatch, dc = _batch(j_collate, JDataset, JPadScheme)
    tbatch, _ = _batch(collate_detection, SyntheticDetectionDataset, PadScheme)
    model = JVoteNet(
        num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
        num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
        num_proposal=PROPOSALS, sampling="vote_fps", backbone="sparseconv",
        backbone_model="Res16UNet14A", bn_momentum=BN_MOMENTUM)
    inputs, labels = _batch_to_inputs(jbatch), _batch_to_labels(jbatch)
    variables = jax.jit(lambda r: model.init(r, inputs, train=False))(
        jax.random.PRNGKey(0))
    tx = optax.adam(LR)

    @jax.jit
    def step(params, bs, opt_state):
        def loss_fn(p):
            ep, mut = model.apply({"params": p, "batch_stats": bs}, inputs,
                                  train=True, mutable=["batch_stats"])
            ep.update(labels)
            loss, ep = j_get_loss(ep, dc)
            return loss, (mut["batch_stats"], ep)

        (loss, (new_bs, ep)), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), new_bs, opt_state, loss, ep

    states = [(variables["params"], variables["batch_stats"], tx.init(variables["params"]))]
    losses, train_eps = [], []
    for _ in range(3):
        p, bs, o, loss, ep = step(*states[-1])
        states.append((p, bs, o))
        losses.append(float(loss))
        train_eps.append(_np_tree(ep))
    states = [_np_tree(s) for s in states]
    eval_ep = _np_tree(jax.jit(lambda p, bs: model.apply(
        {"params": p, "batch_stats": bs}, inputs, train=False))(*states[1][:2]))
    return dict(jbatch=jbatch, tbatch=tbatch, dc=dc, states=states,
                losses=losses, train_eps=train_eps, eval_ep=eval_ep)


def _torch_model(state):
    params, bs, _ = state
    return load_jax_params(votenet_model(0, "Res16UNet14A", PROPOSALS), params, bs)


def _trainer(run, k, checkpoint_dir):
    """A DetectTrainer at the JAX trajectory's state ``k`` (params, batch
    stats, Adam moments and count), at epoch 0's LR and BN momentum."""
    trainer = DetectTrainer(_torch_model(run["states"][k]), run["dc"],
                            DetectConfig(checkpoint_dir=str(checkpoint_dir)), "cpu")
    adam = run["states"][k][2][0]
    load_optax_adam(trainer.opt, trainer.model, adam.mu, adam.nu, adam.count)
    return trainer


