"""The port's VoteNet step against the JAX package's, on a small VoteNet
(Res16UNet14A sparse-conv backbone, 2 scenes x 2000 points, 5 cm voxels,
16 proposals by vote FPS): byte-identical batches, a strict weight load,
train- and eval-mode ``end_points``, one step's loss, gradients (as Adam's
first moment) and running stats, three steps taken step-wise from the same
JAX state, the LR / BN-momentum schedules, one AP evaluation, and the
trainer's save / resume.

Tolerances (f32, JAX at "highest" matmul precision): the loss rtol 1e-5;
end_points, running stats and gradients rtol/atol 2e-4 (gradients relative
to each tensor's largest entry), as ``tests/test_torch_model.py`` holds the
backbone: train-mode BN amplifies summation-order noise.  Updated weights
rtol/atol 2e-4 where the gradient stands clear of that noise; Adam moves a
weight by about lr whatever its gradient's size, so one whose gradient is at
noise level is held to the step's bound, 2 lr.  Integer outputs
(FPS, ball query, object assignment) are equal.  The steps are compared
from the same state each time: a free-running trajectory diverges once an
argmin assignment flips (``tests/test_votenet_trajectory.py``)."""
import itertools

import jax
import numpy as np
import optax
import pytest
import torch

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.detect import ap_helper as j_ap
from pointcontrast_tpu.detect.datasets import (
    SyntheticDetectionDataset as JDataset,
)
from pointcontrast_tpu.detect.datasets import collate_detection as j_collate
from pointcontrast_tpu.detect.loss import get_loss as j_get_loss
from pointcontrast_tpu.detect.train import DetectConfig as JDetectConfig
from pointcontrast_tpu.detect.train import _batch_to_inputs, _batch_to_labels
from pointcontrast_tpu.detect.train import get_bn_momentum as j_bn_momentum
from pointcontrast_tpu.detect.train import get_current_lr as j_current_lr
from pointcontrast_tpu.detect.votenet import VoteNet as JVoteNet
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.detect.datasets import (
    LABEL_FIELDS,
    SyntheticDetectionDataset,
    collate_detection,
)
from pointcontrast_tpu_torch.detect.train import (
    DetectConfig,
    DetectTrainer,
    batch_to_inputs,
    get_bn_momentum,
    get_current_lr,
)
from pointcontrast_tpu_torch.tools.from_jax import (
    jax_state_dict,
    load_jax_params,
    load_optax_adam,
    torch_name,
)
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


def test_detection_batch_byte_identical(run):
    jb, tb = run["jbatch"], run["tbatch"]
    for f in ("point_clouds", "voxel_feats", "point_voxel_idx") + LABEL_FIELDS:
        a, b = np.asarray(getattr(jb, f)), np.asarray(getattr(tb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    jp, tp = jb.voxel_pyramid, tb.voxel_pyramid
    assert jp.num_batch == tp.num_batch and len(jp.levels) == len(tp.levels)
    for l, (jl, tl) in enumerate(zip(jp.levels, tp.levels)):
        for f in ("nbr", "valid", "batch", "down_nbr", "up_parent", "up_offset",
                  "nbr0"):
            a, b = getattr(jl, f), getattr(tl, f)
            assert (a is None) == (b is None), (l, f)
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (l, f)
        assert jl.rev == tl.rev


def test_detection_batch_to_rejects_foreign_rows(run):
    tb = run["tbatch"]
    tb.to("cpu")
    s0 = tb.voxel_feats.shape[0] // 2
    bad = tb.point_voxel_idx.copy()
    bad[1, 7] = s0 - 1  # sample 1 pointing into sample 0's slice
    with pytest.raises(ValueError, match="point_voxel_idx"):
        type(tb)(**{**tb.__dict__, "point_voxel_idx": bad}).to("cpu")
    with pytest.raises(NotImplementedError):
        collate_detection([{"point_clouds": np.zeros((4, 3), np.float32)}],
                          voxel_size=0.05, scheme=PadScheme(npad0=512),
                          layout="voxel")


def test_strict_weight_load(run):
    params, bs, _ = run["states"][0]
    model = _torch_model(run["states"][0])
    n_jax = sum(1 for _ in _flat(params)) + sum(1 for _ in _flat(bs))
    assert len(model.state_dict()) == n_jax
    names = set(jax_state_dict(params, bs))
    for name in ("backbone_net.net.conv0p1s1.weight", "vgen.conv1.weight",
                 "vgen.bn1.running_var", "pnet.vote_aggregation.mlp.layer0.weight",
                 "pnet.vote_aggregation.mlp.bn0.weight", "pnet.conv3.bias"):
        assert name in names, name


def _compare_end_points(got: dict, want: dict):
    compared = 0
    for k, w in want.items():
        if k not in got or not isinstance(w, np.ndarray):
            continue
        g = got[k].detach().numpy()
        if k in INT_FIELDS or k in ("object_assignment", "objectness_label"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        compared += 1
    return compared


def test_end_points_match_jax(run):
    """Train mode at the initial state (the fields of the first step's
    forward and loss) and eval mode after one step (running stats set)."""
    from pointcontrast_tpu_torch.detect.loss import get_loss

    tb = run["tbatch"].to("cpu")
    model = _torch_model(run["states"][0])
    for m in model.modules():
        if hasattr(m, "momentum"):
            m.momentum = BN_MOMENTUM
    model.train()
    ep = model(batch_to_inputs(tb))
    ep.update({k: getattr(tb, k) for k in LABEL_FIELDS})
    _, ep = get_loss(ep, run["dc"])
    assert _compare_end_points(ep, run["train_eps"][0]) >= 30

    model = _torch_model(run["states"][1]).eval()
    with torch.no_grad():
        ep = model(batch_to_inputs(tb))
    assert _compare_end_points(ep, run["eval_ep"]) >= 15


def _check_step(trainer, run, k):
    """The torch step from state k against JAX's: loss, Adam's first moment
    (0.1 x the gradient on the first step), running stats, parameters."""
    loss = trainer.train_epoch(iter([run["tbatch"]]), 1)
    np.testing.assert_allclose(loss, run["losses"][k], rtol=1e-5)
    params, bs, opt = run["states"][k + 1]
    named = dict(trainer.model.named_parameters())
    clear = {}  # where the moment stands clear of the comparison's noise
    for path, mu in _flat(opt[0].mu):
        got = trainer.opt.state[named[torch_name(path)]]["exp_avg"].numpy()
        scale = max(float(np.abs(mu).max()), 1e-12)
        np.testing.assert_allclose(got / scale, mu / scale, rtol=0, atol=2e-4,
                                   err_msg=torch_name(path))
        clear[path] = np.abs(mu) > 1e-3 * scale
    buffers = dict(trainer.model.named_buffers())
    for path, v in _flat(bs):
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), v,
                                   err_msg=torch_name(path), **TOL)
    # Adam moves every weight by about lr whatever its gradient's size, so a
    # weight whose gradient is at noise level may move either way: hold
    # those to the step's bound, the others to TOL.
    for path, v in _flat(params):
        got = named[torch_name(path)].detach().numpy()
        np.testing.assert_allclose(got[clear[path]], v[clear[path]],
                                   err_msg=torch_name(path), **TOL)
        assert np.abs(got - v).max() <= 2 * LR + TOL["atol"], torch_name(path)


def test_one_step_matches_jax(run, tmp_path):
    _check_step(_trainer(run, 0, tmp_path), run, 0)


@pytest.mark.parametrize("k", [1, 2])
def test_steps_match_jax_from_the_same_state(run, k, tmp_path):
    trainer = _trainer(run, k, tmp_path)
    trainer.epoch = 0  # epoch 0's LR and BN momentum, as the JAX steps
    _check_step(trainer, run, k)


def test_schedules_match_jax():
    tcfg = DetectConfig(bn_decay_step=3, lr_decay_steps=(2, 5, 7))
    jcfg = JDetectConfig(bn_decay_step=3, lr_decay_steps=(2, 5, 7))
    for epoch in range(40):
        assert get_current_lr(epoch, tcfg) == j_current_lr(epoch, jcfg)
        assert get_bn_momentum(epoch, tcfg) == j_bn_momentum(epoch, jcfg)


def _labels_from_predictions(batch, ep, per_scene=4):
    """A copy of ``batch`` whose ground truth is the first ``per_scene``
    predicted boxes of each scene (centre, size class and residual,
    semantic class), so that AP is not 0 at random weights."""
    b_, k = ep["center"].shape[:2]
    size_cls = ep["size_scores"].argmax(-1)
    size_res = np.take_along_axis(ep["size_residuals"],
                                  size_cls[..., None, None], axis=2)[:, :, 0]
    labels = {f: np.zeros_like(getattr(batch, f)) for f in LABEL_FIELDS}
    labels["vote_label"] = batch.vote_label
    labels["vote_label_mask"] = batch.vote_label_mask
    labels["center_label"][:, :per_scene] = ep["center"][:, :per_scene]
    labels["size_class_label"][:, :per_scene] = size_cls[:, :per_scene]
    labels["size_residual_label"][:, :per_scene] = size_res[:, :per_scene]
    labels["sem_cls_label"][:, :per_scene] = ep["sem_cls_scores"].argmax(-1)[:, :per_scene]
    labels["box_label_mask"][:, :per_scene] = 1
    return type(batch)(**{**batch.__dict__, **labels}), labels


def test_evaluate_ap_matches_jax(run, tmp_path):
    """DetectTrainer.evaluate after one step against the JAX package's
    parse_predictions / APCalculator on the JAX eval-mode end_points, with
    ground truth drawn from the predictions so that AP is not trivially 0."""
    tbatch, labels = _labels_from_predictions(run["tbatch"], run["eval_ep"])
    got = _trainer(run, 1, tmp_path).evaluate(itertools.repeat(tbatch), 1)
    config_dict = dict(dataset_config=run["dc"], remove_empty_box=False,
                       use_3d_nms=True, cls_nms=True, nms_iou=0.25,
                       use_old_type_nms=False, per_class_proposal=True,
                       conf_thresh=0.05)
    ep = dict(run["eval_ep"], **labels)
    ep["point_clouds"] = np.asarray(run["jbatch"].point_clouds)
    pred = j_ap.parse_predictions(ep, config_dict)
    gt = j_ap.parse_groundtruths(ep, config_dict)
    for t in JDetectConfig().ap_iou_thresholds:
        calc = j_ap.APCalculator(t, run["dc"].class2type)
        calc.step(pred, gt)
        want = calc.compute_metrics()
        assert 0.0 < want["mAP"] <= 1.0
        np.testing.assert_allclose(got[t]["mAP"], want["mAP"], rtol=1e-6)
        np.testing.assert_allclose(got[t]["AR"], want["AR"], rtol=1e-6)


def test_trainer_saves_and_resumes(run, tmp_path):
    trainer = _trainer(run, 0, tmp_path)
    trainer.train_epoch(iter([run["tbatch"]]), 1)
    trainer.save()
    resumed = DetectTrainer(votenet_model(1, "Res16UNet14A", PROPOSALS), run["dc"],
                            DetectConfig(checkpoint_dir=str(tmp_path)), "cpu")
    assert resumed.epoch == 1
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
    p = next(trainer.model.parameters())
    q = next(resumed.model.parameters())
    torch.testing.assert_close(trainer.opt.state[p]["exp_avg"],
                               resumed.opt.state[q]["exp_avg"], rtol=0, atol=0)

