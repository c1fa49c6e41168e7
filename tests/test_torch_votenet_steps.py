"""The port's VoteNet steps against the JAX package's, on the small
VoteNet of ``torch_votenet_common.py``: one step's loss, gradients (as
Adam's first moment) and running stats, the next two steps taken step-wise
from the same JAX state, one AP evaluation, and the trainer's save /
resume.  The batches, weight load and end_points are in
``test_torch_votenet.py``.

Tolerances (f32, JAX at "highest" matmul precision): the loss rtol 1e-5;
running stats and gradients rtol/atol 2e-4 (gradients relative to each
tensor's largest entry): train-mode BN amplifies summation-order noise.
Updated weights rtol/atol 2e-4 where the gradient stands clear of that
noise; Adam moves a weight by about lr whatever its gradient's size, so one
whose gradient is at noise level is held to the step's bound, 2 lr.  The
steps are compared from the same state each time: a free-running trajectory
diverges once an argmin assignment flips
(``tests/test_votenet_trajectory.py``)."""
import itertools

import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401  (autouse)
from torch_votenet_common import (  # noqa: F401  (run: a module fixture)
    LR,
    PROPOSALS,
    TOL,
    _flat,
    _trainer,
    run,
)

from pointcontrast_tpu.detect import ap_helper as j_ap
from pointcontrast_tpu.detect.train import DetectConfig as JDetectConfig
from pointcontrast_tpu_torch.detect.datasets import LABEL_FIELDS
from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer
from pointcontrast_tpu_torch.tools.from_jax import torch_name
from pointcontrast_tpu_torch.tools.workload import votenet_model


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
