"""VoteNet training and evaluation (port of
``pointcontrast_tpu/detect/train.py``).

Adam (``torch.optim.Adam``: optax.adam's defaults b1 0.9, b2 0.999, eps
1e-8; its ``weight_decay`` adds wd * p to the gradient first, as
``optax.chain(add_decayed_weights(wd), adam)`` does), the LR decayed at
epoch milestones, the BN momentum decayed every ``bn_decay_step`` epochs
(0.5 halved, floored at 0.001) on EVERY BatchNorm, the backbone's included,
and AP at IoU 0.25 / 0.5 from the host-numpy NMS and AP code.  BoxNet
(``use_voting=False``) trains with ``get_loss_boxnet``, chosen from the
model.  A ``PreemptionGuard`` set on the trainer is polled after every step:
once it fires, the trainer saves and raises ``Preempted``.
"""
from __future__ import annotations

import dataclasses
import logging
import os

import numpy as np
import torch

from pointcontrast_tpu_torch.detect.ap_helper import (
    APCalculator,
    parse_groundtruths,
    parse_predictions,
)
from pointcontrast_tpu_torch.detect.datasets import LABEL_FIELDS
from pointcontrast_tpu_torch.detect.loss import get_loss, get_loss_boxnet
from pointcontrast_tpu_torch.detect.modules import DenseBatchNorm
from pointcontrast_tpu_torch.nn.layers import MaskedBatchNorm
from pointcontrast_tpu_torch.train.pretrain import latest_checkpoint
from pointcontrast_tpu_torch.utils.preemption import Preempted

log = logging.getLogger(__name__)

METRIC_KEYS = ("loss", "vote_loss", "objectness_loss", "box_loss",
               "sem_cls_loss", "obj_acc", "pos_ratio", "neg_ratio")


@dataclasses.dataclass
class DetectConfig:
    learning_rate: float = 1e-3
    weight_decay: float = 0.0
    lr_decay_steps: tuple = (80, 120, 160)  # epochs
    lr_decay_rates: tuple = (0.1, 0.1, 0.1)
    bn_decay_step: int = 20
    bn_decay_rate: float = 0.5
    bn_momentum_init: float = 0.5
    bn_momentum_min: float = 0.001
    max_epoch: int = 180
    eval_every: int = 5
    checkpoint_dir: str = "weights_votenet"
    # AP config (reference lib/test.py:33-42)
    ap_iou_thresholds: tuple = (0.25, 0.5)
    use_3d_nms: bool = True
    cls_nms: bool = True
    nms_iou: float = 0.25
    use_old_type_nms: bool = False
    per_class_proposal: bool = True
    conf_thresh: float = 0.05
    remove_empty_box: bool = False


def get_current_lr(epoch: int, config: DetectConfig) -> float:
    lr = config.learning_rate
    for step, rate in zip(config.lr_decay_steps, config.lr_decay_rates):
        if epoch >= step:
            lr *= rate
    return lr


def get_bn_momentum(epoch: int, config: DetectConfig) -> float:
    m = config.bn_momentum_init * (
        config.bn_decay_rate ** (epoch // config.bn_decay_step))
    return max(m, config.bn_momentum_min)


def batch_to_inputs(batch) -> dict:
    inputs = {"point_clouds": batch.point_clouds}
    if batch.voxel_feats is not None:
        inputs.update(voxel_feats=batch.voxel_feats,
                      voxel_pyramid=batch.voxel_pyramid,
                      point_voxel_idx=batch.point_voxel_idx)
    return inputs


def batch_to_labels(batch) -> dict:
    return {k: getattr(batch, k) for k in LABEL_FIELDS}


def loss_of(model):
    """``get_loss``, or ``get_loss_boxnet`` for a model without voting."""
    return get_loss if getattr(model, "use_voting", True) else get_loss_boxnet


def make_detect_train_step(dataset_config):
    """``step(model, opt, batch) -> metrics`` for a batch already on the
    model's device: forward, the model's loss (``loss_of``), backward,
    ``opt.step()``.  The returned tensors are not synchronised."""

    def step(model, opt, batch) -> dict:
        model.train()
        opt.zero_grad(set_to_none=True)
        end_points = model(batch_to_inputs(batch))
        end_points.update(batch_to_labels(batch))
        loss, end_points = loss_of(model)(end_points, dataset_config)
        loss.backward()
        opt.step()
        return {k: end_points[k].detach() for k in METRIC_KEYS}

    return step


class DetectTrainer:
    """One device.  ``batches`` given to ``train_epoch`` / ``evaluate`` are
    iterators of ``DetectionBatch``es, on the host (moved with ``to``, which
    bounds-checks them) or already on ``device``.  Resumes from the newest
    checkpoint in ``config.checkpoint_dir``."""

    def __init__(self, model: torch.nn.Module, dataset_config,
                 config: DetectConfig, device):
        self.dc = dataset_config
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.opt = torch.optim.Adam(self.model.parameters(),
                                    lr=config.learning_rate,
                                    weight_decay=config.weight_decay)
        self._step = make_detect_train_step(dataset_config)
        self.epoch = 0
        self.preemption_guard = None  # a utils.preemption.PreemptionGuard
        ckpt = latest_checkpoint(config.checkpoint_dir)
        if ckpt is not None:
            payload = torch.load(ckpt, map_location=self.device)
            self.model.load_state_dict(payload["model"])
            self.opt.load_state_dict(payload["optimizer"])
            self.epoch = int(payload["curr_iter"])
            log.info("resumed from %s at epoch %d", ckpt, self.epoch)

    def set_lr(self, lr: float):
        for group in self.opt.param_groups:
            group["lr"] = lr

    def set_bn_momentum(self, momentum: float):
        """Every BatchNorm of the model, heads and backbone (torch
        convention: running = (1 - m) * running + m * batch)."""
        for m in self.model.modules():
            if isinstance(m, (DenseBatchNorm, MaskedBatchNorm)):
                m.momentum = momentum

    def _on_device(self, batch):
        if isinstance(batch.point_clouds, np.ndarray):
            return batch.to(self.device)
        return batch

    def train_epoch(self, loader, num_batches: int) -> float:
        """``num_batches`` steps at this epoch's LR and BN momentum; the
        losses stay on the device until one host sync at the end.  Returns
        the epoch's mean loss."""
        cfg = self.config
        self.set_lr(get_current_lr(self.epoch, cfg))
        self.set_bn_momentum(get_bn_momentum(self.epoch, cfg))
        losses = []
        for _ in range(num_batches):
            batch = self._on_device(next(loader))
            losses.append(self._step(self.model, self.opt, batch)["loss"])
            if self.preemption_guard is not None and self.preemption_guard.preempted:
                self.save(self.epoch)
                raise Preempted(self.epoch)
        self.epoch += 1
        return float(torch.stack(losses).mean())

    @torch.no_grad()
    def evaluate(self, loader, num_batches: int | None = None) -> dict:
        """AP over ``num_batches`` draws from an infinite iterator, or over a
        finite one drained to exhaustion (``num_batches=None``).  Returns
        {iou threshold: metrics with "mAP" and "AR"}."""
        cfg = self.config
        calcs = {t: APCalculator(t, self.dc.class2type)
                 for t in cfg.ap_iou_thresholds}
        config_dict = {
            "dataset_config": self.dc,
            "remove_empty_box": cfg.remove_empty_box,
            "use_3d_nms": cfg.use_3d_nms,
            "cls_nms": cfg.cls_nms,
            "nms_iou": cfg.nms_iou,
            "use_old_type_nms": cfg.use_old_type_nms,
            "per_class_proposal": cfg.per_class_proposal,
            "conf_thresh": cfg.conf_thresh,
        }
        batches = (iter(loader) if num_batches is None
                   else (next(loader) for _ in range(num_batches)))
        self.model.eval()
        try:
            for batch in batches:
                batch = self._on_device(batch)
                end_points = self.model(batch_to_inputs(batch))
                end_points.update(batch_to_labels(batch))
                end_points["point_clouds"] = batch.point_clouds
                end_points = {k: v.cpu().numpy() for k, v in end_points.items()}
                pred = parse_predictions(end_points, config_dict)
                gt = parse_groundtruths(end_points, config_dict)
                for calc in calcs.values():
                    calc.step(pred, gt)
        finally:
            self.model.train()
        return {t: c.compute_metrics() for t, c in calcs.items()}

    def save(self, step: int | None = None) -> str:
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        step = step or self.epoch
        path = os.path.join(self.config.checkpoint_dir, f"checkpoint_{step}.pth")
        torch.save({"curr_iter": step, "model": self.model.state_dict(),
                    "optimizer": self.opt.state_dict()}, path)
        return path
