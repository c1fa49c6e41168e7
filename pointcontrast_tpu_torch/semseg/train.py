"""Semseg finetuning: the train and eval steps, validation and the trainer
(port of ``pointcontrast_tpu/semseg/train.py``).

Gradient accumulation over ``iter_size`` sub-batches (gradients summed,
then scaled by 1 / iter_size, BN running stats carried from sub-batch to
sub-batch as JAX's ``lax.scan`` carries them), cross-entropy with ignore
label 255, PolyLR stepped per iteration, whole-split validation with
index-seeded scenes and no shift, best-mIoU tracking, save / resume,
lenient pretrain transfer and the preemption guard.  With a CRF wrapper the
filter is skipped when ``RandomState(0).rand() >= 0.5``, one draw per step
in JAX's order; a skipped filter's parameters get a zero gradient, so SGD's
weight decay and momentum still move them as in JAX.

Under a process group each rank runs the step on its shard with the model
under ``DistributedDataParallel`` (``find_unused_parameters`` only with
the CRF wrapper, whose filter sits out half the steps), the first
``iter_size - 1`` sub-batches under ``no_sync`` (one all-reduce a step),
and the same filter coin on every rank; metrics are the ranks' mean;
validation, the best-mIoU checkpoint and every save run on rank 0 with its
replica, as JAX evaluates and saves device 0's copy.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from pointcontrast_tpu_torch.losses.semseg import (
    cross_entropy_ignore,
    fast_hist,
    per_class_iu,
)
from pointcontrast_tpu_torch.parallel import mesh
from pointcontrast_tpu_torch.semseg.crf import Wrapper
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.train import optim
from pointcontrast_tpu_torch.train.checkpoint import lenient_filter, load_module_state_dict
from pointcontrast_tpu_torch.train.pretrain import latest_checkpoint
from pointcontrast_tpu_torch.utils.preemption import Preempted

log = logging.getLogger(__name__)


@dataclasses.dataclass
class SemsegConfig:
    """The reference's optimizer / train config groups."""

    optimizer: str = "sgd"
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    scheduler: str = "polylr"
    poly_power: float = 0.9
    max_iter: int = 60000
    iter_size: int = 1
    ignore_label: int = 255
    stat_freq: int = 40
    val_freq: int = 1000
    save_freq: int = 1000
    checkpoint_dir: str = "weights_semseg"
    # the CRF filter's LR (its own param group); None = the base LR
    wrapper_lr: float | None = None


def forward(model, batch, apply_filter: bool = True):
    """Logits of ``model`` (or of its DDP wrapper) on ``batch``; a CRF
    ``Wrapper`` also takes the batch's bilateral map."""
    if isinstance(mesh.unwrap(model), Wrapper):
        return model(batch.feats, batch.pyramid, batch.crf_nbr,
                     apply_filter=apply_filter)
    return model(batch.feats, batch.pyramid)


def make_semseg_train_step(config: SemsegConfig):
    """``step(model, opt, sched, batches, apply_filter=True) -> metrics``
    over a list of ``iter_size`` sub-batches already on the model's device:
    one forward and backward per sub-batch, then one SGD update.  The
    metrics are the sub-batches' means and are not synchronised.  Under
    DDP the gradients are all-reduced once, with the last sub-batch's
    backward."""

    def step(model, opt, sched, batches, apply_filter: bool = True) -> dict:
        model.train()
        opt.zero_grad(set_to_none=True)
        sums: dict = {}
        wrapped = model is not mesh.unwrap(model)
        for i, sub in enumerate(batches):
            # under DDP only the last sub-batch's backward all-reduces
            accumulate = wrapped and i < len(batches) - 1
            with model.no_sync() if accumulate else contextlib.nullcontext():
                logits = forward(model, sub, apply_filter)
                loss = cross_entropy_ignore(logits, sub.labels, config.ignore_label)
                loss.backward()
            with torch.no_grad():
                valid = sub.labels != config.ignore_label
                hit = (logits.argmax(-1) == sub.labels) & valid
                m = {"loss": loss.detach(), "acc": hit.sum() / valid.sum().clamp(min=1)}
                if sub.truncated_voxels is not None:
                    m["truncated_voxels"] = sub.truncated_voxels
            for k, v in m.items():
                sums[k] = v if k not in sums else sums[k] + v
        inv = 1.0 / len(batches)
        for p in model.parameters():
            if p.grad is None:  # unused (a skipped filter): JAX's zero gradient
                p.grad = torch.zeros_like(p)
            elif len(batches) > 1:
                p.grad.mul_(inv)
        opt.step()
        sched.step()
        return sums if len(batches) == 1 else {k: v * inv for k, v in sums.items()}

    return step


@torch.no_grad()
def eval_step(model, batch):
    """(argmax labels, softmax) of the eval-mode model; a CRF wrapper always
    applies its filter here."""
    model.eval()
    logits = forward(model, batch)
    return logits.argmax(-1), torch.softmax(logits, -1)


def _accumulate(hist, correct, total, pred, labels, ignore_label, num_classes):
    mask = labels != ignore_label
    hist += fast_hist(pred[mask], labels[mask], num_classes)
    return correct + int((pred[mask] == labels[mask]).sum()), total + int(mask.sum())


def _finish(hist, correct, total):
    ious = per_class_iu(hist) * 100
    return float(np.nanmean(ious)), ious, 100.0 * correct / max(total, 1)


def _host_labels(batch) -> np.ndarray:
    labels = batch.labels
    return labels.cpu().numpy() if torch.is_tensor(labels) else np.asarray(labels)


def evaluate(model, loader, num_classes: int, num_batches: int, device,
             ignore_label: int = 255):
    """Sampled validation over ``num_batches`` batches of an infinite
    loader -> (mIoU %, per-class IoU, accuracy %)."""
    hist = np.zeros((num_classes, num_classes))
    correct = total = 0
    for _ in range(num_batches):
        batch = next(loader)
        dev = batch.to(device) if isinstance(batch.feats, np.ndarray) else batch
        pred = eval_step(model, dev)[0].cpu().numpy()
        correct, total = _accumulate(hist, correct, total, pred, _host_labels(batch),
                                     ignore_label, num_classes)
    return _finish(hist, correct, total)


def evaluate_dataset(model, dataset, scheme, num_classes: int, device,
                     batch_size: int = 1, ignore_label: int = 255,
                     num_levels=None, conv0_kernel_size: int = 3,
                     layout: str = "chunked", crf: dict | None = None):
    """Whole-split validation: every scene of ``dataset`` once, in order,
    scene i drawn with ``RandomState(i)``, no shift.  A batch over the
    PadScheme budget keeps a prefix and the rest is collated again, so no
    scene is skipped.  Returns (mIoU %, per-class IoU, acc %, scenes)."""
    hist = np.zeros((num_classes, num_classes))
    correct = total = scenes = 0
    pending = list(range(len(dataset)))
    while pending:
        samples = [dataset.__getitem__(i, rng=np.random.RandomState(i))
                   for i in pending[:batch_size]]
        batch = collate_semseg(
            samples, scheme, ignore_label=ignore_label, shift_coords=False,
            rng=np.random.RandomState(0), num_levels=num_levels,
            conv0_kernel_size=conv0_kernel_size, layout=layout, crf=crf,
            num_chunks=batch_size)
        pending = pending[batch.num_samples:]
        scenes += batch.num_samples
        pred = eval_step(model, batch.to(device))[0].cpu().numpy()
        correct, total = _accumulate(hist, correct, total, pred, batch.labels,
                                     ignore_label, num_classes)
    miou, ious, acc = _finish(hist, correct, total)
    return miou, ious, acc, scenes


class SemsegTrainer:
    """One device.  ``train_loader`` yields ``SemsegBatch``es, on the host
    (moved with ``to``, which bounds-checks them) or already on ``device``;
    as the JAX trainer, one batch is drawn at construction and is the first
    step's (dropped when ``iter_size > 1``).  Validation: ``val_dataset``
    (+ ``val_scheme``) for whole-split validation every ``val_freq`` steps,
    or ``val_loader`` for sampled batches.  ``pretrained``: a state dict
    whose parameters are loaded where name and shape match (into the
    backbone of a CRF wrapper).  Resumes from the newest checkpoint in
    ``config.checkpoint_dir``.  Under a process group the step runs
    ``self.net`` (DDP) and ``self.model`` is the module itself, which rank 0
    validates and saves (no ``module.`` prefix)."""

    def __init__(self, model, train_loader, val_loader, config: SemsegConfig,
                 num_classes: int, device, pretrained: dict | None = None,
                 val_dataset=None, val_scheme=None, val_batch_size: int = 1,
                 conv0_kernel_size: int = 3, layout: str = "chunked",
                 crf: dict | None = None, preemption_guard=None):
        wrapper = crf is not None
        if wrapper != isinstance(model, Wrapper):
            raise ValueError("a CRF wrapper model needs crf settings, and only it")
        self.config = config
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.val_loader = val_loader
        self.val_dataset = val_dataset
        self.val_scheme = val_scheme
        self.val_batch_size = val_batch_size
        self.conv0_kernel_size = conv0_kernel_size
        self.layout = layout
        self.crf = crf
        self.num_classes = num_classes
        self.preemption_guard = preemption_guard
        lr_scales = ({"filter": config.wrapper_lr / config.lr}
                     if wrapper and config.wrapper_lr else None)
        self.opt = optim.make_optimizer(self.model, config, lr_scales)
        self.sched = optim.make_scheduler(self.opt, config, config.scheduler)
        self._step = make_semseg_train_step(config)
        self._feed = iter(train_loader)
        self._first_batch = next(self._feed)
        if wrapper and self._first_batch.crf_nbr is None:
            raise ValueError("CRF wrapper needs a loader collating crf maps")
        if pretrained is not None:
            self._transfer(pretrained)
        # the reference skips the CRF filter with p = 0.5 while training
        self._coin = np.random.RandomState(0) if wrapper else None
        self.best_miou = -1.0
        self.curr_iter = 0
        ckpt = latest_checkpoint(config.checkpoint_dir)
        if ckpt is not None:
            payload = torch.load(ckpt, map_location=self.device)
            load_module_state_dict(self.model, payload["model"])
            self.opt.load_state_dict(payload["optimizer"])
            self.sched.load_state_dict(payload["scheduler"])
            self.curr_iter = int(payload["curr_iter"])
            self._load_best_score()
            log.info("resumed from %s (best mIoU %.2f)", ckpt, self.best_miou)
        self.net = mesh.data_parallel(self.model, find_unused_parameters=wrapper)

    def _transfer(self, source: dict) -> None:
        net = self.model.net if isinstance(self.model, Wrapper) else self.model
        params = {k: v.detach() for k, v in net.named_parameters()}
        merged, loaded, skipped = lenient_filter(params, source)
        with torch.no_grad():
            for name, p in net.named_parameters():
                p.copy_(merged[name])
        log.info("lenient transfer: %d loaded, %d skipped (%s)", len(loaded),
                 len(skipped), skipped[:4])

    def _payload(self) -> dict:
        return {"curr_iter": self.curr_iter, "model": self.model.state_dict(),
                "optimizer": self.opt.state_dict(),
                "scheduler": self.sched.state_dict()}

    def save(self) -> str | None:
        """The checkpoint of this iteration (rank 0; None on the others)."""
        if not mesh.is_main():
            return None
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.config.checkpoint_dir,
                            f"checkpoint_{self.curr_iter}.pth")
        torch.save(self._payload(), path)
        return path

    def _save_best(self) -> None:
        """The current state in a ``best/`` directory with its mIoU."""
        best_dir = os.path.join(self.config.checkpoint_dir, "best")
        os.makedirs(best_dir, exist_ok=True)
        torch.save(self._payload(),
                   os.path.join(best_dir, f"checkpoint_{self.curr_iter}.pth"))
        with open(os.path.join(best_dir, "best.json"), "w") as f:
            json.dump({"step": self.curr_iter, "miou": self.best_miou}, f)

    def _load_best_score(self) -> None:
        path = os.path.join(self.config.checkpoint_dir, "best", "best.json")
        if os.path.exists(path):
            with open(path) as f:
                self.best_miou = json.load(f)["miou"]

    def _on_device(self, batch):
        return batch.to(self.device) if isinstance(batch.feats, np.ndarray) else batch

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def validate(self, val_batches: int = 10):
        """(mIoU %, per-class IoU, acc %) of the whole split or of sampled
        batches."""
        if self.val_dataset is not None:
            miou, ious, acc, scenes = evaluate_dataset(
                self.model, self.val_dataset, self.val_scheme, self.num_classes,
                self.device, self.val_batch_size, self.config.ignore_label,
                conv0_kernel_size=self.conv0_kernel_size, layout=self.layout,
                crf=self.crf)
            log.info("val: full split (%d scenes)", scenes)
            return miou, ious, acc
        return evaluate(self.model, self.val_loader, self.num_classes, val_batches,
                        self.device, self.config.ignore_label)

    def train(self, num_iters: int | None = None, val_batches: int = 10) -> list:
        """Run up to ``num_iters`` steps (bounded by ``max_iter``).  Returns
        [(iter, scalars)] for every logged window; step time is the window's
        wall time less data time, per step."""
        cfg = self.config
        target = min(cfg.max_iter, self.curr_iter + (num_iters or cfg.max_iter))
        batch, self._first_batch = self._first_batch, None
        if cfg.iter_size > 1:
            batch = None  # the single construction batch cannot seed a stacked step
        history = []
        main = mesh.is_main()
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        validating = self.val_dataset is not None or self.val_loader is not None
        self._sync()
        win_t0, win_data, win_iters = time.perf_counter(), 0.0, 0
        log_path = os.path.join(cfg.checkpoint_dir, "metrics.jsonl")
        with open(log_path, "a") if main else contextlib.nullcontext() as writer:
            while self.curr_iter < target:
                t0 = time.perf_counter()
                subs = [batch] if batch is not None else [
                    next(self._feed) for _ in range(cfg.iter_size)]
                subs = [self._on_device(b) for b in subs]
                batch = None
                win_data += time.perf_counter() - t0
                apply_filter = self._coin is None or self._coin.rand() < 0.5
                lr = self.sched.get_last_lr()[0]
                metrics = self._step(self.net, self.opt, self.sched, subs,
                                     apply_filter)
                self.curr_iter += 1
                win_iters += 1
                curr = self.curr_iter
                if curr % cfg.stat_freq == 0 or curr == target:
                    metrics = mesh.mean_over_ranks(metrics)
                    scalars = {k: float(v) for k, v in metrics.items()}
                    self._sync()
                    wall = time.perf_counter() - win_t0
                    scalars.update(lr=lr, data_time=win_data / win_iters,
                                   step_time=(wall - win_data) / win_iters)
                    win_t0, win_data, win_iters = time.perf_counter(), 0.0, 0
                    history.append((curr, scalars))
                    if main:
                        writer.write(json.dumps({"iter": curr, **scalars}) + "\n")
                        writer.flush()
                        log.info("iter %d loss %.4f acc %.3f (data %.3fs step %.3fs)",
                                 curr, scalars["loss"], scalars["acc"],
                                 scalars["data_time"], scalars["step_time"])
                    if main and scalars.get("truncated_voxels", 0) > 0:
                        log.warning("iter %d: pyramid truncation dropped %.0f voxels",
                                    curr, scalars["truncated_voxels"])
                if validating and (curr % cfg.val_freq == 0 or curr == target):
                    if main:  # rank 0's replica over the whole split
                        miou, _, acc = self.validate(val_batches)
                        log.info("val iter %d mIoU %.2f acc %.2f", curr, miou, acc)
                        writer.write(json.dumps({"iter": curr, "val_miou": miou,
                                                 "val_acc": acc}) + "\n")
                        if miou > self.best_miou:
                            self.best_miou = miou
                            self._save_best()
                    mesh.host_barrier()
                if curr % cfg.save_freq == 0 or curr == target:
                    self.save()
                if self.preemption_guard is not None and self.preemption_guard.poll():
                    self.save()
                    mesh.host_barrier()  # every rank raises after rank 0 saved
                    log.warning("preempted at iter %d: checkpoint saved, requeue", curr)
                    raise Preempted(curr)
        return history
