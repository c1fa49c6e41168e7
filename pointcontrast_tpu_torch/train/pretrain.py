"""Contrastive pretraining: the train step + training loop (port of
``pointcontrast_tpu/train/pretrain.py``).

One step runs a single forward over both fused frames, the PointInfoNCE
or hardest-contrastive loss over the collator's pre-sampled indices, the
backward through the hand-written sparse-conv kernels, then SGD and the
stepped ExpLR.  Under a process group the trainer runs the same step in
every rank with the model under ``DistributedDataParallel`` (per-replica
BN), logs the ranks' mean metrics and saves on rank 0, as JAX's
``data_parallel_step`` pmeans grads and metrics and checkpoints device 0's
copy."""
from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import re
import time

import numpy as np
import torch

from pointcontrast_tpu_torch.data.collate import PairBatch
from pointcontrast_tpu_torch.losses.contrastive import (
    hardest_contrastive_loss,
    point_info_nce_loss,
)
from pointcontrast_tpu_torch.parallel import mesh
from pointcontrast_tpu_torch.train import optim
from pointcontrast_tpu_torch.train.checkpoint import load_module_state_dict
from pointcontrast_tpu_torch.utils.preemption import Preempted

log = logging.getLogger(__name__)


@dataclasses.dataclass
class PretrainConfig:
    """The trainers' and optimizer's settings (reference
    pretrain/pointcontrast/config/defaults.yaml, nce_t from ddp_launch.sh).
    ``mode``: 'nce' (PointNCELossTrainer) or 'hardest'
    (HardestContrastiveLossTrainer).  How many pairs and candidates a batch
    samples is the collator's (``collate_pair``'s ``npos``, ``num_pos`` and
    ``num_hn``)."""

    mode: str = "nce"
    nce_t: float = 0.4
    pos_thresh: float = 0.1
    neg_thresh: float = 1.4
    optimizer: str = "sgd"
    lr: float = 0.1
    momentum: float = 0.8
    weight_decay: float = 1e-4
    exp_gamma: float = 0.99
    max_iter: int = 60000
    lr_update_freq: int = 1000
    stat_freq: int = 40
    checkpoint_dir: str = "weights"
    save_freq: int = 1000


def make_train_step(config: PretrainConfig):
    """Build ``step(model, opt, sched, batch, hardest=None,
    return_hardest=False) -> metrics`` for a fused-frame batch already on
    the model's device: ``loss`` (and in the hardest mode ``pos_loss`` and
    ``neg_loss``) and ``truncated_voxels``.  ``hardest`` and
    ``return_hardest`` go to ``hardest_contrastive_loss`` (hardest mode
    only); with ``return_hardest`` the metrics also hold the hardest
    negatives taken, ``"hardest": (i01, i10)``.  The returned tensors are
    not synchronised."""
    if config.mode not in ("nce", "hardest"):
        raise ValueError(f"unknown pretraining mode {config.mode!r}")

    def step(model, opt, sched, batch: PairBatch, hardest=None,
             return_hardest: bool = False) -> dict:
        model.train()
        opt.zero_grad(set_to_none=True)
        # fused-frame batch: one forward over all 2B frames; the sampled
        # indices already point into the combined table.
        f = model(batch.feats0, batch.pyramid0)
        if config.mode == "nce":
            loss = point_info_nce_loss(f, f, batch.q_idx, batch.k_idx,
                                       batch.pair_valid, temperature=config.nce_t)
            metrics = {"loss": loss}
        else:
            pos_loss, neg_loss, *picked = hardest_contrastive_loss(
                f, f, batch.pos0_idx, batch.pos1_idx, batch.pos_valid,
                batch.cand0_idx, batch.cand0_valid, batch.cand1_idx,
                batch.cand1_valid, batch.collide0, batch.collide1,
                pos_thresh=config.pos_thresh, neg_thresh=config.neg_thresh,
                hardest=hardest, return_hardest=return_hardest)
            loss = pos_loss + neg_loss
            metrics = {"loss": loss, "pos_loss": pos_loss, "neg_loss": neg_loss}
        loss.backward()
        opt.step()
        sched.step()
        metrics = {k: v.detach() for k, v in metrics.items()}
        if return_hardest:
            metrics["hardest"] = picked[0]
        return {**metrics, "truncated_voxels": batch.truncated_voxels}

    return step


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    found = [(int(m.group(1)), f) for f in os.listdir(directory)
             if (m := re.fullmatch(r"checkpoint_(\d+)\.pth", f))]
    return os.path.join(directory, max(found)[1]) if found else None


class PretrainTrainer:
    """Training loop: batches -> step -> periodic JSONL metrics and
    ``torch.save`` checkpoints; resumes from the newest checkpoint in
    ``config.checkpoint_dir``.

    ``batches`` is any iterable of ``PairBatch``es, on the host (moved with
    ``to(device)``, which bounds-checks them) or already on ``device``.
    ``preemption_guard`` (``utils.preemption.PreemptionGuard``) is polled
    after every step: once it is set (on any rank), the trainer saves a
    checkpoint and raises ``Preempted``.

    Under a process group (``parallel.multihost.initialize``) ``batches``
    are this rank's shard and the step runs ``self.net``, the model under
    DDP; ``self.model`` is the module itself.  Each rank resumes from the
    same checkpoint; rank 0 alone writes checkpoints (the module's
    ``state_dict``, no ``module.`` prefix: they resume under any world
    size) and ``metrics.jsonl``."""

    def __init__(self, model: torch.nn.Module, batches, config: PretrainConfig,
                 device, preemption_guard=None):
        self.config = config
        self.preemption_guard = preemption_guard
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.batches = batches
        self.opt = optim.make_optimizer(self.model, config)
        self.sched = optim.make_scheduler(self.opt, config)
        self._step = make_train_step(config)
        self.curr_iter = 0
        ckpt = latest_checkpoint(config.checkpoint_dir)
        if ckpt is not None:
            payload = torch.load(ckpt, map_location=self.device)
            load_module_state_dict(self.model, payload["model"])
            self.opt.load_state_dict(payload["optimizer"])
            self.sched.load_state_dict(payload["scheduler"])
            self.curr_iter = int(payload["curr_iter"])
            log.info("resumed from %s at iter %d", ckpt, self.curr_iter)
        self.net = mesh.data_parallel(self.model)

    def save(self) -> str | None:
        """The checkpoint of this iteration (rank 0; None on the others)."""
        if not mesh.is_main():
            return None
        os.makedirs(self.config.checkpoint_dir, exist_ok=True)
        path = os.path.join(self.config.checkpoint_dir,
                            f"checkpoint_{self.curr_iter}.pth")
        torch.save({
            "curr_iter": self.curr_iter,
            "model": self.model.state_dict(),
            "optimizer": self.opt.state_dict(),
            "scheduler": self.sched.state_dict(),
        }, path)
        return path

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def train(self, num_iters: int | None = None) -> list:
        """Run up to ``num_iters`` steps (bounded by ``max_iter`` and the
        batches).  Returns [(iter, scalars)] for every logged window; step
        time is the window's wall time less data time, per step."""
        cfg = self.config
        target = min(cfg.max_iter, self.curr_iter + (num_iters or cfg.max_iter))
        history = []
        main = mesh.is_main()
        os.makedirs(cfg.checkpoint_dir, exist_ok=True)
        log_path = os.path.join(cfg.checkpoint_dir, "metrics.jsonl")
        feed = iter(self.batches)
        self._sync()
        win_t0, win_data, win_iters = time.perf_counter(), 0.0, 0
        with open(log_path, "a") if main else contextlib.nullcontext() as writer:
            while self.curr_iter < target:
                t0 = time.perf_counter()
                batch = next(feed, None)
                if batch is None:
                    break
                if isinstance(batch.feats0, np.ndarray):
                    batch = batch.to(self.device)
                win_data += time.perf_counter() - t0
                lr = self.sched.get_last_lr()[0]
                metrics = self._step(self.net, self.opt, self.sched, batch)
                self.curr_iter += 1
                win_iters += 1
                if self.curr_iter % cfg.stat_freq == 0 or self.curr_iter == target:
                    metrics = mesh.mean_over_ranks(metrics)
                    scalars = {k: float(v) for k, v in metrics.items()}
                    self._sync()
                    wall = time.perf_counter() - win_t0
                    scalars.update(lr=lr, data_time=win_data / win_iters,
                                   step_time=(wall - win_data) / win_iters)
                    win_t0, win_data, win_iters = time.perf_counter(), 0.0, 0
                    history.append((self.curr_iter, scalars))
                    if main:
                        writer.write(json.dumps({"iter": self.curr_iter, **scalars}) + "\n")
                        writer.flush()
                        log.info("iter %d loss %.4f (data %.3fs step %.3fs)",
                                 self.curr_iter, scalars["loss"],
                                 scalars["data_time"], scalars["step_time"])
                    if main and scalars["truncated_voxels"] > 0:
                        log.warning("iter %d: pyramid truncation dropped %.0f "
                                    "voxels", self.curr_iter,
                                    scalars["truncated_voxels"])
                if self.curr_iter % cfg.save_freq == 0 or self.curr_iter == target:
                    self.save()
                if self.preemption_guard is not None and self.preemption_guard.poll():
                    self.save()
                    mesh.host_barrier()  # every rank raises after rank 0 saved
                    log.warning("preempted at iter %d: checkpoint saved, requeue",
                                self.curr_iter)
                    raise Preempted(self.curr_iter)
        return history
