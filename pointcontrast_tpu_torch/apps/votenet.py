"""VoteNet finetune entry point (port of ``pointcontrast_tpu/apps/votenet.py``).

Usage: python -m pointcontrast_tpu_torch.apps.votenet [config.yaml] [k=v ...]

Datasets ``scannet`` and ``synthetic``; either backbone (``net.backbone``
``pointnet2`` or ``sparseconv``, the latter voxelised in the configured
``data.layout``, ``chunked`` or ``voxel``, the JAX app's default);
Adam with epoch-milestone decay, an AP evaluation at IoU 0.25 / 0.5 and a
checkpoint every ``eval.eval_every`` epochs, resume from the run directory,
pretrained-backbone transfer (``net.weights``), and a requeueable exit on
preemption.  ``main(argv, device)`` runs on ``cuda`` unless the caller
passes another device (the tests pass ``"cpu"``); a missing card is an
error, never a fall-back.  What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item, before any work starts.

``distributed.num_devices`` as in the pretrain CLI: N > 1 (0: every visible
card) spawns N ranks, or ``torchrun`` starts them, and ``main`` returns
None.  Each rank trains on its shard under DDP; rank 0 evaluates with its
replica and writes the snapshot, the checkpoints and the requeue marker.
"""
from __future__ import annotations

import logging
import os
import sys

import torch

from pointcontrast_tpu_torch.config import (
    load_config,
    maybe_resume_config,
    net_dtype,
    save_config,
)
from pointcontrast_tpu_torch.nn import registry
from pointcontrast_tpu_torch.parallel import launch, mesh, multihost

log = logging.getLogger(__name__)

DEFAULT_CONFIG = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "configs", "votenet_default.yaml",
)


class _BatchLoader:
    """Round-robin detection batches from an infinite sampler, collated on
    the host (``DetectTrainer`` moves them to its device).  A data-parallel
    rank draws its own shard (``num_shards``, ``shard_id``), so the ranks'
    batches hold distinct scenes, as JAX's stacked device batches do."""

    def __init__(self, dataset, batch_size, voxel_size=None, scheme=None,
                 shuffle=True, seed=0, layout="voxel", num_shards=1, shard_id=0):
        from pointcontrast_tpu_torch.data.sampler import DistributedInfSampler

        self.dataset = dataset
        self.batch_size = batch_size
        self.voxel_size = voxel_size
        self.scheme = scheme
        self.layout = layout
        # DistributedInfSampler, as the JAX app: its order differs from
        # InfSampler's
        self.sampler = DistributedInfSampler(len(dataset), num_shards, shard_id,
                                             shuffle=shuffle, seed=seed)

    def _collate(self, idxs):
        from pointcontrast_tpu_torch.detect.datasets import collate_detection

        return collate_detection([self.dataset[i] for i in idxs],
                                 voxel_size=self.voxel_size, scheme=self.scheme,
                                 layout=self.layout)

    def __next__(self):
        return self._collate([next(self.sampler) for _ in range(self.batch_size)])

    def epoch(self):
        """One full pass in dataset order: every scene once per evaluate."""
        for start in range(0, len(self.dataset), self.batch_size):
            yield self._collate(range(start, min(start + self.batch_size,
                                                 len(self.dataset))))


def check_supported(cfg, device: torch.device) -> None:
    """Raise on what the port does not run yet, so that a run never does
    something other than what its config asks for."""
    if cfg.data.dataset == "sunrgbd":
        raise NotImplementedError(
            "data.dataset=sunrgbd: the SUN RGB-D loader is not ported (no data "
            "in the repo; ROADMAP Queue 1 item 10)")
    if cfg.net.backbone == "sparseconv":
        layout = cfg.data.get("layout", "voxel")
        if layout not in ("chunked", "voxel"):
            raise NotImplementedError(
                f"data.layout={layout}: the sparse-conv backbone runs the "
                "chunked and voxel layouts (the JAX app runs any other "
                "layout as voxel)")
    elif cfg.net.weights:
        raise ValueError("net.weights loads a pretrained sparse-conv backbone; "
                         f"net.backbone={cfg.net.backbone} has none to load")


def _datasets(cfg):
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.datasets import (
        ScannetDetectionDataset,
        SyntheticDetectionDataset,
    )

    kw = dict(num_points=cfg.data.num_points, use_color=cfg.data.use_color,
              use_height=cfg.data.use_height, seed=cfg.misc.seed)
    if cfg.data.dataset == "scannet":
        split = os.path.join(cfg.data.split_dir, "scannetv2_{}.txt")
        return (ScannetDatasetConfig(),
                ScannetDetectionDataset(cfg.data.data_path,
                                        split_file=split.format("train"),
                                        augment=True, **kw),
                ScannetDetectionDataset(cfg.data.data_path,
                                        split_file=split.format("val"),
                                        augment=False, **kw))
    if cfg.data.dataset == "synthetic":
        # random box-object rooms with the ScanNet sample contract: the app
        # runs end to end without data on disk
        num_scenes = int(cfg.data.get("num_scenes", 8))
        return (ScannetDatasetConfig(),
                SyntheticDetectionDataset(num_scenes=num_scenes, augment=True, **kw),
                SyntheticDetectionDataset(num_scenes=max(num_scenes // 2, 1),
                                          augment=False, **kw))
    raise ValueError(f"unknown dataset {cfg.data.dataset!r}")


def _transfer_backbone(trainer, weights: str) -> None:
    """Load a pretraining checkpoint (``PretrainTrainer``'s ``.pth``, or the
    newest in a directory) into ``backbone_net.net`` where names and shapes
    match (reference ddp_main.py:120-141)."""
    from pointcontrast_tpu_torch.train.checkpoint import lenient_filter
    from pointcontrast_tpu_torch.train.pretrain import latest_checkpoint

    ckpt = latest_checkpoint(weights) if os.path.isdir(weights) else weights
    if not ckpt:
        raise FileNotFoundError(f"net.weights={weights}: no checkpoint")
    source = torch.load(ckpt, map_location=trainer.device)["model"]
    net = trainer.model.backbone_net.net
    merged, loaded, skipped = lenient_filter(net.state_dict(), source)
    net.load_state_dict(merged)
    log.info("backbone transfer from %s: %d loaded %d skipped", ckpt,
             len(loaded), len(skipped))


def _rank_main(argv: list[str], device: str, models: dict) -> None:
    """One spawned rank's run (``parallel.launch.run``).  ``models``: the
    parent's model registry, so that a model registered at run time (not at
    import) exists in the rank too."""
    registry.MODELS.update(models)
    main(argv, device)


def main(argv: list[str] | None = None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    command = list(argv)
    logging.basicConfig(level=logging.INFO)
    path = DEFAULT_CONFIG
    if argv and "=" not in argv[0]:
        path = argv.pop(0)
    cfg = load_config(path, argv)
    cfg = maybe_resume_config(cfg.misc.out_dir, cfg, argv)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the votenet app runs on the GPU "
                           "(call main(argv, device='cpu') for the CPU)")
    check_supported(cfg, device)
    world = launch.resolve_world_size(launch.requested_devices(cfg), device)
    if world > 1 and not multihost.launched():
        return launch.run(world, _rank_main, (command, str(device), dict(registry.MODELS)),
                          device)
    with launch.process_group(device) as device:
        return _train(cfg, device)


def _train(cfg, device: torch.device):
    """The run in this process: one device, or this rank's."""
    os.makedirs(cfg.misc.out_dir, exist_ok=True)
    if mesh.is_main():
        save_config(cfg, os.path.join(cfg.misc.out_dir, "config.yaml"))

    from pointcontrast_tpu_torch.data.collate import PadScheme
    from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer
    from pointcontrast_tpu_torch.detect.votenet import VoteNet
    from pointcontrast_tpu_torch.utils import preemption

    dc, train_ds, val_ds = _datasets(cfg)
    voxel_size = scheme = None
    layout = "voxel"
    if cfg.net.backbone == "sparseconv":
        voxel_size = cfg.data.voxel_size
        scheme = PadScheme(npad0=cfg.data.npad0,
                           level_ratios=tuple(cfg.data.pad_ratios)
                           if cfg.data.get("pad_ratios") else None)
        layout = cfg.data.get("layout", "voxel")
    shard_id, num_shards = multihost.shard_info()
    train_loader = _BatchLoader(train_ds, cfg.data.batch_size, voxel_size,
                                scheme, seed=cfg.misc.seed, layout=layout,
                                num_shards=num_shards, shard_id=shard_id)
    val_loader = _BatchLoader(val_ds, cfg.data.batch_size, voxel_size, scheme,
                              shuffle=False, seed=cfg.misc.seed, layout=layout)

    model = VoteNet(
        num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
        num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
        input_feature_dim=int(cfg.data.use_color) * 3 + int(cfg.data.use_height),
        num_proposal=cfg.net.num_proposal, vote_factor=cfg.net.vote_factor,
        sampling=cfg.net.cluster_sampling, backbone=cfg.net.backbone,
        backbone_model=cfg.net.get("backbone_model", "Res16UNet34C"),
        generator=torch.Generator().manual_seed(int(cfg.misc.seed)),
        dtype=net_dtype(cfg) if cfg.net.backbone == "sparseconv" else None)
    tcfg = DetectConfig(
        learning_rate=cfg.optimizer.learning_rate,
        weight_decay=cfg.optimizer.weight_decay,
        lr_decay_steps=tuple(cfg.optimizer.lr_decay_steps),
        lr_decay_rates=tuple(cfg.optimizer.lr_decay_rates),
        bn_decay_step=cfg.optimizer.bn_decay_step,
        bn_decay_rate=cfg.optimizer.bn_decay_rate,
        max_epoch=cfg.optimizer.max_epoch,
        eval_every=cfg.eval.eval_every,
        checkpoint_dir=os.path.join(cfg.misc.out_dir, "weights"),
        ap_iou_thresholds=tuple(cfg.eval.ap_iou_thresholds),
        use_3d_nms=cfg.eval.use_3d_nms,
        cls_nms=cfg.eval.cls_nms,
        nms_iou=cfg.eval.nms_iou,
        per_class_proposal=cfg.eval.per_class_proposal,
        conf_thresh=cfg.eval.conf_thresh,
    )
    trainer = DetectTrainer(model, dc, tcfg, device)
    if cfg.net.weights and trainer.epoch == 0:
        _transfer_backbone(trainer, cfg.net.weights)

    guard = preemption.PreemptionGuard()
    trainer.preemption_guard = guard
    steps_per_epoch = max(1, len(train_ds) // cfg.data.batch_size)
    try:
        for epoch in range(trainer.epoch, cfg.optimizer.max_epoch):
            loss = trainer.train_epoch(train_loader, steps_per_epoch)
            log.info("epoch %d loss %.4f", epoch, loss)
            if (epoch + 1) % cfg.eval.eval_every == 0:
                if mesh.is_main():
                    # a full deterministic validation pass: every scene once,
                    # rank 0's replica
                    metrics = trainer.evaluate(val_loader.epoch())
                    for t, m in metrics.items():
                        log.info("epoch %d AP@%.2f mAP %.4f AR %.4f",
                                 epoch, t, m["mAP"], m["AR"])
                    # trainer.epoch is already epoch + 1, so a resume
                    # continues at the next epoch instead of re-training it
                    trainer.save()
                mesh.host_barrier()
    except preemption.Preempted as p:
        if mesh.is_main():
            preemption.write_requeue_marker(cfg.misc.out_dir, p.step)
        log.warning("exiting requeueable (epoch %d); restart resumes", p.step)
        sys.exit(preemption.REQUEUE_EXIT_CODE)
    finally:
        guard.uninstall()
    if mesh.is_main():
        preemption.clear_requeue_marker(cfg.misc.out_dir)
    return trainer


if __name__ == "__main__":
    main()
