"""Semseg finetune entry point (port of ``pointcontrast_tpu/apps/semseg.py``).

Usage: python -m pointcontrast_tpu_torch.apps.semseg [config.yaml] [k=v ...]

The dataset and its augmentations, the model (any registry net, optionally
wrapped in ``BilateralCRF``), lenient transfer of a pretraining checkpoint
(``net.weights``), CE training with PolyLR and whole-split mIoU validation
in the configured ``data.layout`` (chunked, voxel, brick[:N]; voxel when
unset, as the JAX app),
checkpoints and resume from the run directory, and a requeueable exit on
preemption.  ``main(argv, device)`` runs on ``cuda`` unless the caller
passes another device (the tests pass ``"cpu"``); a missing card is an
error, never a fall-back.  What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item, before any work starts.
``main`` returns the trainer and its logged history.

``distributed.num_devices`` as in the pretrain CLI: N > 1 (0: every visible
card) spawns N ranks, or ``torchrun`` starts them, and ``main`` returns
``(None, rank 0's history)``.  Each rank trains on its shard of the train
split under DDP; rank 0 validates the whole split with its replica and
writes the snapshot, the checkpoints, the metrics and the requeue marker.
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
    "configs", "semseg_default.yaml",
)


def check_supported(cfg, device: torch.device) -> None:
    """Raise on what the port does not run yet, so that a run never does
    something other than what its config asks for."""
    from pointcontrast_tpu_torch.data.collate import parse_layout
    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.nn.resnet import ResNetBase
    from pointcontrast_tpu_torch.nn.resunet import MinkUNetHyper
    from pointcontrast_tpu_torch.semseg.datasets import load_dataset

    load_dataset(cfg.data.dataset)  # the ScanNet / Stanford loaders raise
    geometry = load_model(cfg.net.model).GEOMETRY
    if geometry.dimension != 3:
        # JAX's app builds a 3-D pyramid for an ST net and silently trains
        # the 3-D base network under the ST name (ROADMAP Queue 3)
        raise ValueError(
            f"net.model={cfg.net.model} is a {geometry.dimension}-D spatio-temporal "
            f"net: it needs {geometry.dimension}-D inputs (x, y, z, t), and the "
            "semseg app's datasets are 3-D; pick a 3-D net (Res16UNet*, ResUNet*, "
            "MinkUNetHyper14INBN)")
    if issubclass(load_model(cfg.net.model), ResNetBase):
        raise ValueError(
            f"net.model={cfg.net.model}: a ResNet's logits sit at level 5 "
            "(stride 32), not at the labelled level-0 rows, so it cannot "
            "train semantic segmentation; pick a U-Net (Res16UNet*, ResUNet*, "
            "MinkUNetHyper14INBN)")
    net_dtype(cfg)  # an unknown net.dtype raises before any work
    layout = cfg.data.get("layout", "voxel")
    kind, _ = parse_layout(layout)  # unknown layouts raise ValueError
    if kind == "brick" and issubclass(load_model(cfg.net.model), MinkUNetHyper):
        raise ValueError(
            f"net.model={cfg.net.model} data.layout={layout}: MinkUNetHyper's "
            "chained pooling-transposes need per-fine-row up_parent maps, which "
            "brick levels don't carry; use data.layout=voxel or chunked")
    wrapper = cfg.net.get("wrapper_type", "") or ""
    if wrapper == "TrilateralCRF":
        # the 7-D (space + colour + time) grid needs per-point timestamps,
        # which the 3-D semseg datasets do not carry
        raise ValueError("TrilateralCRF requires 4D spatio-temporal inputs; the "
                         "semseg app's datasets are 3D — use BilateralCRF")
    if wrapper not in ("", "BilateralCRF"):
        raise ValueError(f"unknown net.wrapper_type {wrapper!r}")


def build_datasets(cfg):
    from pointcontrast_tpu_torch.semseg import transforms as t
    from pointcontrast_tpu_torch.semseg.datasets import load_dataset

    cls = load_dataset(cfg.data.dataset)
    prevoxel = t.Compose([t.ElasticDistortion(cls.ELASTIC_DISTORT_PARAMS)])
    input_tf = t.Compose([
        t.RandomDropout(0.2),
        t.RandomHorizontalFlip(cls.ROTATION_AXIS, cls.IS_TEMPORAL),
        t.ChromaticAutoContrast(),
        t.ChromaticTranslation(cfg.augmentation.data_aug_color_trans_ratio),
        t.ChromaticJitter(cfg.augmentation.data_aug_color_jitter_std),
    ]) if cfg.augmentation.use_feat_aug else None
    train_ds = cls(cfg.data.path, phase=cfg.train.train_phase, augment_data=True,
                   prevoxel_transform=prevoxel, input_transform=input_tf,
                   ignore_label=cfg.data.ignore_label)
    val_ds = cls(cfg.data.path, phase=cfg.train.val_phase, augment_data=False,
                 ignore_label=cfg.data.ignore_label)
    return train_ds, val_ds


def _pretrained(weights: str) -> dict:
    """The model state of a pretraining checkpoint (``PretrainTrainer``'s
    ``.pth``, or the newest in a directory)."""
    from pointcontrast_tpu_torch.train.pretrain import latest_checkpoint

    ckpt = latest_checkpoint(weights) if os.path.isdir(weights) else weights
    if not ckpt:
        raise FileNotFoundError(f"net.weights={weights}: no checkpoint")
    log.info("loading pretrain weights from %s", ckpt)
    return torch.load(ckpt, map_location="cpu")["model"]


def _rank_main(argv: list[str], device: str, models: dict):
    """One spawned rank's run (``parallel.launch.run``): its history.
    ``models``: the parent's model registry, so that a model registered at
    run time (not at import) exists in the rank too."""
    registry.MODELS.update(models)
    return main(argv, device)[1]


def main(argv: list[str] | None = None, device=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    command = list(argv)
    logging.basicConfig(level=logging.INFO)
    path = DEFAULT_CONFIG
    if argv and "=" not in argv[0]:
        path = argv.pop(0)
    cfg = load_config(path, argv)
    cfg = maybe_resume_config(cfg.train.out_dir, cfg, argv)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the semseg app runs on the GPU "
                           "(call main(argv, device='cpu') for the CPU)")
    check_supported(cfg, device)
    world = launch.resolve_world_size(launch.requested_devices(cfg), device)
    if world > 1 and not multihost.launched():
        return None, launch.run(world, _rank_main,
                                (command, str(device), dict(registry.MODELS)), device)
    with launch.process_group(device) as device:
        return _train(cfg, device)


def _train(cfg, device: torch.device):
    """The run in this process: one device, or this rank's."""
    os.makedirs(cfg.train.out_dir, exist_ok=True)
    if mesh.is_main():
        save_config(cfg, os.path.join(cfg.train.out_dir, "config.yaml"))

    from pointcontrast_tpu_torch.data.collate import PadScheme
    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.semseg.crf import BilateralCRF
    from pointcontrast_tpu_torch.semseg.dataset import SemsegBatches
    from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer
    from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets
    from pointcontrast_tpu_torch.utils import preemption

    train_ds, val_ds = build_datasets(cfg)
    layout = cfg.data.get("layout", "voxel")  # the JAX app's default
    scheme = PadScheme(npad0=cfg.data.npad0,
                       level_ratios=tuple(cfg.data.pad_ratios)
                       if cfg.data.get("pad_ratios") else None)
    crf = None
    if cfg.net.get("wrapper_type", ""):
        crf = dict(
            kernel_size=int(cfg.net.get("wrapper_kernel_size", 3)),
            region={0: "hypercube", 1: "hypercross"}[
                int(cfg.net.get("wrapper_region_type", 1))],
            spatial_sigma=float(cfg.net.get("wrapper_spatial_sigma", 1.0)),
            chromatic_sigma=float(cfg.net.get("wrapper_chromatic_sigma", 12.0)),
        )
    shard_id, num_shards = multihost.shard_info()
    train_loader = SemsegBatches(
        train_ds, cfg.data.batch_size, scheme,
        augment_shift=cfg.augmentation.shift_coords,
        limit_numpoints=cfg.data.limit_numpoints,
        conv0_kernel_size=cfg.net.conv1_kernel_size, layout=layout, crf=crf,
        num_shards=num_shards, shard_id=shard_id)

    gen = torch.Generator().manual_seed(0)
    model = load_model(cfg.net.model)(
        in_channels=3, out_channels=train_ds.num_classes,
        conv1_kernel_size=cfg.net.conv1_kernel_size,
        bn_momentum=cfg.optimizer.bn_momentum, generator=gen, dtype=net_dtype(cfg))
    if crf is not None:
        kv = len(kernel_offsets(crf["kernel_size"], 6, crf["region"]))
        model = BilateralCRF(model, train_ds.num_classes, kv,
                             int(cfg.net.get("wrapper_iterations", 10)),
                             generator=gen)
    tcfg = SemsegConfig(
        optimizer=cfg.optimizer.optimizer.lower(),
        lr=cfg.optimizer.lr,
        momentum=cfg.optimizer.sgd_momentum,
        weight_decay=cfg.optimizer.weight_decay,
        scheduler=cfg.optimizer.scheduler.lower(),
        poly_power=cfg.optimizer.poly_power,
        max_iter=cfg.optimizer.max_iter,
        iter_size=cfg.train.iter_size,
        ignore_label=cfg.data.ignore_label,
        stat_freq=cfg.train.stat_freq,
        val_freq=cfg.train.val_freq,
        save_freq=cfg.train.save_freq,
        checkpoint_dir=os.path.join(cfg.train.out_dir, "weights"),
        wrapper_lr=float(cfg.net.get("wrapper_lr", 0) or 0) or None,
    )
    guard = preemption.PreemptionGuard()
    try:
        trainer = SemsegTrainer(
            model, train_loader, None, tcfg, num_classes=train_ds.num_classes,
            device=device,
            pretrained=_pretrained(cfg.net.weights) if cfg.net.weights else None,
            val_dataset=val_ds, val_scheme=scheme,
            val_batch_size=cfg.data.batch_size,
            conv0_kernel_size=cfg.net.conv1_kernel_size, layout=layout,
            crf=crf, preemption_guard=guard)
        history = trainer.train()
    except preemption.Preempted as p:
        if mesh.is_main():
            preemption.write_requeue_marker(cfg.train.out_dir, p.step)
        log.warning("exiting requeueable (iter %d); restart resumes", p.step)
        sys.exit(preemption.REQUEUE_EXIT_CODE)
    finally:
        guard.uninstall()
    if mesh.is_main():
        preemption.clear_requeue_marker(cfg.train.out_dir)
    return trainer, history


if __name__ == "__main__":
    main()
