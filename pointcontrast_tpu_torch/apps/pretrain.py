"""Pretraining entry point (port of ``pointcontrast_tpu/apps/pretrain.py``).

Usage: python -m pointcontrast_tpu_torch.apps.pretrain [config.yaml] [k=v ...]

Loads the config with its dotted overrides (resuming the run directory's
snapshot when there is one, with the overrides on top, as
``config.maybe_resume_config`` allows), builds the pair
dataset (``ScanNetMatchPairDataset`` or ``SyntheticPairDataset``, each
frame's features jittered),
the prefetching ``PairLoader`` in the trainer's mode (``trainer.trainer``:
``HardestContrastiveLossTrainer`` or ``PointNCELossTrainer``) and layout
(``data.layout``: chunked, voxel, brick[:N]; voxel when unset, as the JAX
app), and the model named by ``net.model`` in ``net.dtype``; then trains
to ``opt.max_iter`` under a preemption guard, resuming from the newest
checkpoint of ``<misc.out_dir>/weights``.  A preemption saves, writes the
requeue marker and exits with ``REQUEUE_EXIT_CODE``.  The checkpoints are
what the semseg and votenet CLIs load as ``net.weights``.

``main(argv, device)`` runs on ``cuda`` unless the caller passes another
device (the tests pass ``"cpu"``); a missing card is an error, never a
fall-back.  What the port does not run yet raises ``NotImplementedError``
naming its ROADMAP item, before any work starts.  ``main`` returns the
trainer and its logged history.

``distributed.num_devices``: 1 trains in this process; N > 1 (0: every
visible card) spawns N ranks (``parallel/launch.py``; more cards than are
visible raise ``ValueError`` first) and returns ``(None, rank 0's
history)``; under ``torchrun --nproc_per_node N -m
pointcontrast_tpu_torch.apps.pretrain ...`` each process is a rank.  A rank
trains on its loader shard under DDP (NCCL on the card, gloo on the CPU);
rank 0 writes the config snapshot, the checkpoints, the metrics and the
requeue marker.
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
    "configs", "pretrain_default.yaml",
)

TRAINERS = {"PointNCELossTrainer": "nce", "HardestContrastiveLossTrainer": "hardest"}
DATASETS = ("ScanNetMatchPairDataset", "SyntheticPairDataset")


def check_supported(cfg, device: torch.device) -> str:
    """Raise on what the port does not run yet, or on an unknown trainer,
    dataset, model, dtype, layout or scheduler, so that a run never does
    something other than what its config asks for.  Returns the loss
    mode."""
    from pointcontrast_tpu_torch.data.collate import parse_layout
    from pointcontrast_tpu_torch.nn.registry import load_model

    if cfg.trainer.trainer not in TRAINERS:
        raise ValueError(f"unknown trainer.trainer {cfg.trainer.trainer!r}: "
                         f"one of {sorted(TRAINERS)}")
    if cfg.data.dataset not in DATASETS:
        raise ValueError(f"unknown data.dataset {cfg.data.dataset!r}: one of {DATASETS}")
    load_model(cfg.net.model)  # an unknown model raises
    net_dtype(cfg)  # an unknown net.dtype raises
    parse_layout(cfg.data.get("layout", "voxel"))  # an unknown layout raises
    if str(cfg.opt.scheduler).lower() != "explr":
        raise ValueError(f"opt.scheduler={cfg.opt.scheduler}: the pretraining trainers "
                         "step the reference's ExpLR (every trainer.lr_update_freq)")
    if not cfg.data.get("fuse_frames", True):
        raise NotImplementedError(
            "data.fuse_frames=false: the per-frame parity mode of collate_pair "
            "is not ported (ROADMAP Queue 1 item 1); the port fuses both frames "
            "into one forward")
    return TRAINERS[cfg.trainer.trainer]


def build_dataset(cfg):
    """The pair dataset of ``data.dataset`` with the trainer's
    augmentations and ``Compose([Jitter()])`` on each frame's features."""
    from pointcontrast_tpu_torch.data.pair_dataset import (
        ScanNetMatchPairDataset,
        SyntheticPairDataset,
    )
    from pointcontrast_tpu_torch.data.transforms import Compose, Jitter

    kwargs = dict(
        voxel_size=cfg.data.voxel_size,
        positive_search_multiplier=cfg.trainer.positive_pair_search_voxel_size_multiplier,
        random_rotation=cfg.trainer.use_random_rotation,
        rotation_range=cfg.trainer.rotation_range,
        random_scale=cfg.trainer.use_random_scale,
        min_scale=cfg.trainer.min_scale,
        max_scale=cfg.trainer.max_scale,
        transform=Compose([Jitter()]),
        seed=cfg.misc.seed,
    )
    if cfg.data.dataset == "ScanNetMatchPairDataset":
        return ScanNetMatchPairDataset(
            cfg.data.dataset_root_dir, cfg.data.scannet_match_dir, **kwargs
        )
    return SyntheticPairDataset(
        num_pairs=cfg.data.get("num_pairs", 50),
        points_per_frame=cfg.data.get("points_per_frame", 20000),
        **kwargs,
    )


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
    cfg = maybe_resume_config(cfg.misc.out_dir, cfg, argv)
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the pretrain app runs on the GPU "
                           "(call main(argv, device='cpu') for the CPU)")
    mode = check_supported(cfg, device)
    world = launch.resolve_world_size(launch.requested_devices(cfg), device)
    if world > 1 and not multihost.launched():
        return None, launch.run(world, _rank_main,
                                (command, str(device), dict(registry.MODELS)), device)
    with launch.process_group(device) as device:
        return _train(cfg, mode, device)


def _train(cfg, mode: str, device: torch.device):
    """The run in this process: one device, or this rank's."""
    os.makedirs(cfg.misc.out_dir, exist_ok=True)
    if mesh.is_main():
        save_config(cfg, os.path.join(cfg.misc.out_dir, "config.yaml"))

    from pointcontrast_tpu_torch.data.collate import PadScheme
    from pointcontrast_tpu_torch.data.loader import PairLoader
    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.train.pretrain import PretrainConfig, PretrainTrainer
    from pointcontrast_tpu_torch.utils import preemption

    scheme = PadScheme(
        npad0=cfg.data.npad0,
        level_ratios=tuple(cfg.data.pad_ratios) if cfg.data.get("pad_ratios") else None,
    )
    model = load_model(cfg.net.model)(
        in_channels=3,
        out_channels=cfg.net.model_n_out,
        conv1_kernel_size=cfg.net.conv1_kernel_size,
        bn_momentum=cfg.opt.bn_momentum,
        normalize_feature=cfg.net.normalize_feature,
        generator=torch.Generator().manual_seed(int(cfg.misc.seed)),
        dtype=net_dtype(cfg),
    )
    tcfg = PretrainConfig(
        mode=mode,
        nce_t=cfg.misc.nceT,
        pos_thresh=cfg.trainer.pos_thresh,
        neg_thresh=cfg.trainer.neg_thresh,
        optimizer=cfg.opt.optimizer.lower(),
        lr=cfg.opt.lr,
        momentum=cfg.opt.momentum,
        weight_decay=cfg.opt.weight_decay,
        exp_gamma=cfg.opt.exp_gamma,
        max_iter=cfg.opt.max_iter,
        lr_update_freq=cfg.trainer.lr_update_freq,
        stat_freq=cfg.trainer.stat_freq,
        checkpoint_dir=os.path.join(cfg.misc.out_dir, "weights"),
    )
    shard_id, num_shards = multihost.shard_info()
    loader = PairLoader(
        build_dataset(cfg),
        batch_size=cfg.trainer.batch_size,
        scheme=scheme,
        mode=mode,
        npos=cfg.misc.npos,
        num_pos=cfg.trainer.num_pos_per_batch * cfg.trainer.batch_size,
        num_hn=cfg.trainer.num_hn_samples_per_batch * cfg.trainer.batch_size,
        num_workers=cfg.misc.num_workers,
        seed=cfg.misc.seed,
        conv0_kernel_size=cfg.net.conv1_kernel_size,
        layout=cfg.data.get("layout", "voxel"),
        shard_id=shard_id,
        num_shards=num_shards,
    )
    guard = preemption.PreemptionGuard()
    try:
        trainer = PretrainTrainer(model, loader, tcfg, device, preemption_guard=guard)
        history = trainer.train()
    except preemption.Preempted as p:
        if mesh.is_main():
            preemption.write_requeue_marker(cfg.misc.out_dir, p.step)
        log.warning("exiting requeueable (iter %d); restart resumes", p.step)
        sys.exit(preemption.REQUEUE_EXIT_CODE)
    finally:
        loader.close()
        # a finished run must not keep swallowing SIGTERM / SIGUSR1 in a
        # long-lived host process (pytest, notebooks)
        guard.uninstall()
    if mesh.is_main():
        preemption.clear_requeue_marker(cfg.misc.out_dir)
    return trainer, history


if __name__ == "__main__":
    main()
