"""The workloads of the port's chip runs.

Pretraining, as the JAX package's ``bench.py`` times it: Res16UNet34C, 4
frame pairs per step fused into one sparse batch of 8 chunks,
saturated-surface synthetic frames (~15.5k voxels each at 2.5 cm),
``PadScheme.scannet(npad0=131072)``, 4096 PointInfoNCE pairs.

VoteNet, at the shipped ``configs/votenet_default.yaml``: 8 scenes x 40000
points (no colour, no height), 256 proposals by vote FPS, over either
backbone: ``sparseconv`` (the YAML's default; Res16UNet34C 3 -> 256, 2.5 cm
voxels, ``npad0`` 262144 with the YAML's ``pad_ratios``, chunked layout) or
``pointnet2`` (``net.backbone=pointnet2``; no voxels).
``SyntheticDetectionDataset`` scenes, since no ScanNet detection data ships
with the repo."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PAIRS = 4
NPAD0 = PAIRS * 32768  # both frames fused: 8 chunks of 16384 rows
POINTS_PER_FRAME = 45000  # saturates the visible surfaces at 2.5 cm
ROOM_SIZE = 1.75
NPOS = 4096

VOTENET_SCENES = 8
VOTENET_POINTS = 40000
VOTENET_VOXEL = 0.025
VOTENET_NPAD0 = 262144
VOTENET_PAD_RATIOS = (1.0, 0.8, 0.35, 0.11, 0.04)
VOTENET_PROPOSALS = 256


def pretrain_batches(device, n_batches: int = 2, pairs: int = PAIRS,
                     npad0: int = NPAD0, points: int = POINTS_PER_FRAME,
                     room: float = ROOM_SIZE, npos: int = NPOS,
                     seed: int = 0) -> list:
    """``n_batches`` collated batches moved (bounds-checked) to ``device``."""
    from pointcontrast_tpu_torch.data import (
        PadScheme,
        SyntheticPairDataset,
        collate_pair,
    )

    ds = SyntheticPairDataset(num_pairs=pairs * 2, points_per_frame=points,
                              room_size=room, seed=seed)
    scheme = PadScheme.scannet(npad0=npad0)
    rng = np.random.RandomState(seed)
    return [
        collate_pair([ds[(b * pairs + i) % len(ds)] for i in range(pairs)],
                     scheme, npos=npos, rng=rng).to(device)
        for b in range(n_batches)
    ]


def votenet_batches(device, n_batches: int = 2, scenes: int = VOTENET_SCENES,
                    points: int = VOTENET_POINTS,
                    voxel: float | None = VOTENET_VOXEL,
                    npad0: int = VOTENET_NPAD0,
                    pad_ratios: tuple = VOTENET_PAD_RATIOS,
                    seed: int = 0) -> list:
    """``n_batches`` collated VoteNet batches of ``scenes`` distinct scenes
    each, moved (bounds-checked) to ``device``; ``voxel=None`` collates
    without voxels, for the PointNet++ backbone."""
    from pointcontrast_tpu_torch.data import PadScheme
    from pointcontrast_tpu_torch.detect.datasets import (
        SyntheticDetectionDataset,
        collate_detection,
    )

    ds = SyntheticDetectionDataset(num_scenes=n_batches * scenes,
                                   num_points=points, seed=seed)
    scheme = (None if voxel is None
              else PadScheme(npad0=npad0, level_ratios=tuple(pad_ratios)))
    return [
        collate_detection([ds[b * scenes + i] for i in range(scenes)],
                          voxel_size=voxel, scheme=scheme,
                          layout="chunked").to(device)
        for b in range(n_batches)
    ]


def votenet_model(seed: int = 0, backbone_model: str = "Res16UNet34C",
                  num_proposal: int = VOTENET_PROPOSALS,
                  backbone: str = "sparseconv",
                  use_voting: bool = True) -> torch.nn.Module:
    """VoteNet (or, with ``use_voting=False``, BoxNet) over ``backbone`` for
    the ScanNet classes, random weights from ``seed``, on the CPU;
    ``backbone_model`` names the sparse-conv backbone's net."""
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.votenet import VoteNet

    dc = ScannetDatasetConfig()
    return VoteNet(
        num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
        num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
        num_proposal=num_proposal,
        sampling="vote_fps", backbone=backbone,
        backbone_model=backbone_model, use_voting=use_voting,
        generator=torch.Generator().manual_seed(seed))


@contextlib.contextmanager
def plain_ops():
    """Route ``sparse.ops`` and ``detect.ops`` through the kernels'
    plain-torch twins while the block runs, on any device: the reference
    side of a kernels-vs-plain comparison of a whole step on the card.  The
    wrappers themselves never fall back; this swaps what the ops call,
    process-wide (autograd runs CUDA backward functions on its own
    threads)."""
    from pointcontrast_tpu_torch.detect import kernels as dk
    from pointcontrast_tpu_torch.sparse import kernels as sk
    from pointcontrast_tpu_torch.sparse import ops

    # sparse.ops imported the wrappers by name; detect.ops calls them
    # through the detect.kernels module
    swaps = [(ops, fn.__name__, getattr(sk, fn.__name__ + "_plain"))
             for fn in sk.KERNELS]
    swaps += [(dk, fn.__name__, getattr(dk, fn.__name__ + "_plain"))
              for fn in dk.KERNELS]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, plain in swaps:
            setattr(mod, name, plain)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def pretrain_model(seed: int = 0) -> torch.nn.Module:
    """Res16UNet34C (3 -> 32 channels, L2-normalised), random weights from
    ``seed``, on the CPU."""
    from pointcontrast_tpu_torch.nn.registry import load_model

    return load_model("Res16UNet34C")(
        in_channels=3, out_channels=32, normalize_feature=True,
        generator=torch.Generator().manual_seed(seed))
