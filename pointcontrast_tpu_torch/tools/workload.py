"""The workloads of the port's chip runs.

Pretraining, as the JAX package's ``bench.py`` times it: Res16UNet34C, 4
frame pairs per step fused into one sparse batch of 8 chunks,
saturated-surface synthetic frames (~15.5k voxels each at 2.5 cm),
``PadScheme.scannet(npad0=131072)``, 4096 PointInfoNCE pairs, or in the
hardest mode (the shipped YAML's trainer) 4096 positives and 1024
hard-negative candidates a frame.

VoteNet, at the shipped ``configs/votenet_default.yaml``: 8 scenes x 40000
points (no colour, no height), 256 proposals by vote FPS, over either
backbone: ``sparseconv`` (the YAML's default; Res16UNet34C 3 -> 256, 2.5 cm
voxels, ``npad0`` 262144 with the YAML's ``pad_ratios``, chunked layout) or
``pointnet2`` (``net.backbone=pointnet2``; no voxels).
``SyntheticDetectionDataset`` scenes, since no ScanNet detection data ships
with the repo.

Semseg, as the JAX package's ``bench.py`` semseg step: 6 saturated-surface
scenes (frame 0 of ``SyntheticPairDataset(num_pairs=6, points_per_frame=
90000, room_size=2.4, voxel_size=0.02, seed=0)``, ~250k voxels at 2 cm),
random colours and labels (20 classes) from ``RandomState(0)``,
``PadScheme.scannet(npad0=262144)`` (the YAML's ``pad_ratios``), chunked
layout with 6 chunks.  The frames' voxel coords are used: the JAX bench
casts the frames' metric xyz to int (``ds[i][0]``), which leaves ~10
distinct voxels per scene.

ResNet (ResNet14-101 at the published widths, 3 -> 20): the semseg
workload's 6 scenes through a 6-level chunked pyramid with the k3s2 maps
(``build_chunked_pyramid(num_levels=6, npads=PadScheme.scannet(262144,
6).npads, build_down3=True)``, 6 chunks), normalised colours, and one
random label (20 classes, ``RandomState(0)``) per level-5 voxel, where the
ResNet's logits sit; cross-entropy and the semseg SGD + PolyLR recipe."""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any

import numpy as np
import torch

PAIRS = 4
NPAD0 = PAIRS * 32768  # both frames fused: 8 chunks of 16384 rows
POINTS_PER_FRAME = 45000  # saturates the visible surfaces at 2.5 cm
ROOM_SIZE = 1.75
NPOS = 4096
# the hardest mode at configs/pretrain_default.yaml: num_pos_per_batch 1024
# and num_hn_samples_per_batch 256, times the 4 pairs of a batch
NUM_POS = 1024 * PAIRS
NUM_HN = 256 * PAIRS

VOTENET_SCENES = 8
VOTENET_POINTS = 40000
VOTENET_VOXEL = 0.025
VOTENET_NPAD0 = 262144
VOTENET_PAD_RATIOS = (1.0, 0.8, 0.35, 0.11, 0.04)
VOTENET_PROPOSALS = 256

SEMSEG_SCENES = 6
SEMSEG_POINTS = 90000
SEMSEG_ROOM = 2.4
SEMSEG_VOXEL = 0.02
SEMSEG_NPAD0 = 262144
SEMSEG_CLASSES = 20
# the shipped BilateralCRF settings (configs/semseg_default.yaml)
SEMSEG_CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0,
                  chromatic_sigma=12.0)


def pretrain_batches(device, n_batches: int = 2, pairs: int = PAIRS,
                     npad0: int = NPAD0, points: int = POINTS_PER_FRAME,
                     room: float = ROOM_SIZE, npos: int = NPOS,
                     seed: int = 0, layout: str = "chunked", mode: str = "nce",
                     num_pos: int = NUM_POS, num_hn: int = NUM_HN) -> list:
    """``n_batches`` collated batches in ``layout`` moved (bounds-checked)
    to ``device`` (None: the host batches, numpy); ``mode`` 'nce' (``npos``
    pairs) or 'hardest' (``num_pos`` positives and ``num_hn`` candidates a
    frame: the shipped YAML's 1024 and 256 a pair, times ``pairs``)."""
    from pointcontrast_tpu_torch.data import (
        PadScheme,
        SyntheticPairDataset,
        collate_pair,
    )

    ds = SyntheticPairDataset(num_pairs=pairs * 2, points_per_frame=points,
                              room_size=room, seed=seed)
    scheme = PadScheme.scannet(npad0=npad0)
    rng = np.random.RandomState(seed)
    host = [
        collate_pair([ds[(b * pairs + i) % len(ds)] for i in range(pairs)],
                     scheme, mode=mode, npos=npos, num_pos=num_pos, num_hn=num_hn,
                     rng=rng, layout=layout)
        for b in range(n_batches)
    ]
    return host if device is None else [b.to(device) for b in host]


def votenet_batches(device, n_batches: int = 2, scenes: int = VOTENET_SCENES,
                    points: int = VOTENET_POINTS,
                    voxel: float | None = VOTENET_VOXEL,
                    npad0: int = VOTENET_NPAD0,
                    pad_ratios: tuple = VOTENET_PAD_RATIOS,
                    seed: int = 0, layout: str = "chunked") -> list:
    """``n_batches`` collated VoteNet batches of ``scenes`` distinct scenes
    each, voxelised in ``layout`` ('chunked' or 'voxel'), moved
    (bounds-checked) to ``device``; ``voxel=None`` collates without voxels,
    for the PointNet++ backbone."""
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
                          layout=layout).to(device)
        for b in range(n_batches)
    ]


def votenet_model(seed: int = 0, backbone_model: str = "Res16UNet34C",
                  num_proposal: int = VOTENET_PROPOSALS,
                  backbone: str = "sparseconv",
                  use_voting: bool = True,
                  dtype: torch.dtype | None = None) -> torch.nn.Module:
    """VoteNet (or, with ``use_voting=False``, BoxNet) over ``backbone`` for
    the ScanNet classes, random weights from ``seed``, on the CPU;
    ``backbone_model`` names the sparse-conv backbone's net, ``dtype`` its
    activations' dtype (bf16: the YAML's mixed precision)."""
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.votenet import VoteNet

    dc = ScannetDatasetConfig()
    return VoteNet(
        num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
        num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
        num_proposal=num_proposal,
        sampling="vote_fps", backbone=backbone,
        backbone_model=backbone_model, use_voting=use_voting,
        generator=torch.Generator().manual_seed(seed), dtype=dtype)


class SemsegScenes:
    """The semseg workload's scenes as a dataset: ``__getitem__(i, rng)``
    gives (voxel coords, colours 0-254, labels), as ``evaluate_dataset`` and
    ``collate_semseg`` take them; no augmentation."""

    ignore_mask = 255

    def __init__(self, scenes: int = SEMSEG_SCENES, points: int = SEMSEG_POINTS,
                 room: float = SEMSEG_ROOM, voxel: float = SEMSEG_VOXEL,
                 classes: int = SEMSEG_CLASSES, seed: int = 0):
        from pointcontrast_tpu_torch.data import SyntheticPairDataset

        ds = SyntheticPairDataset(num_pairs=scenes, points_per_frame=points,
                                  room_size=room, voxel_size=voxel, seed=seed)
        rng = np.random.RandomState(seed)
        self.samples = []
        for i in range(scenes):
            c = np.asarray(ds[i][2], np.int32)  # frame 0's voxel coords
            self.samples.append((
                c,
                rng.randint(0, 255, (len(c), 3)).astype(np.float32),
                rng.randint(0, classes, len(c)).astype(np.int32),
            ))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int, rng=None):
        return self.samples[index]


def semseg_scheme(npad0: int = SEMSEG_NPAD0):
    from pointcontrast_tpu_torch.data import PadScheme

    return PadScheme.scannet(npad0=npad0)


def semseg_batch(scenes: SemsegScenes, npad0: int = SEMSEG_NPAD0,
                 crf: dict | None = None, layout: str = "chunked"):
    """The one host batch of all ``scenes`` in ``layout`` (chunked: one
    chunk a scene), with the CRF's bilateral map when ``crf`` is given."""
    from pointcontrast_tpu_torch.semseg.dataset import collate_semseg

    return collate_semseg(list(scenes.samples), semseg_scheme(npad0),
                          ignore_label=255, shift_coords=False,
                          rng=np.random.RandomState(1), crf=crf,
                          num_chunks=len(scenes), layout=layout)


def semseg_model(seed: int = 0, model: str = "Res16UNet34C",
                 classes: int = SEMSEG_CLASSES, bn_momentum: float = 0.02,
                 crf: dict | None = None, iterations: int = 10,
                 dtype: torch.dtype | None = None) -> torch.nn.Module:
    """A registry net 3 -> ``classes`` (BN momentum 0.02, the YAML's), in a
    ``BilateralCRF`` of ``iterations`` mean-field steps when ``crf`` is
    given; random weights from ``seed``, on the CPU; ``dtype``: the net's
    activations (bf16: the YAML's ``net.dtype``)."""
    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.semseg.crf import BilateralCRF
    from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets

    gen = torch.Generator().manual_seed(seed)
    net = load_model(model)(in_channels=3, out_channels=classes,
                            bn_momentum=bn_momentum, generator=gen, dtype=dtype)
    if crf is None:
        return net
    kv = len(kernel_offsets(crf["kernel_size"], 6, crf["region"]))
    return BilateralCRF(net, classes, kv, iterations, generator=gen)


RESNET_LEVELS = 6


@dataclasses.dataclass
class ResNetBatch:
    """One chunked ResNet batch: numpy on the host, torch after ``to``."""

    feats: Any  # [B * S_0, 3], padded rows zero
    labels: Any  # [B * S_5] int, padding = 255 (the logits' level)
    pyramid: Any  # chunked Pyramid, 6 levels, with down_nbr3
    truncated_voxels: float = 0.0
    num_samples: int = 0

    def to(self, device) -> "ResNetBatch":
        """Bounds-check the host batch (every map per chunk, ``down_nbr3``
        included), then move it to ``device``."""
        from pointcontrast_tpu_torch.data.collate import (
            check_pyramid_bounds,
            pyramid_to,
        )

        rows = check_pyramid_bounds(self.pyramid)
        if (self.feats.shape[0] != rows[0]
                or self.labels.shape != (rows[RESNET_LEVELS - 1],)):
            raise ValueError(f"feats {self.feats.shape} / labels {self.labels.shape} "
                             f"do not fit levels of {rows} rows")
        return ResNetBatch(
            feats=torch.from_numpy(self.feats).to(device),
            labels=torch.from_numpy(self.labels.astype(np.int64)).to(device),
            pyramid=pyramid_to(self.pyramid, device),
            truncated_voxels=self.truncated_voxels, num_samples=self.num_samples)


def resnet_batch(scenes: SemsegScenes, npad0: int = SEMSEG_NPAD0,
                 classes: int = SEMSEG_CLASSES, seed: int = 0) -> ResNetBatch:
    """The host ResNet batch of all ``scenes`` (one chunk a scene)."""
    from pointcontrast_tpu_torch.data import PadScheme
    from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid

    nb = len(scenes)
    coords = np.concatenate([
        np.concatenate([np.full((len(c), 1), b, np.int32), c], axis=1)
        for b, (c, _, _) in enumerate(scenes.samples)]).astype(np.int32)
    colours = np.concatenate([f for _, f, _ in scenes.samples]) / 255.0 - 0.5
    npads = PadScheme.scannet(npad0, RESNET_LEVELS).npads
    pyr, meta, rows, orphan = build_chunked_pyramid(
        coords, RESNET_LEVELS, npads, num_batch=nb, build_down3=True)
    feats = np.zeros((pyr.levels[0].valid.shape[0], 3), np.float32)
    feats[rows[~orphan]] = colours[~orphan]
    valid5 = pyr.levels[-1].valid > 0
    labels = np.full(valid5.shape[0], 255, np.int32)
    labels[valid5] = np.random.RandomState(seed).randint(0, classes, int(valid5.sum()))
    truncated = sum(n for _, n in meta.truncated) + int(orphan.sum())
    return ResNetBatch(feats=feats, labels=labels, pyramid=pyr,
                       truncated_voxels=float(truncated), num_samples=nb)


def resnet_model(seed: int = 0, model: str = "ResNet18",
                 classes: int = SEMSEG_CLASSES,
                 bn_momentum: float = 0.02,
                 dtype: torch.dtype | None = None) -> torch.nn.Module:
    """A registry ResNet 3 -> ``classes`` at the published widths, random
    weights from ``seed``, on the CPU; ``dtype``: its activations (bf16:
    JAX's mixed precision; parameters stay f32)."""
    from pointcontrast_tpu_torch.nn.registry import load_model

    return load_model(model)(in_channels=3, out_channels=classes,
                             bn_momentum=bn_momentum,
                             generator=torch.Generator().manual_seed(seed), dtype=dtype)


def resnet_step(model, opt, sched, batch) -> torch.Tensor:
    """One training step: forward, cross-entropy at the level-5 rows
    (ignore 255), backward, SGD and PolyLR.  Returns the loss (not
    synchronised)."""
    from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore

    model.train()
    opt.zero_grad(set_to_none=True)
    loss = cross_entropy_ignore(model(batch.feats, batch.pyramid), batch.labels, 255)
    loss.backward()
    opt.step()
    sched.step()
    return loss.detach()


@contextlib.contextmanager
def plain_ops():
    """Route ``sparse.ops``, ``sparse.brick`` and ``detect.ops`` through the
    kernels' plain-torch twins while the block runs, on any device: the reference
    side of a kernels-vs-plain comparison of a whole step on the card.  The
    wrappers themselves never fall back; this swaps what the ops call,
    process-wide (autograd runs CUDA backward functions on its own
    threads)."""
    from pointcontrast_tpu_torch.detect import kernels as dk
    from pointcontrast_tpu_torch.sparse import kernels as sk
    from pointcontrast_tpu_torch.sparse import ops

    # sparse.ops imported the wrappers by name; sparse.brick and detect.ops
    # call them through their kernels module
    swaps = [(ops, fn.__name__, getattr(sk, fn.__name__ + "_plain"))
             for fn in sk.KERNELS if hasattr(ops, fn.__name__)]
    swaps += [(sk, fn.__name__, getattr(sk, fn.__name__ + "_plain"))
              for fn in sk.KERNELS if not hasattr(ops, fn.__name__)]
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


def pretrain_model(seed: int = 0, dtype: torch.dtype | None = None) -> torch.nn.Module:
    """Res16UNet34C (3 -> 32 channels, L2-normalised), random weights from
    ``seed``, on the CPU; ``dtype``: its activations (bf16: the YAML's
    ``net.dtype``; parameters stay f32)."""
    from pointcontrast_tpu_torch.nn.registry import load_model

    return load_model("Res16UNet34C")(
        in_channels=3, out_channels=32, normalize_feature=True,
        generator=torch.Generator().manual_seed(seed), dtype=dtype)
