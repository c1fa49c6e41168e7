"""Voxelization datasets and fixed-shape semseg batches (host side, numpy,
plus the move to torch).

Jax-free port of ``pointcontrast_tpu/semseg/dataset.py``: the voxelization
dataset base (prevoxel / input / target transforms, label remap to
``ignore_label``, coords-as-feats), the collator (concatenate, optional
random translation before the kernel maps, colour normalisation, the
pyramid at PadScheme sizes in the chunked, voxel or brick[:N] layout,
labels padded with ``ignore_label``, and the CRF's bilateral map over the
layout's rows), and a synchronous loader that draws samples, seeds and
shifts in the JAX loader's order.  From the same samples and
``RandomState`` the batches are the JAX package's, byte for byte.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    _build_padded_pyramid,
    _check_below,
    _concat_with_batch_index,
    check_pyramid_bounds,
    parse_layout,
    pyramid_to,
)
from pointcontrast_tpu_torch.data.sampler import DistributedInfSampler
from pointcontrast_tpu_torch.semseg.voxelizer import Voxelizer
from pointcontrast_tpu_torch.sparse.quantize import sparse_quantize


@dataclasses.dataclass
class SemsegBatch:
    """One batch: numpy on the host, torch after ``to``."""

    feats: Any  # [R_0, C] level-0 rows of the layout, padded rows zero
    labels: Any  # [R_0] int, padding = ignore_label
    pyramid: Any  # sparse.topology.Pyramid (chunked, voxel or brick)
    # voxels dropped by graceful truncation (scalar)
    truncated_voxels: Optional[Any] = None
    # [K, R_0] flat bilateral-grid map over the level-0 rows (CRF wrappers)
    crf_nbr: Optional[Any] = None
    num_samples: int = 0

    def to(self, device) -> "SemsegBatch":
        """Bounds-check the host batch, then move it to ``device``: maps
        widened to int32, labels to int64."""
        rows = check_pyramid_bounds(self.pyramid)[0]
        if self.feats.shape[0] != rows or self.labels.shape != (rows,):
            raise ValueError(f"feats {self.feats.shape} / labels {self.labels.shape}: "
                             f"expected {rows} rows")
        crf = None
        if self.crf_nbr is not None:
            if self.crf_nbr.ndim != 2 or self.crf_nbr.shape[1] != rows:
                raise ValueError(f"crf_nbr: shape {self.crf_nbr.shape}, expected "
                                 f"[K, {rows}]")
            _check_below("crf_nbr", self.crf_nbr, rows)
            crf = torch.from_numpy(np.ascontiguousarray(self.crf_nbr, np.int32)).to(device)
        return SemsegBatch(
            feats=torch.from_numpy(self.feats).to(device),
            labels=torch.from_numpy(self.labels.astype(np.int64)).to(device),
            pyramid=pyramid_to(self.pyramid, device),
            truncated_voxels=torch.as_tensor(self.truncated_voxels).to(device),
            crf_nbr=crf,
            num_samples=self.num_samples,
        )


class VoxelizationDataset:
    """Base: load a scene -> prevoxel downsample / transforms -> voxelize ->
    input / target transforms -> label remap -> optional coords-as-feats.
    Subclasses provide ``load_sample``."""

    VOXEL_SIZE = 0.05
    CLIP_BOUND = None
    TEST_CLIP_BOUND = None
    SCALE_AUGMENTATION_BOUND = (0.9, 1.1)
    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 6, np.pi / 6), (-np.pi, np.pi), (-np.pi / 6, np.pi / 6)
    )
    TRANSLATION_AUGMENTATION_RATIO_BOUND = ((-0.2, 0.2), (-0.05, 0.05), (-0.2, 0.2))
    ELASTIC_DISTORT_PARAMS = None
    PREVOXELIZATION_VOXEL_SIZE = None
    AUGMENT_COORDS_TO_FEATS = False
    ROTATION_AXIS = "z"
    IS_TEMPORAL = False
    NUM_LABELS = -1
    IGNORE_LABELS: tuple = ()
    IS_FULL_POINTCLOUD_EVAL = False

    def __init__(self, data_paths, prevoxel_transform=None,
                 input_transform=None, target_transform=None,
                 augment_data: bool = False, ignore_label: int = 255,
                 return_transformation: bool = False, seed: int | None = None):
        self.data_paths = sorted(data_paths)
        self.prevoxel_transform = prevoxel_transform
        self.input_transform = input_transform
        self.target_transform = target_transform
        self.augment_data = augment_data
        self.ignore_mask = ignore_label
        self.return_transformation = return_transformation
        self.rng = np.random.RandomState(seed)
        self.voxelizer = Voxelizer(
            voxel_size=self.VOXEL_SIZE,
            clip_bound=self.CLIP_BOUND,
            use_augmentation=augment_data,
            scale_augmentation_bound=self.SCALE_AUGMENTATION_BOUND,
            rotation_augmentation_bound=self.ROTATION_AUGMENTATION_BOUND,
            translation_augmentation_ratio_bound=self.TRANSLATION_AUGMENTATION_RATIO_BOUND,
            ignore_label=ignore_label,
        )
        # label remap: unevaluated labels -> ignore
        label_map, n_used = {}, 0
        for l in range(self.NUM_LABELS):
            if l in self.IGNORE_LABELS:
                label_map[l] = self.ignore_mask
            else:
                label_map[l] = n_used
                n_used += 1
        label_map[self.ignore_mask] = self.ignore_mask
        self.label_map = label_map
        self.num_classes = self.NUM_LABELS - len(self.IGNORE_LABELS)

    def __len__(self):
        return len(self.data_paths)

    def load_sample(self, index: int):
        """(coords [N, 3] f32, feats [N, 3] f32, labels [N] i32, center|None)."""
        raise NotImplementedError(
            "reading PLY scenes belongs to the ScanNet / Stanford loaders, "
            "which are not ported (their data is not in the repository)")

    def _remap_labels(self, labels: np.ndarray) -> np.ndarray:
        lut_size = max(self.NUM_LABELS, self.ignore_mask + 1)
        lut = np.full(lut_size, self.ignore_mask, dtype=np.int32)
        for k, v in self.label_map.items():
            if 0 <= k < lut_size:
                lut[k] = v
        out = lut[np.clip(labels, 0, lut_size - 1)]
        out[(labels < 0) | (labels >= lut_size)] = self.ignore_mask
        return out

    def __getitem__(self, index: int, rng=None):
        rng = rng if rng is not None else self.rng
        coords, feats, labels, center = self.load_sample(index)
        if self.PREVOXELIZATION_VOXEL_SIZE is not None:
            inds = sparse_quantize(coords / self.PREVOXELIZATION_VOXEL_SIZE,
                                   return_index=True)
            coords, feats, labels = coords[inds], feats[inds], labels[inds]
        if self.prevoxel_transform is not None:
            coords, feats, labels = self.prevoxel_transform(coords, feats, labels, rng=rng)
        coords, feats, labels, transformation = self.voxelizer.voxelize(
            coords, feats, labels, center=center, rng=rng)
        if self.input_transform is not None:
            coords, feats, labels = self.input_transform(coords, feats, labels, rng=rng)
        if self.target_transform is not None:
            coords, feats, labels = self.target_transform(coords, feats, labels, rng=rng)
        if self.IGNORE_LABELS is not None:
            labels = self._remap_labels(np.asarray(labels))
        if self.AUGMENT_COORDS_TO_FEATS:
            feats = np.concatenate([feats, coords - coords.mean(0)], 1)
        out = (coords.astype(np.int32), feats.astype(np.float32),
               labels.astype(np.int32))
        if self.return_transformation:
            out = out + (transformation.astype(np.float32),)
        return out


def collate_semseg(
    samples: list,
    scheme: PadScheme,
    ignore_label: int = 255,
    shift_coords: bool = False,
    normalize_color: bool = True,
    limit_numpoints: int = 0,
    rng: np.random.RandomState | None = None,
    num_levels: int | None = None,
    conv0_kernel_size: int = 3,
    layout: str = "chunked",
    crf: dict | None = None,
    num_chunks: int | None = None,
) -> SemsegBatch:
    """Concatenate, pad to static shapes and build the pyramid in
    ``layout`` ('chunked', 'voxel', 'brick' or 'brick:N').

    crf: when set (keys kernel_size, region, spatial_sigma,
    chromatic_sigma), also build the CRF's bilateral-grid map from the
    batch's coords and raw colours, over the layout's level-0 rows.
    shift_coords: a random [0, 100) translation of all coords (it changes
    the voxel lattice, so it precedes the kernel maps).  normalize_color:
    RGB / 255 - 0.5 on the first three channels.  limit_numpoints: whole
    samples past the budget are left out.  num_chunks: the chunked
    layout's number of per-sample slices (missing samples become empty,
    fully masked chunks)."""
    kind, _ = parse_layout(layout)
    rng = rng or np.random.RandomState()
    coords_l, feats_l, labels_l = [], [], []
    total = 0
    budget = min(scheme.npads[0] - 1,
                 limit_numpoints if limit_numpoints else scheme.npads[0] - 1)
    for s in samples:
        c, f, l = s[:3]
        if total + len(c) > budget:
            if total == 0:  # a single sample too big: subsample it
                keep = rng.choice(len(c), budget, replace=False)
                keep.sort()
                c, f, l = c[keep], f[keep], l[keep]
            else:
                break
        coords_l.append(c)
        feats_l.append(f)
        labels_l.append(l)
        total += len(c)

    nb = len(coords_l)
    coords, feats = _concat_with_batch_index(coords_l, feats_l)
    labels = np.concatenate(labels_l).astype(np.int32)
    if shift_coords:
        coords[:, 1:] += rng.randint(0, 100, 3, dtype=np.int32)
    raw_rgb = feats[:, :3].copy() if crf is not None else None
    if normalize_color:
        # only the RGB channels: appended channels keep their scale
        feats = feats.astype(np.float32).copy()
        feats[:, :3] = feats[:, :3] / 255.0 - 0.5

    def crf_map(keep, rows, nrows):
        from pointcontrast_tpu_torch.semseg.crf import build_bilateral_map

        sel = slice(None) if keep is None else keep
        return build_bilateral_map(
            coords[sel], raw_rgb[sel], nrows,
            spatial_sigma=crf.get("spatial_sigma", 1.0),
            chromatic_sigma=crf.get("chromatic_sigma", 12.0),
            kernel_size=crf.get("kernel_size", 3),
            region=crf.get("region", "hypercross"),
            rows=rows)

    pyr, meta, rows, orphan = _build_padded_pyramid(
        coords, scheme, num_chunks or nb if kind == "chunked" else nb,
        conv0_kernel_size, layout, num_levels)
    truncated = sum(n for _, n in meta.truncated)
    nrows = pyr.levels[0].valid.shape[0]
    if rows is None:  # voxel: input voxel i is row i
        fpad = np.zeros((nrows, feats.shape[1]), np.float32)
        fpad[: len(feats)] = feats
        lpad = np.full(nrows, ignore_label, np.int32)
        lpad[: len(labels)] = labels
        crf_nbr = None if crf is None else crf_map(None, None, nrows)
    else:
        keep = ~orphan
        fpad = np.zeros((nrows, feats.shape[1]), np.float32)
        fpad[rows[keep]] = feats[keep]
        lpad = np.full(nrows, ignore_label, np.int32)
        lpad[rows[keep]] = labels[keep]
        crf_nbr = None if crf is None else crf_map(keep, rows[keep], nrows)
        truncated += int(orphan.sum())
    return SemsegBatch(feats=fpad, labels=lpad, pyramid=pyr,
                       truncated_voxels=np.asarray(truncated, np.float32),
                       crf_nbr=crf_nbr, num_samples=nb)


class SemsegBatches:
    """Host batches drawn as the JAX package's ``SemsegLoader`` draws them,
    synchronously: sample ids from shard ``shard_id`` of ``num_shards`` of
    ``DistributedInfSampler`` (a data-parallel rank's), each sample's
    ``RandomState`` seeded from the loader's stream (seed ``seed + 17 *
    shard_id``, JAX's salt), the collation (shift) from the same stream."""

    def __init__(self, dataset, batch_size: int, scheme: PadScheme,
                 shuffle: bool = True, augment_shift: bool = False,
                 limit_numpoints: int = 0, seed: int = 0,
                 num_levels: int | None = None, conv0_kernel_size: int = 3,
                 layout: str = "chunked", crf: dict | None = None,
                 num_shards: int = 1, shard_id: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.scheme = scheme
        self.augment_shift = augment_shift
        self.limit_numpoints = limit_numpoints
        self.num_levels = num_levels
        self.conv0_kernel_size = conv0_kernel_size
        self.layout = layout
        self.crf = crf
        self.sampler = DistributedInfSampler(len(dataset), num_shards, shard_id,
                                             shuffle, seed)
        self.rng = np.random.RandomState(seed + 17 * shard_id)

    def __iter__(self):
        return self

    def __next__(self) -> SemsegBatch:
        idxs = [next(self.sampler) for _ in range(self.batch_size)]
        seeds = [int(self.rng.randint(0, 2 ** 31 - 1)) for _ in idxs]
        samples = [self.dataset.__getitem__(i, rng=np.random.RandomState(s))
                   for i, s in zip(idxs, seeds)]
        return collate_semseg(
            samples, self.scheme, ignore_label=self.dataset.ignore_mask,
            shift_coords=self.augment_shift, limit_numpoints=self.limit_numpoints,
            rng=self.rng, num_levels=self.num_levels,
            conv0_kernel_size=self.conv0_kernel_size, layout=self.layout,
            crf=self.crf, num_chunks=self.batch_size)
