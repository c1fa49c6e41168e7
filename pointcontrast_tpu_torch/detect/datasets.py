"""Detection datasets and the voxelized VoteNet batch (port of
``pointcontrast_tpu/detect/datasets.py``).

The scene loaders are numpy copies of the JAX package's:
``ScannetDetectionDataset`` reads the reference's preprocessed
``{scene}_vert/_ins_label/_sem_label/_bbox.npy`` files, random-samples
``num_points`` and builds the vote labels; ``SyntheticDetectionDataset``
makes random rooms with box objects under the same sample contract.
``collate_detection`` stacks samples and, for the sparse-conv backbone,
voxelizes them into a chunked or voxel (flat) pyramid with a point ->
voxel-row index; from the same samples it gives the JAX package's arrays
byte for byte.  ``DetectionBatch.to`` checks every index against its chunk
(or, flat, its level) before any kernel can read it through a raw pointer.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

from pointcontrast_tpu_torch.data.collate import (
    PadScheme,
    _level_kind,
    check_pyramid_bounds,
    pyramid_to,
)
from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid
from pointcontrast_tpu_torch.sparse.hashing import HashSpec
from pointcontrast_tpu_torch.sparse.quantize import sparse_quantize

MAX_NUM_OBJ = 64
MEAN_COLOR_RGB = np.array([109.8, 97.2, 83.8])


def rotz(t: float) -> np.ndarray:
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def rotate_aligned_boxes(boxes: np.ndarray, rot_mat: np.ndarray) -> np.ndarray:
    """Axis-aligned box rotation via corner extents
    (model_util_scannet.py:70-91)."""
    centers, lengths = boxes[:, 0:3], boxes[:, 3:6]
    new_centers = centers @ rot_mat.T
    dx, dy = lengths[:, 0] / 2.0, lengths[:, 1] / 2.0
    new_x = np.zeros((len(dx), 4))
    new_y = np.zeros((len(dx), 4))
    for i, (cx, cy) in enumerate([(-1, -1), (1, -1), (1, 1), (-1, 1)]):
        crnrs = np.zeros((len(dx), 3))
        crnrs[:, 0] = cx * dx
        crnrs[:, 1] = cy * dy
        crnrs = crnrs @ rot_mat.T
        new_x[:, i] = crnrs[:, 0]
        new_y[:, i] = crnrs[:, 1]
    new_dx = 2.0 * new_x.max(1)
    new_dy = 2.0 * new_y.max(1)
    new_lengths = np.stack([new_dx, new_dy, lengths[:, 2]], axis=1)
    return np.concatenate([new_centers, new_lengths], axis=1)


def random_sampling(pc: np.ndarray, num_sample: int, rng=None):
    rng = rng or np.random
    n = len(pc)
    if n >= num_sample:
        choices = rng.choice(n, num_sample, replace=False)
    else:
        extra = rng.choice(n, num_sample - n, replace=True)
        choices = np.concatenate([np.arange(n), extra])
    return pc[choices], choices


class ScannetDetectionDataset:
    """Loads the reference's preprocessed per-scene npy files."""

    def __init__(
        self,
        data_path: str,
        split_file: str | None = None,
        scan_names: list | None = None,
        num_points: int = 20000,
        use_color: bool = False,
        use_height: bool = False,
        augment: bool = False,
        data_ratio: float = 1.0,
        seed: int | None = None,
    ):
        self.data_path = data_path
        self.dc = ScannetDatasetConfig()
        if scan_names is None:
            avail = {
                os.path.basename(x)[0:12]
                for x in os.listdir(data_path)
                if x.startswith("scene")
            }
            with open(split_file) as f:
                scan_names = [s for s in f.read().splitlines() if s in avail]
            scan_names = scan_names[: int(len(scan_names) * data_ratio)]
        self.scan_names = scan_names
        self.num_points = num_points
        self.use_color = use_color
        self.use_height = use_height
        self.augment = augment
        self.rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.scan_names)

    def _load_scene(self, scan_name: str):
        p = os.path.join(self.data_path, scan_name)
        return (
            np.load(p + "_vert.npy"),
            np.load(p + "_ins_label.npy"),
            np.load(p + "_sem_label.npy"),
            np.load(p + "_bbox.npy"),
        )

    def __getitem__(self, idx: int) -> dict:
        rng = self.rng
        dc = self.dc
        mesh_vertices, instance_labels, semantic_labels, instance_bboxes = (
            self._load_scene(self.scan_names[idx])
        )
        if not self.use_color:
            point_cloud = mesh_vertices[:, 0:3]
        else:
            point_cloud = mesh_vertices[:, 0:6].copy()
            point_cloud[:, 3:] = (point_cloud[:, 3:] - MEAN_COLOR_RGB) / 256.0
        if self.use_height:
            floor = np.percentile(point_cloud[:, 2], 0.99)
            point_cloud = np.concatenate(
                [point_cloud, (point_cloud[:, 2] - floor)[:, None]], 1
            )

        target_bboxes = np.zeros((MAX_NUM_OBJ, 6))
        target_bboxes_mask = np.zeros(MAX_NUM_OBJ)
        angle_classes = np.zeros(MAX_NUM_OBJ)
        angle_residuals = np.zeros(MAX_NUM_OBJ)
        size_classes = np.zeros(MAX_NUM_OBJ)
        size_residuals = np.zeros((MAX_NUM_OBJ, 3))

        point_cloud, choices = random_sampling(point_cloud, self.num_points, rng)
        instance_labels = instance_labels[choices]
        semantic_labels = semantic_labels[choices]

        nb = instance_bboxes.shape[0]
        target_bboxes_mask[:nb] = 1
        target_bboxes[:nb] = instance_bboxes[:, 0:6]

        if self.augment:
            if rng.random_sample() > 0.5:
                point_cloud[:, 0] = -point_cloud[:, 0]
                target_bboxes[:, 0] = -target_bboxes[:, 0]
            if rng.random_sample() > 0.5:
                point_cloud[:, 1] = -point_cloud[:, 1]
                target_bboxes[:, 1] = -target_bboxes[:, 1]
            rot_angle = rng.random_sample() * np.pi / 18 - np.pi / 36
            rot = rotz(rot_angle)
            point_cloud[:, 0:3] = point_cloud[:, 0:3] @ rot.T
            target_bboxes = rotate_aligned_boxes(target_bboxes, rot)

        # votes to per-instance centroid, computed AFTER augmentation
        point_votes = np.zeros((self.num_points, 3))
        point_votes_mask = np.zeros(self.num_points)
        for i_inst in np.unique(instance_labels):
            ind = np.where(instance_labels == i_inst)[0]
            if semantic_labels[ind[0]] in dc.nyu40ids:
                x = point_cloud[ind, :3]
                center = 0.5 * (x.min(0) + x.max(0))
                point_votes[ind] = center - x
                point_votes_mask[ind] = 1.0
        point_votes = np.tile(point_votes, (1, 3))

        class_ind = [dc.nyu40id2class[int(x)] for x in instance_bboxes[:, -1]]
        size_classes[:nb] = class_ind
        size_residuals[:nb] = target_bboxes[:nb, 3:6] - dc.mean_size_arr[class_ind]
        sem_cls = np.zeros(MAX_NUM_OBJ)
        sem_cls[:nb] = class_ind

        return {
            "point_clouds": point_cloud.astype(np.float32),
            "center_label": target_bboxes[:, 0:3].astype(np.float32),
            "heading_class_label": angle_classes.astype(np.int32),
            "heading_residual_label": angle_residuals.astype(np.float32),
            "size_class_label": size_classes.astype(np.int32),
            "size_residual_label": size_residuals.astype(np.float32),
            "sem_cls_label": sem_cls.astype(np.int32),
            "box_label_mask": target_bboxes_mask.astype(np.float32),
            "vote_label": point_votes.astype(np.float32),
            "vote_label_mask": point_votes_mask.astype(np.int32),
            "scan_idx": np.int32(idx),
        }


class SyntheticDetectionDataset(ScannetDetectionDataset):
    """Random rooms with box objects; same sample contract as ScanNet
    (used by tests — the reference's integration test is likewise 'run on
    tiny data')."""

    def __init__(self, num_scenes: int = 8, num_objects: int = 6,
                 scene_seed: int = 31, **kwargs):
        self.num_scenes = num_scenes
        self.num_objects = num_objects
        self.scene_seed = scene_seed
        super().__init__(
            data_path=".", scan_names=[f"synth{i}" for i in range(num_scenes)],
            **kwargs,
        )

    def _load_scene(self, scan_name: str):
        rng = np.random.RandomState(self.scene_seed + int(scan_name[5:]))
        dc = self.dc
        room = 6.0
        n_bg = 6000
        pts = [rng.rand(n_bg, 3) * [room, room, 0.05]]
        ins = [np.zeros(n_bg)]
        sem = [np.zeros(n_bg)]
        bboxes = []
        for i in range(self.num_objects):
            cls = rng.randint(dc.num_class)
            size = dc.mean_size_arr[cls] * (0.8 + 0.4 * rng.rand(3))
            center = rng.rand(3) * [room - 1, room - 1, 1.0] + [0.5, 0.5, size[2] / 2]
            m = 700
            p = (rng.rand(m, 3) - 0.5) * size
            axis = rng.randint(3)
            p[:, axis] = np.sign(p[:, axis]) * size[axis] / 2
            pts.append(p + center)
            ins.append(np.full(m, i + 1))
            sem.append(np.full(m, dc.nyu40ids[cls]))
            bboxes.append(np.concatenate([center, size, [dc.nyu40ids[cls]]]))
        verts = np.concatenate(pts).astype(np.float32)
        verts = np.concatenate([verts, np.zeros_like(verts)], 1)  # fake color
        return (
            verts,
            np.concatenate(ins).astype(np.int32),
            np.concatenate(sem).astype(np.int32),
            np.stack(bboxes),
        )


LABEL_FIELDS = (
    "center_label", "heading_class_label", "heading_residual_label",
    "size_class_label", "size_residual_label", "sem_cls_label",
    "box_label_mask", "vote_label", "vote_label_mask",
)


def _tensor(a, device) -> torch.Tensor:
    """int arrays become int64 (torch indexes with int64), floats stay."""
    a = np.asarray(a)
    if a.dtype.kind in "iu":
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


@dataclasses.dataclass
class DetectionBatch:
    """Static-shaped VoteNet batch: numpy on the host, torch after ``to``."""

    point_clouds: Any  # [B, N, 3+] f32
    center_label: Any  # [B, MAX_NUM_OBJ, 3]
    heading_class_label: Any
    heading_residual_label: Any
    size_class_label: Any
    size_residual_label: Any
    sem_cls_label: Any
    box_label_mask: Any
    vote_label: Any  # [B, N, 9]
    vote_label_mask: Any  # [B, N]
    # sparse-conv backbone extras (None for pointnet2)
    voxel_feats: Optional[Any] = None  # [R_0, 3] level-0 rows
    voxel_pyramid: Optional[Any] = None  # chunked or voxel (flat) Pyramid
    point_voxel_idx: Optional[Any] = None  # [B, N] rows of voxel_feats

    def to(self, device) -> "DetectionBatch":
        """Bounds-check the host batch (the pyramid, and each sample's
        ``point_voxel_idx``: chunked, inside its own slice
        ``[b * S_0, (b + 1) * S_0)``; flat, below the level-0 rows), then
        move it to ``device``: maps as int32, ``point_voxel_idx`` int32,
        integer labels int64."""
        out = {k: _tensor(getattr(self, k), device)
               for k in ("point_clouds",) + LABEL_FIELDS}
        if self.voxel_pyramid is not None:
            rows = check_pyramid_bounds(self.voxel_pyramid)[0]
            flat = _level_kind(self.voxel_pyramid.levels[0]) == "flat"
            nb = self.voxel_pyramid.num_batch
            pvi = np.asarray(self.point_voxel_idx)
            if self.voxel_feats.shape[0] != rows or pvi.shape[0] != nb:
                raise ValueError(
                    f"voxel_feats {self.voxel_feats.shape} / point_voxel_idx "
                    f"{pvi.shape} do not fit {nb} samples and {rows} rows")
            s0 = rows if flat else rows // nb
            for b in range(nb):
                lo, hi = int(pvi[b].min()), int(pvi[b].max())
                first = 0 if flat else b * s0
                if lo < first or hi >= first + s0:
                    raise ValueError(
                        f"point_voxel_idx: sample {b} rows [{lo}, {hi}] "
                        f"outside [{first}, {first + s0})")
            out.update(
                voxel_feats=torch.from_numpy(self.voxel_feats).to(device),
                voxel_pyramid=pyramid_to(self.voxel_pyramid, device),
                point_voxel_idx=torch.from_numpy(
                    np.ascontiguousarray(pvi, dtype=np.int32)).to(device),
            )
        return DetectionBatch(**out)


def _point_voxel_index(samples, voxel_size):
    """Per sample: unique voxel coords and each point's voxel slot."""
    coords_l, pvi_l = [], []
    for s in samples:
        pc = s["point_clouds"][:, :3]
        vox = np.floor(pc / voxel_size).astype(np.int32)
        sel = sparse_quantize(vox, return_index=True)
        uniq = vox[sel]
        coords_l.append(uniq)
        # hash join point -> voxel
        spec = HashSpec.from_coords(vox)
        keys = spec.encode(vox)
        ukeys = spec.encode(uniq)
        order = np.argsort(ukeys)
        pos = np.searchsorted(ukeys[order], keys)
        pvi_l.append(order[np.minimum(pos, len(order) - 1)])
    return coords_l, pvi_l


def collate_detection(
    samples: list[dict],
    voxel_size: float | None = None,
    scheme: PadScheme | None = None,
    layout: str = "chunked",
) -> DetectionBatch:
    """Stack samples; with ``voxel_size``, voxelize them for the sparse-conv
    backbone (features all ones, as the reference's voxelized dataset) into
    a per-sample chunked pyramid, each point remapped to its voxel's chunked
    row (points whose voxel was dropped or orphaned point at their own
    slice's zero pad row), or into one flat pyramid (``layout="voxel"``),
    each point at its voxel's global row (dropped ones at the pad row
    ``npad0 - 1``).  Any other layout raises ``ValueError``: the JAX
    package sends "brick" down the flat branch, with flat maps under a
    name that promises bricks."""
    if voxel_size is not None and layout not in ("chunked", "voxel"):
        raise ValueError(f"collate_detection layout={layout!r}: the detection "
                         "path runs the 'chunked' and 'voxel' layouts")
    out = {
        k: np.stack([s[k] for s in samples])
        for k in samples[0]
        if k != "scan_idx"
    }
    batch = {k: v for k, v in out.items() if k in DetectionBatch.__dataclass_fields__}
    if voxel_size is None:
        return DetectionBatch(**batch)
    assert scheme is not None
    coords_l, pvi_l = _point_voxel_index(samples, voxel_size)
    budget = scheme.npads[0] - 1
    total = sum(len(c) for c in coords_l)
    if total > budget:
        # Evenly subsample each sample's voxel set; points whose voxel is
        # dropped gather the zero pad row.
        rng = np.random.RandomState(0)
        ratio = budget / total * 0.999
        for b in range(len(samples)):
            n = len(coords_l[b])
            keep = max(1, int(n * ratio))
            keep_idx = np.sort(rng.choice(n, keep, replace=False))
            remap = np.full(n, -1, np.int64)
            remap[keep_idx] = np.arange(keep)
            coords_l[b] = coords_l[b][keep_idx]
            pvi_l[b] = remap[pvi_l[b]]
    lens = [len(c) for c in coords_l]
    offs = np.cumsum([0] + lens[:-1])
    coords = np.concatenate(
        [np.concatenate([np.full((len(c), 1), b, np.int32), c], 1)
         for b, c in enumerate(coords_l)]
    )
    nb = len(samples)
    if layout == "voxel":
        pyr, _meta = build_pyramid(coords, num_levels=scheme.num_levels,
                                   npads=scheme.npads, num_batch=nb)
        npad0 = scheme.npads[0]
        feats = np.zeros((npad0, 3), np.float32)
        feats[: len(coords)] = 1.0
        pvi = np.stack([np.where(pvi_l[b] >= 0, pvi_l[b] + offs[b], npad0 - 1)
                        for b in range(nb)]).astype(np.int32)
        batch.update(voxel_feats=feats, voxel_pyramid=pyr, point_voxel_idx=pvi)
        return DetectionBatch(**batch)
    pyr, _meta, rows, orphan = build_chunked_pyramid(
        coords, num_levels=scheme.num_levels, npads=scheme.npads, num_batch=nb,
    )
    nrows = pyr.levels[0].valid.shape[0]
    s0 = nrows // nb
    feats = np.zeros((nrows, 3), np.float32)
    feats[rows[~orphan]] = 1.0
    pvi = np.stack(
        [
            np.where(
                (pvi_l[b] >= 0) & ~orphan[np.maximum(pvi_l[b], 0) + offs[b]],
                rows[np.maximum(pvi_l[b], 0) + offs[b]],
                b * s0 + s0 - 1,  # slice pad row: zero features
            )
            for b in range(nb)
        ]
    ).astype(np.int32)
    batch.update(voxel_feats=feats, voxel_pyramid=pyr, point_voxel_idx=pvi)
    return DetectionBatch(**batch)
