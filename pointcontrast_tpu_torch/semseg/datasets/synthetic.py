"""Synthetic labeled scenes for tests and chip runs (a copy of
``pointcontrast_tpu/semseg/datasets/synthetic.py``, scene for scene the
same from the same seeds).  Scenes are random
room-like layouts where each structural element carries a stable label, so a
small net can actually fit them (loss decreases, mIoU > chance).
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.semseg.dataset import VoxelizationDataset


class SyntheticSemsegDataset(VoxelizationDataset):
    VOXEL_SIZE = 0.05
    CLIP_BOUND = None
    NUM_LABELS = 5
    IGNORE_LABELS = (4,)  # exercise the remap path
    ELASTIC_DISTORT_PARAMS = ((0.2, 0.4),)
    ROTATION_AUGMENTATION_BOUND = (
        (-np.pi / 64, np.pi / 64), (-np.pi / 64, np.pi / 64), (-np.pi, np.pi)
    )

    def __init__(self, path: str | None = None, phase: str = "train",
                 num_scenes: int = 8, points: int = 4000,
                 room: float = 3.0, scene_seed: int | None = None,
                 label_colors: bool = True, **kwargs):
        """(path, phase) mirror the registry datasets' signature so the
        semseg app can drive this one from config (path is ignored; phase
        selects a disjoint scene pool).

        label_colors=False gives every point a label-INDEPENDENT random
        texture, so the task is solvable only from geometry — the regime
        where geometric pretraining can show a transfer gap
        (experiments/transfer_proof.py)."""
        self.num_scenes = num_scenes
        self.points = points
        self.room = room
        self.label_colors = label_colors
        if scene_seed is None:
            scene_seed = {"train": 77, "val": 7700, "test": 770000}.get(phase, 77)
        self.scene_seed = scene_seed
        super().__init__(data_paths=[f"scene{i}" for i in range(num_scenes)], **kwargs)

    def load_sample(self, index: int):
        rng = np.random.RandomState(self.scene_seed + index)
        n = self.points
        r = self.room
        quarter = n // 4
        # label 0: floor, 1: walls, 2: boxes, 3: scatter, 4: ignored strip
        floor = rng.rand(quarter, 3) * [r, r, 0.02]
        walls = np.concatenate([
            rng.rand(quarter // 2, 3) * [r, 0.02, r / 2],
            rng.rand(quarter - quarter // 2, 3) * [0.02, r, r / 2],
        ])
        boxes = []
        for _ in range(4):
            c = rng.rand(3) * [r, r, r / 4]
            boxes.append((rng.rand(quarter // 4, 3) - 0.5) * 0.4 + c)
        boxes = np.concatenate(boxes)
        scatter = rng.rand(n - quarter - len(walls) - len(boxes), 3) * [r, r, r / 2]
        coords = np.concatenate([floor, walls, boxes, scatter]).astype(np.float32)
        labels = np.concatenate([
            np.zeros(len(floor)), np.ones(len(walls)),
            np.full(len(boxes), 2), np.full(len(scatter), 3),
        ]).astype(np.int32)
        # a small ignored region
        strip = coords[:, 0] > r * 0.95
        labels[strip] = 4
        if self.label_colors:
            colors = np.stack([
                50 + 40 * labels, 200 - 30 * labels, 100 + 20 * labels
            ], 1).astype(np.float32)
            colors += rng.randn(*colors.shape) * 5
        else:
            # near-constant bright color: carries no label signal (the task
            # becomes geometry-only) while keeping the normalized input a
            # NONZERO constant (~0.45) — a pure scale the first BatchNorm
            # absorbs, preserving a pretrained conv0's occupancy encoding
            # (constant-features pretraining encodes each voxel's neighbor
            # pattern as sums of per-offset kernel vectors; zero or noisy
            # inputs would erase it)
            colors = np.full((len(labels), 3), 242.0, np.float32)
            colors += rng.randn(len(labels), 3).astype(np.float32) * 5
        return coords, np.clip(colors, 0, 255), labels, None
