"""Frame-pair datasets for contrastive pretraining (host side, numpy only).

Jax-free port of ``pointcontrast_tpu/data/pair_dataset.py``: the shared
augment + voxelize + match logic, ``ScanNetMatchPairDataset`` and
``SyntheticPairDataset``, sample for sample identical to the JAX package's
from the same seeds.  Random scale (p=0.95), independent random rotations
about each frame's centroid, voxelization keeping the first point per
voxel, positive correspondences within ``1.5 x voxel_size``, all-ones 3-d
features, then the optional (coords, feats) ``transform`` of each frame.
"""
from __future__ import annotations

import os

import numpy as np

from pointcontrast_tpu_torch.data.matching import apply_transform, radius_matches
from pointcontrast_tpu_torch.sparse.quantize import sparse_quantize


def rotation_matrix(axis: np.ndarray, theta: float) -> np.ndarray:
    """Rotation about ``axis`` by ``theta`` (Rodrigues)."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    k = np.array(
        [
            [0, -axis[2], axis[1]],
            [axis[2], 0, -axis[0]],
            [-axis[1], axis[0], 0],
        ]
    )
    return np.eye(3) + np.sin(theta) * k + (1 - np.cos(theta)) * (k @ k)


def sample_random_trans(
    pcd: np.ndarray, rng: np.random.RandomState, rotation_range: float = 360.0
) -> np.ndarray:
    """Random rotation about the centroid."""
    t = np.eye(4)
    r = rotation_matrix(
        rng.rand(3) - 0.5, rotation_range * np.pi / 180.0 * (rng.rand(1)[0] - 0.5)
    )
    t[:3, :3] = r
    t[:3, 3] = r @ (-np.mean(pcd, axis=0))
    return t


class PairDatasetBase:
    """Shared augmentation + voxelize + match logic."""

    def __init__(
        self,
        voxel_size: float = 0.025,
        positive_search_multiplier: float = 1.5,
        random_rotation: bool = True,
        rotation_range: float = 360.0,
        random_scale: bool = False,
        min_scale: float = 0.8,
        max_scale: float = 1.2,
        transform=None,
        seed: int | None = None,
    ):
        self.voxel_size = voxel_size
        self.search_mult = positive_search_multiplier
        self.random_rotation = random_rotation
        self.rotation_range = rotation_range
        self.random_scale = random_scale
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.transform = transform
        self.rng = np.random.RandomState(seed)

    def _make_pair(self, xyz0: np.ndarray, xyz1: np.ndarray, rng=None):
        rng = rng if rng is not None else self.rng
        search_r = self.voxel_size * self.search_mult

        if self.random_scale and rng.rand() < 0.95:
            scale = self.min_scale + (self.max_scale - self.min_scale) * rng.rand()
            search_r *= scale
            xyz0 = scale * xyz0
            xyz1 = scale * xyz1

        if self.random_rotation:
            t0 = sample_random_trans(xyz0, rng, self.rotation_range)
            t1 = sample_random_trans(xyz1, rng, self.rotation_range)
            trans = t1 @ np.linalg.inv(t0)
            xyz0 = apply_transform(xyz0, t0)
            xyz1 = apply_transform(xyz1, t1)
        else:
            trans = np.eye(4)

        sel0 = sparse_quantize(xyz0 / self.voxel_size, return_index=True)
        sel1 = sparse_quantize(xyz1 / self.voxel_size, return_index=True)
        xyz0, xyz1 = xyz0[sel0], xyz1[sel1]

        matches = radius_matches(xyz0, xyz1, search_r, trans)

        feats0 = np.ones((len(xyz0), 3), dtype=np.float64)
        feats1 = np.ones((len(xyz1), 3), dtype=np.float64)
        coords0 = np.floor(xyz0 / self.voxel_size)
        coords1 = np.floor(xyz1 / self.voxel_size)

        if self.transform is not None:
            # the per-task rng: global np.random is neither reproducible nor
            # thread-safe under the loader's pool
            coords0, feats0 = self.transform(coords0, feats0, rng=rng)
            coords1, feats1 = self.transform(coords1, feats1, rng=rng)

        return (
            xyz0.astype(np.float32),
            xyz1.astype(np.float32),
            coords0.astype(np.int32),
            coords1.astype(np.int32),
            feats0.astype(np.float32),
            feats1.astype(np.float32),
            matches,
            trans.astype(np.float32),
        )


class ScanNetMatchPairDataset(PairDatasetBase):
    """Pairs listed in a ``path0 path1 [overlap]`` text file under ``root``,
    one per line, each path an ``.npz`` whose ``pcd`` array holds the
    frame's points (reference example_dataset/overlap-30-50p-subset.txt)."""

    def __init__(self, root: str, pair_list_file: str, **kwargs):
        super().__init__(**kwargs)
        self.root = root
        self.files: list[tuple[str, str]] = []
        with open(os.path.join(root, pair_list_file)) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) >= 2:
                    self.files.append((parts[0], parts[1]))

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx: int, rng=None):
        f0, f1 = self.files[idx]
        xyz0 = np.load(os.path.join(self.root, f0))["pcd"]
        xyz1 = np.load(os.path.join(self.root, f1))["pcd"]
        return self._make_pair(xyz0, xyz1, rng)


class SyntheticPairDataset(PairDatasetBase):
    """Random room-like scenes -> two overlapping noisy views (floor, two
    walls and eight oriented box faces)."""

    def __init__(
        self,
        num_pairs: int = 50,
        points_per_frame: int = 20000,
        room_size: float = 4.0,
        view_noise: float = 0.005,
        overlap: float = 0.6,
        scene_seed: int = 1234,
        **kwargs,
    ):
        super().__init__(**kwargs)
        self.num_pairs = num_pairs
        self.n_points = points_per_frame
        self.room = room_size
        self.noise = view_noise
        self.overlap = overlap
        self.scene_seed = scene_seed

    def __len__(self):
        return self.num_pairs

    def _scene_cloud(self, rng: np.random.RandomState) -> np.ndarray:
        n = self.n_points * 2
        r = self.room
        patches = []
        # floor + two walls
        counts = [n // 4, n // 8, n // 8]
        floor = rng.rand(counts[0], 3) * [r, r, 0.02]
        wall1 = rng.rand(counts[1], 3) * [r, 0.02, r / 2]
        wall2 = rng.rand(counts[2], 3) * [0.02, r, r / 2]
        patches += [floor, wall1, wall2]
        # clutter: random oriented boxes
        remaining = n - sum(counts)
        n_obj = 8
        for _ in range(n_obj):
            m = remaining // n_obj
            size = 0.2 + rng.rand(3) * 0.8
            center = rng.rand(3) * [r, r, r / 4]
            pts = (rng.rand(m, 3) - 0.5) * size
            # squash onto a random face to make it surface-like
            axis = rng.randint(3)
            pts[:, axis] = np.sign(pts[:, axis]) * size[axis] / 2
            rot = rotation_matrix(rng.rand(3) - 0.5, rng.rand() * np.pi)
            patches.append(pts @ rot.T + center)
        return np.concatenate(patches, axis=0)

    def __getitem__(self, idx: int, rng=None):
        scene_rng = np.random.RandomState(self.scene_seed + idx)
        cloud = self._scene_cloud(scene_rng)
        # Two views: overlapping halves along a random direction.
        d = scene_rng.randn(3)
        d /= np.linalg.norm(d)
        proj = cloud @ d
        lo, hi = np.quantile(proj, [0.0, 1.0])
        split = lo + (hi - lo) * 0.5
        width = (hi - lo) * self.overlap / 2
        m0 = proj <= split + width
        m1 = proj >= split - width
        xyz0 = cloud[m0][: self.n_points] + scene_rng.randn(min(m0.sum(), self.n_points), 3) * self.noise
        xyz1 = cloud[m1][: self.n_points] + scene_rng.randn(min(m1.sum(), self.n_points), 3) * self.noise
        return self._make_pair(xyz0, xyz1, rng)
