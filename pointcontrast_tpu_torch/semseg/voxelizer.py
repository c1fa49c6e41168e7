"""Voxelizer: clip-bound cropping + rotation/scale augmentation + label-aware
quantization (host numpy; a copy of ``pointcontrast_tpu/semseg/voxelizer.py``).

Behavioral mirror of the reference's downstream/semseg/lib/voxelizer.py:
  - optional clip box (scalar half-extent or per-axis bounds) around the
    cloud center, shifted by a translation-augmentation ratio;
  - per-axis bounded random rotations composed in random order;
  - scale 1/voxel_size times U[scale_bound] as a 4x4 voxelization matrix;
  - floor to ints, shift to the min corner, label-aware sparse_quantize
    (conflicting voxel labels -> ignore_label);
  - returns the flattened 4x4 transform for test-time inverse mapping.
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.data.pair_dataset import rotation_matrix
from pointcontrast_tpu_torch.sparse.quantize import sparse_quantize


class Voxelizer:
    def __init__(
        self,
        voxel_size: float = 1.0,
        clip_bound=None,
        use_augmentation: bool = False,
        scale_augmentation_bound=None,
        rotation_augmentation_bound=None,
        translation_augmentation_ratio_bound=None,
        ignore_label: int = 255,
    ):
        self.voxel_size = voxel_size
        self.clip_bound = clip_bound
        self.ignore_label = ignore_label
        self.use_augmentation = use_augmentation
        self.scale_augmentation_bound = scale_augmentation_bound
        self.rotation_augmentation_bound = rotation_augmentation_bound
        self.translation_augmentation_ratio_bound = translation_augmentation_ratio_bound

    def get_transformation_matrix(self, rng: np.random.RandomState):
        voxelization_matrix, rotation = np.eye(4), np.eye(4)
        rot_mat = np.eye(3)
        if self.use_augmentation and self.rotation_augmentation_bound is not None:
            rot_mats = []
            for axis_ind, rot_bound in enumerate(self.rotation_augmentation_bound):
                theta = 0.0
                axis = np.zeros(3)
                axis[axis_ind] = 1
                if rot_bound is not None:
                    theta = rng.uniform(*rot_bound)
                rot_mats.append(rotation_matrix(axis, theta))
            rng.shuffle(rot_mats)
            rot_mat = rot_mats[0] @ rot_mats[1] @ rot_mats[2]
        rotation[:3, :3] = rot_mat
        scale = 1.0 / self.voxel_size
        if self.use_augmentation and self.scale_augmentation_bound is not None:
            scale *= rng.uniform(*self.scale_augmentation_bound)
        np.fill_diagonal(voxelization_matrix[:3, :3], scale)
        return voxelization_matrix, rotation

    def clip(self, coords, center=None, trans_aug_ratio=None):
        bound_min = coords.min(0).astype(float)
        bound_max = coords.max(0).astype(float)
        bound_size = bound_max - bound_min
        if center is None:
            center = bound_min + bound_size * 0.5
        if trans_aug_ratio is not None:
            center = center + trans_aug_ratio * bound_size
        lim = self.clip_bound
        if isinstance(lim, (int, float)):
            # scalar: half-extent box; skip clipping for small scenes
            if bound_size.max() < lim:
                return None
            return (
                (coords[:, 0] >= -lim + center[0]) & (coords[:, 0] < lim + center[0])
                & (coords[:, 1] >= -lim + center[1]) & (coords[:, 1] < lim + center[1])
                & (coords[:, 2] >= -lim + center[2]) & (coords[:, 2] < lim + center[2])
            )
        return (
            (coords[:, 0] >= lim[0][0] + center[0]) & (coords[:, 0] < lim[0][1] + center[0])
            & (coords[:, 1] >= lim[1][0] + center[1]) & (coords[:, 1] < lim[1][1] + center[1])
            & (coords[:, 2] >= lim[2][0] + center[2]) & (coords[:, 2] < lim[2][1] + center[2])
        )

    def voxelize(self, coords, feats, labels, center=None, rng=None):
        rng = rng or np.random.RandomState()
        assert coords.shape[1] == 3 and coords.shape[0] == feats.shape[0]
        if self.clip_bound is not None:
            trans_aug_ratio = np.zeros(3)
            if self.use_augmentation and self.translation_augmentation_ratio_bound is not None:
                for axis_ind, bound in enumerate(
                    self.translation_augmentation_ratio_bound
                ):
                    trans_aug_ratio[axis_ind] = rng.uniform(*bound)
            clip_inds = self.clip(coords, center, trans_aug_ratio)
            if clip_inds is not None and clip_inds.sum():
                coords, feats = coords[clip_inds], feats[clip_inds]
                if labels is not None:
                    labels = labels[clip_inds]

        m_v, m_r = self.get_transformation_matrix(rng)
        rigid = m_r @ m_v if self.use_augmentation else m_v

        homo = np.hstack([coords, np.ones((len(coords), 1), coords.dtype)])
        coords_aug = np.floor(homo @ rigid.T[:, :3])
        min_coords = coords_aug.min(0)
        m_t = np.eye(4)
        m_t[:3, -1] = -min_coords
        rigid = m_t @ rigid
        coords_aug = np.floor(coords_aug - min_coords)

        if labels is not None:
            coords_aug, feats, labels = sparse_quantize(
                coords_aug, feats, labels, ignore_label=self.ignore_label
            )
        else:
            coords_aug, feats = sparse_quantize(coords_aug, feats)
        return coords_aug, feats, labels, rigid.flatten()
