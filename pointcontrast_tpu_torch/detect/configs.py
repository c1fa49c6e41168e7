"""Detection dataset configurations.

A copy (numpy only) of ``pointcontrast_tpu/detect/configs.py``.

Mirrors reference downstream/votenet_det_new/lib/datasets/
{scannet/model_util_scannet.py:15-91, sunrgbd/model_util_sunrgbd.py:14-86},
plus vectorized ``class2angle_batch`` / ``class2size_batch`` used by the
AP parser (the reference loops per box).

ScanNet mean sizes ship with the reference as a binary npz
(scannet/meta_data/scannet_means.npz); the values are inlined here so no
binary asset is needed.
"""
from __future__ import annotations

import numpy as np

# scannet_means.npz['arr_0'] values (18 x 3, meters), reference meta_data.
SCANNET_MEAN_SIZES = np.array([
    [0.76966726, 0.81160211, 0.92573741],
    [1.876858, 1.84255952, 1.19315654],
    [0.61327999, 0.61486087, 0.71827014],
    [1.39550063, 1.51215451, 0.83443565],
    [0.97949596, 1.06751485, 0.63296875],
    [0.53166301, 0.59555772, 1.75001483],
    [0.96247056, 0.72462326, 1.14818682],
    [0.83221924, 1.04909355, 1.68756634],
    [0.21132214, 0.4206159, 0.53728459],
    [1.44400728, 1.89708334, 0.26985747],
    [1.02942616, 1.40407966, 0.87554322],
    [1.37664116, 0.65521793, 1.68131292],
    [0.66508189, 0.71111926, 1.29885307],
    [0.41999174, 0.37906947, 1.75139715],
    [0.59359559, 0.59124924, 0.73919014],
    [0.50867595, 0.50656087, 0.30136236],
    [1.15115265, 1.0546296, 0.49706794],
    [0.47535286, 0.49249493, 0.58021168],
], dtype=np.float64)


class DatasetConfigBase:
    num_class: int
    num_heading_bin: int
    num_size_cluster: int
    mean_size_arr: np.ndarray

    def class2size(self, pred_cls, residual):
        return self.mean_size_arr[pred_cls] + residual

    def class2size_batch(self, pred_cls, residual):
        """[...] int, [..., 3] -> [..., 3]."""
        return self.mean_size_arr[np.asarray(pred_cls)] + np.asarray(residual)

    def param2obb(self, center, heading_class, heading_residual, size_class,
                  size_residual):
        heading_angle = self.class2angle(heading_class, heading_residual)
        box_size = self.class2size(int(size_class), size_residual)
        obb = np.zeros(7)
        obb[0:3] = center
        obb[3:6] = box_size
        obb[6] = heading_angle * -1
        return obb


class ScannetDatasetConfig(DatasetConfigBase):
    """18-class, axis-aligned (1 heading bin)."""

    def __init__(self):
        self.num_class = 18
        self.num_heading_bin = 1
        self.num_size_cluster = 18
        self.type2class = {
            "cabinet": 0, "bed": 1, "chair": 2, "sofa": 3, "table": 4,
            "door": 5, "window": 6, "bookshelf": 7, "picture": 8,
            "counter": 9, "desk": 10, "curtain": 11, "refrigerator": 12,
            "showercurtrain": 13, "toilet": 14, "sink": 15, "bathtub": 16,
            "garbagebin": 17,
        }
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.nyu40ids = np.array(
            [3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 14, 16, 24, 28, 33, 34, 36, 39]
        )
        self.nyu40id2class = {int(n): i for i, n in enumerate(self.nyu40ids)}
        self.mean_size_arr = SCANNET_MEAN_SIZES.copy()
        self.type_mean_size = {
            self.class2type[i]: self.mean_size_arr[i]
            for i in range(self.num_size_cluster)
        }

    def class2angle(self, pred_cls, residual, to_label_format=True):
        return 0  # axis-aligned

    def class2angle_batch(self, pred_cls, residual, to_label_format=True):
        return np.zeros(np.asarray(pred_cls).shape)

    def size2class(self, size, type_name):
        cls = self.type2class[type_name]
        return cls, size - self.type_mean_size[type_name]


class SunrgbdDatasetConfig(DatasetConfigBase):
    """10-class, 12 heading bins."""

    def __init__(self):
        self.num_class = 10
        self.num_heading_bin = 12
        self.num_size_cluster = 10
        self.type2class = {
            "bed": 0, "table": 1, "sofa": 2, "chair": 3, "toilet": 4,
            "desk": 5, "dresser": 6, "night_stand": 7, "bookshelf": 8,
            "bathtub": 9,
        }
        self.class2type = {v: k for k, v in self.type2class.items()}
        self.type2onehotclass = dict(self.type2class)
        self.type_mean_size = {
            "bathtub": np.array([0.765840, 1.398258, 0.472728]),
            "bed": np.array([2.114256, 1.620300, 0.927272]),
            "bookshelf": np.array([0.404671, 1.071108, 1.688889]),
            "chair": np.array([0.591958, 0.552978, 0.827272]),
            "desk": np.array([0.695190, 1.346299, 0.736364]),
            "dresser": np.array([0.528526, 1.002642, 1.172878]),
            "night_stand": np.array([0.500618, 0.632163, 0.683424]),
            "sofa": np.array([0.923508, 1.867419, 0.845495]),
            "table": np.array([0.791118, 1.279516, 0.718182]),
            "toilet": np.array([0.699104, 0.454178, 0.756250]),
        }
        self.mean_size_arr = np.stack(
            [self.type_mean_size[self.class2type[i]] for i in range(10)]
        )

    def angle2class(self, angle):
        num_class = self.num_heading_bin
        angle = angle % (2 * np.pi)
        angle_per_class = 2 * np.pi / num_class
        shifted = (angle + angle_per_class / 2) % (2 * np.pi)
        class_id = int(shifted / angle_per_class)
        residual = shifted - (class_id * angle_per_class + angle_per_class / 2)
        return class_id, residual

    def class2angle(self, pred_cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / self.num_heading_bin
        angle = pred_cls * angle_per_class + residual
        if to_label_format and angle > np.pi:
            angle -= 2 * np.pi
        return angle

    def class2angle_batch(self, pred_cls, residual, to_label_format=True):
        angle_per_class = 2 * np.pi / self.num_heading_bin
        angle = np.asarray(pred_cls) * angle_per_class + np.asarray(residual)
        if to_label_format:
            angle = np.where(angle > np.pi, angle - 2 * np.pi, angle)
        return angle

    def size2class(self, size, type_name):
        cls = self.type2class[type_name]
        return cls, size - self.type_mean_size[type_name]
