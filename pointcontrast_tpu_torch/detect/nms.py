"""Greedy NMS over axis-aligned boxes.

A copy (numpy only) of ``pointcontrast_tpu/detect/nms.py``.

Behavioral mirror of
reference downstream/votenet_det_new/lib/utils/nms.py:13-178:
2D / 3D greedy suppression, old-type (asymmetric denominator) and standard
IoU variants, and a same-class-only 3D variant.
"""
from __future__ import annotations

import numpy as np


def _greedy(boxes: np.ndarray, lo, hi, scores, overlap_thresh, old_type,
            cls=None):
    dims = len(lo)
    order = np.argsort(scores)  # ascending; pop from the back
    areas = np.ones(len(boxes))
    for d in range(dims):
        areas = areas * np.maximum(hi[d] - lo[d], 0)
    pick = []
    order = list(order)
    while order:
        i = order.pop()  # highest remaining score
        pick.append(i)
        if not order:
            break
        rest = np.array(order)
        inter = np.ones(len(rest))
        for d in range(dims):
            l = np.maximum(lo[d][i], lo[d][rest])
            h = np.minimum(hi[d][i], hi[d][rest])
            inter = inter * np.maximum(h - l, 0)
        if old_type:
            o = inter / np.maximum(areas[rest], 1e-12)
        else:
            o = inter / np.maximum(areas[i] + areas[rest] - inter, 1e-12)
        if cls is not None:
            o = o * (cls[rest] == cls[i])
        order = [idx for idx, ov in zip(rest, o) if ov <= overlap_thresh]
    return pick


def nms_2d_faster(boxes: np.ndarray, overlap_threshold: float,
                  old_type: bool = False):
    """boxes [K, 5]: x1 y1 x2 y2 score."""
    lo = (boxes[:, 0], boxes[:, 1])
    hi = (boxes[:, 2], boxes[:, 3])
    return _greedy(boxes, lo, hi, boxes[:, 4], overlap_threshold, old_type)


def nms_3d_faster(boxes: np.ndarray, overlap_threshold: float,
                  old_type: bool = False):
    """boxes [K, 7]: x1 y1 z1 x2 y2 z2 score."""
    lo = (boxes[:, 0], boxes[:, 1], boxes[:, 2])
    hi = (boxes[:, 3], boxes[:, 4], boxes[:, 5])
    return _greedy(boxes, lo, hi, boxes[:, 6], overlap_threshold, old_type)


def nms_3d_faster_samecls(boxes: np.ndarray, overlap_threshold: float,
                          old_type: bool = False):
    """boxes [K, 8]: x1 y1 z1 x2 y2 z2 score cls — suppress only same-class
    overlaps (nms.py:133-178)."""
    lo = (boxes[:, 0], boxes[:, 1], boxes[:, 2])
    hi = (boxes[:, 3], boxes[:, 4], boxes[:, 5])
    return _greedy(
        boxes, lo, hi, boxes[:, 6], overlap_threshold, old_type, cls=boxes[:, 7]
    )
