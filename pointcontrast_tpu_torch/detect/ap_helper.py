"""Prediction/GT parsing + AP accumulation.

A copy (numpy only) of ``pointcontrast_tpu/detect/ap_helper.py``.

Behavioral mirror of
reference downstream/votenet_det_new/models/ap_helper.py:40-276,
vectorized: box corners for all proposals are built in one
``get_3d_box_batch`` call instead of a B x K python loop.
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.detect.box_util import (
    extract_pc_in_box3d,
    flip_axis_to_camera,
    flip_axis_to_depth,
    get_3d_box_batch,
    get_iou_obb,
)
from pointcontrast_tpu_torch.detect.eval_det import eval_det
from pointcontrast_tpu_torch.detect.nms import (
    nms_2d_faster,
    nms_3d_faster,
    nms_3d_faster_samecls,
)


def softmax(x: np.ndarray) -> np.ndarray:
    probs = np.exp(x - np.max(x, axis=-1, keepdims=True))
    return probs / np.sum(probs, axis=-1, keepdims=True)


def _decode_pred_boxes(end_points, dataset_config):
    """-> (corners [B, K, 8, 3] upright-camera, sem_cls_probs, obj_prob,
    pred_sem_cls)."""
    center = np.asarray(end_points["center"])
    heading_scores = np.asarray(end_points["heading_scores"])
    heading_residuals = np.asarray(end_points["heading_residuals"])
    size_scores = np.asarray(end_points["size_scores"])
    size_residuals = np.asarray(end_points["size_residuals"])

    pred_heading_class = np.argmax(heading_scores, -1)
    pred_heading_residual = np.take_along_axis(
        heading_residuals, pred_heading_class[..., None], axis=2
    )[..., 0]
    pred_size_class = np.argmax(size_scores, -1)
    pred_size_residual = np.take_along_axis(
        size_residuals, pred_size_class[..., None, None], axis=2
    )[:, :, 0, :]

    heading_angle = dataset_config.class2angle_batch(
        pred_heading_class, pred_heading_residual
    )
    box_size = dataset_config.class2size_batch(pred_size_class, pred_size_residual)
    center_cam = flip_axis_to_camera(center)
    corners = get_3d_box_batch(box_size, heading_angle, center_cam)

    sem_cls_probs = softmax(np.asarray(end_points["sem_cls_scores"]))
    obj_prob = softmax(np.asarray(end_points["objectness_scores"]))[:, :, 1]
    pred_sem_cls = np.argmax(sem_cls_probs, -1)
    return corners, sem_cls_probs, obj_prob, pred_sem_cls


def parse_predictions(end_points, config_dict):
    """ap_helper.py:40-177 -> batch_pred_map_cls."""
    dataset_config = config_dict["dataset_config"]
    corners, sem_cls_probs, obj_prob, pred_sem_cls = _decode_pred_boxes(
        end_points, dataset_config
    )
    bsize, k = corners.shape[:2]

    nonempty_box_mask = np.ones((bsize, k))
    if config_dict.get("remove_empty_box"):
        batch_pc = np.asarray(end_points["point_clouds"])[:, :, 0:3]
        for i in range(bsize):
            for j in range(k):
                box3d = flip_axis_to_depth(corners[i, j])
                pc_in, _ = extract_pc_in_box3d(batch_pc[i], box3d)
                if len(pc_in) < 5:
                    nonempty_box_mask[i, j] = 0

    pred_mask = np.zeros((bsize, k))
    use_3d = config_dict.get("use_3d_nms", False)
    cls_nms = config_dict.get("cls_nms", False)
    old_type = config_dict.get("use_old_type_nms", False)
    nms_iou = config_dict.get("nms_iou", 0.25)
    for i in range(bsize):
        keep = np.where(nonempty_box_mask[i] == 1)[0]
        mins = corners[i, keep].min(axis=1)  # [k', 3]
        maxs = corners[i, keep].max(axis=1)
        if not use_3d:
            boxes = np.stack(
                [mins[:, 0], mins[:, 2], maxs[:, 0], maxs[:, 2],
                 obj_prob[i, keep]], 1
            )
            pick = nms_2d_faster(boxes, nms_iou, old_type)
        elif not cls_nms:
            boxes = np.concatenate(
                [mins, maxs, obj_prob[i, keep, None]], 1
            )
            pick = nms_3d_faster(boxes, nms_iou, old_type)
        else:
            boxes = np.concatenate(
                [mins, maxs, obj_prob[i, keep, None],
                 pred_sem_cls[i, keep, None]], 1
            )
            pick = nms_3d_faster_samecls(boxes, nms_iou, old_type)
        assert len(pick) > 0
        pred_mask[i, keep[pick]] = 1
    end_points["pred_mask"] = pred_mask

    conf_thresh = config_dict.get("conf_thresh", 0.05)
    batch_pred_map_cls = []
    for i in range(bsize):
        if config_dict.get("per_class_proposal"):
            cur = []
            for c in range(dataset_config.num_class):
                cur += [
                    (c, corners[i, j], sem_cls_probs[i, j, c] * obj_prob[i, j])
                    for j in range(k)
                    if pred_mask[i, j] == 1 and obj_prob[i, j] > conf_thresh
                ]
            batch_pred_map_cls.append(cur)
        else:
            batch_pred_map_cls.append(
                [
                    (int(pred_sem_cls[i, j]), corners[i, j], obj_prob[i, j])
                    for j in range(k)
                    if pred_mask[i, j] == 1 and obj_prob[i, j] > conf_thresh
                ]
            )
    end_points["batch_pred_map_cls"] = batch_pred_map_cls
    return batch_pred_map_cls


def parse_groundtruths(end_points, config_dict):
    """ap_helper.py:179-221 -> batch_gt_map_cls."""
    dataset_config = config_dict["dataset_config"]
    center_label = np.asarray(end_points["center_label"])
    heading_class = np.asarray(end_points["heading_class_label"])
    heading_residual = np.asarray(end_points["heading_residual_label"])
    size_class = np.asarray(end_points["size_class_label"])
    size_residual = np.asarray(end_points["size_residual_label"])
    box_mask = np.asarray(end_points["box_label_mask"])
    sem_cls = np.asarray(end_points["sem_cls_label"])

    heading_angle = dataset_config.class2angle_batch(heading_class, heading_residual)
    box_size = dataset_config.class2size_batch(size_class, size_residual)
    center_cam = flip_axis_to_camera(center_label[:, :, 0:3])
    corners = get_3d_box_batch(box_size, heading_angle, center_cam)

    batch_gt_map_cls = []
    for i in range(corners.shape[0]):
        batch_gt_map_cls.append(
            [
                (int(sem_cls[i, j]), corners[i, j])
                for j in range(corners.shape[1])
                if box_mask[i, j] == 1
            ]
        )
    end_points["batch_gt_map_cls"] = batch_gt_map_cls
    return batch_gt_map_cls


class APCalculator:
    """ap_helper.py:223-276."""

    def __init__(self, ap_iou_thresh: float = 0.25, class2type_map=None):
        self.ap_iou_thresh = ap_iou_thresh
        self.class2type_map = class2type_map
        self.reset()

    def step(self, batch_pred_map_cls, batch_gt_map_cls):
        assert len(batch_pred_map_cls) == len(batch_gt_map_cls)
        for pred, gt in zip(batch_pred_map_cls, batch_gt_map_cls):
            self.gt_map_cls[self.scan_cnt] = gt
            self.pred_map_cls[self.scan_cnt] = pred
            self.scan_cnt += 1

    def compute_metrics(self):
        rec, prec, ap = eval_det(
            self.pred_map_cls, self.gt_map_cls, ovthresh=self.ap_iou_thresh,
            get_iou_func=get_iou_obb,
        )
        ret = {}
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            ret[f"{name} Average Precision"] = ap[key]
        ret["mAP"] = np.mean(list(ap.values())) if ap else 0.0
        rec_list = []
        for key in sorted(ap.keys()):
            name = self.class2type_map[key] if self.class2type_map else str(key)
            try:
                ret[f"{name} Recall"] = rec[key][-1]
                rec_list.append(rec[key][-1])
            except (TypeError, IndexError):
                ret[f"{name} Recall"] = 0
                rec_list.append(0)
        ret["AR"] = np.mean(rec_list) if rec_list else 0.0
        return ret

    def reset(self):
        self.gt_map_cls = {}
        self.pred_map_cls = {}
        self.scan_cnt = 0
