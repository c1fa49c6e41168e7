"""VOC-style detection AP.

A copy (numpy only) of ``pointcontrast_tpu/detect/eval_det.py``.

Behavioral mirror of
reference downstream/votenet_det_new/lib/utils/eval_det.py:24-234:
per-class greedy IoU matching against ground truth (each GT matched at most
once), 11-point or continuous VOC AP.  The reference parallelizes classes
with a multiprocessing pool; classes here evaluate sequentially — the whole
pass is milliseconds at VoteNet scales and stays fork-free.
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.detect.box_util import get_iou_obb


def voc_ap(rec: np.ndarray, prec: np.ndarray, use_07_metric: bool = False):
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.any(rec >= t) else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate([[0.0], rec, [1.0]])
    mpre = np.concatenate([[0.0], prec, [0.0]])
    for i in range(len(mpre) - 1, 0, -1):
        mpre[i - 1] = max(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def eval_det_cls(pred: dict, gt: dict, ovthresh: float = 0.25,
                 use_07_metric: bool = False, get_iou_func=get_iou_obb):
    """One class. pred: {img_id: [(bbox, score)]}, gt: {img_id: [bbox]}.
    Returns (rec, prec, ap)."""
    class_recs = {}
    npos = 0
    for img_id in gt:
        boxes = np.array(gt[img_id])
        det = [False] * len(boxes)
        npos += len(boxes)
        class_recs[img_id] = {"bbox": boxes, "det": det}
    for img_id in pred:
        if img_id not in class_recs:
            class_recs[img_id] = {"bbox": np.array([]), "det": []}

    image_ids, confidence, bbs = [], [], []
    for img_id in pred:
        for box, score in pred[img_id]:
            image_ids.append(img_id)
            confidence.append(score)
            bbs.append(box)
    confidence = np.array(confidence)
    order = np.argsort(-confidence)

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for rank, d in enumerate(order):
        rec_entry = class_recs[image_ids[d]]
        bb = bbs[d]
        ovmax = -np.inf
        jmax = -1
        for j, bbgt in enumerate(rec_entry["bbox"]):
            iou = get_iou_func(bb, bbgt)
            if iou > ovmax:
                ovmax, jmax = iou, j
        if ovmax > ovthresh and not rec_entry["det"][jmax]:
            tp[rank] = 1.0
            rec_entry["det"][jmax] = True
        else:
            fp[rank] = 1.0

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    rec = tp / float(max(npos, 1))
    prec = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    return rec, prec, voc_ap(rec, prec, use_07_metric)


def eval_det(pred_all: dict, gt_all: dict, ovthresh: float = 0.25,
             use_07_metric: bool = False, get_iou_func=get_iou_obb):
    """All classes. pred_all: {img_id: [(classname, bbox, score)]},
    gt_all: {img_id: [(classname, bbox)]} -> (rec, prec, ap) per-class dicts."""
    pred: dict = {}
    gt: dict = {}
    for img_id in pred_all:
        for classname, bbox, score in pred_all[img_id]:
            pred.setdefault(classname, {}).setdefault(img_id, []).append(
                (bbox, score)
            )
    for img_id in gt_all:
        for classname, bbox in gt_all[img_id]:
            gt.setdefault(classname, {}).setdefault(img_id, []).append(bbox)

    rec, prec, ap = {}, {}, {}
    for classname in gt:
        if classname in pred:
            rec[classname], prec[classname], ap[classname] = eval_det_cls(
                pred[classname], gt[classname], ovthresh, use_07_metric,
                get_iou_func,
            )
        else:
            rec[classname], prec[classname], ap[classname] = 0.0, 0.0, 0.0
    return rec, prec, ap
