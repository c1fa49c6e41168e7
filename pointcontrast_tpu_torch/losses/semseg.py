"""Semantic-segmentation loss and metrics (port of
``pointcontrast_tpu/losses/semseg.py``): cross-entropy over the rows whose
label is neither ``ignore_label`` nor outside [0, num_classes), and the
reference's numpy ``fast_hist`` / ``per_class_iu``."""
from __future__ import annotations

import numpy as np
import torch


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_label: int = 255,
                         weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean softmax cross-entropy over the non-ignored rows (weighted by
    ``weights[label]`` when given)."""
    num_classes = logits.shape[-1]
    valid = (labels != ignore_label) & (labels >= 0) & (labels < num_classes)
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    w = torch.ones_like(nll) if weights is None else weights[safe]
    w = w * valid.to(nll.dtype)
    return (nll * w).sum() / w.sum().clamp(min=1.0)


def precision_at_one(pred: torch.Tensor, target: torch.Tensor,
                     ignore_label: int = 255) -> torch.Tensor:
    valid = target != ignore_label
    correct = (pred == target) & valid
    return correct.sum() / valid.sum().clamp(min=1) * 100.0


def fast_hist(pred, label, n: int) -> np.ndarray:
    """[n, n] confusion counts (rows: label, columns: prediction) over the
    labels in [0, n)."""
    pred = np.asarray(pred).ravel()
    label = np.asarray(label).ravel()
    k = (label >= 0) & (label < n)
    return np.bincount(n * label[k].astype(int) + pred[k], minlength=n ** 2).reshape(n, n)


def per_class_iu(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))
