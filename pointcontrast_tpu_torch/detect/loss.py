"""VoteNet losses (port of ``pointcontrast_tpu/detect/loss.py``).

Total = (vote + 0.5 objectness + box + 0.1 sem_cls) x 10, box = center +
0.1 heading_cls + heading_reg + 0.1 size_cls + size_reg.  Plain torch: the
label gathers and the [B, num_proposal, MAX_NUM_OBJ] distances are
label-side work that the JAX package, too, computes outside its detect ops.
All masked sums, no boolean indexing, as in JAX.  BoxNet (no voting) trains
with ``get_loss_boxnet``: no vote loss, and the objectness label is the
proposal's seed's vote mask.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

FAR_THRESHOLD = 0.6
NEAR_THRESHOLD = 0.3
GT_VOTE_FACTOR = 3
OBJECTNESS_CLS_WEIGHTS = (0.2, 0.8)


def huber_loss(error, delta: float = 1.0):
    abs_error = error.abs()
    quadratic = torch.clamp_max(abs_error, delta)
    linear = abs_error - quadratic
    return 0.5 * quadratic ** 2 + delta * linear


def nn_distance(pc1, pc2, l1smooth: bool = False, delta: float = 1.0,
                l1: bool = False):
    """Batched bidirectional nearest neighbours, pc1 [B, N, C], pc2 [B, M, C]
    -> (dist1 [B, N], idx1, dist2 [B, M], idx2); ties go to the lowest
    index, as ``jnp.argmin``, and ``amin`` splits the gradient among tied
    minima, as ``jnp.min`` does."""
    diff = pc1[:, :, None, :] - pc2[:, None, :, :]
    if l1smooth:
        d = huber_loss(diff, delta).sum(dim=-1)
    elif l1:
        d = diff.abs().sum(dim=-1)
    else:
        d = (diff * diff).sum(dim=-1)
    return d.amin(dim=2), d.argmin(dim=2), d.amin(dim=1), d.argmin(dim=1)


def _masked_sum_mean(x, mask):
    return (x * mask).sum() / (mask.sum() + 1e-6)


def _ce(logits, labels):
    """Per-element softmax CE, logits [..., C], labels [...] int."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0]


def _take(a, idx):
    """take_along_axis over axis 1 for idx [B, K]: a [B, N] or [B, N, C]."""
    idx = idx.long()
    if a.dim() == 3:
        idx = idx[:, :, None].expand(-1, -1, a.shape[-1])
    return torch.gather(a, 1, idx)


def compute_vote_loss(end_points):
    """Min-of-min L1 distance from each seed's predicted votes to its (up
    to 3) ground-truth votes, over seeds on objects."""
    b, num_seed, _ = end_points["seed_xyz"].shape
    vote_xyz = end_points["vote_xyz"]  # [B, num_seed * vf, 3]
    seed_inds = end_points["seed_inds"]
    seed_gt_votes_mask = _take(end_points["vote_label_mask"], seed_inds)
    seed_gt_votes = _take(end_points["vote_label"], seed_inds)  # [B, S, 9]
    seed_gt_votes = seed_gt_votes + end_points["seed_xyz"].repeat(1, 1, 3)
    vf = vote_xyz.shape[1] // num_seed
    vote_r = vote_xyz.reshape(b * num_seed, vf, 3)
    gt_r = seed_gt_votes.reshape(b * num_seed, GT_VOTE_FACTOR, 3)
    _d1, _i1, dist2, _i2 = nn_distance(vote_r, gt_r, l1=True)
    votes_dist = dist2.amin(dim=1).reshape(b, num_seed)
    return _masked_sum_mean(votes_dist, seed_gt_votes_mask.float())


def compute_objectness_loss(end_points):
    aggregated_vote_xyz = end_points["aggregated_vote_xyz"]
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, ind1, _d2, _i2 = nn_distance(aggregated_vote_xyz, gt_center)
    euclid = torch.sqrt(dist1 + 1e-6)
    objectness_label = (euclid < NEAR_THRESHOLD).long()
    objectness_mask = ((euclid < NEAR_THRESHOLD)
                       | (euclid > FAR_THRESHOLD)).float()
    scores = end_points["objectness_scores"]  # [B, K, 2]
    w = torch.tensor(OBJECTNESS_CLS_WEIGHTS, device=scores.device)
    ce = _ce(scores, objectness_label) * w[objectness_label]
    objectness_loss = _masked_sum_mean(ce, objectness_mask)
    return objectness_loss, objectness_label, objectness_mask, ind1


def compute_box_and_sem_cls_loss(end_points, config):
    nh = config.num_heading_bin
    ns = config.num_size_cluster
    assignment = end_points["object_assignment"]  # [B, K]
    objectness_label = end_points["objectness_label"].float()
    box_label_mask = end_points["box_label_mask"]
    dev = objectness_label.device

    # center: bidirectional Chamfer
    pred_center = end_points["center"]
    gt_center = end_points["center_label"][:, :, 0:3]
    dist1, _i1, dist2, _i2 = nn_distance(pred_center, gt_center)
    center_loss = (_masked_sum_mean(dist1, objectness_label)
                   + _masked_sum_mean(dist2, box_label_mask))

    # heading
    heading_class_label = _take(end_points["heading_class_label"], assignment)
    heading_class_loss = _masked_sum_mean(
        _ce(end_points["heading_scores"], heading_class_label), objectness_label)
    heading_residual_label = _take(end_points["heading_residual_label"], assignment)
    hr_norm_label = heading_residual_label / (np.pi / max(nh, 1))
    hl_one_hot = F.one_hot(heading_class_label.long(), nh).float()
    hr_pred = (end_points["heading_residuals_normalized"] * hl_one_hot).sum(dim=-1)
    heading_reg_loss = _masked_sum_mean(
        huber_loss(hr_pred - hr_norm_label, 1.0), objectness_label)

    # size
    size_class_label = _take(end_points["size_class_label"], assignment)
    size_class_loss = _masked_sum_mean(
        _ce(end_points["size_scores"], size_class_label), objectness_label)
    size_residual_label = _take(end_points["size_residual_label"], assignment)
    sl_one_hot = F.one_hot(size_class_label.long(), ns).float()  # [B, K, ns]
    sr_pred = (end_points["size_residuals_normalized"]
               * sl_one_hot[:, :, :, None]).sum(dim=2)  # [B, K, 3]
    mean_size_arr = torch.from_numpy(
        np.asarray(config.mean_size_arr, dtype=np.float32)).to(dev)
    mean_size_label = (sl_one_hot[:, :, :, None]
                       * mean_size_arr[None, None]).sum(dim=2)
    sr_label_norm = size_residual_label / torch.clamp_min(mean_size_label, 1e-6)
    size_reg_loss = _masked_sum_mean(
        huber_loss(sr_pred - sr_label_norm, 1.0).mean(dim=-1), objectness_label)

    # semantic class
    sem_cls_label = _take(end_points["sem_cls_label"], assignment)
    sem_cls_loss = _masked_sum_mean(
        _ce(end_points["sem_cls_scores"], sem_cls_label), objectness_label)
    return (center_loss, heading_class_loss, heading_reg_loss,
            size_class_loss, size_reg_loss, sem_cls_loss)


def compute_objectness_loss_boxnet(end_points):
    """BoxNet: the objectness label is the proposal's seed point's vote mask
    (no near/far grey zone, so the mask is all ones); the assignment is still
    the nearest ground-truth centre."""
    _d1, ind1, _d2, _i2 = nn_distance(end_points["aggregated_vote_xyz"],
                                      end_points["center_label"][:, :, 0:3])
    seed_labels = _take(end_points["vote_label_mask"], end_points["seed_inds"])
    end_points["seed_labels"] = seed_labels
    objectness_label = _take(seed_labels,
                             end_points["aggregated_vote_inds"]).long()
    objectness_mask = torch.ones(objectness_label.shape,
                                 device=objectness_label.device)
    scores = end_points["objectness_scores"]
    w = torch.tensor(OBJECTNESS_CLS_WEIGHTS, device=scores.device)
    ce = _ce(scores, objectness_label) * w[objectness_label]
    objectness_loss = _masked_sum_mean(ce, objectness_mask)
    return objectness_loss, objectness_label, objectness_mask, ind1


def get_loss(end_points, config):
    """-> (loss, end_points with every term and metric added)."""
    end_points["vote_loss"] = compute_vote_loss(end_points)
    return _finish_loss(end_points, config, compute_objectness_loss)


def get_loss_boxnet(end_points, config):
    """BoxNet's total, (0.5 objectness + box + 0.1 sem_cls) x 10, with
    ``vote_loss`` reported as 0."""
    end_points["vote_loss"] = torch.zeros((), device=end_points["center"].device)
    return _finish_loss(end_points, config, compute_objectness_loss_boxnet)


def _finish_loss(end_points, config, objectness_loss_of):
    vote_loss = end_points["vote_loss"]
    objectness_loss, objectness_label, objectness_mask, assignment = (
        objectness_loss_of(end_points))
    end_points["objectness_loss"] = objectness_loss
    end_points["objectness_label"] = objectness_label
    end_points["objectness_mask"] = objectness_mask
    end_points["object_assignment"] = assignment
    total = objectness_label.shape[0] * objectness_label.shape[1]
    end_points["pos_ratio"] = objectness_label.float().sum() / total
    end_points["neg_ratio"] = objectness_mask.sum() / total - end_points["pos_ratio"]

    (center_loss, heading_cls_loss, heading_reg_loss, size_cls_loss,
     size_reg_loss, sem_cls_loss) = compute_box_and_sem_cls_loss(end_points, config)
    end_points["center_loss"] = center_loss
    end_points["heading_cls_loss"] = heading_cls_loss
    end_points["heading_reg_loss"] = heading_reg_loss
    end_points["size_cls_loss"] = size_cls_loss
    end_points["size_reg_loss"] = size_reg_loss
    end_points["sem_cls_loss"] = sem_cls_loss
    box_loss = (center_loss + 0.1 * heading_cls_loss + heading_reg_loss
                + 0.1 * size_cls_loss + size_reg_loss)
    end_points["box_loss"] = box_loss

    loss = (vote_loss + 0.5 * objectness_loss + box_loss + 0.1 * sem_cls_loss) * 10.0
    end_points["loss"] = loss
    obj_pred = end_points["objectness_scores"].argmax(dim=2)
    end_points["obj_acc"] = _masked_sum_mean(
        (obj_pred == objectness_label).float(), objectness_mask)
    return loss, end_points
