"""Contrastive pretraining losses (port of
``pointcontrast_tpu/losses/contrastive.py``): PointInfoNCE and the
hardest-contrastive loss.

The sampled index arrays are fixed-size with a validity mask (the collator
pre-samples them on the host, with the hardest mode's collision bitmaps)."""
from __future__ import annotations

import torch


def _masked_mean(x, mask):
    m = mask.to(x.dtype)
    return (x * m).sum() / m.sum().clamp(min=1.0)


def point_info_nce_loss(
    f0: torch.Tensor,  # [N0, C] features of frame 0 (L2-normalized by model)
    f1: torch.Tensor,  # [N1, C]
    q_idx: torch.Tensor,  # [P] anchor rows into f0
    k_idx: torch.Tensor,  # [P] positive rows into f1
    pair_valid: torch.Tensor,  # [P] 1/0
    temperature: float = 0.4,
) -> torch.Tensor:
    """In-batch softmax cross-entropy where pair i's positive is the diagonal
    and every other valid sampled key is a negative."""
    q = f0[q_idx]
    k = f1[k_idx]
    # f32 logits from bf16 features (JAX: preferred_element_type=f32): the
    # products of the widened rows are exact, the sums f32
    logits = (q.float() @ k.float().T) / temperature
    # Invalid columns must not act as negatives; invalid rows drop out of the
    # mean. (A padded row's diagonal is also masked, but its row is unused.)
    col_mask = pair_valid[None, :] > 0
    diag = torch.eye(logits.shape[0], dtype=torch.bool, device=logits.device)
    logits = torch.where(col_mask | diag, logits, logits.new_tensor(-1e9))
    per_pair = -torch.log_softmax(logits, dim=1).diagonal()
    return _masked_mean(per_pair, pair_valid)


def _packed_bit(packed: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Row-wise bit test of a little-endian bit-packed [P, ceil(H/8)] uint8
    map (``np.packbits(..., bitorder="little")``): bit ``col[i] % 8`` of
    byte ``packed[i, col[i] // 8]``, as bool [P]."""
    byte = packed.gather(1, (col >> 3)[:, None].long())[:, 0]
    return ((byte >> (col & 7).to(byte.dtype)) & 1).bool()


def _sum_squares(x: torch.Tensor) -> torch.Tensor:
    """Row sums of squares in ``x``'s dtype, rounded once: the products are
    exact in f32 and added in f32 (what the jitted ``jnp.sum(x * x, 1)``
    computes for bf16 ``x`` on XLA's CPU backend; f32 ``x``: the plain sum)."""
    return x.float().square().sum(1).to(x.dtype)


def _pdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Euclidean distance matrix spelt as the JAX package's:
    ``|a|^2 - 2 a.b^T + |b|^2``, clamped at 0, ``+ 1e-7``, square root.
    The squared norms keep the features' dtype (``_sum_squares``); the
    product is f32 (JAX: ``preferred_element_type``), so the distances are
    f32."""
    ab = a.float() @ b.float().T
    d2 = _sum_squares(a).float()[:, None] - 2.0 * ab + _sum_squares(b).float()[None, :]
    return torch.sqrt(d2.clamp(min=0.0) + 1e-7)


def hardest_contrastive_loss(
    f0: torch.Tensor,  # [N0, C]
    f1: torch.Tensor,  # [N1, C]
    pos0_idx: torch.Tensor,  # [P] sampled positive-pair anchors into f0
    pos1_idx: torch.Tensor,  # [P] ... into f1
    pos_valid: torch.Tensor,  # [P]
    cand0_idx: torch.Tensor,  # [H] negative candidate rows into f0
    cand0_valid: torch.Tensor,  # [H]
    cand1_idx: torch.Tensor,  # [H] candidate rows into f1
    cand1_valid: torch.Tensor,  # [H]
    collide0: torch.Tensor,  # [P, ceil(H/8)] uint8: bit j of byte b set iff
    #                          (pos0_idx[i], cand1_idx[8 b + j]) is a true pair
    collide1: torch.Tensor,  # [P, ceil(H/8)] uint8 likewise for (cand0, pos1)
    pos_thresh: float = 0.1,
    neg_thresh: float = 1.4,
    hardest: tuple[torch.Tensor, torch.Tensor] | None = None,
    return_hardest: bool = False,
):
    """Hardest-negative contrastive loss: each positive pair's hardest
    negative is the first minimum of the *unmasked* distances to the valid
    candidates (invalid ones sit at 1e9); anchors whose hardest negative is
    a true positive pair (the collision bitmaps) drop out of the negative
    loss, and are not re-mined.  Returns ``(pos_loss, neg_loss)``; with bf16
    features ``pos_loss`` is bf16, rounded where the jitted JAX loss rounds
    on the CPU (the difference, the row sum of the exact squares, the
    threshold, the difference to it, the masked sum and the mean over a
    bf16 count), and ``neg_loss`` f32 (f32 distances).

    ``hardest``: ``(i01, i10)``, candidate positions [P] taken as the
    hardest negatives in place of the argmins (a step that replays another
    step's choice, to compare two summation orders of one net).
    ``return_hardest``: also return the hardest negatives taken, as a third
    item ``(i01, i10)``."""
    pos_f0 = f0[pos0_idx]
    pos_f1 = f1[pos1_idx]
    sub_f0 = f0[cand0_idx]
    sub_f1 = f1[cand1_idx]

    big = torch.tensor(1e9, dtype=torch.float32, device=f0.device)
    d01 = torch.where(cand1_valid[None, :] > 0, _pdist(pos_f0, sub_f1), big)
    d10 = torch.where(cand0_valid[None, :] > 0, _pdist(pos_f1, sub_f0), big)

    if hardest is None:
        # torch's argmin, as jnp.argmin, takes the first of equal minima;
        # amin splits the gradient evenly between them, as jnp.min
        d01_ind, d10_ind = d01.argmin(1), d10.argmin(1)
        d01_min, d10_min = d01.amin(1), d10.amin(1)
    else:
        d01_ind, d10_ind = hardest
        d01_min = d01.gather(1, d01_ind[:, None])[:, 0]
        d10_min = d10.gather(1, d10_ind[:, None])[:, 0]

    mask0 = (pos_valid > 0) & ~_packed_bit(collide0, d01_ind)
    mask1 = (pos_valid > 0) & ~_packed_bit(collide1, d10_ind)

    # bf16: the difference rounded, its squares not, the row sum once; the
    # threshold rounded to bf16 before the subtraction (a weakly typed
    # scalar in JAX), then the mean over a bf16 count
    pos_d2 = _sum_squares(pos_f0 - pos_f1)
    pos_loss = _masked_mean(torch.relu(pos_d2 - pos_d2.new_tensor(pos_thresh)), pos_valid)
    neg0 = _masked_mean(torch.relu(neg_thresh - d01_min).square(), mask0)
    neg1 = _masked_mean(torch.relu(neg_thresh - d10_min).square(), mask1)
    if return_hardest:
        return pos_loss, 0.5 * (neg0 + neg1), (d01_ind, d10_ind)
    return pos_loss, 0.5 * (neg0 + neg1)
