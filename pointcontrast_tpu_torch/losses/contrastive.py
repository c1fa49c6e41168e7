"""PointInfoNCE loss (port of
``pointcontrast_tpu/losses/contrastive.py::point_info_nce_loss``).

The sampled index arrays are fixed-size with a validity mask (the collator
pre-samples them on the host)."""
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
