"""Voxel quantization: the ``ME.utils.sparse_quantize`` replacement.

Reference usages replicated (see SURVEY.md section 2.7):
  - index mode: ``sparse_quantize(xyz / voxel, return_index=True)``
    (the reference's pretrain/pointcontrast/lib/ddp_data_loaders.py:228-229)
  - label-aware mode: ``sparse_quantize(coords, feats, labels, ignore_label)``
    (the reference's downstream/semseg/lib/voxelizer.py:145-146): voxels whose
    duplicate points carry conflicting labels get ``ignore_label``.

Pure numpy, host side. Unique voxels keep the *first occurrence* in input
order and are returned in first-occurrence order (deterministic).
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.sparse.hashing import HashSpec


def _floor_int(coords: np.ndarray) -> np.ndarray:
    if np.issubdtype(coords.dtype, np.floating):
        return np.floor(coords).astype(np.int32)
    return coords.astype(np.int32)


def sparse_quantize(
    coords: np.ndarray,
    feats: np.ndarray | None = None,
    labels: np.ndarray | None = None,
    ignore_label: int = 255,
    return_index: bool = False,
):
    """Deduplicate points that fall into the same integer voxel.

    Args:
      coords: [N, D] float or int coordinates (floats are floored).
      feats: optional [N, F] per-point features.
      labels: optional [N] per-point integer labels.
      ignore_label: label assigned to voxels with conflicting labels.
      return_index: if True and no feats/labels given, return only the indices
        of the retained points (first occurrence per voxel, in input order).

    Returns:
      - return_index=True: int64 index array ``sel`` with coords[sel] unique.
      - labels given: (unique_coords, unique_feats, unique_labels)
      - feats given:  (unique_coords, unique_feats)
      - else:         unique_coords
    """
    icoords = _floor_int(coords)
    spec = HashSpec.from_coords(icoords)
    keys = spec.encode(icoords)

    # First occurrence per unique key, in input order.
    sorted_keys, first_idx = np.unique(keys, return_index=True)
    sel = np.sort(first_idx)

    if return_index and feats is None and labels is None:
        return sel

    ucoords = icoords[sel]
    if labels is not None:
        if feats is None:
            raise ValueError("label mode requires feats")
        # A voxel's label survives only if every point in it agrees.
        # Map each point to its (input-order) voxel slot, then detect conflict.
        order_of_key = np.argsort(first_idx, kind="stable")
        # rank in sorted_keys -> slot in first-occurrence order
        slot_of_rank = np.empty_like(order_of_key)
        slot_of_rank[order_of_key] = np.arange(len(order_of_key))
        ranks = np.searchsorted(sorted_keys, keys)
        slots = slot_of_rank[ranks]

        ulabels = np.asarray(labels)[sel].copy()
        conflict = np.zeros(len(sel), dtype=bool)
        # Conflict if any point's label differs from its voxel's first label.
        np.logical_or.at(conflict, slots, np.asarray(labels) != ulabels[slots])
        ulabels[conflict] = ignore_label
        out = (ucoords, np.asarray(feats)[sel], ulabels)
        return out + (sel,) if return_index else out

    if feats is not None:
        out = (ucoords, np.asarray(feats)[sel])
        return out + (sel,) if return_index else out
    return ucoords  # bare-coords mode (return_index returned above)
