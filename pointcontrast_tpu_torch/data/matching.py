"""Correspondence search between frame pairs.

The reference finds positive pairs with an open3d KDTree radius search driven
by a Python for-loop over every source point
(the reference's pretrain/pointcontrast/lib/ddp_data_loaders.py:36-49) — the
CPU hot loop of its input pipeline.  Here the same semantics (all (i, j) with
``||T(x0_i) - x1_j|| <= radius``) are computed by a fully vectorized
grid-hash join: bin target points into cells of side ``radius``, probe the 27
neighboring cells for each source point, and distance-filter in one shot.
"""
from __future__ import annotations

import itertools

import numpy as np


def apply_transform(pts: np.ndarray, trans: np.ndarray) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to [N, 3] points."""
    return pts @ trans[:3, :3].T + trans[:3, 3]


def radius_matches(
    source: np.ndarray,  # [N0, 3] float
    target: np.ndarray,  # [N1, 3] float
    radius: float,
    trans: np.ndarray | None = None,  # optional 4x4 applied to source
) -> np.ndarray:
    """All index pairs (i, j) with ||T(source_i) - target_j|| <= radius.

    Returns an [M, 2] int64 array (source index, target index), ordered by
    source index first (same order as the reference's per-point loop).
    """
    src = apply_transform(source, trans) if trans is not None else source
    src = np.ascontiguousarray(src, dtype=np.float64)
    tgt = np.ascontiguousarray(target, dtype=np.float64)
    if len(src) == 0 or len(tgt) == 0:
        return np.empty((0, 2), dtype=np.int64)

    inv_r = 1.0 / radius
    tcell = np.floor(tgt * inv_r).astype(np.int64)
    scell = np.floor(src * inv_r).astype(np.int64)

    lo = np.minimum(tcell.min(0), scell.min(0)) - 1
    extent = np.maximum(tcell.max(0), scell.max(0)) + 2 - lo
    stride = np.array(
        [extent[1] * extent[2], extent[2], 1], dtype=np.int64
    )

    def key(cells):
        return (cells - lo) @ stride

    tkey = key(tcell)
    order = np.argsort(tkey, kind="stable")
    skeys_sorted = tkey[order]

    out_src, out_tgt = [], []
    base = key(scell)
    for d in itertools.product((-1, 0, 1), repeat=3):
        probe = base + np.dot(np.asarray(d, dtype=np.int64), stride)
        left = np.searchsorted(skeys_sorted, probe, side="left")
        right = np.searchsorted(skeys_sorted, probe, side="right")
        counts = right - left
        if counts.sum() == 0:
            continue
        # Expand each source row into its candidate target rows.
        src_idx = np.repeat(np.arange(len(src)), counts)
        # offsets within each run: arange per group
        run_starts = np.repeat(left, counts)
        pos_in_run = np.arange(len(src_idx)) - np.repeat(
            np.cumsum(counts) - counts, counts
        )
        tgt_idx = order[run_starts + pos_in_run]
        d2 = np.sum((src[src_idx] - tgt[tgt_idx]) ** 2, axis=1)
        keep = d2 <= radius * radius
        out_src.append(src_idx[keep])
        out_tgt.append(tgt_idx[keep])

    if not out_src:
        return np.empty((0, 2), dtype=np.int64)
    pairs = np.stack(
        [np.concatenate(out_src), np.concatenate(out_tgt)], axis=1
    )
    # Reference ordering: ascending source index, ties in KDTree order
    # (we use ascending target index — the set of pairs is identical).
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    return pairs[order]
