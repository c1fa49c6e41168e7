"""Chunked (per-frame) pyramids: per-sample slices + local maps.

Jax-free port of ``pointcontrast_tpu/sparse/chunk.py`` (same arrays, byte for
byte).  Layout: every level's rows are [B * S_l] with sample b occupying the
slice [b*S_l, (b+1)*S_l); gather maps are stored frame-LOCAL as [K, B, S_l]
(down maps [K, B, S_{l+1}], transpose parentage [B, S_l]).  Each slice ends
with its own pad rows (local index S_l - 1), so the zero-row invariant holds
per slice, and frame-local indices fit uint16.
"""
from __future__ import annotations

import numpy as np

from pointcontrast_tpu_torch.sparse.topology import (
    ORDERED_MAPS,
    LevelTopo,
    Pyramid,
    PyramidMeta,
    build_pyramid,
)


def chunk_sizes(npads: list[int], num_batch: int, min_chunk: int = 8):
    """Per-sample slice sizes: the PadScheme budget split across samples."""
    return [max(int(n) // num_batch, min_chunk) for n in npads]


def build_chunked_pyramid(
    coords: np.ndarray,
    num_levels: int,
    npads: list[int],
    num_batch: int | None = None,
    conv0_kernel_size: int = 3,
    build_down3: bool = False,
    allow_truncate: bool = True,
):
    """Build per-sample pyramids and stack them into chunked-level arrays.

    ``npads`` are TOTAL per-level budgets (a PadScheme), divided evenly
    across samples.

    Returns (pyramid, meta, rows, orphan):
      rows[i]: layout row of input voxel i (b * S_0 + local slot)
      orphan[i]: True when voxel i was dropped by per-sample level-0
        truncation (its ``rows`` entry is 0 and must be masked).
    """
    coords = np.asarray(coords).astype(np.int32)
    if num_batch is None:
        num_batch = int(coords[:, 0].max()) + 1 if len(coords) else 1
    s_lvls = chunk_sizes(npads, num_batch)

    rows = np.zeros(len(coords), dtype=np.int64)
    orphan = np.zeros(len(coords), dtype=bool)
    sample_levels = []
    sample_metas = []
    empty = []
    for b in range(num_batch):
        sel = np.nonzero(coords[:, 0] == b)[0]
        if len(sel) > s_lvls[0] - 1:
            if not allow_truncate:
                raise ValueError(
                    f"sample {b}: {len(sel)} voxels exceed chunk size "
                    f"{s_lvls[0]} (npad0 {npads[0]} / {num_batch} samples)"
                )
            orphan[sel[s_lvls[0] - 1:]] = True
            sel = sel[: s_lvls[0] - 1]
        rows[sel] = b * s_lvls[0] + np.arange(len(sel))
        sub = coords[sel].copy()
        sub[:, 0] = 0
        empty.append(len(sub) == 0)
        if len(sub) == 0:
            # placeholder voxel; masked out of every level after stacking
            sub = np.zeros((1, coords.shape[1]), np.int32)
        pyr_b, meta_b = build_pyramid(
            sub,
            num_levels,
            dimension=coords.shape[1] - 1,
            conv0_kernel_size=conv0_kernel_size,
            npads=s_lvls,
            num_batch=1,
            allow_truncate=allow_truncate,
            build_down3=build_down3,
        )
        sample_levels.append(pyr_b.levels)
        sample_metas.append(meta_b)

    levels = []
    meta_coords, meta_counts, truncated = [], [], []
    for lvl in range(num_levels):
        per = [sl[lvl] for sl in sample_levels]

        def stacked(attr, axis=1):
            """Maps with a leading K axis stack on axis 1 -> [K, B, S];
            per-row vectors (up_parent/up_offset, the live and up orders)
            on axis 0 -> [B, S]."""
            if getattr(per[0], attr) is None:
                return None
            return np.stack([getattr(x, attr) for x in per], axis=axis)

        valid = np.concatenate([x.valid for x in per])
        batch = np.empty(num_batch * s_lvls[lvl], np.int32)
        for b in range(num_batch):
            sl = slice(b * s_lvls[lvl], (b + 1) * s_lvls[lvl])
            if empty[b]:
                valid[sl] = 0.0
            batch[sl] = np.where(valid[sl] > 0, b, num_batch).astype(np.int32)

        levels.append(
            LevelTopo(
                nbr=stacked("nbr"),
                valid=valid,
                batch=batch,
                down_nbr=stacked("down_nbr"),
                down_nbr3=stacked("down_nbr3"),
                up_parent=stacked("up_parent", axis=0),
                up_offset=stacked("up_offset", axis=0),
                up_order=stacked("up_order", axis=0),  # each chunk's own
                nbr0=stacked("nbr0"),
                rev=per[0].rev,
                rev0=per[0].rev0,
                # each chunk's rows in its own live order
                **{o: stacked(o, axis=0) for _, o in ORDERED_MAPS},
            )
        )
        lvl_coords = []
        count = 0
        for b, m in enumerate(sample_metas):
            if empty[b]:
                continue
            c = m.coords[lvl].copy()
            c[:, 0] = b
            lvl_coords.append(c)
            count += m.counts[lvl]
        meta_coords.append(
            np.concatenate(lvl_coords)
            if lvl_coords else np.zeros((0, coords.shape[1]), np.int32)
        )
        meta_counts.append(count)
    for m in sample_metas:
        truncated.extend(m.truncated)

    pyramid = Pyramid(levels=tuple(levels), num_batch=num_batch)
    meta = PyramidMeta(
        coords=meta_coords,
        counts=meta_counts,
        npads=[s * num_batch for s in s_lvls],
        dimension=coords.shape[1] - 1,
        truncated=truncated,
    )
    return pyramid, meta, rows, orphan


def level_rows(meta: PyramidMeta, level: int, num_batch: int) -> np.ndarray:
    """Layout rows of ``meta.coords[level]`` (valid voxels, in order):
    b * S + local slot."""
    s = meta.npads[level] // num_batch
    c = meta.coords[level]
    out = np.empty(len(c), np.int64)
    pos = 0
    for b in range(num_batch):
        n = int((c[:, 0] == b).sum())
        out[pos: pos + n] = b * s + np.arange(n)
        pos += n
    return out
