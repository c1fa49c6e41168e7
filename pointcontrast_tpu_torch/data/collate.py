"""Fixed-shape pair collation (host side, numpy only) + the move to torch.

Jax-free port of ``pointcontrast_tpu/data/collate.py`` for the pretraining
path: ``collate_pair`` with fused frames, PointInfoNCE or
hardest-contrastive sampling and the three layouts (chunked, voxel,
brick[:N]).  From the same samples and
``RandomState`` it gives the JAX package's arrays byte for byte.
``PairBatch`` is a plain dataclass whose ``to(device)`` checks every index
against the table it reads (per chunk, per level, per brick level) before
any kernel can read it through a raw pointer, then widens the uint16 maps
to int32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from pointcontrast_tpu_torch.sparse.brick import (
    BrickDownMap,
    BrickMap,
    build_brick_pyramid,
)
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import (
    ORDERED_MAPS,
    LevelTopo,
    Pyramid,
    build_pyramid,
)


@dataclasses.dataclass(frozen=True)
class PadScheme:
    """Static padded sizes for a batch's coordinate pyramid.

    ``npads[l]`` must exceed the true voxel count at level ``l``.  With
    ``level_ratios`` unset, level 1 keeps the level-0 budget and deeper
    levels shrink by ``shrink`` per stride."""

    npad0: int
    num_levels: int = 5
    shrink: float = 2.0
    min_pad: int = 256
    level_ratios: tuple | None = None

    @property
    def npads(self) -> list[int]:
        return self.npads_for(self.num_levels)

    def npads_for(self, n_levels: int) -> list[int]:
        """Padded sizes for ``n_levels`` levels (the brick layout needs
        ``num_levels + 1``: level l's bricks are level l+1's coordinates).
        Levels beyond the ratios extrapolate with the last shrink factor."""
        if self.level_ratios is not None:
            if len(self.level_ratios) < self.num_levels:
                raise ValueError(
                    f"level_ratios has {len(self.level_ratios)} entries but "
                    f"num_levels={self.num_levels}"
                )
            ratios = list(self.level_ratios[:n_levels])
            while len(ratios) < n_levels:
                shrink = (ratios[-1] / ratios[-2]
                          if len(ratios) >= 2 and ratios[-2] else 0.5)
                ratios.append(ratios[-1] * min(shrink, 1.0))
            return [max(int(self.npad0 * r) + 1, self.min_pad) for r in ratios]
        return [
            max(int(self.npad0 / self.shrink ** max(lvl - 1, 0)) + 1, self.min_pad)
            for lvl in range(n_levels)
        ]

    @staticmethod
    def scannet(npad0: int, num_levels: int = 5) -> "PadScheme":
        """Tight pads for ScanNet-density scenes (2-2.5cm voxels): level
        counts shrink ~(1, 0.29, 0.073, 0.019, 0.005) per stride on saturated
        surface scans; the ratios carry ~30-40% headroom on top."""
        return PadScheme(
            npad0, num_levels,
            level_ratios=(1.0, 0.38, 0.105, 0.03, 0.011, 0.004),
        )


def _to_index(a, device) -> torch.Tensor | None:
    """uint16/int32 numpy map -> int32 tensor (few torch ops take uint16)."""
    if a is None:
        return None
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def _check_below(name: str, a: np.ndarray, bound: int) -> None:
    if a.size and (int(a.min()) < 0 or int(a.max()) >= bound):
        raise ValueError(
            f"{name}: index range [{int(a.min())}, {int(a.max())}] "
            f"outside [0, {bound})"
        )


def _level_kind(lv: LevelTopo) -> str:
    """'chunked' ([K, B, S] maps), 'flat' ([K, N]) or 'brick' (BrickMap)."""
    m = lv.nbr if lv.nbr is not None else lv.nbr0
    if isinstance(m, BrickMap):
        return "brick"
    return "chunked" if m.ndim == 3 else "flat"


def _check_shape(name: str, a, shape) -> None:
    if a.shape != tuple(shape):
        raise ValueError(f"{name}: shape {a.shape}, expected {tuple(shape)}")


def _check_permutation(name: str, o, shape) -> None:
    """``o`` has ``shape`` and is, along its last axis (per chunk), a
    permutation of the rows: a kernel writes the row each entry names."""
    _check_shape(name, o, shape)
    if not (np.sort(o, axis=-1) == np.arange(o.shape[-1])).all():
        raise ValueError(f"{name}: not a permutation of its rows")


def _check_orders(l: int, lv: LevelTopo) -> None:
    """Each live order present is, per chunk (flat: of the one table), a
    permutation of its map's output rows (the gather GEMM writes the row
    each entry names), and the up order one of the parent map's fine rows
    (``parent_gemm`` does the same); the parent map is a per-row vector,
    so the up order has its shape, not a map's ``shape[1:]``."""
    for name, oname in ORDERED_MAPS:
        m, o = getattr(lv, name), getattr(lv, oname)
        if o is None:
            continue
        if m is None or isinstance(m, (BrickMap, BrickDownMap)):
            raise ValueError(f"level {l} {oname}: no gather map {name} to order")
        _check_permutation(f"level {l} {oname}", o, m.shape[1:])
    if lv.up_order is not None:
        if lv.up_parent is None or lv.up_offset is None:
            raise ValueError(f"level {l} up_order: no parent map to order")
        _check_permutation(f"level {l} up_order", lv.up_order, lv.up_parent.shape)


def _check_chunked(pyr: Pyramid) -> list[int]:
    levels = pyr.levels
    nb = pyr.num_batch
    sizes = [lv.valid.shape[0] // nb for lv in levels]
    for l, lv in enumerate(levels):
        s = sizes[l]
        _check_below(f"level {l} batch", lv.batch, nb + 1)
        for name in ("nbr", "nbr0"):
            m = getattr(lv, name)
            if m is not None:
                if m.shape[1:] != (nb, s):
                    raise ValueError(f"level {l} {name}: shape {m.shape}")
                _check_below(f"level {l} {name}", m, s)
        if lv.down_nbr is None:
            continue
        s_next = sizes[l + 1]
        k_up = lv.down_nbr.shape[0]
        if lv.down_nbr.shape[1:] != (nb, s_next):
            raise ValueError(f"level {l} down_nbr: shape {lv.down_nbr.shape}")
        if lv.up_parent.shape != (nb, s) or lv.up_offset.shape != (nb, s):
            raise ValueError(f"level {l} up maps: shape {lv.up_parent.shape}")
        _check_below(f"level {l} down_nbr", lv.down_nbr, s)
        if lv.down_nbr3 is not None:
            if lv.down_nbr3.shape[1:] != (nb, s_next):
                raise ValueError(f"level {l} down_nbr3: shape {lv.down_nbr3.shape}")
            _check_below(f"level {l} down_nbr3", lv.down_nbr3, s)
        _check_below(f"level {l} up_parent", lv.up_parent, s_next)
        _check_below(f"level {l} up_offset", lv.up_offset, k_up)
    for l, lv in enumerate(levels):
        _check_orders(l, lv)
    return [nb * s for s in sizes]


def _check_flat_level(l: int, lv: LevelTopo, rows: list) -> None:
    """A flat level: maps into its own [npad_l] table, the k2s2 maps
    between it and level l+1's [npad_{l+1}]."""
    n = rows[l]
    _check_orders(l, lv)
    for name in ("nbr", "nbr0"):
        m = getattr(lv, name)
        if m is not None:
            _check_shape(f"level {l} {name}", m, (m.shape[0], n))
            _check_below(f"level {l} {name}", m, n)
    if lv.down_nbr is None:
        return
    n_next = rows[l + 1]
    k_up = lv.down_nbr.shape[0]
    for name in ("down_nbr", "down_nbr3"):
        m = getattr(lv, name)
        if m is not None:
            _check_shape(f"level {l} {name}", m, (m.shape[0], n_next))
            _check_below(f"level {l} {name}", m, n)
    _check_shape(f"level {l} up_parent", lv.up_parent, (n,))
    _check_shape(f"level {l} up_offset", lv.up_offset, (n,))
    _check_below(f"level {l} up_parent", lv.up_parent, n_next)
    _check_below(f"level {l} up_offset", lv.up_offset, k_up)


def _check_brick_level(l: int, lv: LevelTopo, rows: list, kinds: list) -> None:
    """A brick level of NB bricks ([NB * 8] slot rows): its BrickMaps
    index the NB bricks and their slot orders are permutations of the
    [NB * 8] rows (the brick kernels write the row each entry names), the
    down conv's placement indexes the NB rows of its matmul output, and
    the up-gather the next level's rows; at a brick -> flat boundary
    (``place`` / ``up_parent`` None) the flat next level must have exactly
    NB rows."""
    ns = lv.down_nbr.num_slots
    if rows[l] % ns:
        raise ValueError(f"level {l}: {rows[l]} rows are not whole bricks of {ns}")
    nb = rows[l] // ns
    for name in ("nbr", "nbr0"):
        m = getattr(lv, name)
        if m is not None:
            _check_shape(f"level {l} {name}", m.nbr, (m.nbr.shape[0], nb))
            _check_below(f"level {l} {name}", m.nbr, nb)
            if m.order is not None:
                _check_permutation(f"level {l} {name} order", m.order, (rows[l],))
    if l + 1 == len(rows):
        return
    place, upg = lv.down_nbr.place, lv.up_parent
    if place is None or upg is None:
        if kinds[l + 1] != "flat" or rows[l + 1] != nb or (place is None) != (upg is None):
            raise ValueError(f"level {l}: a brick -> flat boundary needs a flat "
                             f"level {l + 1} of {nb} rows")
        return
    if kinds[l + 1] != "brick":
        raise ValueError(f"level {l} place: level {l + 1} is not bricked")
    _check_shape(f"level {l} place", place, (ns, rows[l + 1] // ns))
    _check_below(f"level {l} place", place, nb)
    _check_shape(f"level {l} up_parent", upg, (nb,))
    _check_below(f"level {l} up_parent", upg, rows[l + 1])


def check_pyramid_bounds(pyr: Pyramid) -> list[int]:
    """Layout-aware bounds check of a host pyramid against the table each
    map indexes.  Chunked, per chunk: ``nbr < S_l``, ``down_nbr < S_l``
    (and ``down_nbr3``), ``up_parent < S_{l+1}``, ``up_offset < 2^D``.
    Voxel (flat), per level: the same against ``npad_l`` and
    ``npad_{l+1}``.  Brick levels: ``BrickMap.nbr < NB``, ``place < NB``,
    ``up_parent`` (the up-gather) below the next level's rows, the
    boundary's row counts, each slot order a permutation of the level's
    rows.  Chunked and flat: each live order a permutation of its map's
    output rows, the up order one of the parent map's fine rows.  Every
    layout: the sample ids ``batch <= B`` (``B``: pad rows) that global
    pooling reads, at the level's rows.  Returns the rows of every level's
    feature table; raises ``ValueError`` naming the first map out of
    range."""
    kinds = [_level_kind(lv) for lv in pyr.levels]
    if "chunked" in kinds:
        if set(kinds) != {"chunked"}:
            raise ValueError(f"a chunked pyramid mixed with other layouts: {kinds}")
        return _check_chunked(pyr)
    rows = [lv.valid.shape[0] for lv in pyr.levels]
    for l, lv in enumerate(pyr.levels):
        _check_shape(f"level {l} batch", lv.batch, (rows[l],))
        _check_below(f"level {l} batch", lv.batch, pyr.num_batch + 1)
        if kinds[l] == "brick":
            _check_brick_level(l, lv, rows, kinds)
        else:
            _check_flat_level(l, lv, rows)
    return rows


def _map_to(m, device):
    if isinstance(m, BrickMap):
        return BrickMap(_to_index(m.nbr, device), m.plan, _to_index(m.order, device))
    if isinstance(m, BrickDownMap):
        return BrickDownMap(_to_index(m.place, device), m.num_slots)
    return _to_index(m, device)


def pyramid_to(pyr: Pyramid, device) -> Pyramid:
    """The host pyramid on ``device``, maps widened to int32 (check it with
    ``check_pyramid_bounds`` first: the kernels read through raw pointers)."""

    def level_to(lv: LevelTopo) -> LevelTopo:
        return LevelTopo(
            nbr=_map_to(lv.nbr, device),
            valid=torch.from_numpy(lv.valid).to(device),
            batch=_to_index(lv.batch, device),
            down_nbr=_map_to(lv.down_nbr, device),
            up_parent=_to_index(lv.up_parent, device),
            up_offset=_to_index(lv.up_offset, device),
            nbr0=_map_to(lv.nbr0, device),
            down_nbr3=_to_index(lv.down_nbr3, device),
            up_order=_to_index(lv.up_order, device),
            rev=lv.rev,
            rev0=lv.rev0,
            **{o: _to_index(getattr(lv, o), device) for _, o in ORDERED_MAPS},
        )

    return Pyramid(levels=tuple(level_to(lv) for lv in pyr.levels),
                   num_batch=pyr.num_batch)


HARDEST_FIELDS = ("pos0_idx", "pos1_idx", "pos_valid", "cand0_idx", "cand0_valid",
                  "cand1_idx", "cand1_valid", "collide0", "collide1")


def check_bounds(batch: "PairBatch") -> None:
    """Bounds check of a host ``PairBatch``: its pyramid
    (``check_pyramid_bounds``), the feature rows, and the loss indices of
    its mode below the row count: NCE's ``q_idx`` / ``k_idx``, or the
    hardest mode's positives and candidates, with each validity mask the
    length of its indices and each collision bitmap [P, ceil(H / 8)]
    uint8.  Raises ``ValueError`` naming the first map out of range."""
    rows = check_pyramid_bounds(batch.pyramid0)[0]
    if batch.feats0.shape[0] != rows:
        raise ValueError(f"feats0 has {batch.feats0.shape[0]} rows, expected {rows}")
    if batch.pos0_idx is None:
        _check_below("q_idx", batch.q_idx, rows)
        _check_below("k_idx", batch.k_idx, rows)
        return
    p, h = len(batch.pos0_idx), len(batch.cand0_idx)
    for name, n in (("pos0_idx", p), ("pos1_idx", p), ("pos_valid", p),
                    ("cand0_idx", h), ("cand0_valid", h), ("cand1_idx", h),
                    ("cand1_valid", h)):
        if getattr(batch, name) is None:
            raise ValueError(f"{name}: missing from a hardest-mode batch")
        _check_shape(name, getattr(batch, name), (n,))
        if name.endswith("_idx"):
            _check_below(name, getattr(batch, name), rows)
    for name in ("collide0", "collide1"):
        bits = getattr(batch, name)
        if bits is None:
            raise ValueError(f"{name}: missing from a hardest-mode batch")
        _check_shape(name, bits, (p, -(-h // 8)))
        if bits.dtype != np.uint8:
            raise ValueError(f"{name}: dtype {bits.dtype}, expected uint8")


def _index_to(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a, dtype=np.int64)).to(device)


@dataclasses.dataclass
class PairBatch:
    """One fused-frame batch: numpy on the host, torch after ``to``.  NCE
    batches carry ``q_idx`` / ``k_idx`` / ``pair_valid``, hardest-mode ones
    the ``HARDEST_FIELDS``; the other mode's fields are None."""

    feats0: Any  # [B * S_0, C] padded rows zero (both frames fused)
    pyramid0: Any  # sparse.topology.Pyramid over all 2 * num_pairs frames
    q_idx: Optional[Any] = None  # [npos] anchor rows (frame 0)
    k_idx: Optional[Any] = None  # [npos] positive rows (frame 1)
    pair_valid: Optional[Any] = None  # [npos] float 1/0
    pos0_idx: Optional[Any] = None  # [P] positive pairs' frame-0 rows
    pos1_idx: Optional[Any] = None  # [P] ... frame-1 rows
    pos_valid: Optional[Any] = None  # [P] float 1/0
    cand0_idx: Optional[Any] = None  # [H] hard-negative candidates (frame 0)
    cand0_valid: Optional[Any] = None  # [H]
    cand1_idx: Optional[Any] = None  # [H] ... (frame 1)
    cand1_valid: Optional[Any] = None  # [H]
    collide0: Optional[Any] = None  # [P, ceil(H/8)] uint8 (bit-packed, LE)
    collide1: Optional[Any] = None  # [P, ceil(H/8)] uint8
    # voxels dropped by graceful truncation (scalar)
    truncated_voxels: Optional[Any] = None
    num_pairs: int = 0

    def to(self, device) -> "PairBatch":
        """Bounds-check the host batch, then move it to ``device`` with the
        maps widened to int32, the loss indices to int64 and the collision
        bitmaps as uint8."""
        check_bounds(self)
        moved = {}
        for name in ("q_idx", "k_idx", "pair_valid") + HARDEST_FIELDS:
            a = getattr(self, name)
            if a is not None:
                moved[name] = (_index_to(a, device) if name.endswith("_idx")
                               else torch.from_numpy(np.ascontiguousarray(a)).to(device))
        return PairBatch(
            feats0=torch.from_numpy(self.feats0).to(device),
            pyramid0=pyramid_to(self.pyramid0, device),
            truncated_voxels=torch.as_tensor(self.truncated_voxels).to(device),
            num_pairs=self.num_pairs,
            **moved,
        )


def _concat_with_batch_index(coords_list, feats_list):
    rows = []
    for b, c in enumerate(coords_list):
        bc = np.concatenate(
            [np.full((len(c), 1), b, dtype=np.int32), c.astype(np.int32)], axis=1
        )
        rows.append(bc)
    return np.concatenate(rows, 0), np.concatenate(feats_list, 0).astype(np.float32)


def _offset_matches(matches_list, len0, len1):
    out = []
    o0 = o1 = 0
    for m, n0, n1 in zip(matches_list, len0, len1):
        if len(m) == 0:
            m = np.zeros((1, 2), dtype=np.int64)  # dummy (0,0), as the reference
        out.append(m + np.array([o0, o1], dtype=np.int64))
        o0 += n0
        o1 += n1
    return np.concatenate(out, 0)


def parse_layout(layout: str):
    """'voxel' | 'chunked' | 'brick' (2 brick levels) | 'brick:N'
    -> (kind, N)."""
    if layout == "voxel":
        return "voxel", 0
    if layout == "chunked":
        return "chunked", 0
    if layout == "brick":
        return "brick", 2
    if layout.startswith("brick:"):
        return "brick", int(layout.split(":", 1)[1])
    raise ValueError(f"unknown layout {layout!r}")


def _build_padded_pyramid(coords, scheme: PadScheme, num_batch: int,
                          conv0_kernel_size: int = 3, layout: str = "voxel",
                          num_levels: int | None = None):
    """Returns (pyramid, meta, rows, orphan) of ``num_levels`` levels (the
    scheme's by default); rows/orphan are None for the flat voxel layout,
    the layout rows of the input voxels otherwise."""
    kind, brick_levels = parse_layout(layout)
    n_levels = num_levels or scheme.num_levels
    if kind == "brick":
        return build_brick_pyramid(
            coords, num_levels=n_levels, npads=scheme.npads_for(n_levels + 1),
            num_batch=num_batch, conv0_kernel_size=conv0_kernel_size,
            brick_levels=brick_levels)
    if kind == "chunked":
        return build_chunked_pyramid(
            coords, num_levels=n_levels, npads=scheme.npads,
            num_batch=num_batch, conv0_kernel_size=conv0_kernel_size)
    pyr, meta = build_pyramid(
        coords, num_levels=n_levels, npads=scheme.npads, num_batch=num_batch,
        conv0_kernel_size=conv0_kernel_size)
    return pyr, meta, None, None


def _pad_feats(feats: np.ndarray, npad: int) -> np.ndarray:
    out = np.zeros((npad, feats.shape[1]), dtype=np.float32)
    out[: len(feats)] = feats
    return out


def _layout_feats(feats: np.ndarray, rows: np.ndarray, orphan: np.ndarray,
                  nrows: int) -> np.ndarray:
    """Scatter voxel features to their chunked or brick rows (orphans
    dropped so the zero-row invariant holds for every absent voxel)."""
    out = np.zeros((nrows, feats.shape[1]), dtype=np.float32)
    keep = ~orphan
    out[rows[keep]] = feats[keep]
    return out


def _remap_idx(idx, valid, rows: np.ndarray, orphan: np.ndarray):
    """Map loss indices from voxel ids to layout rows; entries pointing at
    orphaned (truncation-dropped) voxels are invalidated."""
    idx = np.asarray(idx, dtype=np.int64)
    ok = ~orphan[idx]
    out = rows[idx].astype(np.int32)
    out[~ok] = 0
    v = ok.astype(np.float32) if valid is None else (valid * ok).astype(np.float32)
    return out, v


def _subsample_frame(coords, feats, keep_n, rng):
    """Random voxel subset preserving order (overflow safety valve)."""
    sel = np.sort(rng.choice(len(coords), keep_n, replace=False))
    remap = np.full(len(coords), -1, dtype=np.int64)
    remap[sel] = np.arange(keep_n)
    return coords[sel], feats[sel], remap


def _subsample_lists(coords, feats, matches, col, ratio, rng):
    """Subsample every sample of one frame by ``ratio``, dropping the
    matches whose ``col`` end was removed (in place on the lists)."""
    for b in range(len(coords)):
        keep = max(1, int(len(coords[b]) * ratio))
        coords[b], feats[b], remap = _subsample_frame(coords[b], feats[b], keep, rng)
        m = matches[b]
        m = m[remap[m[:, col]] >= 0]
        m[:, col] = remap[m[:, col]]
        matches[b] = m


def sample_nce_pairs(
    matches: np.ndarray, npos: int, rng: np.random.RandomState
):
    """PointInfoNCE anchor sampling: one random positive per unique frame-0
    anchor, then subsample to ``npos`` anchors; padded with zeros + validity
    mask."""
    q_idx = np.zeros(npos, dtype=np.int32)
    k_idx = np.zeros(npos, dtype=np.int32)
    valid = np.zeros(npos, dtype=np.float32)
    if len(matches):
        src = matches[:, 0]
        if np.any(src[1:] < src[:-1]):
            matches = matches[np.argsort(src, kind="stable")]
        uniq, counts = np.unique(matches[:, 0], return_counts=True)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        off = np.floor(rng.rand(len(counts)) * counts).astype(np.int64)
        # matches are sorted by source index, so runs are contiguous
        k_sel = matches[starts + off, 1]
        if npos < len(uniq):
            pick = rng.choice(len(uniq), npos, replace=False)
            uniq, k_sel = uniq[pick], k_sel[pick]
        n = len(uniq)
        q_idx[:n] = uniq
        k_idx[:n] = k_sel
        valid[:n] = 1.0
    return q_idx, k_idx, valid


def sample_hardest_contrastive(
    matches: np.ndarray,
    n0: int,
    n1: int,
    num_pos: int,
    num_hn: int,
    rng: np.random.RandomState,
):
    """Positive pairs and hard-negative candidates, padded to ``num_pos``
    and ``num_hn`` with validity masks, and the bit-packed collision
    bitmaps against the full positive set.  Draws ``cand0``, ``cand1``
    and then the positives from ``rng``, in that order."""
    h0 = min(n0, num_hn)
    h1 = min(n1, num_hn)
    cand0 = np.zeros(num_hn, dtype=np.int32)
    cand1 = np.zeros(num_hn, dtype=np.int32)
    cand0[:h0] = rng.choice(n0, h0, replace=False)
    cand1[:h1] = rng.choice(n1, h1, replace=False)
    cand0_valid = (np.arange(num_hn) < h0).astype(np.float32)
    cand1_valid = (np.arange(num_hn) < h1).astype(np.float32)

    p = min(len(matches), num_pos)
    pos0 = np.zeros(num_pos, dtype=np.int32)
    pos1 = np.zeros(num_pos, dtype=np.int32)
    if len(matches) > num_pos:
        pick = rng.choice(len(matches), num_pos, replace=False)
        sampled = matches[pick]
    else:
        sampled = matches
    pos0[:p] = sampled[:, 0]
    pos1[:p] = sampled[:, 1]
    pos_valid = (np.arange(num_pos) < p).astype(np.float32)

    # Collision bitmaps against the FULL positive set, bit-packed along the
    # candidate axis (little-endian bit order): the loss gathers the byte
    # of each anchor's argmin and shifts.
    collide0 = np.packbits(
        _collision_bitmap(matches[:, 0], matches[:, 1], pos0, cand1, h1, n1),
        axis=1, bitorder="little",
    )
    collide1 = np.packbits(
        _collision_bitmap(matches[:, 1], matches[:, 0], pos1, cand0, h0, n0),
        axis=1, bitorder="little",
    )
    return dict(
        pos0_idx=pos0,
        pos1_idx=pos1,
        pos_valid=pos_valid,
        cand0_idx=cand0,
        cand0_valid=cand0_valid,
        cand1_idx=cand1,
        cand1_valid=cand1_valid,
        collide0=collide0,
        collide1=collide1,
    )


def _collision_bitmap(
    match_anchor: np.ndarray,  # [M] anchor column of the match list
    match_other: np.ndarray,  # [M] other-frame column
    anchors: np.ndarray,  # [P] sampled anchor indices
    cands: np.ndarray,  # [H] sampled candidate indices (other frame)
    num_valid_cands: int,
    n_other: int,
) -> np.ndarray:
    """bitmap[i, j] = (anchors[i], cands[j]) is a true positive pair: each
    anchor's few true matches are marked, not all P x H cells tested."""
    p, h = len(anchors), len(cands)
    out = np.zeros((p, h), dtype=bool)
    if len(match_anchor) == 0 or num_valid_cands == 0:
        return out
    order = np.argsort(match_anchor, kind="stable")
    sa, so = match_anchor[order], match_other[order]
    starts = np.searchsorted(sa, anchors, side="left")
    ends = np.searchsorted(sa, anchors, side="right")
    counts = ends - starts
    total = int(counts.sum())
    if total == 0:
        return out
    anchor_rows = np.repeat(np.arange(p), counts)
    flat = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
    targets = so[np.repeat(starts, counts) + flat]
    inv = np.full(n_other, -1, dtype=np.int64)
    inv[cands[:num_valid_cands]] = np.arange(num_valid_cands)
    cols = inv[targets]
    keep = cols >= 0
    out[anchor_rows[keep], cols[keep]] = True
    return out


def collate_pair(
    samples: list,
    scheme: PadScheme,
    mode: str = "nce",
    npos: int = 4096,
    num_pos: int = 4096,
    num_hn: int = 1024,
    rng: np.random.RandomState | None = None,
    max_fit_attempts: int = 6,
    fuse_frames: bool = True,
    conv0_kernel_size: int = 3,
    layout: str = "chunked",
) -> PairBatch:
    """Collate ``__getitem__`` tuples into one static-shaped ``PairBatch``.

    Frame 1's clouds become extra sparse-batch samples (ids B..2B-1) and ONE
    pyramid is built over all 2B frames, in ``layout`` ('chunked', 'voxel',
    'brick' or 'brick:N').  ``mode``: 'nce' (``npos`` PointInfoNCE pairs)
    or 'hardest' (``num_pos`` positives, ``num_hn`` hard-negative
    candidates per frame and their collision bitmaps).  The loss indices
    point into that combined table (remapped to the layout's rows, orphans
    of truncation invalidated and counted).  The JAX package's separate
    frames (``fuse_frames=False``) are not ported yet and raise."""
    parse_layout(layout)  # unknown layouts raise
    if mode not in ("nce", "hardest") or not fuse_frames:
        raise ValueError(
            f"collate_pair supports mode='nce' or 'hardest' with "
            f"fuse_frames=True (got {mode!r}, {fuse_frames})"
        )
    rng = rng or np.random.RandomState()
    _, _, coords0, coords1, feats0, feats1, matches, _ = zip(*samples)
    coords0, feats0, coords1, feats1 = (
        list(coords0), list(feats0), list(coords1), list(feats1),
    )
    matches = [np.asarray(m, dtype=np.int64).reshape(-1, 2) for m in matches]
    nb = len(samples)

    for _ in range(max_fit_attempts):
        len0 = [len(c) for c in coords0]
        len1 = [len(c) for c in coords1]
        c0, f0 = _concat_with_batch_index(coords0, feats0)
        c1, f1 = _concat_with_batch_index(coords1, feats1)
        budget = (scheme.npads[0] - 1) // 2
        if len(c0) > budget or len(c1) > budget:
            # Too many voxels for the static shape: evenly subsample frames.
            for cl, fl, col in ((coords0, feats0, 0), (coords1, feats1, 1)):
                total = sum(len(c) for c in cl)
                if total > budget:
                    _subsample_lists(cl, fl, matches, col,
                                     budget / total * 0.999, rng)
            continue
        try:
            c1f = c1.copy()
            c1f[:, 0] += nb  # frame-1 clouds as extra batch samples
            pyr0, meta0, rows0, orph0 = _build_padded_pyramid(
                np.concatenate([c0, c1f]), scheme, 2 * nb, conv0_kernel_size,
                layout)
        except ValueError:
            # deeper-level overflow: shrink level 0 and retry
            _subsample_lists(coords0, feats0, matches, 0, 0.8, rng)
            _subsample_lists(coords1, feats1, matches, 1, 0.8, rng)
            continue
        break
    else:
        raise ValueError(
            f"batch does not fit PadScheme {scheme} after {max_fit_attempts} attempts"
        )

    all_matches = _offset_matches(matches, len0, len1)
    truncated = sum(n for _, n in meta0.truncated)
    off1 = len(c0)  # frame-1 rows start here in the combined table
    feats = np.concatenate([f0, f1])
    if rows0 is None:  # voxel: input voxel i is row i
        feats0 = _pad_feats(feats, scheme.npads[0])
    else:
        truncated += int(orph0.sum())
        feats0 = _layout_feats(feats, rows0, orph0, pyr0.levels[0].valid.shape[0])
    if mode == "nce":
        q, k, v = sample_nce_pairs(all_matches, npos, rng)
        if rows0 is None:
            k = k + off1
        else:
            q, v = _remap_idx(q, v, rows0, orph0)
            k, v = _remap_idx(k + off1, v, rows0, orph0)
        loss = dict(q_idx=q, k_idx=k, pair_valid=v)
    else:
        loss = sample_hardest_contrastive(all_matches, len(c0), len(c1), num_pos,
                                          num_hn, rng)
        loss["pos1_idx"] = loss["pos1_idx"] + off1
        loss["cand1_idx"] = loss["cand1_idx"] + off1
        if rows0 is not None:
            loss["pos0_idx"], v = _remap_idx(loss["pos0_idx"], loss["pos_valid"],
                                             rows0, orph0)
            loss["pos1_idx"], loss["pos_valid"] = _remap_idx(loss["pos1_idx"], v,
                                                             rows0, orph0)
            for c in ("cand0", "cand1"):
                loss[f"{c}_idx"], loss[f"{c}_valid"] = _remap_idx(
                    loss[f"{c}_idx"], loss[f"{c}_valid"], rows0, orph0)
    return PairBatch(
        feats0=feats0,
        pyramid0=pyr0,
        truncated_voxels=np.asarray(truncated, np.float32),
        num_pairs=nb,
        **loss,
    )
