"""Batch coordinate pyramid + kernel maps (host side, numpy only).

Jax-free port of ``pointcontrast_tpu/sparse/topology.py``: ``LevelTopo`` and
``Pyramid`` are plain dataclasses instead of ``flax.struct`` pytrees, with
what the voxel layout, ``chunk.build_chunked_pyramid`` and
``brick.build_brick_pyramid`` need (same-level ``nbr``, the stem's
``nbr0``, the k2s2 ``down_nbr`` and ``up_parent``/``up_offset``, the
ResNets' k3s2 ``down_nbr3``, ``valid``, ``batch`` and the brick layout's
``first_nbr_level``) and the 4-D spatio-temporal pyramids of the ST nets
(``region``, ``axis_types``, ``stride_axes``: space halved, time never).
The maps are byte-identical to the JAX package's.  ``Geometry`` gives a
net's kernel regions, and from them the tap count of every conv, from the
same offsets ``build_pyramid`` builds its maps with, so that a model and
its pyramid cannot disagree.

Structural facts that make every map gather-only:
  - stride-1 conv: output coords == input coords; for each kernel offset an
    output voxel has at most ONE input neighbour -> nbr[K, N].
  - stride-2 k=2 conv: output coords = unique(floor(in/2)); the input child
    at 2c+off exists at most once per offset -> down_nbr[2^D, N_out].
  - stride-2 k=2 transpose conv: each fine voxel has exactly one coarse
    parent and one kernel offset -> up_parent/up_offset[N_fine].
  - stride-2 k=3 conv: the input at 2c+off for off in {-1, 0, 1}^D exists
    at most once per offset -> down_nbr3[3^D, N_out] (windows overlap: a
    fine voxel has up to 2^D parents, so its adjoint is a scatter).

Missing neighbours point at the last padded row, whose features the device
ops keep at exactly zero.  Each gather map comes with its live order
(``live_order``): its output rows sorted by the taps at which they name a
real row, the order in which the gather GEMM tiles them (any order gives
the same sums; this one lets whole 16-row fragments skip a tap).  The
parent map comes with its up order (``up_order``): the fine rows sorted by
their offset, those whose parent is the coarse pad row last, the order in
which ``parent_gemm`` tiles them (a 128-row tile then spans one or two
offsets' weights instead of all eight).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np

from pointcontrast_tpu_torch.sparse.hashing import HashSpec
from pointcontrast_tpu_torch.sparse.kernel_map import (
    kernel_offsets,
    reversal_permutation,
)

_BUCKET_BASE = 256


def _shrink_idx(arr: np.ndarray, index_space: int) -> np.ndarray:
    """Downcast gather maps to uint16 when every index fits (halves the
    host->device bytes; the torch side widens them to int32)."""
    if arr is not None and index_space <= 65536:
        return arr.astype(np.uint16)
    return arr


def _ordered(m, npad_in: int, npad_out: int):
    """The live order of a map into an [npad_in] table (None for None)."""
    if m is None:
        return None
    return _shrink_idx(live_order(m, npad_in - 1), npad_out)


def up_order(up_parent: np.ndarray, up_offset: np.ndarray, pad: int,
             num_offsets: int = 8) -> np.ndarray:
    """[N] int32: the fine rows of a parent map sorted, stably, by their
    offset (one of ``num_offsets``), the rows whose parent is the coarse pad
    row ``pad`` (pad fine rows and the voxels truncation orphaned) last.
    One stable sort of num_offsets + 1 small keys (numpy's radix sort on
    uint8)."""
    key = np.where(up_parent == pad, num_offsets, up_offset).astype(np.uint8)
    return np.argsort(key, kind="stable").astype(np.int32)


def bucket_size(n: int, base: int = _BUCKET_BASE) -> int:
    """Smallest bucket strictly greater than n on a geometric {1, 1.5}*2^k
    grid."""
    b = base
    while b <= n:
        b = b * 3 // 2 if (b & (b - 1)) == 0 else (b // 3) * 4
    return b


@dataclasses.dataclass(frozen=True)
class Geometry:
    """A net's kernel regions: ``dimension``, the same-level region
    (``region``, with per-axis ``axis_types`` for 'hybrid') and the strided
    axes (``stride_axes``, None: all).  The 3-D nets take the default; the
    4-D ST nets ``HYBRID_4D`` (cube over space, cross over time: 29 taps)
    and the Tesseract ones ``TESSERACT_4D`` (the 81-tap hypercube), both
    halving space and never time.  ``pyramid_kwargs`` are
    ``build_pyramid``'s arguments for it, ``volumes`` the tap count of each
    of its convs."""

    dimension: int = 3
    region: str = "hypercube"
    axis_types: Optional[tuple] = None
    stride_axes: Optional[tuple] = None

    def pyramid_kwargs(self) -> dict:
        return dict(dimension=self.dimension, region=self.region,
                    axis_types=self.axis_types, stride_axes=self.stride_axes)

    def offsets(self, conv0_kernel_size: int = 3, block_kernel_size: int = 3) -> dict:
        """{"block", "stem", "down", "down3"}: the offsets of the
        same-level map ``nbr``, of the stem's ``nbr0`` (None where the stem
        reads ``nbr``), of the k2s2 ``down_nbr`` (child offsets on the
        strided axes, 0 on the others) and of the k3s2 ``down_nbr3``."""
        sa = (np.ones(self.dimension, bool) if self.stride_axes is None
              else np.asarray(self.stride_axes, bool))
        block = kernel_offsets(block_kernel_size, self.dimension, self.region,
                               axis_types=tuple(self.axis_types) if self.axis_types else None)
        stem = None
        if conv0_kernel_size != block_kernel_size or self.axis_types:
            ks0 = (conv0_kernel_size if sa.all()
                   else tuple(conv0_kernel_size if v else 1 for v in sa))
            stem = kernel_offsets(ks0, self.dimension, "hypercube")
        down = kernel_offsets(tuple(2 if v else 1 for v in sa), self.dimension, "hypercube")
        down3 = kernel_offsets(3, self.dimension, "hypercube")
        return {"block": block, "stem": stem, "down": down, "down3": down3}

    def volumes(self, conv0_kernel_size: int = 3, block_kernel_size: int = 3) -> dict:
        """{"block", "stem", "down", "down3"}: the taps of each conv (the
        stem's those of the map it reads, the transposed conv's the down
        map's)."""
        offs = self.offsets(conv0_kernel_size, block_kernel_size)
        if offs["stem"] is None:
            offs["stem"] = offs["block"]
        return {key: len(o) for key, o in offs.items()}


HYBRID_4D = Geometry(4, "hybrid", ("hypercube",) * 3 + ("hypercross",),
                     (True, True, True, False))
TESSERACT_4D = Geometry(4, "hypercube", None, (True, True, True, False))


@dataclasses.dataclass
class LevelTopo:
    """Static-shaped per-level gather maps (numpy on the host, torch tensors
    after ``PairBatch.to``).  K_down, the k2s2 maps' offsets: 2^D, or 2 to
    the number of strided axes (8 for the ST nets' (2, 2, 2, 1))."""

    nbr: Any = None  # [K, Npad] same-level map (chunked: [K, B, S])
    valid: Any = None  # [Npad] float32 mask
    batch: Any = None  # [Npad] int32 sample id
    down_nbr: Optional[Any] = None  # [K_down, Npad_next]: level l -> l+1
    up_parent: Optional[Any] = None  # [Npad]: idx into level l+1
    up_offset: Optional[Any] = None  # [Npad]: kernel offset id in [0, K_down)
    nbr0: Optional[Any] = None  # level-0 only: stem map when k != 3
    down_nbr3: Optional[Any] = None  # [3^D, Npad_next]: k3s2, build_down3
    # static offset-reversal permutations for nbr/nbr0: enable the
    # scatter-free conv backward
    rev: Optional[tuple] = None
    rev0: Optional[tuple] = None
    # each map's live order (``live_order``; chunked [B, S_out], flat
    # [Npad_out]): the row order in which the gather GEMM tiles its outputs
    nbr_order: Optional[Any] = None
    nbr0_order: Optional[Any] = None
    down_order: Optional[Any] = None
    down3_order: Optional[Any] = None
    # the parent map's up order (``up_order``; chunked [B, S], flat [Npad]):
    # the row order in which parent_gemm tiles the fine rows
    up_order: Optional[Any] = None


# (map, its live order): the LevelTopo fields ``live_order`` pairs
ORDERED_MAPS = (("nbr", "nbr_order"), ("nbr0", "nbr0_order"),
                ("down_nbr", "down_order"), ("down_nbr3", "down3_order"))


@dataclasses.dataclass
class Pyramid:
    levels: tuple
    num_batch: int = 1


@dataclasses.dataclass
class PyramidMeta:
    """Host-only metadata."""

    coords: list  # [Nl, 1+D] int32 level coords, padded rows excluded
    counts: list  # true voxel count per level
    npads: list  # padded size per level
    dimension: int
    truncated: list  # (level, n_dropped) pairs when allow_truncate kicked in


def _key_join(keys: np.ndarray, base: np.ndarray, off_keys: np.ndarray,
              pad: int) -> np.ndarray:
    """[K, len(base)] indices into ``keys``'s row order for every query
    ``base[i] + off_keys[k]``; misses map to ``pad`` (native hash table when
    available, sorted-key searchsorted otherwise)."""
    from pointcontrast_tpu_torch.sparse import native

    if native.get_lib() is not None:
        return native.query_map(keys, base, off_keys, pad)

    n = len(keys)
    qkeys = base[None, :].astype(np.int64) + off_keys[:, None]  # [K, M]
    if n == 0:
        return np.full(qkeys.shape, pad, dtype=np.int32)
    order = np.argsort(keys)
    skeys = keys[order]
    pos = np.searchsorted(skeys, qkeys.ravel()).reshape(qkeys.shape)
    pos_c = np.minimum(pos, n - 1)
    found = skeys[pos_c] == qkeys
    return np.where(found, order[pos_c], pad).astype(np.int32)


def live_order(m: np.ndarray, pad: int) -> np.ndarray:
    """[N] int32: the output rows of a [K, N] gather map sorted, stably and
    tap 0 first, by the taps at which they name a row other than the pad
    row ``pad``.  Rows that gather at the same taps then sit side by side,
    so the gather GEMM's 16-row fragments skip a tap as a whole where none
    of their rows is live there (level 0's rows lie in first-occurrence
    order, where nearly every 16 consecutive rows hold a live row at every
    tap)."""
    live = np.packbits(m != pad, axis=0)  # [ceil(K / 8), N], tap 0 the top bit
    return np.lexsort(live[::-1]).astype(np.int32)


def _same_level_map(coords: np.ndarray, offsets: np.ndarray,
                    npad: int) -> np.ndarray:
    """nbr[K, npad]: index of the voxel at coords[j] + offsets[k], else the
    pad row (npad-1)."""
    n = len(coords)
    pad = npad - 1
    max_off = int(np.abs(offsets).max()) if len(offsets) else 0
    spec = HashSpec.from_coords(coords, margin=max_off + 1)
    keys = spec.encode(coords)  # [N]
    off_keys = offsets.astype(np.int64) @ spec.stride[1:]  # [K]

    out = np.full((len(offsets), npad), pad, dtype=np.int32)
    out[:, :n] = _key_join(keys, keys, off_keys, pad)
    return out


def _downsample(coords: np.ndarray, stride_axes: np.ndarray | None = None):
    """Unique coarse coords (floor(c/2) on the strided axes, ``stride_axes``
    a bool mask or None for all, c on the others) + per-fine parent index
    & offset."""
    coarse_of_fine = coords.copy()
    scale = 2 if stride_axes is None else np.where(stride_axes, 2, 1)[None, :]
    coarse_of_fine[:, 1:] = np.floor_divide(coords[:, 1:], scale)
    spec = HashSpec.from_coords(coarse_of_fine)
    child_off = (coords[:, 1:] - scale * coarse_of_fine[:, 1:]).astype(np.int32)

    if stride_axes is None and coords.shape[1] == 4:
        from pointcontrast_tpu_torch.sparse import native

        if native.get_lib() is not None:
            coarse, parent = native.downsample(coords, spec.lo, spec.stride)
            return coarse, parent, child_off

    keys = spec.encode(coarse_of_fine)
    _, first_idx, inverse = np.unique(keys, return_index=True,
                                      return_inverse=True)
    # Keep coarse voxels in first-occurrence (input) order for determinism.
    perm = np.argsort(first_idx, kind="stable")  # rank -> slot order
    slot_of_rank = np.empty_like(perm)
    slot_of_rank[perm] = np.arange(len(perm))
    coarse = coarse_of_fine[np.sort(first_idx)]
    parent = slot_of_rank[inverse].astype(np.int32)  # fine -> coarse slot
    return coarse, parent, child_off


def build_pyramid(
    coords: np.ndarray,
    num_levels: int,
    dimension: int = 3,
    conv0_kernel_size: int = 3,
    block_kernel_size: int = 3,
    npads: list | None = None,
    num_batch: int | None = None,
    allow_truncate: bool = True,
    build_down3: bool = False,
    first_nbr_level: int = 0,
    region: str = "hypercube",
    axis_types: tuple | None = None,
    stride_axes: tuple | None = None,
):
    """Build the full coordinate pyramid for a sparse U-Net.

    coords: [N, 1+dimension] unique batched voxel coords (batch index first).
    npads: padded sizes per level (default: bucket_size).
    allow_truncate: drop coarse voxels beyond a level's pad instead of
      raising (meta.truncated records (level, n_dropped)).
    build_down3: also build the kernel-3 stride-2 maps ``down_nbr3`` of the
      ResNet family's strided blocks.
    first_nbr_level: build no same-level maps below this level (the brick
      layout reads level l's conv geometry from level l+1's map, so it
      never needs level 0's, the largest).
    region, axis_types: the same-level kernel region ('hybrid': per-axis
      'hypercube' / 'hypercross', the 4-D ST nets' cube over space and
      cross over time).
    stride_axes: per-axis bool, False = never downsampled (the ST nets'
      (2, 2, 2, 1)); the k2s2 maps then take the strided axes' children
      only, and the stem map ``nbr0``, built whenever ``axis_types`` is
      set, spans only those axes.  ``Geometry`` holds the three.

    Returns (Pyramid, PyramidMeta)."""
    coords = np.asarray(coords)
    if coords.ndim != 2 or coords.shape[1] != dimension + 1:
        raise ValueError(f"coords must be [N, {dimension + 1}], got {coords.shape}")
    coords = coords.astype(np.int32)
    if num_batch is None:
        num_batch = int(coords[:, 0].max()) + 1 if len(coords) else 1

    geometry = Geometry(dimension, region, axis_types, stride_axes)
    offsets = geometry.offsets(conv0_kernel_size, block_kernel_size)
    offs3, offs2 = offsets["block"], offsets["down"]
    sa = np.asarray(stride_axes if stride_axes is not None else [True] * dimension, bool)
    stride_vec = None if sa.all() else sa

    levels = []
    meta_coords, meta_counts, meta_npads, truncated = [], [], [], []
    cur = coords
    for lvl in range(num_levels):
        n = len(cur)
        npad = npads[lvl] if npads is not None else bucket_size(n)
        if npad <= n:
            raise ValueError(f"level {lvl}: npad {npad} must exceed count {n}")

        nbr = (_same_level_map(cur, offs3, npad)
               if lvl >= first_nbr_level else None)
        valid = np.zeros(npad, dtype=np.float32)
        valid[:n] = 1.0
        batch = np.full(npad, num_batch, dtype=np.int32)
        batch[:n] = cur[:, 0]

        nbr0 = None
        rev0 = None
        if lvl == 0 and first_nbr_level == 0 and offsets["stem"] is not None:
            nbr0 = _same_level_map(cur, offsets["stem"], npad)
            rev0 = reversal_permutation(offsets["stem"])

        level = dict(
            nbr=_shrink_idx(nbr, npad), valid=valid, batch=batch,
            nbr0=_shrink_idx(nbr0, npad),
            rev=reversal_permutation(offs3) if nbr is not None else None,
            rev0=rev0,
            nbr_order=_ordered(nbr, npad, npad),
            nbr0_order=_ordered(nbr0, npad, npad),
        )
        meta_coords.append(cur)
        meta_counts.append(n)
        meta_npads.append(npad)

        if lvl < num_levels - 1:
            coarse, parent, child_off = _downsample(cur, stride_vec)
            nc = len(coarse)
            npad_next = npads[lvl + 1] if npads is not None else bucket_size(nc)
            if npad_next <= nc:
                if not allow_truncate:
                    raise ValueError(
                        f"level {lvl + 1}: npad {npad_next} must exceed count {nc}"
                    )
                # Graceful truncation: keep the first npad-1 coarse voxels;
                # orphaned fine voxels point at the coarse pad row.
                limit = npad_next - 1
                coarse = coarse[:limit]
                dropped = parent >= limit
                parent = np.where(dropped, limit, parent).astype(np.int32)
                child_off = np.where(dropped[:, None], 0, child_off).astype(np.int32)
                truncated.append((lvl + 1, nc - limit))
                nc = limit
            up_parent = np.full(npad, npad_next - 1, dtype=np.int32)
            up_parent[:n] = parent
            up_offset = np.zeros(npad, dtype=np.int32)
            pow2 = 1 << np.arange(dimension)
            lut = np.full(1 << dimension, -1, dtype=np.int32)
            lut[offs2 @ pow2] = np.arange(len(offs2), dtype=np.int32)
            up_offset[:n] = lut[child_off @ pow2]
            # down_nbr built from the coarse (output) side: the child at
            # c * (2 on the strided axes, 1 on the others) + off.
            down_nbr = np.full((len(offs2), npad_next), npad - 1, dtype=np.int32)
            fine_spec = HashSpec.from_coords(cur, margin=2)
            fine_keys = fine_spec.encode(cur)
            doubled = coarse.astype(np.int64).copy()
            doubled[:, 1:] *= np.where(sa, 2, 1)[None, :]
            base = fine_spec.encode(doubled)  # [nc]
            off_keys = offs2.astype(np.int64) @ fine_spec.stride[1:]
            down_nbr[:, :nc] = _key_join(fine_keys, base, off_keys, npad - 1)

            level.update(
                down_nbr=_shrink_idx(down_nbr, npad),
                up_parent=_shrink_idx(up_parent, npad_next),
                up_offset=up_offset.astype(np.uint16),
                down_order=_ordered(down_nbr, npad, npad_next),
                up_order=_shrink_idx(up_order(up_parent, up_offset, npad_next - 1,
                                              len(offs2)), npad),
            )
            if build_down3:
                offs3s = offsets["down3"]
                off3_keys = offs3s.astype(np.int64) @ fine_spec.stride[1:]
                down_nbr3 = np.full((len(offs3s), npad_next), npad - 1, dtype=np.int32)
                down_nbr3[:, :nc] = _key_join(fine_keys, base, off3_keys, npad - 1)
                level.update(down_nbr3=_shrink_idx(down_nbr3, npad),
                             down3_order=_ordered(down_nbr3, npad, npad_next))
            cur = coarse
        levels.append(LevelTopo(**level))

    pyramid = Pyramid(levels=tuple(levels), num_batch=num_batch)
    meta = PyramidMeta(
        coords=meta_coords, counts=meta_counts, npads=meta_npads,
        dimension=dimension, truncated=truncated,
    )
    return pyramid, meta
