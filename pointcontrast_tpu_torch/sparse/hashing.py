"""Collision-free integer hashing of voxel coordinates (host side).

The reference delegates coordinate hashing to MinkowskiEngine's C++ coordinate
manager (used via ``ME.utils.sparse_quantize`` and ``ME.SparseTensor``; see
the reference's pretrain/pointcontrast/lib/ddp_data_loaders.py:228-229).  Here
coordinates are packed into a single ``int64`` key by a mixed-radix encoding
over the per-column extents, which is exact (no collisions) for any realistic
scene: ScanNet at 2.5 cm spans ~2^9 voxels per axis, so even a batch axis of
2^10 stays far below 2^63.
"""
from __future__ import annotations

# Jax-free copy of pointcontrast_tpu/sparse/hashing.py (behaviour unchanged).

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class HashSpec:
    """Mixed-radix encoding of integer coordinate rows.

    ``lo``/``hi`` bound the coordinates the spec can encode (inclusive lo,
    exclusive hi); ``margin`` widens the box so that keys can also be computed
    for coordinates shifted by kernel offsets without re-deriving a spec.
    """

    lo: np.ndarray  # [C] int64, inclusive lower bound per column
    radix: np.ndarray  # [C] int64, extent per column
    stride: np.ndarray  # [C] int64, mixed-radix multipliers

    @staticmethod
    def from_coords(coords: np.ndarray, margin: int = 0) -> "HashSpec":
        coords = np.asarray(coords)
        if coords.ndim != 2:
            raise ValueError(f"coords must be [N, C], got {coords.shape}")
        lo = coords.min(axis=0).astype(np.int64) - margin
        hi = coords.max(axis=0).astype(np.int64) + margin + 1
        radix = hi - lo
        # Little-endian strides: last column varies fastest. Use Python ints
        # for the overflow check (int64 would silently wrap).
        total = 1
        for r in radix:
            total *= int(r)
        if total >= 1 << 62:
            raise ValueError(
                f"coordinate box too large to hash exactly: {radix} -> {total}"
            )
        stride = np.ones_like(radix)
        for i in range(len(radix) - 2, -1, -1):
            stride[i] = stride[i + 1] * radix[i + 1]
        return HashSpec(lo=lo, radix=radix, stride=stride)

    def encode(self, coords: np.ndarray) -> np.ndarray:
        """[..., C] int coords -> [...] int64 keys. Exact inverse-free packing."""
        c = coords.astype(np.int64) - self.lo
        return (c * self.stride).sum(axis=-1)


def hash_coords(coords: np.ndarray, margin: int = 0):
    """Convenience: build a spec from ``coords`` and return (keys, spec)."""
    spec = HashSpec.from_coords(coords, margin=margin)
    return spec.encode(coords), spec
