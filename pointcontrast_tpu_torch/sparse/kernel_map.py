"""Kernel region enumeration: the ``ME.KernelGenerator`` replacement.

The reference builds kernel regions through ``ME.KernelGenerator`` with
HYPERCUBE / HYPERCROSS / HYBRID region types
(the reference's pretrain/pointcontrast/model/modules/common.py:117-167).
Here a kernel is just its list of integer offsets, enumerated host-side; the
device-side conv consumes one gather-index row per offset.

Conventions (all in *level units*, i.e. the tensor-stride-normalized lattice):
  - odd kernel size k: offsets in [-(k//2), k//2]
  - even kernel size k: offsets in [0, k)   (matches ME's stride-2 k=2 convs,
    where output voxel c covers input children 2c + {0,1}^D)
  - first axis varies fastest (x-fastest order)
"""
from __future__ import annotations

# Jax-free copy of pointcontrast_tpu/sparse/kernel_map.py: the offset order
# and reversal_permutation must stay identical (weights are shared by index).

import functools
import itertools

import numpy as np


def _axis_offsets(k: int, dilation: int = 1) -> list[int]:
    if k % 2 == 1:
        return [d * dilation for d in range(-(k // 2), k // 2 + 1)]
    return [d * dilation for d in range(k)]


@functools.lru_cache(maxsize=None)
def kernel_offsets(
    kernel_size,
    dimension: int = 3,
    region: str = "hypercube",
    dilation: int = 1,
    axis_types: tuple | None = None,
) -> np.ndarray:
    """Enumerate kernel offsets as an [K, dimension] int32 array.

    Args:
      kernel_size: int or tuple of per-axis ints.
      region: 'hypercube' | 'hypercross' | 'hybrid' (per-axis ``axis_types``).
      axis_types: for 'hybrid', a tuple of 'hypercube'/'hypercross' per axis
        (reference: spatial hypercube x temporal hypercross for 4D nets).
    """
    if isinstance(kernel_size, int):
        ks = (kernel_size,) * dimension
    else:
        ks = tuple(kernel_size)
        if len(ks) != dimension:
            raise ValueError(f"kernel_size {ks} does not match dimension {dimension}")

    if region == "hypercube":
        per_axis = [_axis_offsets(k, dilation) for k in ks]
        # x-fastest: iterate the last axis in the outer loop.
        combos = itertools.product(*reversed(per_axis))
        offs = np.array([tuple(reversed(c)) for c in combos], dtype=np.int32)
        offs.flags.writeable = False  # lru_cache shares the array
        return offs
    if region == "hypercross":
        offs = [np.zeros(dimension, dtype=np.int32)]
        for d in range(dimension):
            for o in _axis_offsets(ks[d], dilation):
                if o == 0:
                    continue
                v = np.zeros(dimension, dtype=np.int32)
                v[d] = o
                offs.append(v)
        out = np.stack(offs)
        out.flags.writeable = False  # lru_cache shares the array
        return out
    if region == "hybrid":
        if axis_types is None:
            raise ValueError("hybrid region requires axis_types")
        # ME's HYBRID region (ME 0.4.x Common.py::convert_region_type, the
        # path reference models/modules/common.py:111-117 takes for
        # SPATIAL_HYPERCUBE_TEMPORAL_HYPERCROSS): the offset list is the
        # hypercube PRODUCT over the cube axes with every cross axis held at
        # 0, followed by the one-hot cross-axis deviations (center excluded).
        # Kernel volume = prod(cube ks) + sum(cross ks - 1)  -- e.g. the 4D
        # ST nets' k=3 block convs carry 3*3*3 + 2 = 29 weights, NOT the
        # 81-offset cube x cross product.  Enumeration order reproduces ME's
        # list construction: each successive cube axis is expanded in the
        # inner loop, so LATER cube axes vary fastest (unlike the C++
        # HYPERCUBE iterator's x-fastest order); cross deviations follow in
        # ascending per-axis offset order.
        base = [np.zeros(dimension, dtype=np.int32)]
        for d, t in enumerate(axis_types):
            if t != "hypercube":
                continue
            base = [
                np.concatenate([off[:d], [o], off[d + 1:]]).astype(np.int32)
                for off in base
                for o in _axis_offsets(ks[d], dilation)
            ]
        for d, t in enumerate(axis_types):
            if t != "hypercross":
                continue
            for o in _axis_offsets(ks[d], dilation):
                if o == 0:
                    continue
                v = np.zeros(dimension, dtype=np.int32)
                v[d] = o
                base.append(v)
        out = np.stack(base)
        out.flags.writeable = False  # lru_cache shares the array
        return out
    raise ValueError(f"unknown region type: {region}")


def offset_index(offsets: np.ndarray) -> dict:
    """Map each offset tuple to its row index in ``offsets``."""
    return {tuple(int(v) for v in o): i for i, o in enumerate(offsets)}


def reversal_permutation(offsets: np.ndarray) -> tuple:
    """rev with offsets[rev[k]] == -offsets[k], or None if the set is not
    centrally symmetric (then the conv's adjoint is not a conv over the same
    map and callers must fall back to autodiff).

    For symmetric same-level kernels this is what makes the conv backward a
    *gather* instead of a scatter: the adjoint of 'read my neighbor at +o'
    is 'read my neighbor at -o'."""
    idx = offset_index(offsets)
    rev = []
    for o in offsets:
        key = tuple(int(-v) for v in o)
        if key not in idx:
            return None
        rev.append(idx[key])
    return tuple(rev)
