"""Bilateral / trilateral mean-field CRF wrappers (port of
``pointcontrast_tpu/semseg/crf.py``).

The segmentation logits are refined by mean-field iterations of softmax ->
pairwise sparse conv in a bilateral grid -> + unary.  The grid lives in 6-D,
floor(xyz / sigma_s) (+) floor(rgb / sigma_c) (7-D with time); its
neighbour map is built on the host with the pyramid's own hash join, so the
filter is a flat-map ``sparse_conv`` (``ops._ConvChunkDownFused`` at
B = 1: gather_gemm forward, scatter_gemm / gather_wgrad backward, any
number of taps; their bf16 forms on a bf16 backbone's logits).

The reference skips the filter with p = 0.5 during training to keep the
backbone filter-invariant; callers choose with ``apply_filter``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from pointcontrast_tpu_torch.sparse import ops
from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets
from pointcontrast_tpu_torch.sparse.topology import _same_level_map


def build_bilateral_map(
    coords: np.ndarray,  # [N, 1+3] int (batch, x, y, z) voxel coords
    colors: np.ndarray,  # [N, 3] in [0, 255]
    npad: int,
    spatial_sigma: float = 1.0,
    chromatic_sigma: float = 12.0,
    kernel_size: int = 3,
    region: str = "hypercross",
    time_coords: np.ndarray | None = None,
    temporal_sigma: float = 1.0,
    rows: np.ndarray | None = None,
) -> np.ndarray:
    """Neighbour map over the (tri)lateral grid -> [K, npad] int32: batch
    (+) floor(spatial / sigma_s) (+) floor(colour / sigma_c) (+)
    floor(t / sigma_t).

    rows: voxel i lives at feature row ``rows[i]`` (the chunked layout's
    slice rows).  The map is then FLAT over those rows, with missing
    neighbours and unoccupied rows pointing at the global pad row npad - 1,
    a zero row in every layout."""
    cols = [
        coords[:, :1],
        np.floor(coords[:, 1:4] / spatial_sigma).astype(np.int32),
        np.floor(colors / chromatic_sigma).astype(np.int32),
    ]
    if time_coords is not None:
        cols.append(np.floor(time_coords[:, None] / temporal_sigma).astype(np.int32))
    grid = np.concatenate(cols, axis=1).astype(np.int32)
    offs = kernel_offsets(kernel_size, grid.shape[1] - 1, region)
    if rows is None:
        return _same_level_map(grid, offs, npad)
    n = len(grid)
    packed = _same_level_map(grid, offs, n + 1)  # pad index == n
    rows = np.asarray(rows, np.int64)
    trans = np.concatenate([rows, [npad - 1]]).astype(np.int32)
    out = np.full((len(offs), npad), npad - 1, dtype=np.int32)
    out[:, rows] = trans[packed[:, :n]]
    return out


class MeanFieldCRF(nn.Module):
    """Mean-field iterations with a learned pairwise kernel ``weight``
    [K, C, C] (flax ``kernel``, initialised N(0, 0.1))."""

    def __init__(self, nchannels: int, kernel_volume: int,
                 meanfield_iterations: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.meanfield_iterations = meanfield_iterations
        w = torch.empty(kernel_volume, nchannels, nchannels)
        with torch.no_grad():
            w.normal_(0.0, 0.1, generator=generator)
        self.weight = nn.Parameter(w)

    def forward(self, unary, crf_nbr, valid):
        # in the unary's dtype, as JAX's kernel.astype (bf16: the flat
        # conv's bf16 forms; the parameter stays f32)
        w = self.weight.to(unary.dtype)
        out = unary
        for _ in range(self.meanfield_iterations):
            out = ops.mask_rows(torch.softmax(out, dim=1), valid)
            out = ops.sparse_conv(out, crf_nbr, w, valid_out=valid)
            out = out + unary
        return out


class Wrapper(nn.Module):
    """Backbone + CRF filter.  The backbone is any registry model; the CRF
    map comes with the batch (``SemsegBatch.crf_nbr``)."""

    def __init__(self, net: nn.Module, nchannels: int, kernel_volume: int,
                 meanfield_iterations: int = 10,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.net = net
        self.filter = MeanFieldCRF(nchannels, kernel_volume, meanfield_iterations,
                                   generator=generator)

    def forward(self, features, pyramid, crf_nbr, apply_filter: bool = True):
        logits = self.net(features, pyramid)
        if not apply_filter:
            return logits
        return self.filter(logits, crf_nbr, pyramid.levels[0].valid)


class BilateralCRF(Wrapper):
    """6-D grid: spatial + chromatic."""


class TrilateralCRF(Wrapper):
    """7-D grid: spatial + chromatic + temporal."""
