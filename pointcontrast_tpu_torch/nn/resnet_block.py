"""Residual blocks for sparse U-Nets (port of
``pointcontrast_tpu/nn/resnet_block.py::BasicBlock``): two k=3 convs,
expansion 1, and a 1x1 conv + norm shortcut whenever the channel count
changes.  Submodules ``conv1``/``norm1``/``conv2``/``norm2`` hold the flax
``SparseConv_0``/``MaskedBatchNorm_0``/``SparseConv_1``/``MaskedBatchNorm_1``;
``downsample_conv``/``downsample_norm`` keep their flax names."""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparseLinear,
    relu,
)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseConv(inplanes, planes, kernel_volume, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        if inplanes != out:
            self.downsample_conv = SparseLinear(inplanes, out, bias=False,
                                                generator=generator)
            self.downsample_norm = MaskedBatchNorm(out, bn_momentum)
        else:
            self.downsample_conv = self.downsample_norm = None

    def forward(self, x, nbr, valid, rev=None):
        out = relu(self.norm1(self.conv1(x, nbr, valid, rev), valid))
        out = self.norm2(self.conv2(out, nbr, valid, rev), valid)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid)
        else:
            residual = x
        return relu(out + residual)
