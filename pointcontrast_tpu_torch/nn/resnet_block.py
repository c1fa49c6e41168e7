"""Residual blocks for sparse U-Nets (port of
``pointcontrast_tpu/nn/resnet_block.py``): ``BasicBlock`` (two k=3 convs,
expansion 1), ``Bottleneck`` (1x1 - k=3 - 1x1, expansion 4) and
``BasicBlockINBN`` (InstanceNorm + BatchNorm), each with a 1x1 conv + norm
shortcut whenever the channel count changes.

Submodules carry the port's names (``conv1``, ``norm1``, ...); each class's
``FLAX_NAMES`` maps the flax auto-names of its JAX twin to them, in the
order flax numbers its layers, and ``tools.from_jax`` renames by the block
class it meets.  ``downsample_conv``/``downsample_norm`` (and the INBN
norms) keep their flax names."""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparseInstanceNorm,
    SparseLinear,
    relu,
)


class InstanceBatchNorm(nn.Module):
    """InstanceNorm followed by BatchNorm (reference NormType
    INSTANCE_BATCH_NORM); submodules ``inorm`` and ``bnorm`` as in flax."""

    def __init__(self, num_features: int, momentum: float = 0.05):
        super().__init__()
        self.inorm = SparseInstanceNorm(num_features)
        self.bnorm = MaskedBatchNorm(num_features, momentum)

    def forward(self, x, valid, batch, num_batch: int):
        return self.bnorm(self.inorm(x, valid, batch, num_batch), valid)


def _shortcut(block, inplanes, out, bn_momentum, generator, norm=MaskedBatchNorm):
    if inplanes != out:
        block.downsample_conv = SparseLinear(inplanes, out, bias=False,
                                             generator=generator)
        block.downsample_norm = norm(out, bn_momentum)
    else:
        block.downsample_conv = block.downsample_norm = None


class BasicBlock(nn.Module):
    expansion = 1
    FLAX_NAMES = {"SparseConv_0": "conv1", "MaskedBatchNorm_0": "norm1",
                  "SparseConv_1": "conv2", "MaskedBatchNorm_1": "norm2"}

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, kernel_volume, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        _shortcut(self, inplanes, planes * self.expansion, bn_momentum, generator)

    def forward(self, x, nbr, valid, rev=None, batch=None, num_batch: int = 1,
                order=None):
        out = relu(self.norm1(self.conv1(x, nbr, valid, rev, order=order), valid))
        out = self.norm2(self.conv2(out, nbr, valid, rev, order=order), valid)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid)
        else:
            residual = x
        return relu(out + residual)


class Bottleneck(nn.Module):
    expansion = 4
    FLAX_NAMES = {"SparseLinear_0": "conv1", "MaskedBatchNorm_0": "norm1",
                  "SparseConv_0": "conv2", "MaskedBatchNorm_1": "norm2",
                  "SparseLinear_1": "conv3", "MaskedBatchNorm_2": "norm3"}

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseLinear(inplanes, planes, bias=False, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        self.conv3 = SparseLinear(planes, out, bias=False, generator=generator)
        self.norm3 = MaskedBatchNorm(out, bn_momentum)
        _shortcut(self, inplanes, out, bn_momentum, generator)

    def forward(self, x, nbr, valid, rev=None, batch=None, num_batch: int = 1,
                order=None):
        out = relu(self.norm1(self.conv1(x, valid), valid))
        out = relu(self.norm2(self.conv2(out, nbr, valid, rev, order=order), valid))
        out = self.norm3(self.conv3(out, valid), valid)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid)
        else:
            residual = x
        return relu(out + residual)


class BasicBlockINBN(nn.Module):
    """BasicBlock with InstanceNorm + BatchNorm (reference BasicBlockINBN)."""

    expansion = 1
    FLAX_NAMES = {"SparseConv_0": "conv1", "SparseConv_1": "conv2"}

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, kernel_volume, generator=generator)
        self.norm1 = InstanceBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = InstanceBatchNorm(planes, bn_momentum)
        _shortcut(self, inplanes, planes * self.expansion, bn_momentum, generator,
                  norm=InstanceBatchNorm)

    def forward(self, x, nbr, valid, rev=None, batch=None, num_batch: int = 1,
                order=None):
        out = self.conv1(x, nbr, valid, rev, order=order)
        out = relu(self.norm1(out, valid, batch, num_batch))
        out = self.norm2(self.conv2(out, nbr, valid, rev, order=order), valid, batch, num_batch)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid,
                                            batch, num_batch)
        else:
            residual = x
        return relu(out + residual)
