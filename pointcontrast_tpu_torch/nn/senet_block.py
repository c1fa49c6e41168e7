"""Squeeze-and-Excitation sparse blocks (port of
``pointcontrast_tpu/nn/senet_block.py``).

``SELayer``: per-sample global average pool -> FC bottleneck -> ReLU -> FC
-> sigmoid gate -> broadcast back to the rows and multiply.  ``SEBasicBlock``
and ``SEBottleneck`` gate their residual branch after its last norm.  The
FCs are ``nn.Linear`` (weights [out, in]; ``tools.from_jax`` transposes the
flax ``Dense`` kernels, [in, out]), initialised as flax's ``Dense``
(LeCun-normal truncated at 2 std, zero bias).  ``FLAX_NAMES`` maps the flax
auto-names of each block's layers to the port's names, as in
``nn.resnet_block``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from pointcontrast_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparseLinear,
    relu,
)
from pointcontrast_tpu_torch.nn.resnet_block import _shortcut
from pointcontrast_tpu_torch.sparse import ops


def _dense(cin: int, cout: int, generator: torch.Generator | None) -> nn.Linear:
    fc = nn.Linear(cin, cout)
    std = math.sqrt(1.0 / cin) / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(fc.weight, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
        fc.bias.zero_()
    return fc


class SELayer(nn.Module):
    def __init__(self, channel: int, reduction: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        hidden = max(channel // reduction, 1)
        self.fc1 = _dense(channel, hidden, generator)
        self.fc2 = _dense(hidden, channel, generator)

    def forward(self, x, valid, batch, num_batch: int):
        y = ops.global_pool(x, batch, num_batch, average=True)  # [B, C]
        y = torch.sigmoid(self.fc2(relu(self.fc1(y))))
        return x * ops.broadcast_to_points(y, batch, valid)


class SEBasicBlock(nn.Module):
    expansion = 1
    FLAX_NAMES = {"SparseConv_0": "conv1", "MaskedBatchNorm_0": "norm1",
                  "SparseConv_1": "conv2", "MaskedBatchNorm_1": "norm2"}

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05, reduction: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.conv1 = SparseConv(inplanes, planes, kernel_volume, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        self.se = SELayer(planes, reduction, generator=generator)
        _shortcut(self, inplanes, planes * self.expansion, bn_momentum, generator)

    def forward(self, x, nbr, valid, rev=None, batch=None, num_batch: int = 1,
                order=None):
        out = relu(self.norm1(self.conv1(x, nbr, valid, rev, order=order), valid))
        out = self.norm2(self.conv2(out, nbr, valid, rev, order=order), valid)
        out = self.se(out, valid, batch, num_batch)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid)
        else:
            residual = x
        return relu(out + residual)


class SEBottleneck(nn.Module):
    expansion = 4
    FLAX_NAMES = {"SparseLinear_0": "conv1", "SparseConv_0": "conv2",
                  "SparseLinear_1": "conv3"}

    def __init__(self, inplanes: int, planes: int, kernel_volume: int = 27,
                 bn_momentum: float = 0.05, reduction: int = 16,
                 generator: torch.Generator | None = None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = SparseLinear(inplanes, planes, bias=False, generator=generator)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.conv2 = SparseConv(planes, planes, kernel_volume, generator=generator)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        self.conv3 = SparseLinear(planes, out, bias=False, generator=generator)
        self.norm3 = MaskedBatchNorm(out, bn_momentum)
        self.se = SELayer(out, reduction, generator=generator)
        _shortcut(self, inplanes, out, bn_momentum, generator)

    def forward(self, x, nbr, valid, rev=None, batch=None, num_batch: int = 1,
                order=None):
        out = relu(self.norm1(self.conv1(x, valid), valid))
        out = relu(self.norm2(self.conv2(out, nbr, valid, rev, order=order), valid))
        out = self.norm3(self.conv3(out, valid), valid)
        out = self.se(out, valid, batch, num_batch)
        if self.downsample_conv is not None:
            residual = self.downsample_norm(self.downsample_conv(x, valid), valid)
        else:
            residual = x
        return relu(out + residual)
