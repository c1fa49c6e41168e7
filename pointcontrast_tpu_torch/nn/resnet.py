"""ResNet family: strided sparse residual encoders (port of
``pointcontrast_tpu/nn/resnet.py``, the 3-D classes).

stem conv -> BN -> ReLU -> k2s2 sum pool to level 1 -> 4 stride-2 residual
layers -> 1x1 head at pixel distance 32 (level 5).  The first block of each
layer (``_StridedBlock``) carries the stride: a kernel-3 stride-2 conv over
the ``down_nbr3`` map and a 1x1 stride-2 shortcut over the centre child of
the k2s2 map (``down_nbr[0:1]``).  Both run through K4, as in JAX, and so
does a BasicBlock-shaped strided block's second conv, to which JAX passes no
``rev``.  Needs a chunked pyramid of at least 6 levels built with
``build_down3=True``.  Submodules carry the flax names (``conv1``, ``bn1``,
``layer1_0``, ``final``).  ``dtype`` (None: the input features') is the
activations' dtype, as in ``res16unet``: in bf16 the K4 convs and the sum
pool run their bf16 forms.  The tap counts come from the class's
``GEOMETRY``, as in ``res16unet``: the 4-D ``STResNet*`` (``HYBRID_4D``)
and ``STResTesseractNet*`` (``TESSERACT_4D``) classes of JAX
``nn/resnet.py:171-222``, whose strided blocks read an 81-tap ``down_nbr3``
(a (3, 3, 3, 3) window about the doubled spatial coords) through K4 in tap
groups.
"""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparseLinear,
    relu,
)
from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock, Bottleneck
from pointcontrast_tpu_torch.sparse import ops
from pointcontrast_tpu_torch.sparse.topology import HYBRID_4D, TESSERACT_4D, Geometry

NUM_LEVELS = 6  # strides 1, 2, 4, 8, 16, 32


class _StridedBlock(nn.Module):
    """First block of a stride-2 layer, BasicBlock- or Bottleneck-shaped.
    Its flax submodules are all named explicitly, so ``FLAX_NAMES`` is
    empty."""

    FLAX_NAMES: dict = {}

    def __init__(self, inplanes: int, planes: int, bottleneck: bool,
                 bn_momentum: float = 0.05, kernel_volume: int = 27,
                 down_volume: int = 27, generator: torch.Generator | None = None):
        """``kernel_volume``: the same-level map's taps; ``down_volume``:
        ``down_nbr3``'s (27 in 3-D, 81 in 4-D)."""
        super().__init__()
        g = generator
        self.bottleneck = bottleneck
        out = planes * (4 if bottleneck else 1)
        if bottleneck:
            # 1x1 s1 (fine level) -> 3x3 s2 (down_nbr3) -> 1x1
            self.conv1 = SparseLinear(inplanes, planes, bias=False, generator=g)
            self.conv2 = SparseConv(planes, planes, down_volume, generator=g)
            self.conv3 = SparseLinear(planes, out, bias=False, generator=g)
            self.norm3 = MaskedBatchNorm(out, bn_momentum)
        else:
            # 3x3 s2 -> 3x3 s1
            self.conv1 = SparseConv(inplanes, planes, down_volume, generator=g)
            self.conv2 = SparseConv(planes, planes, kernel_volume, generator=g)
        self.norm1 = MaskedBatchNorm(planes, bn_momentum)
        self.norm2 = MaskedBatchNorm(planes, bn_momentum)
        self.downsample_conv = SparseConv(inplanes, out, 1, generator=g)
        self.downsample_norm = MaskedBatchNorm(out, bn_momentum)

    def forward(self, x, down_nbr3, down_center, nbr_out, valid_in, valid_out,
                orders=(None, None, None)):
        """``orders``: the live orders of down_nbr3, down_center and
        nbr_out."""
        order3, order_c, order_out = orders
        if self.bottleneck:
            out = relu(self.norm1(self.conv1(x, valid_in), valid_in))
            out = relu(self.norm2(self.conv2(out, down_nbr3, valid_out, order=order3),
                                  valid_out))
            out = self.norm3(self.conv3(out, valid_out), valid_out)
        else:
            out = relu(self.norm1(self.conv1(x, down_nbr3, valid_out, order=order3),
                                  valid_out))
            out = self.norm2(self.conv2(out, nbr_out, valid_out, order=order_out),
                             valid_out)
        residual = self.downsample_norm(
            self.downsample_conv(x, down_center, valid_out, order=order_c), valid_out)
        return relu(out + residual)


class ResNetBase(nn.Module):
    BLOCK = None  # BasicBlock or Bottleneck (the stride-1 blocks)
    LAYERS = ()
    INIT_DIM = 64
    PLANES = (64, 128, 256, 512)
    OUT_PIXEL_DIST = 32
    GEOMETRY = Geometry()

    def __init__(self, in_channels: int, out_channels: int,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        g = generator
        vol = self.GEOMETRY.volumes(conv1_kernel_size)
        k3 = vol["block"]
        bottleneck = self.BLOCK is Bottleneck
        self.conv1 = SparseConv(in_channels, self.INIT_DIM, vol["stem"], generator=g)
        self.bn1 = MaskedBatchNorm(self.INIT_DIM, bn_momentum)
        c = self.INIT_DIM
        for i, planes in enumerate(self.PLANES):
            self.add_module(f"layer{i + 1}_0", _StridedBlock(
                c, planes, bottleneck, bn_momentum, k3, vol["down3"], generator=g))
            c = planes * self.BLOCK.expansion
            for b in range(1, self.LAYERS[i]):
                self.add_module(f"layer{i + 1}_{b}", self.BLOCK(
                    c, planes, k3, bn_momentum, generator=g))
        self.final = SparseLinear(c, out_channels, bias=True, generator=g)

    def forward(self, features, pyramid):
        """features: [B*S_0, in_channels] (padded rows zero); pyramid: a
        chunked ``Pyramid`` of at least NUM_LEVELS levels with ``down_nbr3``.
        Returns [B*S_5, out_channels], at level 5's rows."""
        lv = pyramid.levels
        if len(lv) < NUM_LEVELS or any(l.down_nbr3 is None for l in lv[1:5]):
            raise ValueError("ResNet needs a 6-level pyramid built with "
                             "build_down3=True")
        features = features.to(self.dtype or features.dtype)
        nbr0, rev0, order0 = ((lv[0].nbr0, lv[0].rev0, lv[0].nbr0_order)
                              if lv[0].nbr0 is not None
                              else (lv[0].nbr, lv[0].rev, lv[0].nbr_order))
        out = relu(self.bn1(self.conv1(features, nbr0, lv[0].valid, rev0,
                                       order=order0), lv[0].valid))
        # k2s2 sum pool to level 1
        out = ops.sparse_sum_pool(out, lv[0].down_nbr, lv[1].valid)
        for i in range(len(self.PLANES)):
            src, dst = lv[1 + i], lv[2 + i]
            out = getattr(self, f"layer{i + 1}_0")(
                out, src.down_nbr3, src.down_nbr[0:1], dst.nbr, src.valid,
                dst.valid, (src.down3_order, src.down_order, dst.nbr_order))
            for b in range(1, self.LAYERS[i]):
                out = getattr(self, f"layer{i + 1}_{b}")(out, dst.nbr, dst.valid,
                                                         dst.rev, order=dst.nbr_order)
        return self.final(out, lv[5].valid)


class ResNet14(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (1, 1, 1, 1)


class ResNet18(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 2, 2, 2)


class ResNet34(ResNetBase):
    BLOCK = BasicBlock
    LAYERS = (3, 4, 6, 3)


class ResNet50(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 6, 3)


class ResNet101(ResNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 23, 3)


# --- 4-D spatio-temporal variants (JAX nn/resnet.py:171-222) ---


class STResNetBase(ResNetBase):
    GEOMETRY = HYBRID_4D


class STResNet14(STResNetBase, ResNet14):
    pass


class STResNet18(STResNetBase, ResNet18):
    pass


class STResNet34(STResNetBase, ResNet34):
    pass


class STResNet50(STResNetBase, ResNet50):
    pass


class STResNet101(STResNetBase, ResNet101):
    pass


class STResTesseractNetBase(STResNetBase):
    """Full 4-D hypercube kernels (81 taps)."""

    GEOMETRY = TESSERACT_4D


class STResTesseractNet14(STResTesseractNetBase, STResNet14):
    pass


class STResTesseractNet18(STResTesseractNetBase, STResNet18):
    pass


class STResTesseractNet34(STResTesseractNetBase, STResNet34):
    pass


class STResTesseractNet50(STResTesseractNetBase, STResNet50):
    pass


class STResTesseractNet101(STResTesseractNetBase, STResNet101):
    pass
