"""Res16UNet family: 8-stage sparse U-Net over a 5-level chunked pyramid
(port of ``pointcontrast_tpu/nn/res16unet.py``).

stem conv -> 4x [stride-2 conv + BN + ReLU + residual stage] encoder ->
4x [transpose conv + BN + ReLU + skip-concat + residual stage] decoder ->
1x1 head, optional L2-normalized output.  Submodules carry the flax names
(``conv0p1s1``, ``bn0``, ``block1_0``, ``convtr4p16s2``, ``final``, ...),
so ``tools.from_jax`` is a rename.  Unlike flax, torch fixes channel counts
at construction, so the constructor tracks them the way the reference's
``inplanes`` does.  ``dtype`` (None: the input features') is the
activations' dtype, as JAX's: the stem casts the features to it and every
layer computes in it (bf16: mixed precision; parameters stay f32).

Each conv's tap count comes from the class's ``GEOMETRY``
(``sparse.topology.Geometry``), the same offsets its pyramid is built
from, where JAX's flax modules read it off the map's shape.  The 4-D
spatio-temporal classes (``STRes16UNet*``, JAX ``nn/res16unet.py:211-253``)
carry ``HYBRID_4D`` (29-tap block convs, a (3, 3, 3, 1) stem, 8-child
(2, 2, 2, 1) strided convs) and ``STResTesseract16UNet18A`` ``TESSERACT_4D``
(81-tap block convs and stem): a pyramid for them is built with
``GEOMETRY.pyramid_kwargs()``.
"""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.nn.layers import (
    MaskedBatchNorm,
    SparseConv,
    SparseConvTranspose,
    SparseLinear,
    down_of,
    l2_normalize_rows,
    relu,
)
from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock, Bottleneck
from pointcontrast_tpu_torch.sparse.topology import HYBRID_4D, TESSERACT_4D, Geometry

NUM_LEVELS = 5  # strides 1, 2, 4, 8, 16


class Res16UNetBase(nn.Module):
    """Base 8-stage sparse U-Net (see the class attributes of subclasses)."""

    BLOCK = None
    PLANES = (32, 64, 128, 256, 256, 256, 256, 256)
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)
    INIT_DIM = 32
    GEOMETRY = Geometry()

    def __init__(self, in_channels: int, out_channels: int,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.05,
                 normalize_feature: bool = False,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.normalize_feature = normalize_feature
        self.dtype = dtype
        vol = self.GEOMETRY.volumes(conv1_kernel_size)
        k3, k_up = vol["block"], vol["down"]
        g = generator

        def bn(name, c):
            self.add_module(name, MaskedBatchNorm(c, bn_momentum))

        # the stem reads the pyramid's nbr0 map when it has one
        self.conv0p1s1 = SparseConv(in_channels, self.INIT_DIM, vol["stem"], generator=g)
        bn("bn0", self.INIT_DIM)
        c = self.INIT_DIM
        skip_channels = [c]
        for s in range(4):
            self.add_module(f"conv{s + 1}p{2 ** s}s2",
                            SparseConv(c, c, k_up, generator=g))
            bn(f"bn{s + 1}", c)
            c = self._add_stage(f"block{s + 1}", c, self.PLANES[s],
                                self.LAYERS[s], k3, bn_momentum, g)
            skip_channels.append(c)
        for d in range(4):
            planes = self.PLANES[4 + d]
            self.add_module(f"convtr{4 + d}p{2 ** (4 - d)}s2",
                            SparseConvTranspose(c, planes, k_up, generator=g))
            bn(f"bntr{4 + d}", planes)
            c = self._add_stage(f"block{5 + d}", planes + skip_channels[3 - d],
                                planes, self.LAYERS[4 + d], k3, bn_momentum, g)
        self.final = SparseLinear(c, out_channels, bias=True, generator=g)

    def _add_stage(self, name, inplanes, planes, blocks, kernel_volume,
                   bn_momentum, generator) -> int:
        for i in range(blocks):
            self.add_module(
                f"{name}_{i}",
                self.BLOCK(inplanes, planes, kernel_volume, bn_momentum,
                           generator=generator),
            )
            inplanes = planes * self.BLOCK.expansion
        return inplanes

    def _stage(self, x, lv, name, blocks, num_batch):
        for i in range(blocks):
            x = getattr(self, f"{name}_{i}")(x, lv.nbr, lv.valid, lv.rev,
                                              lv.batch, num_batch, order=lv.nbr_order)
        return x

    def forward(self, features, pyramid):
        """features: [B*S_0, in_channels] (padded rows zero); pyramid: a
        chunked ``Pyramid`` with NUM_LEVELS levels of torch tensors."""
        lv = pyramid.levels
        nb = pyramid.num_batch
        if len(lv) < NUM_LEVELS:
            raise ValueError("Res16UNet needs a 5-level pyramid")
        features = features.to(self.dtype or features.dtype)
        nbr0, rev0, order0 = ((lv[0].nbr0, lv[0].rev0, lv[0].nbr0_order)
                              if lv[0].nbr0 is not None
                              else (lv[0].nbr, lv[0].rev, lv[0].nbr_order))
        out = self.conv0p1s1(features, nbr0, lv[0].valid, rev0, order=order0)
        out = relu(self.bn0(out, lv[0].valid))

        skips = [out]
        for s in range(4):
            out = getattr(self, f"conv{s + 1}p{2 ** s}s2")(
                out, lv[s].down_nbr, lv[s + 1].valid,
                up=(lv[s].up_parent, lv[s].up_offset, lv[s].up_order),
                order=lv[s].down_order)
            out = relu(getattr(self, f"bn{s + 1}")(out, lv[s + 1].valid))
            out = self._stage(out, lv[s + 1], f"block{s + 1}", self.LAYERS[s], nb)
            if s < 3:
                skips.append(out)

        for d in range(4):
            lvl = 3 - d  # producing level index
            out = getattr(self, f"convtr{4 + d}p{2 ** (4 - d)}s2")(
                out, lv[lvl].up_parent, lv[lvl].up_offset, lv[lvl].valid,
                up_order=lv[lvl].up_order, down=down_of(lv[lvl]))
            out = relu(getattr(self, f"bntr{4 + d}")(out, lv[lvl].valid))
            out = torch.cat([out, skips[lvl]], dim=1)
            out = self._stage(out, lv[lvl], f"block{5 + d}", self.LAYERS[4 + d], nb)

        out = self.final(out, lv[0].valid)
        if self.normalize_feature:
            out = l2_normalize_rows(out, lv[0].valid)
        return out


class Res16UNet14(Res16UNetBase):
    BLOCK = BasicBlock
    LAYERS = (1, 1, 1, 1, 1, 1, 1, 1)


class Res16UNet18(Res16UNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 2, 2, 2, 2, 2, 2, 2)


class Res16UNet34(Res16UNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet50(Res16UNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 6, 2, 2, 2, 2)


class Res16UNet101(Res16UNetBase):
    BLOCK = Bottleneck
    LAYERS = (2, 3, 4, 23, 2, 2, 2, 2)


class Res16UNet14A(Res16UNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet14A2(Res16UNet14A):
    LAYERS = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B(Res16UNet14):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet14B2(Res16UNet14B):
    LAYERS = (1, 1, 1, 1, 2, 2, 2, 2)


class Res16UNet14B3(Res16UNet14B):
    LAYERS = (2, 2, 2, 2, 1, 1, 1, 1)


class Res16UNet14C(Res16UNet14):
    PLANES = (32, 64, 128, 256, 192, 192, 128, 128)


class Res16UNet14D(Res16UNet14):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet18A(Res16UNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class Res16UNet18B(Res16UNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 128, 128)


class Res16UNet18D(Res16UNet18):
    PLANES = (32, 64, 128, 256, 384, 384, 384, 384)


class Res16UNet34A(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 64)


class Res16UNet34B(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 64, 32)


class Res16UNet34C(Res16UNet34):
    PLANES = (32, 64, 128, 256, 256, 128, 96, 96)


# --- 4-D spatio-temporal variants (JAX nn/res16unet.py:211-253): hybrid
#     kernels (cube over space, cross over time), space strided, time not ---


class STRes16UNetBase(Res16UNetBase):
    GEOMETRY = HYBRID_4D


class STRes16UNet14(STRes16UNetBase, Res16UNet14):
    pass


class STRes16UNet14A(STRes16UNetBase, Res16UNet14A):
    pass


class STRes16UNet18(STRes16UNetBase, Res16UNet18):
    pass


class STRes16UNet34(STRes16UNetBase, Res16UNet34):
    pass


class STRes16UNet50(STRes16UNetBase, Res16UNet50):
    pass


class STRes16UNet101(STRes16UNetBase, Res16UNet101):
    pass


class STRes16UNet18A(STRes16UNet18):
    PLANES = (32, 64, 128, 256, 128, 128, 96, 96)


class STResTesseract16UNetBase(STRes16UNetBase):
    """Full 4-D hypercube kernels (81 taps)."""

    GEOMETRY = TESSERACT_4D


class STResTesseract16UNet18A(STRes16UNet18A, STResTesseract16UNetBase):
    pass
