"""MinkUNet / ResUNet family: 6-stage sparse U-Net over a 4-level pyramid
(port of ``pointcontrast_tpu/nn/resunet.py``, the 3-D classes).

stem conv -> residual stage on level 0 -> 3x [k2s2 conv + BN + ReLU +
residual stage] encoder -> 3x [k2s2 transpose conv + BN + ReLU + skip
concat (+ stage for the first two)] decoder -> 1x1 to 512, BN (momentum
0.1), ReLU -> 1x1 head.  As in the reference, block5/6 run before the next
transpose conv and the last skip concat feeds the final MLP directly.
Submodules carry the flax names (``conv1p1s1``, ``bn1``, ``block1_0``,
``convtr4p8s2``, ``final_fc``, ``final_bn``, ``final``).  ``MinkUNetHyper``
adds the hypercolumn: block5's and block6's outputs are average-unpooled
to level 0 and concatenated after the last skip concat.  ``dtype`` (None:
the input features') is the activations' dtype, as in ``res16unet``
(MinkUNetHyper's unpools pass the level's down map, whose bf16 adjoint
adds each parent's children in order through it).  The tap counts come from
the class's ``GEOMETRY``, as in ``res16unet``: the 4-D ``STResUNet*``
(``HYBRID_4D``) and ``STResTesseractUNet*`` (``TESSERACT_4D``) classes of
JAX ``nn/resunet.py:270-317``.
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
    relu,
)
from pointcontrast_tpu_torch.nn.resnet_block import (
    BasicBlock,
    BasicBlockINBN,
    Bottleneck,
)
from pointcontrast_tpu_torch.sparse import ops
from pointcontrast_tpu_torch.sparse.brick import BrickMap
from pointcontrast_tpu_torch.sparse.topology import HYBRID_4D, TESSERACT_4D, Geometry

NUM_LEVELS = 4  # strides 1, 2, 4, 8


class MinkUNetBase(nn.Module):
    BLOCK = None
    PLANES = (64, 128, 256, 512, 256, 128, 128)
    LAYERS = (2, 2, 2, 2, 2, 2)
    INIT_DIM = 64
    GEOMETRY = Geometry()

    def __init__(self, in_channels: int, out_channels: int,
                 conv1_kernel_size: int = 3, bn_momentum: float = 0.05,
                 generator: torch.Generator | None = None,
                 dtype: torch.dtype | None = None):
        super().__init__()
        vol = self.GEOMETRY.volumes(conv1_kernel_size)
        k3, k_up = vol["block"], vol["down"]
        g = generator
        self.dtype = dtype

        def stage(name, inplanes, planes, blocks):
            for i in range(blocks):
                self.add_module(f"{name}_{i}", self.BLOCK(
                    inplanes, planes, k3, bn_momentum, generator=g))
                inplanes = planes * self.BLOCK.expansion
            return inplanes

        self.conv1p1s1 = SparseConv(in_channels, self.INIT_DIM, vol["stem"], generator=g)
        self.bn1 = MaskedBatchNorm(self.INIT_DIM, bn_momentum)
        c = stage("block1", self.INIT_DIM, self.PLANES[0], self.LAYERS[0])
        skip_channels = [c]
        for s in range(3):
            self.add_module(f"conv{s + 2}p{2 ** s}s2",
                            SparseConv(c, c, k_up, generator=g))
            self.add_module(f"bn{s + 2}", MaskedBatchNorm(c, bn_momentum))
            c = stage(f"block{s + 2}", c, self.PLANES[s + 1], self.LAYERS[s + 1])
            skip_channels.append(c)
        for d in range(3):
            planes = self.PLANES[4 + d]
            self.add_module(f"convtr{4 + d}p{2 ** (3 - d)}s2",
                            SparseConvTranspose(c, planes, k_up, generator=g))
            self.add_module(f"bntr{4 + d}", MaskedBatchNorm(planes, bn_momentum))
            c = planes + skip_channels[2 - d]
            if d < 2:
                c = stage(f"block{5 + d}", c, planes, self.LAYERS[4 + d])
        self.final_fc = SparseLinear(c + self._head_extra(), 512, bias=False,
                                     generator=g)
        self.final_bn = MaskedBatchNorm(512, 0.1)
        self.final = SparseLinear(512, out_channels, bias=True, generator=g)

    def _head_extra(self) -> int:
        """Channels the head takes beyond the last skip concat's."""
        return 0

    def _stage(self, x, lv, name, blocks, num_batch):
        for i in range(blocks):
            x = getattr(self, f"{name}_{i}")(x, lv.nbr, lv.valid, lv.rev,
                                              lv.batch, num_batch, order=lv.nbr_order)
        return x

    def _trunk(self, features, pyramid):
        """(the last skip concat at level 0, [block5's output at level 2,
        block6's at level 1])."""
        lv = pyramid.levels
        nb = pyramid.num_batch
        if len(lv) < NUM_LEVELS:
            raise ValueError(f"{type(self).__name__} needs a 4-level pyramid")
        nbr0, rev0, order0 = ((lv[0].nbr0, lv[0].rev0, lv[0].nbr0_order)
                              if lv[0].nbr0 is not None
                              else (lv[0].nbr, lv[0].rev, lv[0].nbr_order))
        features = features.to(self.dtype or features.dtype)
        out = relu(self.bn1(self.conv1p1s1(features, nbr0, lv[0].valid, rev0,
                                           order=order0), lv[0].valid))
        out = self._stage(out, lv[0], "block1", self.LAYERS[0], nb)
        skips = [out]
        for s in range(3):
            out = getattr(self, f"conv{s + 2}p{2 ** s}s2")(
                out, lv[s].down_nbr, lv[s + 1].valid,
                up=(lv[s].up_parent, lv[s].up_offset, lv[s].up_order),
                order=lv[s].down_order)
            out = relu(getattr(self, f"bn{s + 2}")(out, lv[s + 1].valid))
            out = self._stage(out, lv[s + 1], f"block{s + 2}", self.LAYERS[s + 1], nb)
            if s < 2:
                skips.append(out)
        stages = []
        for d in range(3):
            lvl = 2 - d
            out = getattr(self, f"convtr{4 + d}p{2 ** (3 - d)}s2")(
                out, lv[lvl].up_parent, lv[lvl].up_offset, lv[lvl].valid,
                up_order=lv[lvl].up_order, down=down_of(lv[lvl]))
            out = relu(getattr(self, f"bntr{4 + d}")(out, lv[lvl].valid))
            out = torch.cat([out, skips[lvl]], dim=1)
            if d < 2:
                out = self._stage(out, lv[lvl], f"block{5 + d}", self.LAYERS[4 + d], nb)
                stages.append(out)
        return out, stages

    def _head(self, out, valid):
        out = relu(self.final_bn(self.final_fc(out, valid), valid))
        return self.final(out, valid)

    def forward(self, features, pyramid):
        """features: [B*S_0, in_channels] (padded rows zero); pyramid: a
        chunked ``Pyramid`` with at least NUM_LEVELS levels of tensors."""
        out, _ = self._trunk(features, pyramid)
        return self._head(out, pyramid.levels[0].valid)


class ResUNet14(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (1, 1, 1, 1, 1, 1)


class ResUNet18(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (2, 2, 2, 2, 2, 2)


class ResUNet34(MinkUNetBase):
    BLOCK = BasicBlock
    LAYERS = (3, 4, 6, 3, 2, 2)


class ResUNet50(MinkUNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 6, 3, 2, 2)


class ResUNet101(MinkUNetBase):
    BLOCK = Bottleneck
    LAYERS = (3, 4, 23, 3, 2, 2)


class ResUNet14D(ResUNet14):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet18D(ResUNet18):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet34D(ResUNet34):
    PLANES = (64, 128, 256, 512, 512, 512, 512)


class ResUNet34E(ResUNet34):
    INIT_DIM = 32
    PLANES = (32, 64, 128, 256, 128, 64, 64)


class ResUNet34F(ResUNet34):
    INIT_DIM = 32
    PLANES = (32, 64, 128, 256, 128, 64, 32)


class ResUNet18INBN(ResUNet18):
    BLOCK = BasicBlockINBN


class MinkUNetHyper(MinkUNetBase):
    """Hypercolumn variant: block5's output (level 2) and block6's (level 1)
    are average-unpooled to level 0, one parent gather per level, and the
    head takes the concatenation [out, up(block6), up(block5)]."""

    def _head_extra(self) -> int:
        return (self.PLANES[4] + self.PLANES[5]) * self.BLOCK.expansion

    def forward(self, features, pyramid):
        lv = pyramid.levels
        if any(isinstance(l.nbr, BrickMap) for l in lv):
            raise ValueError(
                "MinkUNetHyper's chained pooling-transposes need per-fine-row "
                "up_parent maps, which brick levels don't carry — build the "
                "pyramid with layout='voxel'")
        out, stages = self._trunk(features, pyramid)
        hyper = []
        for x, lvl in zip(stages, (2, 1)):
            for l in range(lvl - 1, -1, -1):
                x = ops.sparse_avg_unpool(x, lv[l].up_parent, lv[l].valid,
                                          lv[l].down_nbr)
            hyper.append(x)
        out = torch.cat([out] + hyper[::-1], dim=1)
        return self._head(out, lv[0].valid)


class MinkUNetHyper14INBN(MinkUNetHyper):
    BLOCK = BasicBlockINBN
    LAYERS = (1, 1, 1, 1, 1, 1)


# --- 4-D spatio-temporal variants (JAX nn/resunet.py:270-317) ---


class STMinkUNetBase(MinkUNetBase):
    GEOMETRY = HYBRID_4D


class STResUNet14(STMinkUNetBase, ResUNet14):
    pass


class STResUNet18(STMinkUNetBase, ResUNet18):
    pass


class STResUNet34(STMinkUNetBase, ResUNet34):
    pass


class STResUNet50(STMinkUNetBase, ResUNet50):
    pass


class STResUNet101(STMinkUNetBase, ResUNet101):
    pass


class STResTesseractUNetBase(STMinkUNetBase):
    """Full 4-D hypercube kernels (81 taps)."""

    GEOMETRY = TESSERACT_4D


class STResTesseractUNet14(STResTesseractUNetBase, ResUNet14):
    pass


class STResTesseractUNet18(STResTesseractUNetBase, ResUNet18):
    pass


class STResTesseractUNet34(STResTesseractUNetBase, ResUNet34):
    pass


class STResTesseractUNet50(STResTesseractUNetBase, ResUNet50):
    pass


class STResTesseractUNet101(STResTesseractUNetBase, ResUNet101):
    pass
