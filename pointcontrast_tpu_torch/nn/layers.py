"""Core sparse layers as torch ``nn.Module``s (port of
``pointcontrast_tpu/nn/layers.py``).

Conventions, as in the JAX package:
  - features are [Npad, C]; padded rows are kept at exactly zero (ops that
    break this -- bias, norm -- re-mask their output);
  - weights keep the JAX layout: conv kernels [K, Cin, Cout] in the
    ``kernel_offsets`` order, linear kernels [Cin, Cout];
  - BatchNorm follows torch semantics: running = (1-m)*running + m*batch,
    with the unbiased batch variance entering the running average
    (momentum 0.05, the reference pretrain config);
  - mixed precision, as JAX's ``dtype``: parameters are f32 in every mode,
    and a layer computes in its input features' dtype (the net's stem
    casts them), casting its parameters to it at use; the convs and the
    linear map take bf16 x bf16 products with f32 sums, rounded once; the
    norms keep their statistics in f32 and cast their output back.
"""
from __future__ import annotations

import torch
from torch import nn

from pointcontrast_tpu_torch.sparse import brick, ops


def kernel_init_(w: torch.Tensor, generator: torch.Generator | None = None):
    """He/fan-in normal over the full receptive field (K * Cin)."""
    fan_in = w.shape[0] * w.shape[1] if w.dim() == 3 else w.shape[0]
    with torch.no_grad():
        w.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=generator)
    return w


class SparseConv(nn.Module):
    """Sparse convolution: ``nbr`` decides the geometry (a same-level map
    gives a stride-1 conv, a down map a strided conv onto the coarser
    level) and the layout (a ``BrickMap`` or ``BrickDownMap`` runs the
    brick convs); ``order``, the map's live order from the pyramid, only
    orders the gather GEMM's output tiles (a ``BrickMap`` carries its
    own, for the brick kernels)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_volume: int,
                 bias: bool = False, generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            kernel_init_(torch.empty(kernel_volume, in_channels, out_channels),
                         generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, features, nbr, valid_out, rev=None, up=None, order=None):
        w = self.weight.to(features.dtype)
        # the map object decides the layout: same weights, same semantics
        if isinstance(nbr, brick.BrickMap):
            return brick.brick_conv(features, nbr.nbr, w, nbr.plan,
                                    bias=self.bias, valid_out=valid_out, order=nbr.order)
        if isinstance(nbr, brick.BrickDownMap):
            return brick.brick_down_conv(features, nbr.place, w,
                                         bias=self.bias, valid_out=valid_out)
        return ops.sparse_conv(features, nbr, w, bias=self.bias,
                               valid_out=valid_out, rev=rev, up=up, order=order)


def down_of(level):
    """(down_nbr, down_order) of a pyramid level, the map through which K3's
    backward gathers onto it (``ops.sparse_conv_transpose``'s ``down``);
    None on a brick level, whose down map is a ``BrickDownMap``."""
    if not torch.is_tensor(level.down_nbr):
        return None
    return level.down_nbr, level.down_order


class SparseConvTranspose(nn.Module):
    """Stride-2 kernel-2 transposed conv onto the reused finer level;
    ``down``, that level's ``down_of``, is what its backward gathers
    through (a brick level's up conv takes none)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_volume: int = 8, bias: bool = False,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            kernel_init_(torch.empty(kernel_volume, in_channels, out_channels),
                         generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, features, up_parent, up_offset, valid_out, up_order=None, down=None):
        w = self.weight.to(features.dtype)
        if up_offset is None:  # brick layout: up_parent is the up-gather
            return brick.brick_up_conv(features, up_parent, w,
                                       bias=self.bias, valid_out=valid_out)
        return ops.sparse_conv_transpose(features, up_parent, up_offset,
                                         w, bias=self.bias,
                                         valid_out=valid_out, up_order=up_order,
                                         down=down)


class SparseLinear(nn.Module):
    """1x1 conv == per-voxel linear map (no gather).  In bf16, JAX's
    ``dot(bf16, bf16, preferred_element_type=f32).astype(bf16)``: the
    product of the widened operands (bf16 x bf16 is exact in f32), one
    rounding, then the bias in bf16."""

    def __init__(self, in_channels: int, out_channels: int, bias: bool = True,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(
            kernel_init_(torch.empty(in_channels, out_channels), generator))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None

    def forward(self, features, valid):
        dtype = features.dtype
        w = self.weight.to(dtype)
        if dtype == torch.bfloat16:
            out = (features.float() @ w.float()).to(dtype)
        else:
            out = features @ w
        if self.bias is not None:
            out = out + self.bias.to(dtype)
        return ops.mask_rows(out, valid)


class MaskedBatchNorm(nn.Module):
    """Padding-aware BatchNorm with torch running-stat semantics: moments
    over valid rows only; the running variance takes the unbiased batch
    variance."""

    def __init__(self, num_features: int, momentum: float = 0.05,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, features, valid):
        if self.training:
            mean, var, n = ops.masked_moments(features, valid)
            with torch.no_grad():
                unbiased = var * (n / (n - 1.0).clamp(min=1.0))
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps)
        out = (ops.widen(features) - mean) * inv * self.weight + self.bias
        return ops.mask_rows(out.to(features.dtype), valid)


class SparseInstanceNorm(nn.Module):
    """Per-sample (per point cloud) normalisation from global pooling and
    broadcast, as the reference's MinkowskiInstanceNorm: per-channel mean
    and biased variance over each sample's rows, statistics in float32."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, features, valid, batch, num_batch: int):
        f = features.float()
        mean = ops.global_pool(f, batch, num_batch)
        centered = ops.mask_rows(f - ops.broadcast_to_points(mean, batch), valid)
        var = ops.global_pool(centered.square(), batch, num_batch)
        inv = ops.broadcast_to_points(torch.rsqrt(var + self.eps), batch)
        out = centered * inv * self.weight + self.bias
        return ops.mask_rows(out.to(features.dtype), valid)


class SparseLayerNorm(nn.Module):
    """Per-sample layer norm as the reference's MinkowskiLayerNorm: SCALAR
    moments per sample, over all its rows and channels jointly."""

    def __init__(self, num_features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))

    def forward(self, features, valid, batch, num_batch: int):
        c = features.shape[-1]
        f = features.float()
        mean = ops.global_pool(f, batch, num_batch).mean(-1, keepdim=True)
        centered = ops.mask_rows(
            f - ops.broadcast_to_points(mean.expand(num_batch, c), batch), valid)
        var = ops.global_pool(centered * centered, batch, num_batch).mean(
            -1, keepdim=True)
        instd = 1.0 / torch.sqrt(var + self.eps)
        out = (centered * ops.broadcast_to_points(instd.expand(num_batch, c), batch)
               * self.weight + self.bias)
        return ops.mask_rows(out.to(features.dtype), valid)


def relu(features):
    """ReLU preserves the zero-padding invariant; no re-mask needed."""
    return torch.relu(features)


def l2_normalize_rows(features, valid, eps: float = 1e-12):
    """Row-wise L2 normalization, x * rsqrt(max(sum x^2, eps)): the clamp
    sits inside the rsqrt, so all-zero pad rows stay zero with a finite
    gradient (sqrt's gradient at zero is NaN, and 0 * NaN poisons the
    backward)."""
    sq = features.float().square().sum(dim=1, keepdim=True)
    inv = torch.rsqrt(sq.clamp(min=eps))
    return ops.mask_rows(features * inv.to(features.dtype), valid)
