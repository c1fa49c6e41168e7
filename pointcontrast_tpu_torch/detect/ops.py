"""PointNet++ ops of the detection path (port of
``pointcontrast_tpu/detect/ops.py``, which replaced the reference's CUDA
extension ``sampling/ball_query/group_points_gpu.cu`` with XLA programs).

Each op runs through a kernel of ``detect.kernels`` (plain torch on CPU
tensors, the hand-written sm_90a kernel on CUDA tensors):
  - ``furthest_point_sample`` (K6) and ``ball_query`` (K7) return int32
    indices and carry no gradient, as in the reference;
  - ``gather`` (K8) is the channels-last row gather every
    ``take_along_axis`` of the JAX modules becomes, an autograd Function
    whose backward is the scatter-add kernel.  ``gather_points`` and
    ``group_points`` keep the JAX (and reference) [B, C, N] layout over it;
  - ``three_nn`` (K9) returns the three nearest known points and their
    distances, with no gradient, and ``three_interpolate`` (K9) is the
    channels-last weighted 3-row gather of the JAX FP module
    (``pointcontrast_tpu/detect/modules.py:113-120``), an autograd Function
    whose backward is the ``three_interpolate_grad`` kernel.
"""
from __future__ import annotations

import torch

from pointcontrast_tpu_torch.detect import kernels


def furthest_point_sample(xyz: torch.Tensor, npoint: int) -> torch.Tensor:
    """[B, N, 3] -> [B, npoint] int32 indices, starting at index 0 like the
    CUDA kernel the JAX op replaced."""
    return kernels.furthest_point_sample(xyz.contiguous(), npoint)


def ball_query(new_xyz: torch.Tensor, xyz: torch.Tensor, radius: float,
               nsample: int) -> torch.Tensor:
    """[B, M, nsample] int32: per centre, the first ``nsample`` points in
    point order within ``radius``; short lists repeat the first hit, centres
    with none get index 0."""
    return kernels.ball_query(new_xyz.contiguous(), xyz.contiguous(), radius,
                              nsample)


class _Gather(torch.autograd.Function):
    """out[b, ...] = table[b, idx[b, ...]]; d table = scatter-add of the
    cotangent through the same indices."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[1]
        return kernels.gather_rows(table, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return kernels.scatter_add_rows(ct.contiguous(), idx, ctx.n), None


def gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Channels-last gather: table [B, N, C], idx [B, ...] int32 ->
    [B, ..., C] (``take_along_axis`` over the point axis)."""
    return _Gather.apply(table.contiguous(), idx.contiguous())


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N] x [B, M] -> [B, C, M] (the reference's layout)."""
    return gather(points.transpose(1, 2), idx).transpose(1, 2)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, C, N] x [B, M, S] -> [B, C, M, S]."""
    return gather(points.transpose(1, 2), idx).permute(0, 3, 1, 2)


def three_nn(unknown: torch.Tensor, known: torch.Tensor):
    """[B, N, 3] x [B, M, 3] -> (dist [B, N, 3], idx [B, N, 3] int32): the
    three nearest known points of each unknown one, nearest first."""
    return kernels.three_nn(unknown.contiguous(), known.contiguous())


def interpolation_weights(dist: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Inverse-distance weights of the FP layers, normalised over the 3."""
    recip = 1.0 / torch.clamp_min(dist, eps)
    return recip / recip.sum(dim=-1, keepdim=True)


class _ThreeInterpolate(torch.autograd.Function):
    """out[b, n] = sum_j weight[b, n, j] feats[b, idx[b, n, j]]; d feats is
    the kernel's scatter of ``ct * weight``.  d weight (plain torch) is only
    computed when asked for: on the VoteNet path the weights come from
    ``xyz``, which carries no gradient."""

    @staticmethod
    def forward(ctx, feats, idx, weight):
        ctx.save_for_backward(idx, weight,
                              feats if ctx.needs_input_grad[2] else None)
        ctx.m = feats.shape[1]
        return kernels.three_interpolate(feats, idx, weight)

    @staticmethod
    def backward(ctx, ct):
        idx, weight, feats = ctx.saved_tensors
        ct = ct.contiguous()
        d_feats = d_weight = None
        if ctx.needs_input_grad[0]:
            d_feats = kernels.three_interpolate_grad(ct, idx, weight, ctx.m)
        if ctx.needs_input_grad[2]:
            g = torch.gather(feats, 1, idx.reshape(idx.shape[0], -1, 1).long()
                             .expand(-1, -1, feats.shape[-1]))
            d_weight = (g.reshape(*idx.shape, -1) * ct[:, :, None, :]).sum(-1)
        return d_feats, None, d_weight


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Channels-last interpolation: feats [B, M, C], idx [B, N, 3] int32,
    weight [B, N, 3] -> [B, N, C]."""
    return _ThreeInterpolate.apply(feats.contiguous(), idx.contiguous(),
                                   weight.contiguous())
