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
    ``group_points`` keep the JAX (and reference) [B, C, N] layout over it.
``three_nn`` / ``three_interpolate`` (K9) belong to the PointNet++ backbone
and are not ported yet (ROADMAP Queue 1 item 10).
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
