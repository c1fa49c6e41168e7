"""The four device kernels behind the VoteNet step's PointNet++ ops.

Each kernel has three things side by side here, as in ``sparse.kernels``:
  - ``<name>_plain``: the same function in plain torch.  The CPU tests use
    it, and it is the reference the CUDA kernel is compared with on the card;
  - ``<name>``: the wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the hand-written kernel from ``csrc/detect_ops.cu``
    (built by ``cuda_build`` for sm_90a at first use) or raises;
  - ``<name>.launches``: a plain int, +1 per kernel launch (not per plain
    call).

Which JAX op each kernel replaces (``pointcontrast_tpu/detect/ops.py``, XLA
programs; the package has no Pallas kernel on this path):
  furthest_point_sample  K6 ``furthest_point_sample`` (a ``fori_loop`` of
                         [B, N] min-updates and argmaxes)
  ball_query             K7 ``ball_query`` (pairwise distances + top_k)
  gather_rows            K8 ``gather_points`` / ``group_points`` and the
                         inline ``take_along_axis`` gathers of
                         ``detect/votenet.py`` and ``detect/modules.py``
  scatter_add_rows       K8's backward (XLA's gather transpose)
What bounds them on an H100: FPS is a chain of ``npoint`` dependent steps,
each a pass over one cloud and a block-wide argmax, so it is latency-bound
on one SM per cloud (8 of 132 SMs at batch 8); the design keeps a cloud in
one block so that a step needs two ``__syncthreads`` and no grid-wide sync,
and leaves the [B, N] running distances in L2.  Ball query reads each
cloud once per centre (256 x 1024 points x 12 B per cloud, L2-resident) and
stops at ``nsample`` hits.  The gather and scatter move rows of 4*C bytes
and are bound by device-memory bandwidth; the scatter's atomics collide.

Distances are spelt out in one order, (x^2 + y^2) + z^2 with every product
and sum rounded on its own, in the kernels (``__fmul_rn``/``__fadd_rn``)
and in the twins (separate torch ops, never ``.sum(-1)`` or a matmul), so
the two agree bit for bit and pick the same indices.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from pointcontrast_tpu_torch import cuda_build
from pointcontrast_tpu_torch.cuda_build import check as _check
from pointcontrast_tpu_torch.cuda_build import ptr as _ptr
from pointcontrast_tpu_torch.cuda_build import require as _require
from pointcontrast_tpu_torch.cuda_build import stream as _stream
from pointcontrast_tpu_torch.cuda_build import use_plain as _use_plain


def _lib():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load("detect_ops", {
        "pc_fps": [vp, vp, vp, ci, ci, ci, vp],
        "pc_ball_query": [vp, vp, vp, ci, ci, ci, cf, ci, vp],
        "pc_gather_rows": [vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_scatter_add_rows": [vp, vp, vp, ci, ci, ci, ci, vp],
    })


def _check_cloud(name: str, x: torch.Tensor) -> None:
    if x.dim() != 3 or x.shape[-1] != 3:
        raise ValueError(f"{name}: expected [B, N, 3], got {tuple(x.shape)}")


def _check_index(name: str, idx: torch.Tensor, b_: int) -> None:
    """Shape check only: reading the values would cost a host sync per
    launch.  The kernels read through raw pointers, so every index must be
    in range: the path's indices come from ``furthest_point_sample`` and
    ``ball_query`` (in range by construction) or from
    ``DetectionBatch.to``, which checks ``point_voxel_idx`` per sample."""
    if idx.dim() < 2 or idx.shape[0] != b_:
        raise ValueError(f"{name}: index of shape {tuple(idx.shape)} for a "
                         f"batch of {b_}")


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


def sq3(x, y, z):
    """(x^2 + y^2) + z^2 as three rounded products and two rounded sums."""
    return (x * x + y * y) + z * z


def sq3_dot(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis, unfused."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


# --------------------------------------------------------------------------
# K6 furthest_point_sample


def furthest_point_sample_plain(xyz, npoint: int):
    b_, n, _ = xyz.shape
    out = torch.zeros(b_, npoint, dtype=torch.int32, device=xyz.device)
    dists = torch.full((b_, n), float("inf"), device=xyz.device)
    rows = torch.arange(b_, device=xyz.device)
    last = torch.zeros(b_, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        dists = torch.minimum(dists, sq3(d[..., 0], d[..., 1], d[..., 2]))
        last = torch.argmax(dists, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


def furthest_point_sample(xyz, npoint: int):
    """[B, N, 3] f32 -> [B, npoint] int32: index 0 first, then each step the
    point furthest from those chosen (ties to the lowest index)."""
    _check_cloud("furthest_point_sample", xyz)
    b_, n, _ = xyz.shape
    if not 0 < npoint <= n:
        raise ValueError(f"furthest_point_sample: npoint {npoint} of {n} points")
    if _use_plain(xyz):
        return furthest_point_sample_plain(xyz, npoint)
    _require(xyz, "xyz", torch.float32, 3)
    out = torch.empty(b_, npoint, dtype=torch.int32, device=xyz.device)
    dist = torch.empty(b_, n, dtype=torch.float32, device=xyz.device)
    rc = _lib().pc_fps(_ptr(xyz), _ptr(dist), _ptr(out), b_, n, npoint,
                       _stream())
    _check(rc, "furthest_point_sample")
    furthest_point_sample.launches += 1
    return out


# --------------------------------------------------------------------------
# K7 ball_query


def _radius2(radius: float) -> np.float32:
    """The threshold as the JAX op compares it: ``radius * radius`` in
    Python, then rounded to f32 against the f32 distances."""
    return np.float32(radius * radius)


def ball_query_plain(new_xyz, xyz, radius: float, nsample: int):
    n = xyz.shape[1]
    a, p = new_xyz[:, :, None, :], xyz[:, None, :, :]
    ab = sq3_dot(a, p)
    d2 = torch.clamp_min((sq3(a[..., 0], a[..., 1], a[..., 2])
                          + sq3(p[..., 0], p[..., 1], p[..., 2])) - 2.0 * ab, 0.0)
    inside = d2 < torch.tensor(_radius2(radius), device=d2.device)
    col = torch.arange(n, device=xyz.device, dtype=torch.int32)
    key = torch.where(inside, col, torch.full_like(col, n))
    out = torch.topk(key, nsample, dim=-1, largest=False, sorted=True).values
    first = out[..., :1]
    first = torch.where(first == n, torch.zeros_like(first), first)
    return torch.where(out == n, first, out).to(torch.int32)


def ball_query(new_xyz, xyz, radius: float, nsample: int):
    """[B, M, 3] centres, [B, N, 3] points -> [B, M, nsample] int32: the
    first ``nsample`` points (in point order) with squared distance
    ``max(|a|^2 + |b|^2 - 2 a.b, 0) < radius^2``; slots past the hit count
    repeat the first hit, a centre with no hit gets index 0."""
    _check_cloud("ball_query centres", new_xyz)
    _check_cloud("ball_query points", xyz)
    b_, m, _ = new_xyz.shape
    n = xyz.shape[1]
    if xyz.shape[0] != b_ or not 0 < nsample <= n:
        raise ValueError(f"ball_query: {tuple(new_xyz.shape)} centres over "
                         f"{tuple(xyz.shape)} points, nsample {nsample}")
    if _use_plain(xyz):
        return ball_query_plain(new_xyz, xyz, radius, nsample)
    _require(new_xyz, "new_xyz", torch.float32, 3)
    _require(xyz, "xyz", torch.float32, 3)
    out = torch.empty(b_, m, nsample, dtype=torch.int32, device=xyz.device)
    rc = _lib().pc_ball_query(_ptr(new_xyz), _ptr(xyz), _ptr(out), b_, m, n,
                              float(_radius2(radius)), nsample, _stream())
    _check(rc, "ball_query")
    ball_query.launches += 1
    return out


# --------------------------------------------------------------------------
# K8 gather_rows / scatter_add_rows


def gather_rows_plain(table, idx):
    b_, _, c = table.shape
    flat = idx.reshape(b_, -1).long()
    out = torch.gather(table, 1, flat.unsqueeze(-1).expand(-1, -1, c))
    return out.reshape(*idx.shape, c)


def gather_rows(table, idx):
    """table [B, N, C] f32, idx [B, ...] int -> [B, ..., C]: row
    ``idx[b, ...]`` of sample b's table."""
    b_, n, c = table.shape
    _check_index("gather_rows", idx, b_)
    if _use_plain(table):
        return gather_rows_plain(table, idx)
    _require(table, "table", torch.float32, 3)
    flat = idx.reshape(b_, -1)
    _require(flat, "idx", torch.int32, 2)
    m = flat.shape[1]
    out = torch.empty(b_, m, c, dtype=torch.float32, device=table.device)
    rc = _lib().pc_gather_rows(_ptr(table), _ptr(flat), _ptr(out), b_, n, m, c,
                               _stream())
    _check(rc, "gather_rows")
    gather_rows.launches += 1
    return out.reshape(*idx.shape, c)


def scatter_add_rows_plain(grad, idx, n: int):
    b_, c = idx.shape[0], grad.shape[-1]
    flat = idx.reshape(b_, -1).long()
    out = grad.new_zeros(b_, n, c)
    return out.scatter_add_(1, flat.unsqueeze(-1).expand(-1, -1, c),
                            grad.reshape(b_, -1, c))


def scatter_add_rows(grad, idx, n: int):
    """The backward of ``gather_rows``: grad [B, ..., C], idx [B, ...] ->
    [B, n, C] with ``out[b, idx[b, j]] += grad[b, j]``.  Rows collide, and on
    the card the f32 atomics add them in no fixed order."""
    b_, c = idx.shape[0], grad.shape[-1]
    _check_index("scatter_add_rows", idx, b_)
    if tuple(grad.shape) != (*idx.shape, c):
        raise ValueError(f"scatter_add_rows: grad {tuple(grad.shape)} for "
                         f"index {tuple(idx.shape)}")
    if _use_plain(grad):
        return scatter_add_rows_plain(grad, idx, n)
    g = grad.reshape(b_, -1, c)
    flat = idx.reshape(b_, -1)
    _require(g, "grad", torch.float32, 3)
    _require(flat, "idx", torch.int32, 2)
    out = torch.zeros(b_, n, c, dtype=torch.float32, device=grad.device)
    rc = _lib().pc_scatter_add_rows(_ptr(g), _ptr(flat), _ptr(out), b_, n,
                                    flat.shape[1], c, _stream())
    _check(rc, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


KERNELS = (furthest_point_sample, ball_query, gather_rows, scatter_add_rows)
reset_launches()
