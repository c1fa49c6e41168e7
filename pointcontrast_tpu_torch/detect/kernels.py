"""The seven device kernels behind the VoteNet step's PointNet++ ops.

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
  three_nn               K9 ``three_nn`` (pairwise distances + top_k 3)
  three_interpolate      K9 ``three_interpolate``, in the channels-last form
                         inline at ``detect/modules.py:113-120``
  three_interpolate_grad K9's backward with respect to the features
What bounds them on an H100: FPS is a chain of ``npoint`` dependent steps,
each a pass over one cloud and an argmax over it, so a step's latency bounds
it; the design gives a large cloud a thread-block cluster of up to 16 CTAs
(64-128 of 132 SMs at batch 8) and a small one a single CTA, holds each
thread's few points and their running distances in registers for the
whole launch, and takes a step with one ``__syncthreads`` and, across a
cluster, stores of the CTAs' winners into each other's shared memory with
an mbarrier arrival each.  Ball query costs ~10 f32 operations per
(centre, point) pair it scans, up to the ``nsample``-th hit, and |b|^2
once per point (SA1: 16,384 centres over 40000-point clouds, ~3/4 of each
cloud scanned); it gives each centre a warp that tests 32 points a step
and places the hits in point order by ballot, and each block 8 centres of
one cloud, which it streams through shared memory as (x, y, z, |b|^2)
tiles.  The gather and scatter move rows of 4*C bytes and are bound by
device-memory bandwidth; the scatter's atomics collide.
The gather gives each output row a group of 1 to 32 lanes, by C: one lane
reads the row's index and a shuffle hands it on, the lanes copy the row
with float4 (or neighbouring scalar) loads, in 32-bit offsets, one group a
row with no cap on the grid.  The scatter gives each group a run of 8
consecutive rows and adds a row's sum once for each stretch of the run
that names it (ball query repeats a ball's first hit in every slot past
its hits), with 16-byte atomics where C allows.  Their wrappers do the
least they can on the host (the library, the stream and pointers as plain
ints, one allocation): at the path's small shapes the launch costs more
than the copy.
K9 works on the FP layers' few hundred points: ``three_nn`` reads under
0.4 MB and does ~13 operations a (unknown, known) pair; a lane group of up
to 32 scans each point's cloud from shared memory, where one thread a point
ran 2 warps an SM; ``three_interpolate`` and its
backward move [B, N, C] rows and are bound by bandwidth (~12.6 MB at FP2).
The backward adds ~6 products into each known row (more unknown points
than known ones): a block picks out the index entries that name its 8
known rows, in order, and a warp sums each row's products in registers
and writes it once, where device-memory atomics on the same rows ran one
after another.

Every distance (K6, K7, K9) and K9's weighted sum is spelt out in one
order in the kernels and in the twins, so that the two agree bit for bit
and pick the same indices: the order in which XLA computes the JAX ops on
the CPU, which contracts each 3-term sum of products into a chain of fused
multiply-adds, ``fma(z, z', fma(y, y', x x'))``.  The JAX values agree with
that chain bit for bit, and with the unfused sum ``(x x' + y y') + z z'``
only in part of the entries; on near-duplicate points, and at the
ball-query radius, the two spellings pick different indices.  The kernels call
``__fmaf_rn``; the twins call ``fma_plain``, an exact single-rounding FMA in
float64 (never ``.sum(-1)``, ``cdist`` or a matmul).
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

from pointcontrast_tpu_torch import cuda_build
from pointcontrast_tpu_torch.cuda_build import check as _check
from pointcontrast_tpu_torch.cuda_build import check_index_space
from pointcontrast_tpu_torch.cuda_build import ptr as _ptr
from pointcontrast_tpu_torch.cuda_build import require as _require
from pointcontrast_tpu_torch.cuda_build import stream as _stream
from pointcontrast_tpu_torch.cuda_build import use_plain as _use_plain


@functools.cache
def _lib():
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    return cuda_build.load("detect_ops", {
        "pc_fps_cluster": [ci, ci],
        "pc_fps": [vp, vp, ci, ci, ci, ci, vp],
        "pc_ball_query": [vp, vp, vp, ci, ci, ci, cf, ci, vp],
        "pc_gather_rows": [vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_scatter_add_rows": [vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_three_nn": [vp, vp, vp, vp, ci, ci, ci, vp],
        "pc_three_interpolate": [vp, vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_three_interpolate_grad": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
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


def _round_sum(p, c):
    """float32 of the exact ``p + c`` (float64 operands: an exact product and
    a float32 value), rounded once: the sum is rounded to odd in float64
    (the TwoSum error term says which way), and the cast to float32 then
    rounds correctly, since float64 carries more than 24 + 1 bits (Boldo and
    Melquiond)."""
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    even_inexact = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    return torch.where(even_inexact, torch.nextafter(s, err * math.inf), s).float()


def fma_plain(a, b, c):
    """float32 ``a * b + c`` rounded once, as ``__fmaf_rn``.  On float64
    operands (reference runs in float64) it is ``a * b + c``."""
    if a.dtype == torch.float64:
        return a * b + c
    return _round_sum(a.double() * b.double(), c.double())


def dot3_fma(a, b):
    """fma(a2, b2, fma(a1, b1, a0 b0)) over the last axis: XLA's CPU code for
    ``jnp.sum(a * b, -1)`` and for the 3-deep einsum of ``_sqdist``.  On
    float64 operands (reference runs in float64) the plain sum."""
    if a.dtype == torch.float64:
        return (a * b).sum(-1)
    p = a.double() * b.double()
    acc = _round_sum(p[..., 1], (a[..., 0] * b[..., 0]).double())
    return _round_sum(p[..., 2], acc.double())


# --------------------------------------------------------------------------
# K6 furthest_point_sample


def furthest_point_sample_plain(xyz, npoint: int):
    b_, n, _ = xyz.shape
    out = torch.zeros(b_, npoint, dtype=torch.int32, device=xyz.device)
    dists = torch.full((b_, n), float("inf"), dtype=xyz.dtype, device=xyz.device)
    rows = torch.arange(b_, device=xyz.device)
    last = torch.zeros(b_, dtype=torch.long, device=xyz.device)
    for i in range(1, npoint):
        d = xyz - xyz[rows, last][:, None, :]
        dists = torch.minimum(dists, dot3_fma(d, d))
        last = torch.argmax(dists, dim=1)
        out[:, i] = last.to(torch.int32)
    return out


@functools.lru_cache(maxsize=None)
def fps_cluster(b_: int, n: int, device: int) -> int:
    """CTAs of the cluster that samples each of ``b_`` clouds of ``n``
    points on the card (``pc_fps_cluster``: the largest, up to 16, whose
    batch of clusters runs at once, each CTA's points in registers, or in
    shared memory past their capacity).  Raises when no cluster holds the
    cloud or the card refuses every one that does."""
    with torch.cuda.device(device):
        cs = _lib().pc_fps_cluster(b_, n)
    if cs == -1:
        raise ValueError(f"furthest_point_sample: a cloud of {n} points exceeds what the "
                         f"largest cluster holds in shared memory")
    if cs < 0:
        raise RuntimeError(f"furthest_point_sample: no cluster fits on the card for "
                           f"{b_} clouds of {n} points (CUDA error {-cs})")
    return cs


def furthest_point_sample(xyz, npoint: int):
    """[B, N, 3] f32 -> [B, npoint] int32: index 0 first, then each step the
    point furthest from those chosen (ties to the lowest index).  With more
    samples than distinct points every distance ends at 0 and the rest are
    index 0, as in the JAX op (``npoint`` may exceed N).  On the card one
    thread-block cluster samples each cloud (``fps_cluster``)."""
    _check_cloud("furthest_point_sample", xyz)
    b_, n, _ = xyz.shape
    if npoint <= 0 or n == 0:
        raise ValueError(f"furthest_point_sample: npoint {npoint} of {n} points")
    if _use_plain(xyz):
        return furthest_point_sample_plain(xyz, npoint)
    _require(xyz, "xyz", torch.float32, 3)
    check_index_space("furthest_point_sample", xyz=xyz.numel(), out=b_ * npoint)
    cs = fps_cluster(b_, n, xyz.get_device())
    out = torch.empty(b_, npoint, dtype=torch.int32, device=xyz.device)
    rc = _lib().pc_fps(_ptr(xyz), _ptr(out), b_, n, npoint, cs, _stream())
    _check(rc, "furthest_point_sample")
    furthest_point_sample.launches += 1
    return out


# --------------------------------------------------------------------------
# K7 ball_query


def _radius2(radius: float) -> np.float32:
    """The threshold as the JAX op compares it: ``radius * radius`` in
    Python, then rounded to f32 against the f32 distances."""
    return np.float32(radius * radius)


# centres per block of the plain ball query, as the JAX op's ``chunk=512``
# blocks: the [B, 256, N] float64 temporaries of a 40000-point cloud fit on
# the card
_BQ_PLAIN_CHUNK = 256


def ball_query_plain(new_xyz, xyz, radius: float, nsample: int):
    n = xyz.shape[1]
    p = xyz[:, None, :, :]
    pp = dot3_fma(p, p)
    r2 = torch.tensor(_radius2(radius), device=xyz.device)
    col = torch.arange(n, device=xyz.device, dtype=torch.int32)
    outs = []
    for lo in range(0, new_xyz.shape[1], _BQ_PLAIN_CHUNK):
        a = new_xyz[:, lo:lo + _BQ_PLAIN_CHUNK, None, :]
        d2 = torch.clamp_min((dot3_fma(a, a) + pp) - 2.0 * dot3_fma(a, p), 0.0)
        key = torch.where(d2 < r2, col, torch.full_like(col, n))
        outs.append(torch.topk(key, nsample, dim=-1, largest=False,
                               sorted=True).values)
    out = torch.cat(outs, dim=1)
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
    ``idx[b, ...]`` of sample b's table.  B N C and B M C (M indices a
    sample) must stay below 2^31, on either device."""
    b_, n, c = table.shape
    _check_index("gather_rows", idx, b_)
    m = idx.numel() // b_ if b_ else 0
    check_index_space("gather_rows", table=b_ * n * c, out=b_ * m * c)
    if _use_plain(table):
        return gather_rows_plain(table, idx)
    _require(table, "table", torch.float32, 3)
    _require(idx, "idx", torch.int32, idx.dim())  # read as [B, M]: no reshape
    out = torch.empty(*idx.shape, c, dtype=torch.float32, device=table.device)
    if out.numel() == 0:
        return out
    rc = _lib().pc_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                               b_, n, m, c, _stream(table))
    _check(rc, "gather_rows")
    gather_rows.launches += 1
    return out


def scatter_add_rows_plain(grad, idx, n: int):
    b_, c = idx.shape[0], grad.shape[-1]
    flat = idx.reshape(b_, -1).long()
    out = grad.new_zeros(b_, n, c)
    return out.scatter_add_(1, flat.unsqueeze(-1).expand(-1, -1, c),
                            grad.reshape(b_, -1, c))


def scatter_add_rows(grad, idx, n: int):
    """The backward of ``gather_rows``: grad [B, ..., C], idx [B, ...] ->
    [B, n, C] with ``out[b, idx[b, j]] += grad[b, j]``.  Rows collide, and on
    the card the f32 atomics add them in no fixed order.  B M C (M indices a
    sample) and B n C must stay below 2^31, on either device."""
    b_, c = idx.shape[0], grad.shape[-1]
    _check_index("scatter_add_rows", idx, b_)
    if tuple(grad.shape) != (*idx.shape, c):
        raise ValueError(f"scatter_add_rows: grad {tuple(grad.shape)} for "
                         f"index {tuple(idx.shape)}")
    m = idx.numel() // b_ if b_ else 0
    check_index_space("scatter_add_rows", grad=b_ * m * c, out=b_ * n * c)
    if _use_plain(grad):
        return scatter_add_rows_plain(grad, idx, n)
    _require(grad, "grad", torch.float32, grad.dim())  # read as [B, M, C]
    _require(idx, "idx", torch.int32, idx.dim())  # read as [B, M]: no reshape
    out = torch.zeros(b_, n, c, dtype=torch.float32, device=grad.device)
    if grad.numel() == 0:
        return out
    rc = _lib().pc_scatter_add_rows(grad.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                    b_, n, m, c, _stream(grad))
    _check(rc, "scatter_add_rows")
    scatter_add_rows.launches += 1
    return out


# --------------------------------------------------------------------------
# K9 three_nn / three_interpolate / three_interpolate_grad


def three_nn_plain(unknown, known):
    u, k = unknown[:, :, None, :], known[:, None, :, :]
    d2 = torch.clamp_min((dot3_fma(u, u) + dot3_fma(k, k)) - 2.0 * dot3_fma(u, k),
                         0.0)
    idx = torch.sort(d2, dim=-1, stable=True).indices[..., :3]
    d = unknown[:, :, None, :] - gather_rows_plain(known, idx)
    return torch.sqrt(torch.clamp_min(dot3_fma(d, d), 0.0)), idx.to(torch.int32)


def three_nn(unknown, known):
    """[B, N, 3] unknown, [B, M, 3] known (M >= 3) f32 -> (dist [B, N, 3]
    f32, idx [B, N, 3] int32): per unknown point the three known points of
    least ``max(|u|^2 + |k|^2 - 2 u.k, 0)`` in ascending order, ties to the
    lower index (``lax.top_k``), and their distances recomputed as
    ``sqrt(|u - k|^2)``.  On the card a group of lanes scans each point's
    known cloud, a lane every G-th point, and merges the lanes' triples
    in (distance, index) order: the same indices and bits as the twin."""
    _check_cloud("three_nn unknown", unknown)
    _check_cloud("three_nn known", known)
    b_, n, _ = unknown.shape
    m = known.shape[1]
    if known.shape[0] != b_ or m < 3:
        raise ValueError(f"three_nn: {tuple(unknown.shape)} unknown over "
                         f"{tuple(known.shape)} known points")
    if _use_plain(known):
        return three_nn_plain(unknown, known)
    _require(unknown, "unknown", torch.float32, 3)
    _require(known, "known", torch.float32, 3)
    dist = torch.empty(b_, n, 3, dtype=torch.float32, device=known.device)
    idx = torch.empty(b_, n, 3, dtype=torch.int32, device=known.device)
    if b_ == 0 or n == 0:
        return dist, idx
    rc = _lib().pc_three_nn(_ptr(unknown), _ptr(known), _ptr(dist), _ptr(idx),
                            b_, n, m, _stream())
    _check(rc, "three_nn")
    three_nn.launches += 1
    return dist, idx


def _check_interp(name, idx, weight, b_, n=None):
    if idx.dim() != 3 or idx.shape[0] != b_ or idx.shape[2] != 3 or (
            n is not None and idx.shape[1] != n) or weight.shape != idx.shape:
        raise ValueError(f"{name}: index {tuple(idx.shape)} and weight "
                         f"{tuple(weight.shape)} for a batch of {b_}")


def three_interpolate_plain(feats, idx, weight):
    g = gather_rows_plain(feats, idx)  # [B, N, 3, C]
    w = weight[..., None]
    return fma_plain(g[:, :, 2], w[:, :, 2],
                     fma_plain(g[:, :, 1], w[:, :, 1], g[:, :, 0] * w[:, :, 0]))


def three_interpolate(feats, idx, weight):
    """feats [B, M, C] f32, idx [B, N, 3] int32, weight [B, N, 3] f32 ->
    [B, N, C]: ``fma(f[i2], w2, fma(f[i1], w1, f[i0] w0))`` per channel."""
    b_, m, c = feats.shape
    _check_interp("three_interpolate", idx, weight, b_)
    if _use_plain(feats):
        return three_interpolate_plain(feats, idx, weight)
    _require(feats, "feats", torch.float32, 3)
    _require(idx, "idx", torch.int32, 3)
    _require(weight, "weight", torch.float32, 3)
    n = idx.shape[1]
    out = torch.empty(b_, n, c, dtype=torch.float32, device=feats.device)
    rc = _lib().pc_three_interpolate(_ptr(feats), _ptr(idx), _ptr(weight),
                                     _ptr(out), b_, m, n, c, _stream())
    _check(rc, "three_interpolate")
    three_interpolate.launches += 1
    return out


def three_interpolate_grad_plain(grad, idx, weight, m: int):
    return scatter_add_rows_plain(grad[:, :, None, :] * weight[..., None], idx, m)


SMEM_PER_BLOCK = 232448  # bytes of shared memory a block may hold (sm_90)
INTERP_ROWS = 8  # known rows a block of three_interpolate_grad sums, a warp each
# unknown points a sample at most: the block keeps up to 3 N packed entries
# in shared memory, INTERP_ROWS lists of a 32-multiple each, beside a count
# and a 64-entry queue a warp
INTERP_MAX_N = ((SMEM_PER_BLOCK // 4 - 65 * INTERP_ROWS) // INTERP_ROWS // 32 * 32
                * INTERP_ROWS // 3)


def three_interp_entries(n: int) -> int:
    """The entries of a sample's [N, 3] index that each warp of a
    ``three_interpolate_grad`` block scans (a multiple of 32): the block's
    shared list holds ``INTERP_ROWS`` times as many.  Raises past
    ``INTERP_MAX_N`` unknown points."""
    if n > INTERP_MAX_N:
        raise ValueError(
            f"three_interpolate_grad: {n} unknown points a sample, over the "
            f"{INTERP_MAX_N} whose entries a block's {SMEM_PER_BLOCK} bytes "
            "of shared memory hold")
    return -(-3 * n // (32 * INTERP_ROWS)) * 32


def three_interpolate_grad(grad, idx, weight, m: int):
    """The backward of ``three_interpolate`` with respect to the features:
    grad [B, N, C] -> [B, m, C] with ``out[b, idx[b, n, j]] += grad[b, n] *
    weight[b, n, j]``.  Unknown points share known neighbours; on the card
    a warp sums each known row's products in registers in (n, j) order, as
    the twin's scatter-add does on the CPU, and writes the row once.  B N C
    and B m C must stay below 2^31, and N at most ``INTERP_MAX_N``, on
    either device."""
    b_, n, c = grad.shape
    _check_interp("three_interpolate_grad", idx, weight, b_, n)
    check_index_space("three_interpolate_grad", grad=b_ * n * c, out=b_ * m * c)
    entries = three_interp_entries(n)
    if _use_plain(grad):
        return three_interpolate_grad_plain(grad, idx, weight, m)
    _require(grad, "grad", torch.float32, 3)
    _require(idx, "idx", torch.int32, 3)
    _require(weight, "weight", torch.float32, 3)
    out = torch.empty(b_, m, c, dtype=torch.float32, device=grad.device)
    if out.numel() == 0:
        return out
    rc = _lib().pc_three_interpolate_grad(
        grad.data_ptr(), idx.data_ptr(), weight.data_ptr(), out.data_ptr(), b_, m,
        n, c, entries, _stream(grad))
    _check(rc, "three_interpolate_grad")
    three_interpolate_grad.launches += 1
    return out


KERNELS = (furthest_point_sample, ball_query, gather_rows, scatter_add_rows,
           three_nn, three_interpolate, three_interpolate_grad)
reset_launches()
