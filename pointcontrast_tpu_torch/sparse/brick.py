"""Brick (2^D micro-dense) sparse layout.

Jax-free port of ``pointcontrast_tpu/sparse/brick.py``: the same names,
plans and maps (``BrickMap`` and ``BrickDownMap`` are plain dataclasses in
place of ``flax.struct`` pytrees), and the three convs over the port's
kernels.  Each voxel sits in its parent "brick" (the 2^D cell of the next
pyramid level):

  * features at level l are ``[NB*2^D, C]`` with voxel (brick b, slot s) at
    row ``b*2^D + s``, slot s = sum_a s_a 2^a; ``NB = npad_{l+1}`` because a
    level-l brick IS a level-(l+1) coordinate.  Empty slots hold exactly
    zero (the padding invariant extends to slots);
  * a same-level conv reads whole brick rows of the 3^D neighbour bricks,
    which are the entries of the *coarser* level's same-level map:
    ``brick_conv``, an autograd Function over the ``brick_gemm`` and
    ``brick_wgrad`` kernels with JAX's scatter-free backward;
  * the k2s2 down conv is one dense ``[NB, 8*Cin] @ [8*Cin, Cout]`` matmul
    and a placement gather into the next level's bricks (``gather_sum`` at
    one tap, ``scatter_sum`` its adjoint);
  * the k2s2 transposed conv is a row gather of each fine brick's coarse
    parent and one ``[NB, Cin] @ [Cin, 8*Cout]`` matmul.

bf16 features (JAX's bf16 mode) run the bf16 forms with JAX's rounding:
every output, dF and dW the f32 sum of its bf16 x bf16 products rounded
once to bf16 (``brick_gemm_bf16``, ``brick_wgrad_bf16``; the two dense
products on the widened operands, whose f32 sums round once whatever
``allow_tf32`` and ``allow_bf16_reduced_precision_reduction`` say: a bf16
value is exact in TF32), the gathers ``gather_sum_bf16`` at one tap (a
copy) and their adjoints ``scatter_sum_bf16``'s store form (the maps name
each kept row once).

Weights are shaped as the flat ops' ([K, Cin, Cout] in the same
``kernel_offsets`` order), so one checkpoint runs in either layout.
"""
from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Any, NamedTuple

import numpy as np
import torch

from pointcontrast_tpu_torch.sparse import kernels
from pointcontrast_tpu_torch.sparse.kernel_map import kernel_offsets, offset_index
from pointcontrast_tpu_torch.sparse.ops import _GatherSum, mask_rows


class BrickPlan(NamedTuple):
    """Static schedule for a same-level brick conv.

    steps: per neighbour-brick offset d (a row of the coarse level's map):
      (d_idx, s_ranges, p_ranges, taps, is_center).  s_ranges/p_ranges are
      per-axis (lo, hi) slot ranges, ordered slowest axis first to match a
      row-major reshape of the slot dimension; taps[i][j] is the tap for
      the i-th input / j-th output slot of those ranges' row-major
      enumerations, or -1 when the pair falls outside the kernel."""

    steps: tuple
    num_taps: int
    num_slots: int
    dimension: int


@functools.lru_cache(maxsize=None)
def build_plan(kernel_size, dimension: int = 3, region: str = "hypercube",
               dilation: int = 1, axis_types: tuple | None = None) -> BrickPlan:
    """Plan a same-level conv in brick layout: kernels whose reach stays
    within one neighbour brick per axis (max |offset| <= 2)."""
    offs_k = kernel_offsets(kernel_size, dimension, region, dilation, axis_types)
    if int(np.abs(offs_k).max()) > 2:
        raise ValueError(
            f"brick layout supports kernel offsets |off|<=2, got {kernel_size}")
    tap_of = offset_index(offs_k)
    nbrs = kernel_offsets(3, dimension)  # coarse same-level map row order
    max_tap = int(np.abs(offs_k).max())
    steps = []
    for d_idx, d in enumerate(nbrs):
        # slot values per axis that reach some tap: 2*d_a + s_a - p_a
        s_vals, p_vals = [], []
        for a in range(dimension):
            s_vals.append([s for s in (0, 1)
                           if any(abs(2 * int(d[a]) + s - p) <= max_tap for p in (0, 1))])
            p_vals.append([p for p in (0, 1)
                           if any(abs(2 * int(d[a]) + s - p) <= max_tap for s in (0, 1))])
        if any(not v for v in s_vals + p_vals):
            continue
        # slot id = sum_a s_a * 2^a (axis 0 fastest): enumerate the ranges
        # slowest axis first
        s_list = [tuple(reversed(c)) for c in itertools.product(*reversed(s_vals))]
        p_list = [tuple(reversed(c)) for c in itertools.product(*reversed(p_vals))]
        taps = []
        any_tap = False
        for s in s_list:
            row = []
            for p in p_list:
                t = tuple(2 * int(d[a]) + s[a] - p[a] for a in range(dimension))
                row.append(tap_of.get(t, -1))
                any_tap |= t in tap_of
            taps.append(tuple(row))
        if not any_tap:
            continue
        s_ranges = tuple((min(v), max(v) + 1) for v in s_vals)
        p_ranges = tuple((min(v), max(v) + 1) for v in p_vals)
        steps.append((d_idx, s_ranges, p_ranges, tuple(taps), bool((d == 0).all())))
    return BrickPlan(steps=tuple(steps), num_taps=len(offs_k),
                     num_slots=1 << dimension, dimension=dimension)


@functools.lru_cache(maxsize=None)
def slot_steps(plan: BrickPlan) -> tuple:
    """The plan in slot form, as the kernels take it: per step (d_idx,
    is_center, T) with T[s][p] the tap from source slot s to output slot p
    (full slot ids), -1 where none.  The ONE place that reads the plan's
    slot-range ordering (slowest axis first, as ``build_plan`` enumerates)."""
    out = []
    for d_idx, s_ranges, p_ranges, taps, is_center in plan.steps:
        def slots(ranges):
            return [sum(v << a for a, v in enumerate(reversed(c)))
                    for c in itertools.product(*[range(lo, hi)
                                                 for lo, hi in reversed(ranges)])]

        s_slots, p_slots = slots(s_ranges), slots(p_ranges)
        tm = [[-1] * plan.num_slots for _ in range(plan.num_slots)]
        for i, s in enumerate(s_slots):
            for j, p in enumerate(p_slots):
                tm[s][p] = taps[i][j]
        out.append((d_idx, is_center, tuple(tuple(r) for r in tm)))
    return tuple(out)


@dataclasses.dataclass
class BrickMap:
    """Same-level conv geometry in brick layout: the coarse level's map, the
    static plan and the level's slot order (``slot_order``, built with the
    pyramid: the brick kernels tile the occupied slots first).
    ``.shape[0]`` is the kernel volume, as a flat map's."""

    nbr: Any  # [K3, NB] coarse same-level map (pad brick NB-1)
    plan: BrickPlan = None
    order: Any = None  # [NB*2^D] int32 slot rows, occupied first, or None

    @property
    def shape(self):
        return (self.plan.num_taps,)


@dataclasses.dataclass
class BrickDownMap:
    """Stride-2 k=2 down-conv geometry: where each conv output (a coarse
    voxel) sits in the next level's brick layout.  ``place=None`` marks the
    brick -> flat boundary: the matmul's output rows ARE the next level's
    flat rows."""

    place: Any  # [2^D, NB_next] = down_nbr of level l+1, or None
    num_slots: int = 8

    @property
    def shape(self):
        return (self.num_slots,)


def slot_order(valid: np.ndarray) -> np.ndarray:
    """[NB*2^D] int32: a brick level's slot rows, the occupied ones first in
    brick order (``flatnonzero(valid)``), then the empty slots and every
    slot of the pad bricks.  The brick kernels tile their output rows in
    this order, so the 128-row tiles past the occupied count hold no
    occupied slot and only write zeros; the shape stays the level's."""
    live = np.asarray(valid) > 0
    return np.concatenate([np.flatnonzero(live), np.flatnonzero(~live)]).astype(np.int32)


def build_brick_pyramid(coords: np.ndarray, num_levels: int, npads: list,
                        num_batch: int, dimension: int = 3,
                        conv0_kernel_size: int = 3, allow_truncate: bool = True,
                        brick_levels: int | None = None):
    """Build a hybrid pyramid: the finest ``brick_levels`` levels in brick
    layout (their maps read one level up), the rest flat, as the JAX
    package builds it, byte for byte.

    Returns (Pyramid, PyramidMeta, rows0, orphan0): rows0[v] the level-0
    row of input voxel v; orphan0[v] True when coarse truncation dropped
    v's brick (no row: callers drop it and count it).

    Brick levels reinterpret ``LevelTopo``'s fields: nbr/nbr0 a
    ``BrickMap``, down_nbr a ``BrickDownMap``, up_parent the flat up-gather
    rows (None at the boundary), up_offset None, valid/batch at slot
    resolution [NB*2^D]; the BrickMaps carry the level's ``slot_order``."""
    from pointcontrast_tpu_torch.sparse.topology import LevelTopo, Pyramid, build_pyramid

    bl = num_levels if brick_levels is None else max(0, min(brick_levels, num_levels))
    depth = num_levels + 1 if bl >= num_levels else num_levels
    if len(npads) < depth:
        raise ValueError(f"hybrid pyramid needs {depth} npads, got {len(npads)}")
    base, meta = build_pyramid(
        coords, num_levels=depth, dimension=dimension, npads=list(npads[:depth]),
        num_batch=num_batch, conv0_kernel_size=conv0_kernel_size,
        allow_truncate=allow_truncate, first_nbr_level=1 if bl >= 1 else 0)
    lv = base.levels
    ns = 1 << dimension
    plan3 = build_plan(3, dimension)
    plan0 = build_plan(conv0_kernel_size, dimension) if conv0_kernel_size != 3 else None
    levels = []
    for l in range(num_levels):
        if l >= bl:  # flat levels pass through unchanged
            levels.append(lv[l])
            continue
        pad_l = lv[l].valid.shape[0] - 1
        valid = (lv[l].down_nbr != pad_l).T.astype(np.float32).reshape(-1)
        batch = np.repeat(lv[l + 1].batch, ns).astype(np.int32)
        batch = np.where(valid > 0, batch, num_batch).astype(np.int32)
        order = slot_order(valid)
        next_is_brick = (l + 1) < bl
        upg = ((lv[l + 1].up_parent.astype(np.int64) * ns + lv[l + 1].up_offset)
               .astype(np.int32) if next_is_brick else None)
        levels.append(LevelTopo(
            nbr=BrickMap(lv[l + 1].nbr, plan3, order),
            valid=valid,
            batch=batch,
            down_nbr=BrickDownMap(lv[l + 1].down_nbr if next_is_brick else None,
                                  num_slots=ns),
            up_parent=upg,
            up_offset=None,
            nbr0=BrickMap(lv[l + 1].nbr, plan0, order) if l == 0 and plan0 else None,
        ))
    n0 = meta.counts[0]
    if bl >= 1:
        parent = lv[0].up_parent[:n0].astype(np.int64)
        orphan0 = parent == (lv[1].valid.shape[0] - 1)
        rows0 = (parent * ns + lv[0].up_offset[:n0]).astype(np.int64)
        rows0[orphan0] = 0  # callers must mask these via orphan0
    else:
        rows0 = np.arange(n0, dtype=np.int64)
        orphan0 = np.zeros(n0, dtype=bool)
    return Pyramid(levels=tuple(levels), num_batch=num_batch), meta, rows0, orphan0


@functools.lru_cache(maxsize=None)
def _tap_reversal(plan: BrickPlan):
    """Permutation over tap ids with offset(rev[t]) == -offset(t), from the
    plan's tap matrices (the taps of d at (s, p) and of -d at (p, s) are
    negations of each other); None when the tap set is not centrally
    symmetric."""
    by_d = {d_idx: (s_r, p_r, np.asarray(taps))
            for d_idx, s_r, p_r, taps, _ in plan.steps}
    k3 = 3 ** plan.dimension
    rev = np.full(plan.num_taps, -1, np.int64)
    for d_idx, (s_r, p_r, taps) in by_d.items():
        nd = k3 - 1 - d_idx  # hypercube enumeration: offset(k3-1-k) = -offset(k)
        if nd not in by_d:
            return None
        ns_r, np_r, ntaps = by_d[nd]
        if ns_r != p_r or np_r != s_r:
            return None
        for i in range(taps.shape[0]):
            for j in range(taps.shape[1]):
                t = taps[i, j]
                if t < 0:
                    continue
                t2 = ntaps[j, i]
                if t2 < 0:
                    return None
                rev[t] = t2
    if (rev < 0).any():
        return None
    return tuple(int(v) for v in rev)


class _BrickConv(torch.autograd.Function):
    """out = brick_gemm(F, W) at the occupied slots (``valid``), zeros at
    the others.  Backward (JAX ``_brick_sym_bwd``, scatter free): dF is the
    same brick conv of the cotangent with W'[t] = W[rev[t]]^T (the
    cotangent is zero at empty slots and pad bricks because the forward
    masks them), dW re-reads the forward's gathers (brick_wgrad); both
    leave out the empty slots, as the forward does."""

    @staticmethod
    def _kernels(features):
        """(gemm, wgrad) for the features' dtype, looked up when called (so
        that ``tools.workload.plain_ops`` can swap in the twins)."""
        if features.dtype == torch.bfloat16:
            return kernels.brick_gemm_bf16, kernels.brick_wgrad_bf16
        return kernels.brick_gemm, kernels.brick_wgrad

    @staticmethod
    def forward(ctx, features, nbr, weights, plan, rev, valid, order):
        steps = slot_steps(plan)
        out = _BrickConv._kernels(features)[0](features, nbr, steps, weights, valid, order)
        ctx.save_for_backward(features, nbr, weights, valid, order)
        ctx.steps, ctx.rev = steps, rev
        return out

    @staticmethod
    def backward(ctx, ct):
        features, nbr, weights, valid, order = ctx.saved_tensors
        gemm, wgrad = _BrickConv._kernels(features)
        ct = ct.contiguous()
        df = dw = None
        if ctx.needs_input_grad[0]:
            wrev = weights[list(ctx.rev)].transpose(1, 2).contiguous()
            df = gemm(ct, nbr, ctx.steps, wrev, valid, order)
        if ctx.needs_input_grad[2]:
            dw = wgrad(features, nbr, ctx.steps, ct, weights.shape[0], valid, order)
        return df, None, dw, None, None, None, None


def brick_conv(features: torch.Tensor,  # [NB*2^D, Cin], empty slots zero
               nbr: torch.Tensor,  # [K3, NB] coarse same-level map
               weights: torch.Tensor,  # [K_taps, Cin, Cout]
               plan: BrickPlan,
               bias: torch.Tensor | None = None,
               valid_out: torch.Tensor | None = None,
               order: torch.Tensor | None = None) -> torch.Tensor:
    """Same-level sparse conv over brick rows (JAX ``brick_conv``).  Only
    JAX's custom-VJP form is ported: a centrally symmetric tap set with
    ``valid_out``; JAX differentiates the other cases by autodiff of
    ``_brick_core``, which no model of the port reaches.  The kernels
    compute the occupied slots (``valid_out``: the level's, which is also
    the source's) from the occupied slots only, tiled in ``order`` (the
    ``BrickMap``'s ``slot_order``; None: the rows' own order).  bf16
    features and weights: the bf16 kernels, bf16 out, dF and dW."""
    rev = _tap_reversal(plan)
    if rev is None or valid_out is None:
        raise NotImplementedError(
            "brick_conv without a centrally symmetric tap set or without "
            "valid_out (JAX differentiates _brick_core by autodiff there): "
            "not ported, ROADMAP Queue 1 item 2b")
    out = _BrickConv.apply(features.contiguous(), nbr, weights.contiguous(), plan, rev,
                           valid_out, order)
    if bias is not None:  # in the activations' dtype, as JAX's b.astype(dtype)
        out = out + bias.to(out.dtype)
    return mask_rows(out, valid_out)


def _product(x, w):
    """x @ w; bf16 operands: the product of the widened operands (each
    bf16 x bf16 product exact in f32) rounded once, JAX's
    ``dot(preferred_element_type=f32).astype(bf16)``.  Its autodiff rounds
    dx and dw once each from their f32 sums too."""
    if x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def brick_down_conv(features: torch.Tensor,  # [NB*2^D, Cin] level-l brick rows
                    place: torch.Tensor | None,  # [2^D, NB_next] or None
                    weights: torch.Tensor,  # [2^D, Cin, Cout]
                    bias: torch.Tensor | None = None,
                    valid_out: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-2 k=2 conv: slots ARE the kernel offsets, so the conv is one
    dense matmul (``torch.matmul``, as JAX leaves it to XLA); the
    placement gather re-lays its rows (level-(l+1) voxels) into level
    l+1's bricks, slot-major.  ``place=None``: the rows are the flat next
    level's.  In bf16 the product is rounded before the gather, which
    copies it (JAX rounds after its ``take``: the same values)."""
    ns, cin, cout = weights.shape
    nb = features.shape[0] // ns
    y = _product(features.reshape(nb, ns * cin), weights.reshape(ns * cin, cout))
    if place is None:
        out = y
    else:
        rows = place.transpose(0, 1).reshape(1, 1, -1)  # out row b*ns+s <- place[s, b]
        out = _GatherSum.apply(y, rows.contiguous(), None)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out if valid_out is None else mask_rows(out, valid_out)


def brick_up_conv(features: torch.Tensor,  # [NB_coarse*2^D, Cin] level-(l+1) rows
                  up_gather: torch.Tensor | None,  # [NB_l] rows, or None
                  weights: torch.Tensor,  # [2^D, Cin, Cout]
                  bias: torch.Tensor | None = None,
                  valid_out: torch.Tensor | None = None) -> torch.Tensor:
    """Stride-2 k=2 transposed conv onto the reused finer level: a fine
    brick's id IS its coarse parent voxel and a fine voxel's slot IS its
    kernel offset, so this is one row gather (``gather_sum`` at one tap)
    and one [NB, Cin] @ [Cin, 2^D*Cout] matmul.  ``up_gather=None``: the
    coarse level is flat, and its rows already are the fine bricks'.  The
    gather's adjoint leaves out the coarse pad brick's 2^D slots: every
    pad source of the fine level points at its slot 0."""
    ns, cin, cout = weights.shape
    if up_gather is None:
        g = features
    else:
        g = _GatherSum.apply(features.contiguous(), up_gather.reshape(1, 1, -1), None,
                             features.shape[0] - ns)
    nb = g.shape[0]
    out = _product(g, weights.transpose(0, 1).reshape(cin, ns * cout)).reshape(nb * ns, cout)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out if valid_out is None else mask_rows(out, valid_out)
