"""The device kernels behind the sparse convolutions and global pooling.

Each kernel has three things side by side here:
  - ``<name>_plain``: the same function in plain torch (``gather``,
    ``matmul``, ``scatter_add_``).  The CPU tests use it, and it is the
    reference the CUDA kernel is compared with on the card;
  - ``<name>``: the wrapper.  A CPU tensor takes the plain version; a CUDA
    tensor launches the hand-written kernel from ``csrc/sparse_conv.cu``
    (built with nvcc for sm_90a into ``_build/`` at first use) or raises;
  - ``<name>.launches``: a plain int, +1 per kernel launch (not per plain
    call), so a run can show that its main path went through the kernel.

bf16 forms (``<name>_bf16``, their twins and counters beside the f32
ones): ``gather_gemm_bf16``, ``gather_wgrad_bf16``, ``parent_gemm_bf16``
and ``scatter_parent_bf16`` take the bf16 operands of JAX's bf16 mode and
keep its rounding points: bf16 x bf16 products summed in f32, each output
rounded once to bf16 (``gather_gemm_bf16``'s ``round_each_tap``: each tap
rounded first, JAX's flat ``_conv_core``; ``gather_wgrad_bf16`` writes f32
dW, A bf16 and G bf16 or f32, the f32 G the stacked dy of K3's parent
design; ``scatter_parent_bf16`` that f32 dy).  Their
twins gather bf16 and round as the kernels do, on exact (f64) sums for
``gather_gemm_bf16`` and f32 ones for the others.  ``gather_gemm_bf16``,
``parent_gemm_bf16`` and ``gather_wgrad_bf16`` on two bf16 operands run
on the tensor cores (mma.sync), summing in another order than the SIMT
forms: ``gather_gemm_bf16_bound``, ``parent_gemm_bf16_bound`` and
``gather_wgrad_bf16_bound`` give the distance from the exact sum their
outputs are held to (``parent_gemm_bf16(..., trans_w=True)``: K2's dF on
the forward's weights, read transposed in the kernel).
``scatter_gemm_bf16`` (K4's dF in bf16, on the tensor cores) scatter-adds
its products into one f32 table with f32 atomics and rounds it once
(``scatter_gemm_bf16_bound``); ``gather_sum_bf16`` and ``scatter_sum_bf16``
(the pools and their adjoints in bf16) round after every bf16 add in JAX's
order (tap order; ascending source row), with no atomics, bit-equal to
their twins.  ``brick_gemm_bf16`` and ``brick_wgrad_bf16`` (the brick
layout's conv in bf16, on the tensor cores) round each output once from
its f32 sum, their twins from the exact (f64) one
(``brick_gemm_bf16_bound``, ``brick_wgrad_bf16_bound``).  Every wrapper
checks each operand's dtype and raises on another (no cast inside a
wrapper; ``scatter_gemm``, ``gather_sum``, ``scatter_sum``, ``brick_gemm``
and ``brick_wgrad`` route a bf16 operand to their bf16 forms).

Operand convention (chunked layout): tables are [B, S, C] f32; a gathered
operand names its rows either through a frame-local map [K, B, S_out] int32
read at tap ``taps[j]`` (``map_ is not None``) or, for a stacked table,
as ``j * tap_stride + s``.  ``row_index`` spells that out.

Which JAX op each kernel replaces (all in ``pointcontrast_tpu/sparse/ops.py``,
custom-VJP XLA programs, except the Pallas probes; the bf16 forms the same
ops in JAX's bf16 mode):
  gather_gemm    K1 ``_conv_chunk_fused`` fwd and dF, K2 ``_conv_chunk_down2``
                 fwd, K3 ``_conv_tr_chunk`` dF (the cotangent gathered
                 through the level's down map, the parent map's inverse:
                 each live slot of JAX's stacked ``dy`` is one cotangent
                 row), K4 ``_conv_chunk_down_fused`` fwd
  gather_wgrad   K1/K2/K3/K4 dW (K3's through the same down map)
  parent_gemm    K3 fwd, K2 dF (with W_k^T)
  scatter_parent JAX K3 bwd's scatter-add into the stacked [8*S_c, Cout]
                 table, the coarse pad slot left out (a row store): K3's
                 parent design, which no op runs (``chip_smoke.py`` times it
                 beside the down-map gathers; a stacked table is read by
                 gather_gemm / gather_wgrad as ``j * tap_stride + s``)
  scatter_gemm   the flat-map conv ``_conv_core``'s dF (its autodiff: a
                 scatter of ct W_k^T at the map's rows; its forward is
                 gather_gemm and its dW gather_wgrad, at B = 1), and K4's dF
                 (children of overlapping k3s2 windows have many parents)
  segment_sum    ``global_pool``'s segment sum and ``broadcast_to_points``'
                 backward (the adjoint of its row gather)
  gather_sum     K5 ``sparse_sum_pool``, ``sparse_avg_pool`` (and its count
                 of present children, at C = 1) and ``sparse_avg_unpool``
                 (K = 1, the parent gather); also the function of the nine
                 Pallas gather probes (``experiments/pallas_gather_probe*.py``:
                 ``table[idx]`` and ``sum_k table[nbr[k]]``, as [1, N, C]
                 tables and [K, 1, M] maps)
  scatter_sum    the pooling ops' backward, the adjoint of gather_sum (and
                 of ``jnp.take`` in the brick layout's placement and up
                 gathers, ``pointcontrast_tpu/sparse/brick.py:465``, ``:491``)
  scatter_gemm_bf16, gather_sum_bf16, scatter_sum_bf16: K4's dF
                 (``_conv_chunk_down_fused_bwd``, :578-615, and the flat
                 conv's) and the pools (:906-964) in bf16
The same kernels run the voxel (flat) layout at B = 1, a flat [K, N] map
taken as [K, 1, N]: JAX ``_conv_sym`` (K1's three), the flat k2s2 down
conv (K2's), the flat transposed conv (K3's) and the flat pooling ops
(gather_sum, scatter_sum); gather_sum and scatter_sum at K = 1 are also
the brick layout's placement and up gathers.  Two kernels serve the brick
layout's same-level conv (``pointcontrast_tpu/sparse/brick.py``):
  brick_gemm     ``_brick_core``: the forward of ``brick_conv`` and, with
                 W'[t] = W[rev[t]]^T, its dF (``_brick_sym_bwd``)
  brick_wgrad    ``_brick_sym_bwd``'s dW (the gs^T @ cp blocks)
  brick_gemm_bf16, brick_wgrad_bf16: the same in JAX's bf16 mode
What bounds them on an H100: the gather kernels read every gathered row once
per tap at 4*Cin bytes and do 2*Cin*Cout flop per row and tap, so at the
slice's widths (Cin, Cout >= 32) they are bound by f32 SIMT issue (67 TFLOP/s
peak without tensor cores), not by the 3.35 TB/s of HBM, on the pairs whose
gathered rows are live: the sparse ops name the chunk's zero pad row as
``skip``; gather_gemm skips (16-row fragment, tap) pairs without a live
row, gather_wgrad compacts its live pairs, both pipeline their copies with
cp.async (csrc/sparse_conv.cu spells out the designs).
parent_gemm (2 Cin Cout operations a fine row) runs gather_gemm's pipeline
over the fine rows in the pyramid's up order (``topology.up_order``), one
offset's weights a step, the parent rows of the other offsets zero-filled;
its bf16 form the same tiles on the tensor cores.
scatter_parent stores rows (HBM bytes bound it): its valid rows never
collide, and the coarse pad slot, which pad and orphaned fine rows all
name, is left out, so no atomic remains.
scatter_gemm (2*Cin*Cout flop per (row, tap) pair whose destination is
live) runs gather_gemm's pipeline over the cotangent rows in the map's live
order, compacts each 128-row tile's live rows a tap (computing them
rounded up to 16) and adds each tap's products with float4 f32 atomics (a
map may repeat a destination); segment_sum reads each
row once (bound by HBM bytes) in lane groups that sum a run of ids in
registers, and its last block adds the blocks' partials in block order (no
f32 atomic at up to SEG_SMEM segments).  gather_sum does no multiply: it
reads each gathered row once and
writes each output row once (bound by HBM bytes), float4 along C, a group
of lanes a row that reads the row's indices once and adds the kept rows
in tap order (a row copy at one tap); its
adjoint scatter_sum reads each kept cotangent row once and adds it with
16-byte f32 atomics (HBM bytes too): a group of lanes a row reads the
row's destinations first and reads nothing for a row whose destinations
all lie at or past ``skip_from``, the source's pad rows, where every
missing child of a map points (on a brick table the pad brick's 8 slots:
left in, they turned 17k adds onto one row).  brick_gemm and brick_wgrad
do 2*Cin*Cout flop per (tap, output slot) pair whose output and source slots
are both occupied (f32 arithmetic bounds them); they take the level's
``valid`` and slot order (``brick.slot_order``: occupied slots first), run
gather_gemm's and gather_wgrad's pipelines over the occupied output slots,
read a row's source at each tap from the plan's slot table
(``brick_slot_table``) and skip the empty sources, and write exact zeros at
the empty slots.  ``brick_gemm_bf16`` runs the same tiles on the tensor
cores; ``brick_wgrad_bf16`` compacts each tap's live pairs brick by brick
and, up to ``BRICK_NARROW`` input channels, multiplies whole bricks a
neighbour row instead (JAX's block product; csrc/sparse_conv.cu spells out
both).
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from pointcontrast_tpu_torch import cuda_build
from pointcontrast_tpu_torch.cuda_build import check as _check
from pointcontrast_tpu_torch.cuda_build import check_index_space
from pointcontrast_tpu_torch.cuda_build import ptr as _ptr
from pointcontrast_tpu_torch.cuda_build import require as _require
from pointcontrast_tpu_torch.cuda_build import stream as _stream
from pointcontrast_tpu_torch.cuda_build import use_plain as _use_plain

MAX_TAPS = 32
# gather_gemm: output rows of a block tile, and the blocks below which it
# splits a tile's taps over several blocks (two waves of 132 SMs)
GEMM_ROWS = 128
GEMM_BLOCKS = 2 * 132
# scatter_gemm: the blocks below which it splits a tile's steps, four
# times gather_gemm's: at the deep levels most warps of a tile are past
# its taps' few live rows, and shorter blocks keep two an SM busy to the
# end (the fastest of one, two, four, eight and sixteen times on the
# ResNets' K4 dF: ``chip_smoke.py --scatter-blocks``)
SCATTER_BLOCKS = 4 * GEMM_BLOCKS
# segment_sum: the segments its deterministic path takes (csrc seg::SMEM;
# the callers' num_batch + 1 <= 9), and the blocks a launch aims at over
# all its channel tiles (two an SM)
SEG_SMEM = 16
SEG_BLOCKS = 264
# gather_wgrad: blocks to aim at (eight waves of 132 SMs, for balance: a
# block's work is its slice's live pairs; the fastest of 2, 4, 8 and 16
# waves for the tensor-core form too: ``chip_smoke.py --wgrad-blocks``)
WGRAD_BLOCKS = 8 * 132
BF16 = torch.bfloat16


class TapList(ctypes.Structure):
    _fields_ = [("idx", ctypes.c_int * MAX_TAPS)]


def _taps_struct(taps) -> TapList:
    return _tap_list(tuple(taps or ()))


@functools.lru_cache(maxsize=None)
def _tap_list(taps: tuple) -> TapList:
    # ctypes passes the struct by value: one cached instance per tap list
    t = TapList()
    for i, v in enumerate(taps):
        t.idx[i] = v
    return t


@functools.cache
def _lib():
    vp, ci = ctypes.c_void_p, ctypes.c_int
    return cuda_build.load("sparse_conv", {
        "pc_gather_gemm": [vp, vp, TapList, ci, ci, vp, vp, vp, vp, vp, vp,
                           ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        "pc_gather_gemm_tile_n": [ci, ci, ci],
        "pc_gather_wgrad": [vp, vp, TapList, ci, ci, ci, ci, vp, vp, TapList,
                            ci, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp],
        "pc_gather_wgrad_tiles": [ci, ci, ci],
        "pc_parent_gemm": [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp],
        "pc_scatter_parent": [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp],
        "pc_scatter_gemm": [vp, vp, TapList, ci, vp, vp, vp, ci, ci, ci, ci, ci,
                            ci, ci, ci, vp],
        "pc_scatter_gemm_tile_n": [ci, ci],
        "pc_segment_sum": [vp, vp, vp, vp, ctypes.c_longlong, vp, ci, ci, ci, ci, ci,
                           vp],
        "pc_segment_sum_plan": [vp, ci, ci, ci, vp],
        "pc_gather_sum": [vp, vp, TapList, ci, ci, vp, ci, ci, ci, ci, ci, ci, vp],
        "pc_scatter_sum": [vp, vp, TapList, ci, ci, vp, ci, ci, ci, ci, ci, ci, vp, ci,
                           vp, vp],
        "pc_brick_gemm": [vp, vp, ci, vp, ci, ci, vp, vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_brick_wgrad": [vp, vp, vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, vp],
        "pc_brick_wgrad_bf16": [vp, vp, ci, vp, ci, ci, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                                ci, vp],
    })


def _check_rows(name, map_, taps, tap_stride, n, b_, s_rows, s_table):
    """Raise unless n blocks of a gathered operand stay inside its
    [B, s_table] table: a map is [K, B, s_rows] and read at n listed taps,
    a stacked table holds n blocks of ``tap_stride`` rows.  (The map's
    values are checked against their chunk by ``PairBatch.to``.)"""
    if map_ is not None:  # spelt for a launch's host cost: a few µs a call
        shape = map_.shape
        if len(shape) != 3 or shape[1] != b_ or shape[2] != s_rows:
            raise ValueError(f"{name}: map of shape {tuple(shape)}, "
                             f"expected [K, {b_}, {s_rows}]")
        if len(taps) < n or (n > 0 and not 0 <= min(taps[:n]) <= max(taps[:n]) < shape[0]):
            raise ValueError(f"{name}: need {n} taps in [0, {shape[0]}), "
                             f"got {list(taps)}")
    elif (n - 1) * tap_stride + s_rows > s_table:
        raise ValueError(f"{name}: {n} blocks of stride {tap_stride} and "
                         f"{s_rows} rows overrun a table of {s_table} rows")


def _check_shape(name, t, shape):
    if t is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNELS}


# --------------------------------------------------------------------------
# plain-torch helpers


def row_index(map_, taps, tap_stride: int, j: int, b_: int, s_out: int,
              device) -> torch.Tensor:
    """[B, S_out] int64 rows of tap j (see the module docstring)."""
    if map_ is not None:
        return map_[int(taps[j])].long()
    return (j * tap_stride + torch.arange(s_out, device=device)).expand(b_, s_out)


def take_rows(x3: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-chunk row gather: x3 [B, S, C], idx [B, S_out] -> [B, S_out, C]."""
    return torch.gather(x3, 1, idx.unsqueeze(-1).expand(-1, -1, x3.shape[-1]))


# --------------------------------------------------------------------------
# (a) gather_gemm


def _kept(rows, skip):
    """[..., 1] bool: the gathered rows that are not ``skip``."""
    return (rows != skip)[..., None]


def _wide(t):
    """A bf16 operand widened to f32 (exact) for a twin's products; any
    other tensor, and None, as it is."""
    return t.float() if t is not None and t.dtype == BF16 else t


def gather_gemm_plain(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None,
                      round_each_tap=False, f32_out=False):
    # ``order`` only orders the kernel's tiles: every row's sum is the same.
    # bf16 operands: rows gathered in bf16, their products summed exactly
    # (f64) and each sum rounded once to bf16; ``round_each_tap`` (JAX's
    # flat _conv_core): each tap's exact product rounded to bf16, the
    # rounded taps (in list order, the centre last) summed exactly and the
    # sum rounded again (``f32_out``: to f32 instead).  The kernel's f32
    # sums round the same way but where a rounding boundary lies within
    # their error (``gather_gemm_bf16_bound``)
    b_, s_in, _ = x3.shape
    acc = torch.float64 if x3.dtype == BF16 else x3.dtype

    def product(rows, wj):
        p = rows.to(acc) @ wj.to(acc)
        return p.to(x3.dtype).to(acc) if round_each_tap else p

    centre = None
    if wc is not None:
        xc = x3[:, :s_out]
        if 0 <= skip < s_out:
            xc = torch.where(_kept(torch.arange(s_out, device=x3.device), skip), xc, 0.0)
        centre = product(xc, wc)
    if centre is None or round_each_tap:
        out = x3.new_zeros(b_, s_out, w.shape[-1], dtype=acc)
    else:
        out = centre
    for j in range(w.shape[0]):
        idx = row_index(map_, taps, tap_stride, j, b_, s_out, x3.device)
        rows = take_rows(x3, idx)
        if skip >= 0:
            rows = torch.where(_kept(idx, skip), rows, 0.0)
        out = out + product(rows, w[j])
    if centre is not None and round_each_tap:
        out = out + centre
    return out.to(torch.float32 if f32_out else x3.dtype)


gather_gemm_bf16_plain = gather_gemm_plain  # the twin takes both dtypes

# How far an output of the bf16 gather GEMMs may lie from the exact (f64)
# sum of its bf16 x bf16 products (exact in f32 and f64), whatever order
# the kernel adds them in: each f32 add is off by at most one f32 ulp
# (2^-23 relative: the tensor cores' adds may truncate), so a sum of n
# terms is off by at most gamma(n) = n u / (1 - n u) of the sum of their
# magnitudes (Higham, Accuracy and Stability of Numerical Algorithms,
# eq. 4.4, any order of summation); a rounding to bf16 moves a value by at
# most 2^-8 of it.  Derived, not fitted: the card's checks print each
# output's largest ratio to it.
F32_ADD_ULP = 2.0 ** -23
BF16_HALF_ULP = 2.0 ** -8


def _gamma(n):
    """gamma(n) of an int, or of a tensor of counts, elementwise."""
    return n * F32_ADD_ULP / (1 - n * F32_ADD_ULP)


def gather_gemm_bf16_bound(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None,
                           round_each_tap=False, f32_out=False):
    """(ref, bound), f64 [B, s_out, Cout]: the exact sum of the products
    ``gather_gemm_bf16`` computes, and how far from it an output may lie.
    One rounding: an f32 sum of the T Cin products, rounded once, lies
    within 2^-8 |ref| + (1 + 2^-8) gamma(T Cin) P, P the sum of |products|.
    ``round_each_tap``: tap t's f32 sum rounds to within e_t = 2^-8 |T_t| +
    (1 + 2^-8) gamma(Cin) P_t of its exact T_t, the f32 sum of the T
    rounded taps to within E = sum_t e_t + gamma(T) sum_t (|T_t| + e_t) of
    ref, and its rounding to within 2^-8 |ref| + (1 + 2^-8) E (``f32_out``:
    no last rounding, E itself)."""
    b_, _, cin = x3.shape
    f64 = torch.float64
    ref = size = spread = None

    def add(rows, wj):
        nonlocal ref, size, spread
        r, wj = rows.to(f64), wj.to(f64)
        t, p = r @ wj, r.abs() @ wj.abs()
        e = (BF16_HALF_ULP * t.abs() + (1 + BF16_HALF_ULP) * _gamma(cin) * p
             if round_each_tap else p)
        ref, size = (t, e) if ref is None else (ref + t, size + e)
        if round_each_tap:  # sum_t (|T_t| + e_t)
            spread = t.abs() + e if spread is None else spread + t.abs() + e

    for j in range(w.shape[0]):
        idx = row_index(map_, taps, tap_stride, j, b_, s_out, x3.device)
        rows = take_rows(x3, idx)
        add(torch.where(_kept(idx, skip), rows, 0.0) if skip >= 0 else rows, w[j])
    if wc is not None:
        xc = x3[:, :s_out]
        if 0 <= skip < s_out:
            xc = torch.where(_kept(torch.arange(s_out, device=x3.device), skip), xc, 0.0)
        add(xc, wc)
    taps_n = w.shape[0] + (wc is not None)
    err = (size + _gamma(taps_n) * spread if round_each_tap
           else _gamma(taps_n * cin) * size)
    if f32_out:
        return ref, err
    return ref, BF16_HALF_ULP * ref.abs() + (1 + BF16_HALF_ULP) * err


def _gemm_splits(b_, s_out, cout, ntap, tile_n=None) -> int:
    """Blocks over which gather_gemm spreads one tile's taps: one, unless
    its tiles (128 rows x the kernel's Cout tile ``tile_n``, by default the
    f32 kernel's, per chunk) come to fewer than GEMM_BLOCKS; then enough to
    get there, with 3 taps a split at least."""
    tile_n = _gemm_tile_n(cout) if tile_n is None else tile_n
    blocks = -(-s_out // GEMM_ROWS) * -(-cout // tile_n) * b_
    if blocks >= GEMM_BLOCKS or ntap < 6:
        return 1
    return min(ntap // 3, -(-GEMM_BLOCKS // blocks))


def _scatter_splits(b_, s_out, cin, steps, tile_n=None) -> int:
    """Blocks over which scatter_gemm spreads one tile's ``steps`` (taps x
    32-deep Cout chunks): one, unless its tiles (128 rows x the kernel's
    Cin tile ``tile_n``, by default the f32 kernel's, per chunk) come to
    fewer than SCATTER_BLOCKS, or it has fewer than 6 steps; then enough to
    get there, with 3 steps a split at least."""
    tile_n = _gemm_tile_n(cin) if tile_n is None else tile_n
    blocks = -(-s_out // GEMM_ROWS) * -(-cin // tile_n) * b_
    if blocks >= SCATTER_BLOCKS or steps < 6:
        return 1
    return min(steps // 3, -(-SCATTER_BLOCKS // blocks))


@functools.lru_cache(maxsize=None)
def _gemm_tile_n(cout: int) -> int:
    return _lib().pc_gather_gemm_tile_n(cout, 0, 0)


@functools.lru_cache(maxsize=None)
def _gemm_tile_n_bf16(cout: int, round_each_tap: bool) -> int:
    """gather_gemm_bf16's Cout tile (the tensor-core kernel's: up to 128,
    64 under ``round_each_tap``, whose second accumulator set doubles the
    registers)."""
    return _lib().pc_gather_gemm_tile_n(cout, 1, int(round_each_tap))


def _refuse_bf16(name, t, form):
    """An f32 kernel's wrapper refuses a bf16 operand (on either device):
    its bf16 form is ``form``."""
    if t is not None and t.dtype == BF16:
        raise TypeError(f"{name} takes float32; a bfloat16 operand goes to {form}")


def _require_dtypes(name, dtype, **operands):
    """A bf16 form's wrapper: raise unless every operand given (None
    passes) has ``dtype``, on either device."""
    for what, t in operands.items():
        if t is not None and t.dtype != dtype:
            raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")


def _gemm_shapes(x3, map_, taps, tap_stride, w, wc, s_out, order):
    b_, s_in, cin = x3.shape
    g, _, cout = w.shape
    if wc is not None and s_in != s_out:
        raise ValueError("the centre tap needs S_in == S_out")
    _check_shape("w", w, (g, cin, cout))
    _check_shape("wc", wc, (cin, cout))
    _check_rows("gather_gemm", map_, taps, tap_stride, g, b_, s_out, s_in)
    _check_shape("order", order, (b_, s_out))
    check_index_space("gather_gemm", x3_rows=b_ * s_in, out_rows=b_ * s_out)


def _gather_gemm_launch(name, x3, map_, taps, tap_stride, w, wc, s_out, skip, order,
                        dtype, round_each_tap=False, f32_out=False):
    """The gather-GEMM kernel on ``dtype`` (f32 or bf16: the tensor-core
    kernel, ``round_each_tap`` and ``f32_out`` its modes) operands -> (the
    output in ``dtype``, f32 under ``f32_out``, launches: 0 or 1); split
    partials in f32."""
    b_, s_in, cin = x3.shape
    g, _, cout = w.shape
    _require(x3, "x3", dtype, 3)
    _require(w, "w", dtype, 3)
    _require(wc, "wc", dtype, 2)
    _require(order, "order", torch.int32, 2)
    _require(map_, "map", torch.int32, 3)
    if g > MAX_TAPS:
        raise ValueError(f"{g} taps > {MAX_TAPS}")
    out = torch.empty(b_, s_out, cout, device=x3.device,
                      dtype=torch.float32 if f32_out else dtype)
    if out.numel() == 0:
        return out, 0
    ntap = g + (wc is not None)
    tile_n = (_gemm_tile_n_bf16(cout, round_each_tap) if dtype == BF16
              else _gemm_tile_n(cout))
    splits = _gemm_splits(b_, s_out, cout, ntap, tile_n)
    ws = tickets = None
    if splits > 1:
        ws = torch.empty(splits, b_, s_out, cout, device=x3.device, dtype=torch.float32)
        tiles = -(-s_out // GEMM_ROWS) * -(-cout // tile_n) * b_
        tickets = torch.zeros(tiles, device=x3.device, dtype=torch.int32)
    rc = _lib().pc_gather_gemm(
        _ptr(x3), _ptr(map_), _taps_struct(taps), tap_stride, g, _ptr(w),
        _ptr(wc), _ptr(order), _ptr(out), _ptr(ws), _ptr(tickets), splits, b_,
        s_in, s_out, cin, cout, int(skip), int(dtype == BF16), int(round_each_tap),
        int(f32_out), _stream())
    _check(rc, name)
    return out, 1


def gather_gemm(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None):
    """out[b,s] = [x3[b,s] @ wc] + sum_j x3[b, row(j,b,s)] @ w[j], every
    product whose gathered row is ``skip`` left out (-1: none; the centre
    tap's row is s).  The sparse ops pass a chunk's pad row, whose features
    or cotangent are zero by contract, so leaving it out changes nothing but
    the work.  ``order`` [B, s_out] int32, optional: each chunk's output
    rows in the order the kernel tiles them (the map's live order, built
    with the pyramid, ``topology.live_order``), so that rows which gather
    at the same taps share 16-row fragments; any permutation of each
    chunk's rows gives the same sum (a row no entry names is never written).

    x3 [B, S_in, Cin]; w [G, Cin, Cout] (one block per gathered tap);
    wc [Cin, Cout] or None: the ungathered centre tap (needs S_in == S_out);
    returns [B, s_out, Cout], all f32 (bf16 operands go to
    ``gather_gemm_bf16``).  On the card the sum is the same from run to
    run: where the taps are split over blocks (``_gemm_splits``), the
    partial sums are added in split order."""
    _gemm_shapes(x3, map_, taps, tap_stride, w, wc, s_out, order)
    _refuse_bf16("gather_gemm", x3, "gather_gemm_bf16")
    if _use_plain(x3):
        return gather_gemm_plain(x3, map_, taps, tap_stride, w, wc, s_out, skip)
    out, n = _gather_gemm_launch("gather_gemm", x3, map_, taps, tap_stride, w, wc, s_out,
                                 skip, order, torch.float32)
    gather_gemm.launches += n
    return out


def gather_gemm_bf16(x3, map_, taps, tap_stride, w, wc, s_out, skip=-1, order=None,
                     round_each_tap=False, f32_out=False):
    """``gather_gemm`` on bf16 operands (x3, w and wc bf16; JAX's bf16 conv
    products, ``preferred_element_type=f32``): each output row's products
    and their sum in f32, rounded once to bf16 -> [B, s_out, Cout] bf16.
    ``round_each_tap``: JAX's flat ``_conv_core`` instead, each tap's f32
    product rounded to bf16 before the f32 sum over the taps (in list
    order, the centre last), and the sum rounded again.  ``f32_out``, in
    either mode: the sum left in f32 (-> f32: a conv of more than MAX_TAPS
    taps adds its launches' sums and rounds once, as JAX's one
    accumulator).  Where the taps are split over blocks, the f32 partials
    are added in split order and the sum rounded once: the same bits from
    run to run."""
    _gemm_shapes(x3, map_, taps, tap_stride, w, wc, s_out, order)
    _require_dtypes("gather_gemm_bf16", BF16, x3=x3, w=w, wc=wc)
    if _use_plain(x3):
        return gather_gemm_bf16_plain(x3, map_, taps, tap_stride, w, wc, s_out, skip,
                                      round_each_tap=round_each_tap, f32_out=f32_out)
    out, n = _gather_gemm_launch("gather_gemm_bf16", x3, map_, taps, tap_stride, w, wc,
                                 s_out, skip, order, BF16, round_each_tap, f32_out)
    gather_gemm_bf16.launches += n
    return out


# --------------------------------------------------------------------------
# (b) gather_wgrad


def gather_wgrad_plain(a3, a_map, a_taps, a_stride, g3, g_map, g_taps,
                       g_stride, k, s_rows, skip_a=-1, skip_g=-1):
    # bf16 operands: rows gathered as they are, products and sums in f32
    b_ = a3.shape[0]
    dw = []
    for j in range(k):
        ia = row_index(a_map, a_taps, a_stride, j, b_, s_rows, a3.device)
        ig = row_index(g_map, g_taps, g_stride, j, b_, s_rows, a3.device)
        ra, rg = take_rows(a3, ia), take_rows(g3, ig)
        if skip_a >= 0 or skip_g >= 0:
            ra = torch.where(_kept(ia, skip_a) & _kept(ig, skip_g), ra, 0.0)
        dw.append(torch.einsum("bsc,bsd->cd", _wide(ra), _wide(rg)))
    return torch.stack(dw)


gather_wgrad_bf16_plain = gather_wgrad_plain


def bound_ratio(got, ref, bound) -> float:
    """The largest |got - ref| / bound of an output against its bound
    (``gather_gemm_bf16_bound``, ``gather_wgrad_bf16_bound``): at most 1
    where it holds; an output off an exact zero bound counts as inf."""
    err = (got.double() - ref).abs()
    ratio = torch.where(bound > 0, err / bound.clamp(min=1e-300),
                        torch.where(err > 0, float("inf"), 0.0))
    return float(ratio.max()) if ratio.numel() else 0.0


def gather_wgrad_bf16_bound(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride,
                            k, s_rows, skip_a=-1, skip_g=-1):
    """(ref, bound), f64 [k, Ca, Cg]: the exact sum of the products
    ``gather_wgrad_bf16`` computes (its output is f32: no bf16 rounding),
    and how far from it an f32 sum of tap j's n_j kept pairs may lie:
    gamma(n_j) of the sum of |products| (``gather_gemm_bf16_bound``)."""
    b_ = a3.shape[0]
    f64 = torch.float64
    ref, bound = [], []
    for j in range(k):
        ia = row_index(a_map, a_taps, a_stride, j, b_, s_rows, a3.device)
        ig = row_index(g_map, g_taps, g_stride, j, b_, s_rows, a3.device)
        kept = _kept(ia, skip_a) & _kept(ig, skip_g)
        ra = torch.where(kept, take_rows(a3, ia), 0.0).to(f64)
        rg = torch.where(kept, take_rows(g3, ig), 0.0).to(f64)
        ref.append(torch.einsum("bsc,bsd->cd", ra, rg))
        size = torch.einsum("bsc,bsd->cd", ra.abs(), rg.abs())
        bound.append(_gamma(int(kept.sum())) * size)
    return torch.stack(ref), torch.stack(bound)


@functools.lru_cache(maxsize=None)
def _wgrad_tiles(ca: int, cg: int, mma: bool = False) -> int:
    """gather_wgrad's output tiles: the SIMT forms', or (``mma``) the
    tensor-core form's, up to 128 channels a side (128 x 64 at most where
    both sides take 128: csrc ``gw::qs_for``)."""
    return _lib().pc_gather_wgrad_tiles(ca, cg, int(mma))


def _wgrad_shapes(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows):
    b_, sa, _ = a3.shape
    _, sg, cg = g3.shape
    _check_shape("g3", g3, (b_, sg, cg))
    _check_rows("gather_wgrad a", a_map, a_taps, a_stride, k, b_, s_rows, sa)
    _check_rows("gather_wgrad g", g_map, g_taps, g_stride, k, b_, s_rows, sg)
    check_index_space("gather_wgrad", rows=b_ * s_rows, a3_rows=b_ * sa, g3_rows=b_ * sg)


def _gather_wgrad_launch(name, a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride,
                         k, s_rows, skip_a, skip_g, a_dtype, g_dtype):
    """The wgrad kernel on an ``a_dtype`` a3 and a ``g_dtype`` g3 (f32 or
    bf16 each) -> (dW [k, Ca, Cg] f32, launches: 0 or 1)."""
    b_, sa, ca = a3.shape
    _, sg, cg = g3.shape
    _require(a3, "a3", a_dtype, 3)
    _require(g3, "g3", g_dtype, 3)
    _require(a_map, "a_map", torch.int32, 3)
    _require(g_map, "g_map", torch.int32, 3)
    if k > MAX_TAPS:
        raise ValueError(f"{k} taps > {MAX_TAPS}")
    rows = b_ * s_rows
    if rows == 0 or k == 0:
        return torch.zeros(k, ca, cg, device=a3.device, dtype=torch.float32), 0
    tiles = _wgrad_tiles(ca, cg, a_dtype == BF16 and g_dtype == BF16)
    slices = max(1, min(-(-rows // 256), -(-WGRAD_BLOCKS // (tiles * k))))
    per_block = -(-rows // slices)
    slices = -(-rows // per_block)
    ws = tickets = None
    if slices > 1:
        ws = torch.empty(slices, k, ca, cg, device=a3.device, dtype=torch.float32)
        tickets = torch.zeros(tiles * k, device=a3.device, dtype=torch.int32)
    dw = torch.empty(k, ca, cg, device=a3.device, dtype=torch.float32)
    rc = _lib().pc_gather_wgrad(
        _ptr(a3), _ptr(a_map), _taps_struct(a_taps), a_stride, sa, ca, int(skip_a),
        _ptr(g3), _ptr(g_map), _taps_struct(g_taps), g_stride, sg, cg, int(skip_g),
        _ptr(dw), _ptr(ws), _ptr(tickets), k, b_, s_rows, per_block,
        int(a_dtype == BF16), int(g_dtype == BF16), _stream())
    _check(rc, name)
    return dw, 1


def gather_wgrad(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride,
                 k, s_rows, skip_a=-1, skip_g=-1):
    """dW[j] = sum_{b, s < s_rows} a3[b, rowA(j,b,s)]^T @ g3[b, rowG(j,b,s)],
    every pair whose A row is ``skip_a`` or whose G row is ``skip_g`` left
    out (-1: none).

    a3 and g3 f32 (a bf16 a3 goes to ``gather_wgrad_bf16``); returns
    [k, Ca, Cg] f32.  On the card each block reduces the live pairs of one
    tap's row slice (about ``WGRAD_BLOCKS`` blocks in all, slices of 256
    rows at least), and the slices' partial sums are added in slice order,
    so dW is the same from run to run."""
    _wgrad_shapes(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows)
    _refuse_bf16("gather_wgrad", a3, "gather_wgrad_bf16")
    _refuse_bf16("gather_wgrad", g3, "gather_wgrad_bf16")
    if _use_plain(a3):
        return gather_wgrad_plain(a3, a_map, a_taps, a_stride, g3, g_map,
                                  g_taps, g_stride, k, s_rows, skip_a, skip_g)
    dw, n = _gather_wgrad_launch("gather_wgrad", a3, a_map, a_taps, a_stride, g3, g_map,
                                 g_taps, g_stride, k, s_rows, skip_a, skip_g,
                                 torch.float32, torch.float32)
    gather_wgrad.launches += n
    return dw


def gather_wgrad_bf16(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride,
                      k, s_rows, skip_a=-1, skip_g=-1):
    """``gather_wgrad`` with a bf16 a3 (the features) and a bf16 or f32 g3
    (the cotangent; the stacked ``dy`` of K3's parent design is f32): JAX's
    ``F.f32^T @ ct.f32``, products and sums in f32 -> [k, Ca, Cg] f32.  The
    sparse ops round it to the weights' dtype, as JAX's ``dw.astype``.  The
    same bits from run to run (slices added in slice order)."""
    _wgrad_shapes(a3, a_map, a_taps, a_stride, g3, g_map, g_taps, g_stride, k, s_rows)
    _require_dtypes("gather_wgrad_bf16", BF16, a3=a3)
    if g3.dtype not in (BF16, torch.float32):
        raise TypeError(f"gather_wgrad_bf16: g3 must be {BF16} or torch.float32, "
                        f"got {g3.dtype}")
    if _use_plain(a3):
        return gather_wgrad_bf16_plain(a3, a_map, a_taps, a_stride, g3, g_map,
                                       g_taps, g_stride, k, s_rows, skip_a, skip_g)
    dw, n = _gather_wgrad_launch("gather_wgrad_bf16", a3, a_map, a_taps, a_stride, g3,
                                 g_map, g_taps, g_stride, k, s_rows, skip_a, skip_g,
                                 BF16, g3.dtype)
    gather_wgrad_bf16.launches += n
    return dw


# --------------------------------------------------------------------------
# (c) parent_gemm


def parent_gemm_plain(x3, parent, off, w, skip=-1, order=None, trans_w=False):
    # ``order`` only orders the kernel's tiles: every row is the same.
    # bf16 operands: products and sums in f32, each row rounded once;
    # ``trans_w``: on w[o]^T, a view
    if trans_w:
        w = w.transpose(1, 2)
    b_, s_c, _ = x3.shape
    k, _, cout = w.shape
    table = torch.einsum("bsc,kcd->bksd", _wide(x3), _wide(w)).reshape(b_, k * s_c, cout)
    out = take_rows(table, off.long() * s_c + parent.long())
    if skip >= 0:
        out = torch.where(_kept(parent, skip), out, 0.0)
    return out.to(x3.dtype)


parent_gemm_bf16_plain = parent_gemm_plain


def parent_gemm_bf16_bound(x3, parent, off, w, skip=-1, order=None, trans_w=False):
    """(ref, bound), f64 [B, S_f, Cout]: the exact sum of the products
    ``parent_gemm_bf16`` computes (row i: x3[b, parent] @ w[off], zeros
    where the parent is ``skip``), and how far from it an output may lie
    whatever order its f32 sum of Cin products runs in:
    2^-8 |ref| + (1 + 2^-8) gamma(Cin) P, P the sum of |products|
    (``gather_gemm_bf16_bound`` at one tap)."""
    f64 = torch.float64
    w = (w.transpose(1, 2) if trans_w else w).to(f64)
    rows = take_rows(x3.to(f64), parent.long())
    kept = parent != skip  # skip -1: every row
    ref = rows.new_zeros(*parent.shape, w.shape[2])
    size = torch.zeros_like(ref)
    for o in range(w.shape[0]):  # one offset's rows at a time
        sel = kept & (off == o)
        ref[sel] = rows[sel] @ w[o]
        size[sel] = rows[sel].abs() @ w[o].abs()
    err = _gamma(x3.shape[2]) * size
    return ref, BF16_HALF_ULP * ref.abs() + (1 + BF16_HALF_ULP) * err


def _parent_splits(b_, s_f, cout, tile_n=None) -> int:
    """Blocks over which parent_gemm spreads one tile's offsets: one,
    unless its tiles (128 rows x the kernel's Cout tile ``tile_n``, by
    default the f32 kernel's, per chunk) come to fewer than GEMM_BLOCKS;
    then enough to get there, at most 4 (a tile of the up order spans a few
    offsets; a block with none of its own leaves at once)."""
    tile_n = _gemm_tile_n(cout) if tile_n is None else tile_n
    blocks = -(-s_f // GEMM_ROWS) * -(-cout // tile_n) * b_
    if blocks >= GEMM_BLOCKS:
        return 1
    return min(4, -(-GEMM_BLOCKS // blocks))


def _parent_shapes(x3, parent, off, w, order, trans_w=False):
    """w is [8, Cin, Cout], or [8, Cout, Cin] under ``trans_w``."""
    b_, s_c, cin = x3.shape
    k = w.shape[0]
    cout = w.shape[1] if trans_w else w.shape[2]
    s_f = parent.shape[1]
    _check_shape("w", w, (k, cout, cin) if trans_w else (k, cin, cout))
    _check_shape("parent", parent, (b_, s_f))
    _check_shape("off", off, (b_, s_f))
    _check_shape("order", order, (b_, s_f))
    check_index_space("parent_gemm", x3_rows=b_ * s_c, out_rows=b_ * s_f)


def _parent_gemm_launch(name, x3, parent, off, w, skip, order, dtype, trans_w=False):
    """The parent-GEMM kernel on ``dtype`` operands (bf16: the tensor-core
    kernel, ``trans_w`` its form on w[o]^T) -> (the output in ``dtype``,
    launches: 0 or 1)."""
    b_, s_c, cin = x3.shape
    k = w.shape[0]
    cout = w.shape[1] if trans_w else w.shape[2]
    s_f = parent.shape[1]
    _require(x3, "x3", dtype, 3)
    _require(w, "w", dtype, 3)
    _require(parent, "parent", torch.int32, 2)
    _require(off, "off", torch.int32, 2)
    _require(order, "order", torch.int32, 2)
    if k != 8:
        raise ValueError(f"parent_gemm takes 8 offsets (k2s2), got {k}")
    out = torch.empty(b_, s_f, cout, device=x3.device, dtype=dtype)
    if out.numel() == 0:
        return out, 0
    tile_n = _gemm_tile_n_bf16(cout, False) if dtype == BF16 else None
    rc = _lib().pc_parent_gemm(
        _ptr(x3), _ptr(parent), _ptr(off), _ptr(w), _ptr(order), _ptr(out), b_, s_c,
        s_f, cin, cout, int(skip), _parent_splits(b_, s_f, cout, tile_n),
        int(dtype == BF16), int(trans_w), _stream())
    _check(rc, name)
    return out, 1


def parent_gemm(x3, parent, off, w, skip=-1, order=None, trans_w=False):
    """out[b,i] = x3[b, parent[b,i]] @ w[off[b,i]], zeros where parent[b,i]
    is ``skip`` (-1: none).  K3's forward passes the coarse pad row, whose
    features are zero by contract, so leaving it out changes nothing but
    the work; K2's dF passes -1.  ``order`` [B, S_f] int32, optional: each
    chunk's fine rows in the order the kernel tiles them (the pyramid's up
    order, ``topology.up_order``: by offset, so that a 128-row tile stages
    one or two offsets' weights); without one the kernel tiles the rows in
    their own order.  ``order`` must be a permutation of each chunk's rows
    (``check_pyramid_bounds`` checks the pyramid's): on the card the output
    is left uninitialised and each block writes only the rows its order
    entries name, so a row that no entry names is never written.

    x3 [B, S_c, Cin]; parent/off [B, S_f]; w [8, Cin, Cout] -> [B, S_f, Cout],
    f32 (bf16 operands go to ``parent_gemm_bf16``).  ``trans_w``: w is
    [8, Cout, Cin] and row i is x3[b, parent] @ w[off]^T (K2's dF on the
    forward's weights; this form makes the transposed copy, the bf16 form
    reads W in place).  On the card every output row is written once, by
    one block, in a fixed order of products: the same bits from run to
    run."""
    _parent_shapes(x3, parent, off, w, order, trans_w)
    _refuse_bf16("parent_gemm", x3, "parent_gemm_bf16")
    if _use_plain(x3):
        return parent_gemm_plain(x3, parent, off, w, skip, trans_w=trans_w)
    if trans_w:
        w = w.transpose(1, 2).contiguous()
    out, n = _parent_gemm_launch("parent_gemm", x3, parent, off, w, skip, order,
                                 torch.float32)
    parent_gemm.launches += n
    return out


def parent_gemm_bf16(x3, parent, off, w, skip=-1, order=None, trans_w=False):
    """``parent_gemm`` on bf16 x3 and w (JAX K3's forward and K2's dF in
    bf16: bf16 x bf16 products summed in f32, each row rounded once) ->
    [B, S_f, Cout] bf16.  ``trans_w``: w is [8, Cout, Cin] and row i is
    x3[b, parent] @ w[off]^T (K2's dF on the forward's weights, with no
    transposed copy).  On the card the products run on the tensor cores, in
    another order of f32 adds than the twin's: an output lies within
    ``parent_gemm_bf16_bound`` of the exact sum, and two launches give the
    same bits (each row written once, by one block)."""
    _parent_shapes(x3, parent, off, w, order, trans_w)
    _require_dtypes("parent_gemm_bf16", BF16, x3=x3, w=w)
    if _use_plain(x3):
        return parent_gemm_bf16_plain(x3, parent, off, w, skip, trans_w=trans_w)
    out, n = _parent_gemm_launch("parent_gemm_bf16", x3, parent, off, w, skip, order, BF16,
                                 trans_w)
    parent_gemm_bf16.launches += n
    return out


# --------------------------------------------------------------------------
# (d) scatter_parent


def scatter_parent_plain(ct3, parent, off, k, s_c):
    # a bf16 cotangent lands widened (exactly) in an f32 dy, as JAX's
    # scatter of ct.astype(f32)
    b_, _, c = ct3.shape
    idx = off.long() * s_c + parent.long()
    kept = torch.where((parent < s_c - 1)[..., None], _wide(ct3), 0.0)
    dy = kept.new_zeros(b_, k * s_c, c)
    return dy.scatter_add_(1, idx.unsqueeze(-1).expand(-1, -1, c), kept)


scatter_parent_bf16_plain = scatter_parent_plain


def _scatter_parent_launch(name, ct3, parent, off, k, s_c, dtype):
    """The scatter kernel on a ``dtype`` cotangent -> (dy f32, launches:
    0 or 1)."""
    b_, s_f, c = ct3.shape
    _require(ct3, "ct3", dtype, 3)
    _require(parent, "parent", torch.int32, 2)
    _require(off, "off", torch.int32, 2)
    if k != 8:
        raise ValueError(f"{name} takes 8 offsets (k2s2), got {k}")
    dy = torch.zeros(b_, k * s_c, c, device=ct3.device, dtype=torch.float32)
    if ct3.numel() == 0:
        return dy, 0
    rc = _lib().pc_scatter_parent(ct3.data_ptr(), parent.data_ptr(), off.data_ptr(),
                                  dy.data_ptr(), b_, s_f, s_c, c, int(dtype == BF16),
                                  _stream(ct3))
    _check(rc, name)
    return dy, 1


def _scatter_parent_shapes(name, ct3, parent, off, k, s_c):
    b_, s_f, c = ct3.shape
    _check_shape("parent", parent, (b_, s_f))
    _check_shape("off", off, (b_, s_f))
    check_index_space(name, ct3=b_ * s_f * c, out=b_ * k * s_c * c)


def scatter_parent(ct3, parent, off, k, s_c):
    """dy[b, off[b,i] * s_c + parent[b,i]] = ct3[b, i] for every fine row i
    whose parent is not the coarse pad row ``s_c - 1`` -> [B, k * s_c, C],
    zeros elsewhere: JAX K3's backward scatter with the pad slot left out
    (the port's K3 gathers through the down map instead; this is its parent
    design, kept for the comparison).  Pad fine rows and the fine voxels truncation orphaned all name that
    slot; its sum reached only dF's pad row (dW multiplies it by the zero
    pad features), and every other destination is named once, so the card
    stores rows and equals the twin bit for bit.  ct3 and dy f32 (a bf16
    ct3 goes to ``scatter_parent_bf16``).  B S_f C and B k s_c C must stay
    below 2^31, on either device."""
    _scatter_parent_shapes("scatter_parent", ct3, parent, off, k, s_c)
    _refuse_bf16("scatter_parent", ct3, "scatter_parent_bf16")
    if _use_plain(ct3):
        return scatter_parent_plain(ct3, parent, off, k, s_c)
    dy, n = _scatter_parent_launch("scatter_parent", ct3, parent, off, k, s_c,
                                   torch.float32)
    scatter_parent.launches += n
    return dy


def scatter_parent_bf16(ct3, parent, off, k, s_c):
    """``scatter_parent`` of a bf16 cotangent into an f32 dy (JAX K3's
    backward scatters ``ct.astype(f32)``): each kept row widened exactly
    and stored once, equal to the twin bit for bit."""
    _scatter_parent_shapes("scatter_parent_bf16", ct3, parent, off, k, s_c)
    _require_dtypes("scatter_parent_bf16", BF16, ct3=ct3)
    if _use_plain(ct3):
        return scatter_parent_bf16_plain(ct3, parent, off, k, s_c)
    dy, n = _scatter_parent_launch("scatter_parent_bf16", ct3, parent, off, k, s_c, BF16)
    scatter_parent_bf16.launches += n
    return dy


# --------------------------------------------------------------------------
# (e) scatter_gemm


def scatter_gemm_plain(g3, map_, taps, w, s_in, skip, order=None):
    # ``order`` only orders the kernel's tiles: every destination's sum is
    # the same
    b_, cin = g3.shape[0], w.shape[1]
    out = g3.new_zeros(b_, s_in, cin)
    for j in range(w.shape[0]):
        idx = map_[int(taps[j])].long()
        y = torch.where((idx != skip)[..., None], g3 @ w[j].transpose(0, 1), 0.0)
        out.scatter_add_(1, idx.unsqueeze(-1).expand(-1, -1, cin), y)
    return out


def scatter_gemm_bf16_plain(g3, map_, taps, w, s_in, skip, order=None):
    # bf16 operands: the products exact (f64), their scatter-sums f64 and
    # each destination rounded once to bf16, as JAX's f32 scatter of
    # ct.f32 W^T.f32 rounded to the features' dtype up to the f32 adds'
    # order (the kernel's atomics: ``scatter_gemm_bf16_bound``)
    return scatter_gemm_plain(_wide(g3).double(), map_, taps, _wide(w).double(), s_in,
                              skip).to(g3.dtype)


def scatter_gemm_bf16_bound(g3, map_, taps, w, s_in, skip, order=None):
    """(ref, bound), f64 [B, s_in, Cin]: the exact sum ``scatter_gemm_bf16``
    rounds, and how far from it its output may lie.  A destination that n
    kept (row, tap) pairs reach sums n Cout bf16 x bf16 products (exact in
    f32) in f32, in any order (mma sums, then atomics): within gamma(n Cout)
    P of the exact sum, P the sum of their |products|
    (``gather_gemm_bf16_bound``), and the rounding to bf16 within 2^-8 of
    it."""
    f64 = torch.float64
    g, w = _wide(g3).to(f64), _wide(w).to(f64)
    ref = scatter_gemm_plain(g, map_, taps, w, s_in, skip)
    size = scatter_gemm_plain(g.abs(), map_, taps, w.abs(), s_in, skip)
    ones = torch.ones_like(g[..., :1])
    pairs = scatter_gemm_plain(ones, map_, taps, ones.new_ones(len(taps), 1, 1), s_in, skip)
    err = _gamma(pairs * g.shape[-1]) * size
    return ref, BF16_HALF_ULP * ref.abs() + (1 + BF16_HALF_ULP) * err


def _scatter_shapes(name, g3, map_, taps, w, s_in, order):
    b_, s_out, cout = g3.shape
    g, cin, _ = w.shape
    _check_shape("w", w, (g, cin, cout))
    _check_rows(name, map_, taps, 0, g, b_, s_out, s_in)
    _check_shape("order", order, (b_, s_out))
    if order is not None and order.dtype != torch.int32:
        raise TypeError(f"order must be torch.int32, got {order.dtype}")


@functools.lru_cache(maxsize=None)
def _scatter_tile_n(cin: int, bf16: bool) -> int:
    """scatter_gemm's Cin tile: the f32 kernel's, or the tensor-core
    kernel's (up to 128)."""
    return _lib().pc_scatter_gemm_tile_n(cin, int(bf16))


def _scatter_gemm_launch(g3, map_, taps, w, out, skip, order, dtype) -> None:
    """One scatter-GEMM launch of at most MAX_TAPS taps, adding into the f32
    ``out`` [B, s_in, Cin]: the f32 kernel, or the tensor-core one on bf16
    g3 and w."""
    b_, s_out, cout = g3.shape
    g, cin, _ = w.shape
    _require(g3, "g3", dtype, 3)
    _require(w, "w", dtype, 3)
    _require(map_, "map", torch.int32, 3)
    _require(order, "order", torch.int32, 2)
    if g > MAX_TAPS:
        raise ValueError(f"{g} taps > {MAX_TAPS}")
    bf16 = dtype == BF16
    splits = _scatter_splits(b_, s_out, cin, g * -(-cout // 32), _scatter_tile_n(cin, bf16))
    rc = _lib().pc_scatter_gemm(
        _ptr(g3), _ptr(map_), _taps_struct(taps), g, _ptr(w), _ptr(order), _ptr(out),
        splits, b_, s_out, out.shape[1], cin, cout, int(skip), int(bf16), _stream())
    _check(rc, "scatter_gemm_bf16" if bf16 else "scatter_gemm")


def scatter_gemm(g3, map_, taps, w, s_in, skip, order=None):
    """out[b, map[taps[j], b, s]] += g3[b, s] @ w[j]^T for every listed tap
    j and row s, except where the map names row ``skip`` (-1: none).

    g3 [B, S_out, Cout]; map [K, B, S_out] int32 frame-local rows into
    [B, s_in]; w [G, Cin, Cout] (one block per listed tap); ``order``
    [B, S_out] int32, optional: each chunk's cotangent rows in the order the
    kernel tiles them, the map's live order (the one K4's forward passes
    to ``gather_gemm``), so that each tap's live destinations fall in few
    128-row tiles; any permutation of each chunk's rows gives the same
    sum.  Returns [B, s_in, Cin].  The map may name a row many
    times: the card adds the products with f32 atomics, in an order that
    differs from run to run; where its tiles come to few blocks it splits
    each tile's (tap, Cout chunk) steps over several (``_scatter_splits``).
    A bf16 g3 goes to ``scatter_gemm_bf16``."""
    if g3.dtype == BF16:
        return scatter_gemm_bf16(g3, map_, taps, w, s_in, skip, order)
    _scatter_shapes("scatter_gemm", g3, map_, taps, w, s_in, order)
    if _use_plain(g3):
        return scatter_gemm_plain(g3, map_, taps, w, s_in, skip)
    out = torch.zeros(g3.shape[0], s_in, w.shape[1], device=g3.device, dtype=torch.float32)
    _scatter_gemm_launch(g3, map_, taps, w, out, skip, order, torch.float32)
    scatter_gemm.launches += 1
    return out


def scatter_gemm_bf16(g3, map_, taps, w, s_in, skip, order=None):
    """``scatter_gemm`` on a bf16 cotangent and bf16 weights (JAX K4's dF
    in bf16, ``_conv_chunk_down_fused_bwd``, and the flat conv's): the
    bf16 x bf16 products scatter-added in f32 into one f32 table, then
    rounded once to bf16 -> [B, s_in, Cin] bf16.  Any number of taps: one
    launch of the tensor-core kernel a MAX_TAPS of them, all adding into
    the same f32 table.  The adds' order (f32 atomics) changes from run to
    run, so the card's output is held to ``scatter_gemm_bf16_bound`` of
    the exact sum, not to bits."""
    _scatter_shapes("scatter_gemm_bf16", g3, map_, taps, w, s_in, order)
    _require_dtypes("scatter_gemm_bf16", BF16, g3=g3, w=w)
    if _use_plain(g3):
        return scatter_gemm_bf16_plain(g3, map_, taps, w, s_in, skip)
    out = torch.zeros(g3.shape[0], s_in, w.shape[1], device=g3.device, dtype=torch.float32)
    taps = list(taps)
    for lo in range(0, len(taps), MAX_TAPS):
        _scatter_gemm_launch(g3, map_, taps[lo:lo + MAX_TAPS], w[lo:lo + MAX_TAPS], out, skip,
                             order, BF16)
        scatter_gemm_bf16.launches += 1
    return out.to(BF16)


# --------------------------------------------------------------------------
# (f) segment_sum


def segment_sum_plain(x, seg, num_segments):
    return x.new_zeros(num_segments, x.shape[1]).index_add_(0, seg.long(), x)


def segment_sum(x, seg, num_segments: int):
    """out[seg[i]] += x[i]: x [N, C] f32, seg [N] int32 ids in
    [0, num_segments) -> [num_segments, C].

    On the card a block sums its span of rows a run at a time, and the
    last block adds the blocks' partials in block order, so at
    ``num_segments <= SEG_SMEM`` (every caller) the result is the same
    from launch to launch; above, run sums go to ``out`` with f32 atomics.
    Ids outside the range are left out there (``SemsegBatch.to`` checks
    them before any kernel)."""
    n, c = x.shape
    _check_shape("seg", seg, (n,))
    if _use_plain(x):
        return segment_sum_plain(x, seg, num_segments)
    _require(x, "x", torch.float32, 2)
    _require(seg, "seg", torch.int32, 1)
    if n == 0 or c == 0 or num_segments == 0:
        return torch.zeros(num_segments, c, device=x.device, dtype=torch.float32)
    out = _segment_sum_launch(x, seg, num_segments, combine=True)
    segment_sum.launches += 1
    return out


def _segment_sum_launch(x, seg, num_segments, combine):
    """One launch of the segment-sum kernel.  ``combine=False`` stops
    before the last block adds the blocks' partials (``out`` is then left
    unwritten): ``chip_smoke.py`` times it to give the combine's share."""
    n, c = x.shape
    check_index_space("segment_sum", x=n * c)
    det = num_segments <= SEG_SMEM
    out = (torch.empty if det else torch.zeros)(num_segments, c, device=x.device,
                                                dtype=torch.float32)
    ws = tickets = None
    ws_floats = 0
    if det:  # pc_segment_sum's bound: blocks of every tile, S * 128 + 1 floats each
        ws_floats = max(SEG_BLOCKS, -(-c // 4)) * (SEG_SMEM * 128 + 1)
        ws = torch.empty(ws_floats, device=x.device, dtype=torch.float32)
        tickets = _seg_tickets(x.device, -(-c // 4))
    rc = _lib().pc_segment_sum(_ptr(x), _ptr(seg), _ptr(out), _ptr(ws), ws_floats,
                               _ptr(tickets), n, c, num_segments, SEG_BLOCKS,
                               int(combine), _stream())
    _check(rc, "segment_sum")
    return out


def segment_sum_plan(x) -> dict:
    """The card's launch shape for ``segment_sum`` over x ([N, C] f32 on
    the card): lane group, channel tile, tiles (grid y), blocks a tile
    (grid x) and each block's span of rows."""
    plan = (ctypes.c_int * 5)()
    _lib().pc_segment_sum_plan(_ptr(x), x.shape[0], x.shape[1], SEG_BLOCKS, plan)
    return dict(zip(("group", "tile", "tiles", "blocks", "span"), plan))


_SEG_TICKETS: dict = {}


def _seg_tickets(device, n: int) -> torch.Tensor:
    """The segment-sum kernel's tickets on ``device``, one a channel tile:
    zeros, and each launch leaves them at zero (its last block's
    ``atomicInc`` wraps), so launches on one stream share them."""
    key = torch.device(device).index
    t = _SEG_TICKETS.get(key)
    if t is None or t.numel() < n:
        t = torch.zeros(max(n, 1024), device=device, dtype=torch.int32)
        _SEG_TICKETS[key] = t
    return t


# --------------------------------------------------------------------------
# (g) gather_sum


def gather_sum_plain(x3, map_, taps, tap_stride, s_out):
    b_, _, c = x3.shape
    out = x3.new_zeros(b_, s_out, c)
    for j in range(len(taps)):
        out = out + take_rows(x3, row_index(map_, taps, tap_stride, j, b_, s_out,
                                            x3.device))
    return out


def gather_sum_bf16_plain(x3, map_, taps, tap_stride, s_out, round_each_add=True):
    # bf16 rows added from zero in tap order: bf16 + bf16 in torch rounds
    # every add (``round_each_add``, JAX's Python sum of the chunked
    # gathers), or an f32 sum in tap order rounded once (jnp.sum of the
    # flat gathers)
    if round_each_add:
        return gather_sum_plain(x3, map_, taps, tap_stride, s_out)
    return gather_sum_plain(x3.float(), map_, taps, tap_stride, s_out).to(x3.dtype)


def _gather_sum_shapes(name, x3, map_, taps, tap_stride, s_out):
    b_, s_in, c = x3.shape
    _check_rows(name, map_, taps, tap_stride, len(taps), b_, s_out, s_in)
    check_index_space(name, x3=b_ * s_in * c, out=b_ * s_out * c,
                      map=0 if map_ is None else map_.numel())


def _gather_sum_launch(name, x3, map_, taps, tap_stride, s_out, dtype, each=False):
    """The gather-sum kernel on a ``dtype`` table (bf16: the bf16 form,
    ``each`` its rounding after every add) -> (out, launches: 0 or 1)."""
    b_, s_in, c = x3.shape
    _require(x3, "x3", dtype, 3)
    _require(map_, "map", torch.int32, 3)
    if not 0 < len(taps) <= MAX_TAPS:
        raise ValueError(f"{len(taps)} taps: 1 to {MAX_TAPS}")
    out = torch.empty(b_, s_out, c, device=x3.device, dtype=dtype)
    if out.numel() == 0:
        return out, 0
    rc = _lib().pc_gather_sum(
        x3.data_ptr(), _ptr(map_), _taps_struct(taps), tap_stride, len(taps),
        out.data_ptr(), b_, s_in, s_out, c, int(dtype == BF16), int(each), _stream(x3))
    _check(rc, name)
    return out, 1


def gather_sum(x3, map_, taps, tap_stride, s_out):
    """out[b,s] = sum_j x3[b, row(j,b,s)] over the listed taps, added in tap
    order from zero (as JAX's ``sum`` of row gathers; the card's result
    equals the twin's bit for bit).

    x3 [B, S_in, C]; map [K, B, s_out] read at ``taps`` (or, with no map,
    len(taps) stacked blocks of ``tap_stride`` rows); returns [B, s_out, C].
    One tap is a row gather.  B S_in C, B s_out C and the map's size must
    stay below 2^31, on either device.  A bf16 x3 goes to
    ``gather_sum_bf16`` (every add rounded)."""
    if x3.dtype == BF16:
        return gather_sum_bf16(x3, map_, taps, tap_stride, s_out)
    _gather_sum_shapes("gather_sum", x3, map_, taps, tap_stride, s_out)
    if _use_plain(x3):
        return gather_sum_plain(x3, map_, taps, tap_stride, s_out)
    out, n = _gather_sum_launch("gather_sum", x3, map_, taps, tap_stride, s_out,
                                torch.float32)
    gather_sum.launches += n
    return out


def gather_sum_bf16(x3, map_, taps, tap_stride, s_out, round_each_add=True):
    """``gather_sum`` on a bf16 table -> bf16, JAX's bf16 pools' rounding:
    every add rounded to bf16, in tap order from zero
    (``round_each_add``: the chunked pools' Python ``sum`` of bf16 gathers),
    or the f32 sum in tap order rounded once (the flat pools' ``jnp.sum``,
    which sums bf16 in f32).  The card's result equals the twin's bit for
    bit; one tap is a row copy either way."""
    _gather_sum_shapes("gather_sum_bf16", x3, map_, taps, tap_stride, s_out)
    _require_dtypes("gather_sum_bf16", BF16, x3=x3)
    if _use_plain(x3):
        return gather_sum_bf16_plain(x3, map_, taps, tap_stride, s_out, round_each_add)
    out, n = _gather_sum_launch("gather_sum_bf16", x3, map_, taps, tap_stride, s_out, BF16,
                                round_each_add)
    gather_sum_bf16.launches += n
    return out


# --------------------------------------------------------------------------
# (h) scatter_sum


def scatter_sum_plain(g3, map_, taps, tap_stride, s_in, skip_from):
    b_, s_g, c = g3.shape
    out = g3.new_zeros(b_, s_in, c)
    for j in range(len(taps)):
        idx = row_index(map_, taps, tap_stride, j, b_, s_g, g3.device)
        y = g3 if skip_from < 0 else torch.where((idx < skip_from)[..., None], g3, 0.0)
        out.scatter_add_(1, idx.unsqueeze(-1).expand(-1, -1, c), y)
    return out


def _ordered_scatter(g3, idx, keep, s_in):
    """[B, s_in, C] in g3's dtype: for each destination, the rows
    ``g3[b, i]`` (``keep[b, i]``) with ``idx[b, i]`` on it added from zero in
    ascending i, every add in that dtype (bf16: rounded).  Each source's
    rank among its destination's sources, then one ``index_add_`` a rank:
    a destination takes one row a call, so the adds keep that order."""
    b_, s_g, c = g3.shape
    dest = (idx.long() + s_in * torch.arange(b_, device=g3.device)[:, None])[keep]
    src = g3[keep]  # row-major: ascending (b, i)
    out = g3.new_zeros(b_ * s_in, c)
    if dest.numel():
        sorted_dest, by_dest = torch.sort(dest, stable=True)
        pos = torch.arange(dest.numel(), device=g3.device)
        first = torch.ones_like(sorted_dest, dtype=torch.bool)
        first[1:] = sorted_dest[1:] != sorted_dest[:-1]
        start = torch.cummax(torch.where(first, pos, 0), 0).values
        rank = torch.empty_like(pos)
        rank[by_dest] = pos - start
        for r in range(int(rank.max()) + 1):
            at = rank == r
            out.index_add_(0, dest[at], src[at])
    return out.reshape(b_, s_in, c)


def scatter_sum_bf16_plain(g3, map_, taps, tap_stride, s_in, skip_from, inverse=None):
    # JAX's bf16 autodiff of the gathers: per tap, an XLA scatter-add into
    # bf16 zeros, each destination's rows in ascending source row, every
    # add rounded; the taps' tables then added in tap order (bf16).
    # ``inverse`` only tells the kernel where the sources are
    b_, s_g, _ = g3.shape
    out = None
    for j in range(len(taps)):
        idx = row_index(map_, taps, tap_stride, j, b_, s_g, g3.device)
        keep = (idx >= 0) & (idx < (s_in if skip_from < 0 else min(skip_from, s_in)))
        part = _ordered_scatter(g3, idx, keep, s_in)
        out = part if out is None else out + part
    return out


def _scatter_sum_shapes(name, g3, map_, taps, tap_stride, s_in):
    b_, s_g, c = g3.shape
    _check_rows(name, map_, taps, tap_stride, len(taps), b_, s_g, s_in)
    check_index_space(name, g3=b_ * s_g * c, out=b_ * s_in * c,
                      map=0 if map_ is None else map_.numel())


def scatter_sum(g3, map_, taps, tap_stride, s_in, skip_from):
    """out[b, row(j,b,s)] += g3[b,s] for every listed tap, except where the
    row is ``skip_from`` or past it (-1: none): the adjoint of
    ``gather_sum`` into a [B, s_in, C] table.  The pooling maps send
    missing children to the chunk's last row (``s_in - 1``), a brick
    table's gathers to the pad brick's slots (``s_in - 8`` on); leaving
    those rows out leaves out the adds that would pile onto them.  A row
    named many times gets f32 atomics on the card, in an order that differs
    from run to run; where no kept row repeats, the card's result equals
    the twin's bit for bit.  B s_g C, B s_in C and the map's size must stay
    below 2^31, on either device.  A bf16 g3 goes to ``scatter_sum_bf16``,
    which refuses a map that names a kept row twice (pass its ``inverse``
    form for those)."""
    if g3.dtype == BF16:
        return scatter_sum_bf16(g3, map_, taps, tap_stride, s_in, skip_from)
    _scatter_sum_shapes("scatter_sum", g3, map_, taps, tap_stride, s_in)
    if _use_plain(g3):
        return scatter_sum_plain(g3, map_, taps, tap_stride, s_in, skip_from)
    out, n = _scatter_sum_launch("scatter_sum", g3, map_, taps, tap_stride, s_in, skip_from,
                                 torch.float32)
    scatter_sum.launches += n
    return out


def _scatter_sum_launch(name, g3, map_, taps, tap_stride, s_in, skip_from, dtype,
                        inverse=None, check=None):
    """The scatter-sum kernel on a ``dtype`` cotangent into a zeroed
    ``dtype`` table (bf16: the bf16 form, through ``inverse`` when given;
    given ``check``, zeroed int32 of 1 entry with an inverse, else 1 + B
    s_in, it sets ``check[0]`` where the map breaks its form's condition)
    -> (out, launches: 0 or 1)."""
    b_, s_g, c = g3.shape
    _require(g3, "g3", dtype, 3)
    _require(map_, "map", torch.int32, 3)
    _require(inverse, "inverse", torch.int32, 3)
    if not 0 < len(taps) <= MAX_TAPS:
        raise ValueError(f"{len(taps)} taps: 1 to {MAX_TAPS}")
    _require(check, "check", torch.int32, 1)
    if check is not None:
        need = 1 + (0 if inverse is not None else b_ * s_in)
        if dtype != BF16 or check.numel() < need:
            raise ValueError(f"{name}: a check takes the bf16 form and {need} entries, "
                             f"got {dtype} and {check.numel()}")
    out = torch.zeros(b_, s_in, c, device=g3.device, dtype=dtype)
    if g3.numel() == 0:
        return out, 0
    rc = _lib().pc_scatter_sum(
        g3.data_ptr(), _ptr(map_), _taps_struct(taps), tap_stride, len(taps),
        out.data_ptr(), b_, s_g, s_in, c, int(skip_from), int(dtype == BF16), _ptr(inverse),
        0 if inverse is None else inverse.shape[0], _ptr(check), _stream(g3))
    _check(rc, name)
    return out, 1


INVERSE_TAPS = 8  # sources a destination of scatter_sum_bf16's inverse form (csrc INV_MAX)


BF16_SCATTER_REFUSAL = "scatter_sum_bf16: the map "


def _scatter_sum_bf16_check(g3, map_, taps, tap_stride, s_in, skip_from, inverse=None):
    """The condition under which ``scatter_sum_bf16``'s kernel computes its
    function, asserted with tensor ops (the CPU's form; the kernel checks
    it as it runs): with no ``inverse``, no destination below
    ``skip_from`` is named twice over all the taps (the store form would
    race); with one, each kept source is named once among the inverse's
    entries at its destination (the inverse form would leave it out, or
    add it twice).  Raises RuntimeError where it does not hold."""
    b_, s_g, _ = g3.shape
    if b_ * s_g == 0 or s_in == 0:
        return
    dev = g3.device
    limit = s_in if skip_from < 0 else min(skip_from, s_in)
    if inverse is None:
        spare = b_ * s_in  # where the entries that are not kept are counted
        named = torch.zeros(spare + 1, device=dev, dtype=torch.int32)
        base = s_in * torch.arange(b_, device=dev)[:, None]
        for j in range(len(taps)):
            idx = row_index(map_, taps, tap_stride, j, b_, s_g, dev)
            keep = (idx >= 0) & (idx < limit)
            named.index_add_(0, torch.where(keep, idx + base, spare).reshape(-1),
                             keep.reshape(-1).to(torch.int32))
        ok = named[:spare].max() <= 1
        what = "names a kept destination twice (pass the inverse form)"
    else:
        idx = row_index(map_, taps, tap_stride, 0, b_, s_g, dev)
        keep = (idx >= 0) & (idx < limit)
        cand = inverse[:, torch.arange(b_, device=dev)[:, None], idx.clamp(0, s_in - 1)]
        named = (cand == torch.arange(s_g, device=dev, dtype=cand.dtype)).sum(0)
        ok = ((named == 1) | ~keep).all()
        what = "has a kept source that the inverse does not name once at its destination"
    torch._assert_async(ok, f"{BF16_SCATTER_REFUSAL}{what}")


def scatter_sum_bf16(g3, map_, taps, tap_stride, s_in, skip_from, inverse=None):
    """``scatter_sum`` of a bf16 cotangent -> bf16, JAX's bf16 autodiff of
    the gathers: each destination below ``skip_from`` gets its rows in
    ascending source row (per tap; the taps' tables added in tap order),
    every add rounded to bf16.  No atomics; on the card the same bits as
    the twin, from run to run.  Two forms:

      - no ``inverse``: no destination below ``skip_from`` may be named
        twice (the sum and average pools' down maps: each fine row is one
        (offset, coarse row)'s), so each kept row is stored once;
      - ``inverse`` [K, B, s_in] int32, K <= 8, one tap: for each
        destination, the source rows that may name it (the unpool's
        adjoint: the level's k2s2 down map, each coarse row's children,
        missing ones at the fine pad row); the kernel keeps those whose
        ``map`` entry is the destination, sorts them and adds them in
        order.  It must name every source of each kept destination, as the
        down map does of the parent map.

    Each call asserts its form's condition on the map: on the CPU with
    tensor ops before the twin runs (``_scatter_sum_bf16_check``, a
    RuntimeError), on the card from the flag the kernel sets as it runs
    (``torch._assert_async``, no host sync: a map that breaks it fails the
    next call that synchronises, with a device-side assert).  The twin
    computes the function from ``map`` alone (``inverse`` only tells the
    kernel where the sources are)."""
    _scatter_sum_shapes("scatter_sum_bf16", g3, map_, taps, tap_stride, s_in)
    _require_dtypes("scatter_sum_bf16", BF16, g3=g3)
    b_ = g3.shape[0]
    if inverse is not None:
        if len(taps) != 1 or map_ is None:
            raise ValueError("scatter_sum_bf16: an inverse goes with one mapped tap")
        if inverse.dim() != 3 or inverse.shape[1:] != (b_, s_in) or not (
                0 < inverse.shape[0] <= INVERSE_TAPS):
            raise ValueError(f"scatter_sum_bf16: inverse of shape {tuple(inverse.shape)}, "
                             f"expected [K <= {INVERSE_TAPS}, {b_}, {s_in}]")
        check_index_space("scatter_sum_bf16", inverse=inverse.numel())
    if _use_plain(g3):
        _scatter_sum_bf16_check(g3, map_, taps, tap_stride, s_in, skip_from, inverse)
        return scatter_sum_bf16_plain(g3, map_, taps, tap_stride, s_in, skip_from)
    claims = 0 if inverse is not None else b_ * s_in  # the store form's, one a row
    check = torch.zeros(1 + claims, device=g3.device, dtype=torch.int32)
    out, n = _scatter_sum_launch("scatter_sum_bf16", g3, map_, taps, tap_stride, s_in,
                                 skip_from, BF16, inverse, check)
    torch._assert_async(check[0] == 0, f"{BF16_SCATTER_REFUSAL}breaks its form's condition")
    scatter_sum_bf16.launches += n
    return out


# --------------------------------------------------------------------------
# (i) brick_gemm and (j) brick_wgrad: the brick layout's same-level conv.
#
# ``steps`` is a brick plan in slot form (``sparse.brick.slot_steps``): one
# (d, centre, T) per plan step, T[s][p] the tap that adds source slot s of
# neighbour brick d into output slot p, -1 where none does.  ``valid``
# [NB*8] f32 marks the level's occupied slots (None: every slot counts);
# ``order`` [NB*8] int32, the level's ``slot_order``, only orders the
# kernels' tiles.


BRICK_SLOTS = 8
BRICK_NBRS = 27  # rows of a brick map (3^3 neighbour bricks)
BRICK_LIMIT = 2 ** 23  # bricks a level: the kernels pack a brick id and its 8 slots' bits
# brick_wgrad_bf16 runs its brick form (one product a neighbour row over
# whole bricks) up to this Cin (csrc BRICK_NARROW)
BRICK_NARROW = 8


@functools.lru_cache(maxsize=None)
def _step_blocks(steps):
    """Per step (d, centre, source slots, output slots, taps [n_s][n_p]):
    the slots that take part and the block matrix of taps between them."""
    out = []
    for d, center, tm in steps:
        s_idx = [s for s in range(BRICK_SLOTS) if any(t >= 0 for t in tm[s])]
        p_idx = [p for p in range(BRICK_SLOTS) if any(tm[s][p] >= 0 for s in s_idx)]
        out.append((d, center, s_idx, p_idx,
                    [[tm[s][p] for p in p_idx] for s in s_idx]))
    return out


@functools.lru_cache(maxsize=None)
def brick_slot_table(steps, num_taps: int):
    """(table [num_taps, 8] int32, centre): table[t, p] = 8 d + s, the row
    d of the brick map and the source slot s that tap t reads for output
    slot p (on each axis, offset + p = 2 d + s, so the pair is unique);
    ``centre`` is the row d at which a brick reads itself.  The kernels'
    form of ``steps``: a row's source at tap t is brick (d == centre ? b :
    nbr[d, b]), slot s."""
    table = np.full((num_taps, BRICK_SLOTS), -1, np.int32)
    centre = -1
    for d, is_centre, tm in steps:
        if is_centre:
            centre = d
        for s in range(BRICK_SLOTS):
            for p in range(BRICK_SLOTS):
                t = tm[s][p]
                if t < 0:
                    continue
                if table[t, p] >= 0:
                    raise ValueError(f"tap {t} reads two sources for output slot {p}")
                table[t, p] = BRICK_SLOTS * d + s
    if centre < 0 or (table < 0).any():
        raise ValueError("the plan has no centre step or leaves a (tap, output slot) "
                         "pair without a source")
    return table, centre


@functools.lru_cache(maxsize=None)
def _slot_table_on(steps, num_taps, device):
    table, centre = brick_slot_table(steps, num_taps)
    return torch.from_numpy(table).to(device), centre


def _brick_source(x3, nbr, d, center):
    """[NB, 8, C] brick rows of neighbour d of every brick."""
    return x3 if center else x3[nbr[d].long()]


@functools.lru_cache(maxsize=None)
def _plan_reach(steps):
    """(least, largest + 1) brick-map row and largest tap + 1 that a plan
    names: its 27 x 64 entries scanned once a plan, not at every launch."""
    ds = [d for d, _, _ in steps]
    return min(ds), max(ds) + 1, 1 + max(t for _, _, tm in steps for row in tm for t in row)


def _check_brick(name, x, nbr, steps, w_taps=None, valid=None, order=None):
    nb = nbr.shape[1]
    if x.dim() != 2 or x.shape[0] != BRICK_SLOTS * nb:
        raise ValueError(f"{name}: brick rows of shape {tuple(x.shape)}, expected "
                         f"[{BRICK_SLOTS * nb}, C] for {nb} bricks")
    d_lo, d_end, t_end = _plan_reach(steps)
    if d_lo < 0 or d_end > nbr.shape[0]:
        raise ValueError(f"{name}: plan reads a neighbour row outside [0, {nbr.shape[0]})")
    if w_taps is not None and t_end > w_taps:
        raise ValueError(f"{name}: plan names a tap outside [0, {w_taps})")
    _check_shape("valid", valid, (BRICK_SLOTS * nb,))
    _check_shape("order", order, (BRICK_SLOTS * nb,))


def _brick_mask(t, valid):
    """t's rows at the occupied slots, exact zeros at the others."""
    return t if valid is None else torch.where((valid != 0)[:, None], t, 0.0)


def brick_gemm_plain(x, nbr, steps, w, valid=None, order=None):
    # ``order`` only orders the kernel's tiles: every row's sum is the same.
    # bf16 operands: the exact (f64) sum over the occupied sources, rounded
    # once to bf16 (the kernel's f32 sum rounds the same way but where a
    # rounding boundary lies within its error: ``brick_gemm_bf16_bound``)
    if x.dtype == BF16:
        return brick_gemm_plain(x.double(), nbr, steps, w.double(), valid).to(BF16)
    nb = nbr.shape[1]
    cin, cout = w.shape[1], w.shape[2]
    x3 = _brick_mask(x, valid).reshape(nb, BRICK_SLOTS, cin)
    out = x.new_zeros(nb, BRICK_SLOTS, cout)
    for d, center, s_idx, p_idx, taps in _step_blocks(steps):
        gs = _brick_source(x3, nbr, d, center)[:, s_idx].reshape(nb, -1)
        tm = torch.tensor(taps, device=w.device)
        wd = w[tm.clamp(min=0)] * (tm >= 0)[..., None, None].to(w.dtype)
        wd = wd.permute(0, 2, 1, 3).reshape(len(s_idx) * cin, len(p_idx) * cout)
        out[:, p_idx] += (gs @ wd).reshape(nb, len(p_idx), cout)
    return _brick_mask(out.reshape(nb * BRICK_SLOTS, cout), valid)


brick_gemm_bf16_plain = brick_gemm_plain  # the twin takes both dtypes


def brick_gemm_bf16_bound(x, nbr, steps, w, valid=None, order=None):
    """(ref, bound), f64 [NB*8, Cout]: the exact sum ``brick_gemm_bf16``
    rounds, and how far from it its output may lie: an output's f32 sum of
    at most taps x Cin bf16 x bf16 products (exact in f32; the zero-filled
    ones add nothing) lies within gamma(taps Cin) P of the exact sum, P the
    sum of their |products|, in any order (``gather_gemm_bf16_bound``), and
    its rounding to bf16 within 2^-8 of it."""
    f64 = torch.float64
    xw, ww = x.to(f64), w.to(f64)
    ref = brick_gemm_plain(xw, nbr, steps, ww, valid)
    size = brick_gemm_plain(xw.abs(), nbr, steps, ww.abs(), valid)
    err = _gamma(w.shape[0] * w.shape[1]) * size
    return ref, BF16_HALF_ULP * ref.abs() + (1 + BF16_HALF_ULP) * err


def _require_brick(x, nbr, valid, order, dtype):
    """The card's operands: what both brick kernels read besides the
    weights or the cotangent (``x`` of ``dtype``)."""
    _require(x, "x", dtype, 2)
    _require(nbr, "nbr", torch.int32, 2)
    _require(valid, "valid", torch.float32, 1)
    _require(order, "order", torch.int32, 1)
    if nbr.shape[0] > BRICK_NBRS:
        raise ValueError(f"a brick map of {nbr.shape[0]} rows > {BRICK_NBRS}")
    if nbr.shape[1] >= BRICK_LIMIT:
        raise ValueError(f"{nbr.shape[1]} bricks: the kernels hold a brick id in 23 bits")
    if valid is not None and valid.data_ptr() % 16:
        raise ValueError("valid: the kernels read a brick's 8 slots as two float4s, "
                         "so its storage must be 16-byte aligned")


def _brick_gemm_shapes(name, x, nbr, steps, w, valid, order):
    _check_brick(name, x, nbr, steps, w.shape[0], valid, order)
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"{name}: {x.shape[1]} channels, weights take {w.shape[1]}")


def _brick_gemm_launch(name, x, nbr, steps, w, valid, order, dtype):
    """The brick-GEMM kernel on ``dtype`` (f32, or bf16: the tensor-core
    kernel) x and w -> (out [NB*8, Cout] in ``dtype``, launches: 0 or 1)."""
    _require_brick(x, nbr, valid, order, dtype)
    _require(w, "w", dtype, 3)
    nb, (taps, cin, cout) = nbr.shape[1], w.shape
    table, centre = _slot_table_on(steps, taps, x.device)
    out = torch.empty(nb * BRICK_SLOTS, cout, device=x.device, dtype=dtype)
    if out.numel() == 0:
        return out, 0
    rc = _lib().pc_brick_gemm(_ptr(x), _ptr(nbr), nbr.shape[0], _ptr(table), taps, centre,
                              _ptr(w), _ptr(valid), _ptr(order), _ptr(out), nb, cin, cout,
                              int(dtype == BF16), _stream())
    _check(rc, name)
    return out, 1


def brick_gemm(x, nbr, steps, w, valid=None, order=None):
    """out[b*8+p] = sum over the plan's steps (d, T) and source slots s of
    x[src_d(b)*8+s] @ w[T[s][p]], src_d(b) = nbr[d, b] (b itself at the
    centre step).  x [NB*8, Cin]; nbr [K3, NB] int32 neighbour bricks;
    w [K_taps, Cin, Cout] -> [NB*8, Cout].  With ``valid`` [NB*8] (the
    level's occupied slots) the sum runs over the occupied sources only and
    the empty output slots and pad bricks get exact zeros; without it every
    slot counts (empty slots get what their neighbours give; pad bricks,
    whose neighbours are all the zero pad brick, exactly zero).  ``order``
    [NB*8] int32, optional: the rows in the order the kernel tiles them
    (the level's ``slot_order``, occupied first); any permutation gives the
    same result, and a row it does not name is never written.

    On the card every output row is written once, by one block, in a
    fixed order of products: the same bits from run to run.  A bf16 x goes
    to ``brick_gemm_bf16``."""
    if x.dtype == BF16:
        return brick_gemm_bf16(x, nbr, steps, w, valid, order)
    _brick_gemm_shapes("brick_gemm", x, nbr, steps, w, valid, order)
    _refuse_bf16("brick_gemm", w, "brick_gemm_bf16")
    if _use_plain(x):
        return brick_gemm_plain(x, nbr, steps, w, valid, order)
    out, n = _brick_gemm_launch("brick_gemm", x, nbr, steps, w, valid, order, torch.float32)
    brick_gemm.launches += n
    return out


def brick_gemm_bf16(x, nbr, steps, w, valid=None, order=None):
    """``brick_gemm`` on bf16 x and w (JAX's ``_brick_core`` in bf16, its
    ``preferred_element_type=f32`` accumulator over the plan's steps, and
    so ``brick_conv``'s forward and dF): each output the f32 sum of its
    bf16 x bf16 products, rounded once to bf16 -> [NB*8, Cout] bf16, exact
    zeros at the empty slots.  On the card the tensor-core kernel, the
    same bits from run to run, held to ``brick_gemm_bf16_bound``."""
    _brick_gemm_shapes("brick_gemm_bf16", x, nbr, steps, w, valid, order)
    _require_dtypes("brick_gemm_bf16", BF16, x=x, w=w)
    if _use_plain(x):
        return brick_gemm_bf16_plain(x, nbr, steps, w, valid, order)
    out, n = _brick_gemm_launch("brick_gemm_bf16", x, nbr, steps, w, valid, order, BF16)
    brick_gemm_bf16.launches += n
    return out


def brick_wgrad_plain(x, nbr, steps, ct, num_taps, valid=None, order=None):
    # ``order`` only orders the kernel's pairs: every tap's sum is the same.
    # bf16 operands: the exact (f64) sums rounded once to bf16
    if x.dtype == BF16:
        return brick_wgrad_plain(x.double(), nbr, steps, ct.double(), num_taps,
                                 valid).to(BF16)
    nb = nbr.shape[1]
    cin, cout = x.shape[1], ct.shape[1]
    x3 = _brick_mask(x, valid).reshape(nb, BRICK_SLOTS, cin)
    ct3 = _brick_mask(ct, valid).reshape(nb, BRICK_SLOTS, cout)
    dw = x.new_zeros(num_taps, cin, cout)
    for d, center, s_idx, p_idx, taps in _step_blocks(steps):
        gs = _brick_source(x3, nbr, d, center)[:, s_idx].reshape(nb, -1)
        cp = ct3[:, p_idx].reshape(nb, -1)
        m = (gs.transpose(0, 1) @ cp).reshape(len(s_idx), cin, len(p_idx), cout)
        tm = torch.tensor(taps, device=x.device)
        keep = tm >= 0
        dw.index_add_(0, tm[keep], m.permute(0, 2, 1, 3)[keep])
    return dw


brick_wgrad_bf16_plain = brick_wgrad_plain  # the twin takes both dtypes


def brick_wgrad_bf16_bound(x, nbr, steps, ct, num_taps, valid=None, order=None):
    """(ref, bound), f64 [taps, Cin, Cout]: the exact sum
    ``brick_wgrad_bf16`` rounds, and how far from it its output may lie:
    tap t's f32 sum of its n_t kept (output slot, source) pairs' products
    within gamma(n_t) of the sum of their |products|, in any order of the
    slices and the mma (``gather_wgrad_bf16_bound``), and the rounding to
    bf16 within 2^-8 of it."""
    f64 = torch.float64
    xw, cw = x.to(f64), ct.to(f64)
    ref = brick_wgrad_plain(xw, nbr, steps, cw, num_taps, valid)
    size = brick_wgrad_plain(xw.abs(), nbr, steps, cw.abs(), num_taps, valid)
    ones = xw.new_ones(x.shape[0], 1)
    pairs = brick_wgrad_plain(ones, nbr, steps, ones, num_taps, valid)  # [taps, 1, 1]
    err = _gamma(pairs) * size
    return ref, BF16_HALF_ULP * ref.abs() + (1 + BF16_HALF_ULP) * err


def _brick_wgrad_shapes(name, x, nbr, steps, ct, num_taps, valid, order):
    _check_brick(name, x, nbr, steps, num_taps, valid, order)
    _check_brick(f"{name} ct", ct, nbr, steps)


def _brick_wgrad_launch(name, x, nbr, steps, ct, num_taps, valid, order, dtype):
    """The brick-wgrad kernel on ``dtype`` (f32, or bf16: the tensor-core
    forms, which leave ``order``) x and ct -> (dW [taps, Cin, Cout] f32,
    launches: 0 or 1)."""
    _require_brick(x, nbr, valid, order, dtype)
    _require(ct, "ct", dtype, 2)
    nb, cin, cout = nbr.shape[1], x.shape[1], ct.shape[1]
    table, centre = _slot_table_on(steps, num_taps, x.device)
    rows = nb * BRICK_SLOTS
    if rows == 0 or num_taps == 0:
        return torch.zeros(num_taps, cin, cout, device=x.device, dtype=torch.float32), 0
    bf16, k3 = dtype == BF16, nbr.shape[0]
    if bf16 and cin <= BRICK_NARROW:
        # the brick form: a block a (column tile of 8 Cout, neighbour row),
        # partials [slices, K3, 8 Cin, 8 Cout], tickets for both combines
        tiles = -(-BRICK_SLOTS * cout // 128)
        slices = _brick_wgrad_slices(nb, tiles, k3, whole=True)  # runs of 256 bricks
        ws = torch.empty(slices, k3, BRICK_SLOTS * cin, BRICK_SLOTS * cout, device=x.device,
                         dtype=torch.float32)
        tickets = torch.zeros(k3 * tiles + 1, device=x.device, dtype=torch.int32)
    else:
        tiles = _wgrad_tiles(cin, cout, bf16)
        slices = _brick_wgrad_slices(rows, tiles, num_taps, whole=bf16)
        ws = tickets = None
        if slices > 1:
            ws = torch.empty(slices, num_taps, cin, cout, device=x.device, dtype=torch.float32)
            tickets = torch.zeros(tiles * num_taps, device=x.device, dtype=torch.int32)
    dw = torch.empty(num_taps, cin, cout, device=x.device, dtype=torch.float32)
    if bf16:
        occ = torch.empty(nb, device=x.device, dtype=torch.int32)  # the bricks' slot words
        rc = _lib().pc_brick_wgrad_bf16(_ptr(x), _ptr(nbr), k3, _ptr(table), num_taps, centre,
                                        _ptr(ct), _ptr(valid), _ptr(occ), _ptr(dw), _ptr(ws),
                                        _ptr(tickets), nb, cin, cout, slices, _stream())
    else:
        rc = _lib().pc_brick_wgrad(_ptr(x), _ptr(nbr), _ptr(table), num_taps, centre, _ptr(ct),
                                   _ptr(valid), _ptr(order), _ptr(dw), _ptr(ws), _ptr(tickets),
                                   nb, cin, cout, slices, _stream())
    _check(rc, name)
    return dw, 1


def brick_wgrad(x, nbr, steps, ct, num_taps, valid=None, order=None):
    """dW[t] = sum over the (d, s, p) with T_d[s][p] = t of
    sum_b x[src_d(b)*8+s]^T @ ct[b*8+p] -> [num_taps, Cin, Cout] f32, with
    ``valid`` over the pairs whose output slot b*8+p and source slot are
    both occupied (without it over every pair).  ``order`` (the level's
    ``slot_order``) only orders the pairs.  On the card each block reduces
    the live pairs of one tap in its share of the rows, and the shares'
    partial sums are added in a fixed order: dW is the same from run to
    run.  A bf16 x goes to ``brick_wgrad_bf16``."""
    if x.dtype == BF16:
        return brick_wgrad_bf16(x, nbr, steps, ct, num_taps, valid, order)
    _brick_wgrad_shapes("brick_wgrad", x, nbr, steps, ct, num_taps, valid, order)
    _refuse_bf16("brick_wgrad", ct, "brick_wgrad_bf16")
    if _use_plain(x):
        return brick_wgrad_plain(x, nbr, steps, ct, num_taps, valid, order)
    dw, n = _brick_wgrad_launch("brick_wgrad", x, nbr, steps, ct, num_taps, valid, order,
                                torch.float32)
    brick_wgrad.launches += n
    return dw


def brick_wgrad_bf16(x, nbr, steps, ct, num_taps, valid=None, order=None):
    """``brick_wgrad`` on bf16 x and ct (JAX ``_brick_sym_bwd``'s dW in
    bf16: the blocks' f32 sums, rounded once to the weights' bf16) ->
    [num_taps, Cin, Cout] bf16.  On the card the tensor-core kernels' f32
    dW (partial sums added in a fixed order: the same bits from run to
    run), rounded once here; held to ``brick_wgrad_bf16_bound``.  They
    take the live pairs brick by brick (``order`` is left) and, up to
    ``BRICK_NARROW`` input channels, one product a neighbour row over whole
    bricks, whose empty slots they read as zeros."""
    _brick_wgrad_shapes("brick_wgrad_bf16", x, nbr, steps, ct, num_taps, valid, order)
    _require_dtypes("brick_wgrad_bf16", BF16, x=x, ct=ct)
    if _use_plain(x):
        return brick_wgrad_bf16_plain(x, nbr, steps, ct, num_taps, valid, order)
    dw, n = _brick_wgrad_launch("brick_wgrad_bf16", x, nbr, steps, ct, num_taps, valid,
                                order, BF16)
    brick_wgrad_bf16.launches += n
    return dw.to(BF16)


def _brick_wgrad_slices(rows, tiles, taps, whole=False) -> int:
    """Blocks a (tap, tile) of brick_wgrad spreads its rows over: about
    ``WGRAD_BLOCKS`` blocks in all, 256 rows a block at least.  A block
    takes every slices-th run of 256 rows of the order (the bf16 forms:
    32 or 256 bricks), so the occupied rows, which the orders put first,
    fall to every block alike.  ``whole`` (the bf16 forms): at most
    ``WGRAD_BLOCKS``, whole waves of 2 blocks an SM, so that no block runs
    alone in a wave of its own."""
    per = WGRAD_BLOCKS // (tiles * taps) if whole else -(-WGRAD_BLOCKS // (tiles * taps))
    return max(1, min(-(-rows // 256), per))


KERNELS = (gather_gemm, gather_wgrad, parent_gemm, scatter_parent,
           scatter_gemm, segment_sum, gather_sum, scatter_sum, brick_gemm,
           brick_wgrad, gather_gemm_bf16, gather_wgrad_bf16, parent_gemm_bf16,
           scatter_parent_bf16, scatter_gemm_bf16, gather_sum_bf16, scatter_sum_bf16,
           brick_gemm_bf16, brick_wgrad_bf16)
reset_launches()
