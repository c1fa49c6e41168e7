"""Sparse ops: convolutions, pooling, masking, masked moments.

Port of ``pointcontrast_tpu/sparse/ops.py``: the chunked layout's ops, the
voxel (flat) layout's, and the per-sample and k2s2 pooling.  Each
convolution is a ``torch.autograd.Function`` carrying the JAX op's
backward, built from the kernels in ``sparse.kernels``:

  K1 ``_ConvChunkFused`` (JAX ``_conv_chunk_fused``): same-level conv,
     scatter-free backward through the offset-reversal permutation, past
     MAX_TAPS off-centre taps in tap groups (``k1_groups``);
  K2 ``_ConvChunkDown2`` (JAX ``_conv_chunk_down2``): k2s2 down conv whose
     dF is a gather through the functional child -> (parent, offset) map;
  K3 ``_ConvTrChunk`` (JAX ``_conv_tr_chunk``): k2s2 transposed conv whose
     backward is K2's forward transposed: dF and dW gather the cotangent
     through the level's down map, the parent map's inverse;
  K4 ``_ConvChunkDownFused`` (JAX ``_conv_chunk_down_fused``, and JAX
     ``_conv_core`` on a flat [K, N] map such as the CRF's bilateral grid,
     run as a [K, 1, N] map): any other map, gather-GEMM forward,
     scatter_gemm dF, gather_wgrad dW, in groups of MAX_TAPS taps.
The voxel layout runs the same Functions at B = 1, a flat [K, N] map taken
as [K, 1, N] and a flat [N] parent map as [1, N]: a same-level map with
``rev`` and ``valid_out`` is K1 (JAX ``_conv_sym``: the scatter-free
backward of ``_ConvChunkFused``), a k2s2 down map with ``up`` is K2 (JAX
differentiates ``_conv_core`` there; the gradient agrees on valid rows),
any other flat map K4, the flat transposed conv K3 and the flat pools
``_GatherSum``.  Missing neighbours point at the one pad row ``N - 1`` of
the whole batch, which is then the "last row of the slice" that the
scatters leave out.
``global_pool`` and ``broadcast_to_points`` are Functions over the
``segment_sum`` kernel and the K8 row gather (``detect.kernels.gather_rows``),
each the other's adjoint.  The K5 k2s2 pooling ops (``sparse_sum_pool``,
``sparse_avg_pool``, ``sparse_avg_unpool``) are one Function, ``_GatherSum``,
over the ``gather_sum`` kernel with ``scatter_sum`` as its backward.

Zero-padding invariant: callers keep features of padded rows at exactly zero
(``mask_rows``) and missing neighbours point at a pad row, so gathered pad
rows contribute exactly zero.  The gather kernels are told so: every
forward gather, K2's and K4's dW pass the features' last row ``S_in - 1``
as ``skip`` (``skip_a``), K1's dF and dW the cotangent's last row (zero: K1
runs only with ``valid_out``, whose mask zeroes it), K3's dF and dW the
cotangent's fine pad row ``S_f - 1`` (where the down map sends missing
children; no valid coarse row reads another fine pad row) and K3's dW the
features' coarse pad row too, so the card spends no products on the pad
row.  K3's forward ``parent_gemm`` passes the coarse pad row ``S_c - 1``
(pad features are zero), K2's dF passes -1: its cotangent's coarse pad row is
zero only through the mask of the conv's output, and a fine voxel that
truncation orphaned reads it (JAX gives that row ``ct[pad] W_0^T``).  Both
tile the fine rows in the pyramid's up order (``topology.up_order``).
Feature gradients at pad rows are garbage by design (they differ between
forms) and every producer masks them.

bf16 activations (JAX's mixed precision): K1-K3 take bf16 features and
weights (the layers' bf16 casts) and run the kernels' bf16 forms.  Every
conv product is bf16 x bf16 with an f32 sum; every dW is ``F.f32^T
ct.f32`` in f32 (``gather_wgrad_bf16``), rounded to the weights' bf16 as
JAX's ``dw.astype(weights.dtype)``.  JAX's K3 backward scatters the bf16
cotangent into an f32 ``dy`` and rounds ``dy W.f32`` once; each live slot
of that table holds one cotangent row widened exactly, so the port's K3
gathers the bf16 cotangent through the down map instead, with the same
products, sums and roundings (``gather_gemm_bf16``'s one rounding; dW as
above).  Where the sums are rounded to bf16 depends on the layout, as in JAX:
  - chunked: JAX's rounding points, once per output (forward and dF of K1,
    K2 and K3);
  - voxel: the K1 and K2 forwards round each tap's product to bf16 before
    the f32 sum and the sum again (JAX's flat ``_conv_core``; the
    ``round_each_tap`` mode of ``gather_gemm_bf16``, the centre added in
    its place among the taps); K3's forward and K1's dF round once, as
    JAX's flat forms do.  K2's and K3's dF round once, where JAX's autodiff
    of its scans rounds each tap's adjoint and adds them in bf16: a delta
    kept on purpose (ROADMAP, "Deltas the port keeps on purpose").
K4 in bf16 (JAX ``_conv_chunk_down_fused`` and the flat ``_conv_core``):
the forward is ``gather_gemm_bf16`` (chunked: one rounding; flat: each tap
rounded, and past MAX_TAPS taps the launches' f32 sums added and rounded
once), dW ``gather_wgrad_bf16`` rounded to the weights' dtype, dF
``scatter_gemm_bf16``: ct W^T in f32 over every tap, rounded once (JAX's
chunked rule; on flat maps JAX's autodiff of ``_conv_core`` rounds each
tap's adjoint and adds them in bf16, the delta the port keeps, as for the
voxel K2 / K3 dF).  The pools in bf16 keep JAX's roundings, which XLA's
CPU code fixes: the chunked sum and average pools round after every add of
their Python ``sum`` (``gather_sum_bf16``), the flat ones sum in f32 and
round once (``jnp.sum``); the average divides by the count cast to bf16;
the adjoints are XLA's bf16 scatter-adds, each destination's rows in
ascending source row, every add rounded (``scatter_sum_bf16``; the unpool's
through the level's down map, its inverse).
"""
from __future__ import annotations

import torch

from pointcontrast_tpu_torch.detect import kernels as detect_kernels
from pointcontrast_tpu_torch.sparse.kernels import (
    BF16,
    MAX_TAPS,
    gather_gemm,
    gather_gemm_bf16,
    gather_sum,
    gather_sum_bf16,
    gather_wgrad,
    gather_wgrad_bf16,
    parent_gemm,
    parent_gemm_bf16,
    scatter_gemm,
    scatter_gemm_bf16,
    scatter_sum,
    scatter_sum_bf16,
    segment_sum,
)


def mask_rows(features: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero out padded rows. valid: [N] float (1 valid / 0 pad)."""
    return features * valid[:, None].to(features.dtype)


def widen(features: torch.Tensor) -> torch.Tensor:
    """``features`` in float32, or in its own dtype where that is wider."""
    return features.to(torch.promote_types(features.dtype, torch.float32))


def masked_moments(features: torch.Tensor, valid: torch.Tensor):
    """Mean/variance over valid rows only (padding-aware BatchNorm stats).

    Returns (mean[C], var[C] biased, n scalar tensor), in float32 or wider
    (a float64 net keeps float64 statistics)."""
    f = widen(features)
    v = valid.to(f.dtype)[:, None]
    n = v.sum().clamp(min=1.0)
    mean = (f * v).sum(dim=0) / n
    var = ((f - mean).square() * v).sum(dim=0) / n
    return mean, var, n


def _forms(features, weights):
    """(gather_gemm, gather_wgrad, parent_gemm) for the features' dtype: the
    f32 kernels, or the bf16 forms for bf16 features (with bf16 weights)."""
    if features.dtype != BF16:
        return gather_gemm, gather_wgrad, parent_gemm
    if weights.dtype != BF16:
        raise TypeError(f"bf16 features need bf16 weights (the layer's cast), got "
                        f"{weights.dtype}")
    return gather_gemm_bf16, gather_wgrad_bf16, parent_gemm_bf16


def _center_of(rev) -> int | None:
    """Index of the zero offset: the unique fixed point of ``rev``."""
    if rev is None:
        return None
    for i, r in enumerate(rev):
        if r == i:
            return i
    return None


def _chunks(taps) -> list:
    """Consecutive runs of at most MAX_TAPS of ``taps`` (one launch each)."""
    taps = list(taps)
    return [taps[lo:lo + MAX_TAPS] for lo in range(0, len(taps), MAX_TAPS)]


def k1_groups(k: int, rev, round_each_tap: bool = False) -> tuple:
    """(forward, dF, dW) tap groups of a K1 conv of ``k`` taps, one launch a
    group: the forward's and dF's off-centre taps (``round_each_tap``: the
    forward's every tap, the centre in its place), dW's every tap, each in
    consecutive runs of at most MAX_TAPS.  A conv of at most MAX_TAPS
    off-centre taps (every 3-D block conv, the hybrid 4-D ones) is one
    launch of each."""
    center = _center_of(rev)
    off = [i for i in range(k) if i != center]
    return (_chunks(range(k) if round_each_tap else off), _chunks(off), _chunks(range(k)))


def _modes(bf16: bool, groups: int, round_each_tap: bool = False) -> dict:
    """``gather_gemm_bf16``'s modes for one of ``groups`` launches: past
    one, each leaves its f32 sum unrounded (``f32_out``)."""
    modes = {"round_each_tap": True} if round_each_tap else {}
    if bf16 and groups > 1:
        modes["f32_out"] = True
    return modes


def _sum_groups(parts, bf16: bool):
    """The groups' partial sums added in group order (one group: its
    output as it is); bf16: the f32 sum rounded once, JAX's one f32
    accumulator over every tap."""
    out = None
    for part in parts:
        out = part if out is None else out + part
    return out.to(BF16) if bf16 else out


class _ConvChunkFused(torch.autograd.Function):
    """K1: out[b,s] = F[b,s] W_c + sum_{k != c} F[b, nbr[k,b,s]] W_k.

    Backward (gather only): dF = ct W_c^T + sum_{k != c} ct[nbr[rev[k]]] W_k^T
    and dW_k = sum F^T ct[nbr[rev[k]]]; the centre's map is the identity on
    valid rows and pad features are zero, so dW takes all K taps gathered.

    Past MAX_TAPS off-centre taps (the Tesseract nets' 81, a k = 5 stem's
    125) each sum runs in tap groups (``k1_groups``), one launch a group:
    the centre's W_c in the first, the groups' f32 partials added in group
    order (bf16: ``f32_out`` partials, rounded once), dW the groups' taps
    concatenated.  Against one launch only the association of the f32 sum
    changes; a conv of one group launches as it always did."""

    @staticmethod
    def forward(ctx, features, nbr, weights, rev, order=None, round_each_tap=False):
        k, b_, s = nbr.shape
        center = _center_of(rev)
        f3 = features.reshape(b_, s, -1)
        gemm = _forms(features, weights)[0]
        groups = k1_groups(k, rev, round_each_tap)[0]
        # round_each_tap: JAX's order, the centre gathered in its place
        wc = None if center is None or round_each_tap else weights[center]
        bf16 = features.dtype == BF16
        modes = _modes(bf16, len(groups), round_each_tap)
        out = _sum_groups((gemm(f3, nbr, taps, 0, weights[taps], wc if i == 0 else None,
                                s, s - 1, order, **modes)
                           for i, taps in enumerate(groups)), bf16)
        ctx.save_for_backward(features, nbr, weights, order)
        ctx.rev, ctx.center = rev, center
        return out.reshape(b_ * s, -1)

    @staticmethod
    def backward(ctx, ct):
        features, nbr, weights, order = ctx.saved_tensors
        rev, center = ctx.rev, ctx.center
        k, b_, s = nbr.shape
        f3 = features.reshape(b_, s, -1)
        ct3 = ct.contiguous().reshape(b_, s, -1)
        gemm, wgrad, _ = _forms(features, weights)
        _, df_groups, dw_groups = k1_groups(k, rev)
        bf16 = features.dtype == BF16
        df = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.transpose(1, 2)
            wtc = None if center is None else wt[center].contiguous()
            modes = _modes(bf16, len(df_groups))
            df = _sum_groups((gemm(ct3, nbr, [rev[i] for i in taps], 0, wt[taps].contiguous(),
                                   wtc if i == 0 else None, s, s - 1, order, **modes)
                              for i, taps in enumerate(df_groups)), bf16)
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[2]:
            dw = torch.cat([wgrad(f3, None, None, 0, ct3, nbr, [rev[i] for i in taps], 0,
                                  len(taps), s, skip_g=s - 1)
                            for taps in dw_groups]).to(weights.dtype)
        return df, None, dw, None, None, None


class _ConvChunkDown2(torch.autograd.Function):
    """K2: out[b,s] = sum_{k<8} F[b, down_nbr[k,b,s]] W_k.

    Backward: dF[b,i] = ct[b, up_parent[b,i]] W_{up_offset[b,i]}^T (every
    fine voxel has exactly one (parent, offset), so no scatter; no skipped
    parent: an orphaned fine voxel reads the cotangent's pad row, as in
    JAX) and dW re-gathers the im2col rows."""

    @staticmethod
    def forward(ctx, features, down_nbr, up_parent, up_offset, weights, order=None,
                up_order=None, round_each_tap=False):
        k, b_, s_out = down_nbr.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        gemm = _forms(features, weights)[0]
        rounding = {"round_each_tap": True} if round_each_tap else {}
        out = gemm(f3, down_nbr, list(range(k)), 0, weights, None, s_out,
                   f3.shape[1] - 1, order, **rounding)
        ctx.save_for_backward(features, down_nbr, up_parent, up_offset, weights, up_order)
        return out.reshape(b_ * s_out, -1)

    @staticmethod
    def backward(ctx, ct):
        features, down_nbr, up_parent, up_offset, weights, up_order = ctx.saved_tensors
        k, b_, s_out = down_nbr.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        ct3 = ct.contiguous().reshape(b_, s_out, -1)
        _, wgrad, pgemm = _forms(features, weights)
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = pgemm(ct3, up_parent, up_offset, weights, -1, up_order, trans_w=True)
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[4]:
            dw = wgrad(f3, down_nbr, list(range(k)), 0, ct3, None,
                       None, 0, k, s_out, skip_a=f3.shape[1] - 1).to(weights.dtype)
        return df, None, None, None, dw, None, None, None


class _ConvTrChunk(torch.autograd.Function):
    """K3: out[b,i] = F[b, up_parent[b,i]] W_{up_offset[b,i]}.

    Backward, K2's forward transposed: each valid (offset, parent) pair
    names one fine row, so through the level's down map ``down`` [8, B,
    S_c], the parent map's inverse (the fine pad row S_f - 1 where a
    coarse row has no child), dF[b,p] = sum_k ct[b, down[k,b,p]] W_k^T
    and dW_k = sum_p F[b,p]^T ct[b, down[k,b,p]], gathers that skip the
    fine pad row (and, for dW, the coarse pad row, whose features are
    zero).  Pad fine rows and the fine voxels truncation orphaned name the
    coarse pad slot, which no valid coarse row's map entry names: JAX's
    stacked ``dy`` holds their sum there, which reaches only dF's pad row
    (the port's is zero).  In bf16, JAX's rounding points: its ``dy`` at a
    live slot is the bf16 cotangent widened exactly, so dF is one rounding
    of the f32 sum of bf16 x bf16 products (``gather_gemm_bf16``) and dW
    their f32 sum (``gather_wgrad_bf16``) rounded to the weights' dtype."""

    @staticmethod
    def forward(ctx, features, up_parent, up_offset, weights, up_order=None, down_nbr=None,
                down_order=None):
        b_, s_f = up_parent.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        # the coarse pad row's features are zero: its fine rows get zeros
        pgemm = _forms(features, weights)[2]
        out = pgemm(f3, up_parent, up_offset, weights, f3.shape[1] - 1, up_order)
        ctx.save_for_backward(features, up_parent, up_offset, weights, down_nbr, down_order)
        return out.reshape(b_ * s_f, -1)

    @staticmethod
    def backward(ctx, ct):
        features, up_parent, up_offset, weights, down, order = ctx.saved_tensors
        k = weights.shape[0]
        b_, s_f = up_parent.shape
        s_c = features.shape[0] // b_
        f3 = features.reshape(b_, s_c, -1)
        ct3 = ct.contiguous().reshape(b_, s_f, -1)
        if down is None:
            down = down_from_up(up_parent, up_offset, k, s_c)
        gemm, wgrad, _ = _forms(features, weights)
        taps = list(range(k))
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = gemm(ct3, down, taps, 0, weights.transpose(1, 2).contiguous(), None, s_c,
                      s_f - 1, order)
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[3]:
            dw = wgrad(f3, None, None, 0, ct3, down, taps, 0, k, s_c, skip_a=s_c - 1,
                       skip_g=s_f - 1).to(weights.dtype)
        return df, None, None, dw, None, None, None


def down_from_up(up_parent: torch.Tensor, up_offset: torch.Tensor, k: int,
                 s_c: int) -> torch.Tensor:
    """[k, B, s_c] int32: the inverse of a parent map [B, S_f], each coarse
    row's child at each offset, the fine pad row S_f - 1 where it has none,
    as the pyramid's ``down_nbr``.  Fine rows whose parent is the coarse pad
    row s_c - 1 (pad rows and the voxels truncation orphaned) name no
    slot.  Plain index ops on the maps' device, no host sync: each kept
    row's slot is unique, the others all go to one spare slot, dropped."""
    b_, s_f = up_parent.shape
    dev = up_parent.device
    spare = k * b_ * s_c
    slot = ((up_offset.long() * b_ + torch.arange(b_, device=dev)[:, None]) * s_c
            + up_parent.long())
    slot = torch.where(up_parent == s_c - 1, spare, slot)
    rows = torch.arange(s_f, dtype=torch.int32, device=dev).expand(b_, s_f)
    down = torch.full((spare + 1,), s_f - 1, dtype=torch.int32, device=dev)
    down.scatter_(0, slot.reshape(-1), rows.reshape(-1))
    return down[:spare].view(k, b_, s_c)


def _tap_groups(k: int):
    """Consecutive tap ranges of at most MAX_TAPS taps (one launch each)."""
    return [range(lo, min(lo + MAX_TAPS, k)) for lo in range(0, k, MAX_TAPS)]


class _ConvChunkDownFused(torch.autograd.Function):
    """K4: out[b,s] = sum_k F[b, nbr[k,b,s]] W_k for any chunked map without
    ``rev`` or ``up`` (the k3s2 ``down_nbr3`` map, a 1-tap downsample map,
    or a same-level map passed without ``rev``) and for a flat [K, N] map
    taken as [K, 1, N] (JAX ``_conv_core`` without ``rev``, any K, no centre
    skip), in groups of MAX_TAPS taps.

    Backward, JAX's: dF[b, nbr[k,b,s]] += ct[b,s] W_k^T, a scatter (k3s2
    windows overlap: up to 8 coarse rows read one fine row), and
    dW_k = sum_s F[b, nbr[k,b,s]]^T ct[b,s].  JAX also scatters into the
    pad row S_in - 1, where missing neighbours point; that sum is left out
    here (pad-row dF is garbage by design, every producer masks it).  The
    scatter tiles the cotangent rows in the forward's ``order``: the map is
    live at (s, k) exactly where the forward gathers a live row, so the
    map's live order serves both.  In bf16 (``round_each_tap``: a flat
    map's forward, each tap rounded) the bf16 forms, dF one f32 scatter
    over every tap rounded once."""

    @staticmethod
    def forward(ctx, features, nbr, weights, order=None, round_each_tap=False):
        k, b_, s_out = nbr.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        groups = _tap_groups(k)
        skip = f3.shape[1] - 1
        if features.dtype != BF16:
            out = None
            for taps in groups:
                part = gather_gemm(f3, nbr, taps, 0, weights[taps.start:taps.stop],
                                   None, s_out, skip, order)
                out = part if out is None else out + part
        else:
            gemm = _forms(features, weights)[0]
            if len(groups) == 1:
                out = gemm(f3, nbr, groups[0], 0, weights, None, s_out, skip, order,
                           round_each_tap=round_each_tap)
            elif round_each_tap:  # JAX's one f32 accumulator over every rounded tap
                out = None
                for taps in groups:
                    part = gemm(f3, nbr, taps, 0, weights[taps.start:taps.stop], None,
                                s_out, skip, order, round_each_tap=True, f32_out=True)
                    out = part if out is None else out + part
                out = out.to(BF16)
            else:
                raise NotImplementedError(
                    f"a chunked bfloat16 conv of {k} taps (more than {MAX_TAPS}): no "
                    "form of gather_gemm_bf16 keeps its f32 sum across launches")
        ctx.save_for_backward(features, nbr, weights, order)
        return out.reshape(b_ * s_out, -1)

    @staticmethod
    def backward(ctx, ct):
        features, nbr, weights, order = ctx.saved_tensors
        k, b_, s_out = nbr.shape
        s_in = features.shape[0] // b_
        f3 = features.reshape(b_, s_in, -1)
        ct3 = ct.contiguous().reshape(b_, s_out, -1)
        groups = _tap_groups(k)
        bf16 = features.dtype == BF16
        wgrad = gather_wgrad_bf16 if bf16 else gather_wgrad
        df = dw = None
        if ctx.needs_input_grad[0]:
            if bf16:  # every tap into one f32 table, rounded once
                df = scatter_gemm_bf16(ct3, nbr, range(k), weights, s_in, s_in - 1, order)
            else:
                for taps in groups:
                    part = scatter_gemm(ct3, nbr, taps, weights[taps.start:taps.stop],
                                        s_in, s_in - 1, order)
                    df = part if df is None else df + part
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[2]:
            dw = torch.cat([wgrad(f3, nbr, taps, 0, ct3, None, None, 0,
                                  len(taps), s_out, skip_a=s_in - 1)
                            for taps in groups]).to(weights.dtype)
        return df, None, dw, None, None


def sparse_conv(
    features: torch.Tensor,  # [B*S_in, Cin] (flat: [N_in, Cin]), pad rows zero
    nbr: torch.Tensor,  # [K, B, S_out] frame-local gather map, or flat [K, N_out]
    weights: torch.Tensor,  # [K, Cin, Cout]
    bias: torch.Tensor | None = None,  # [Cout]
    valid_out: torch.Tensor | None = None,  # [B*S_out] float mask
    rev: tuple | None = None,  # offset-reversal perm (same-level maps only)
    up: tuple | None = None,  # (up_parent, up_offset[, up_order]) for k2s2 down maps
    order: torch.Tensor | None = None,  # [B, S_out] (flat [N_out]): the map's live order
) -> torch.Tensor:
    """Sparse convolution, as JAX's dispatch: a same-level map with ``rev``
    (and ``valid_out``) runs K1, a k2s2 down map with ``up`` K2, any other
    map K4; a flat [K, N_out] map runs the same at B = 1.  ``order``, the
    map's live order from the pyramid (``topology.live_order``), changes
    only the order in which the gather GEMM tiles the output rows, and
    ``up``'s optional third entry, the up order (``topology.up_order``),
    the order in which K2's dF tiles the fine rows.  Either order must be
    a permutation of each chunk's rows, as ``check_pyramid_bounds`` checks
    of the pyramid's: a row that no entry names is never written."""
    features = features.contiguous()
    if up is not None and len(up) == 2:
        up = (*up, None)
    # bf16 on a flat map: JAX's flat forward rounds each tap (_conv_core)
    round_each_tap = nbr.dim() == 2 and features.dtype == BF16
    if nbr.dim() == 2:  # voxel layout: one batch-wide slice
        nbr = nbr[:, None]
        if up is not None:
            up = tuple(None if u is None else u[None] for u in up)
        if order is not None:
            order = order[None]
    elif nbr.dim() != 3:
        raise ValueError(f"[K, B, S] or [K, N] maps only, got {tuple(nbr.shape)}")
    if (rev is not None and nbr.shape[1] * nbr.shape[2] == features.shape[0]
            and valid_out is not None):
        out = _ConvChunkFused.apply(features, nbr, weights, tuple(rev), order,
                                    round_each_tap)
    elif up is not None:
        out = _ConvChunkDown2.apply(features, nbr, up[0], up[1], weights, order, up[2],
                                    round_each_tap)
    else:
        out = _ConvChunkDownFused.apply(features, nbr.contiguous(),
                                        weights.contiguous(), order, round_each_tap)
    if bias is not None:  # in the activations' dtype, as JAX's b.astype(dtype)
        out = out + bias.to(out.dtype)
    if valid_out is not None:
        out = mask_rows(out, valid_out)
    return out


def sparse_conv_transpose(
    features: torch.Tensor,  # [B*S_coarse, Cin] (flat: [N_coarse, Cin])
    up_parent: torch.Tensor,  # [B, S_fine] frame-local coarse parent, or [N_fine]
    up_offset: torch.Tensor,  # [B, S_fine] (or [N_fine]) offset id in [0, 8)
    weights: torch.Tensor,  # [8, Cin, Cout]
    bias: torch.Tensor | None = None,
    valid_out: torch.Tensor | None = None,
    up_order: torch.Tensor | None = None,  # [B, S_fine] (or [N_fine]): the up order
    down: tuple | None = None,  # (down_nbr [8, B, S_coarse], down_order [B, S_coarse])
) -> torch.Tensor:
    """k2s2 transposed conv onto the reused finer level (K3; a flat parent
    map at B = 1).  ``up_order``, the pyramid's up order
    (``topology.up_order``), changes only the order in which the kernel
    tiles the fine rows.  It must be a permutation of each chunk's rows, as
    ``check_pyramid_bounds`` checks of the pyramid's: a row that no entry
    names is never written.  ``down``: the down map of the level this conv
    produces and its live order (flat: [8, N_coarse] and [N_coarse]), which
    the backward gathers through; it must be the parent map's inverse below
    the pad rows, as the pyramid builders make it.  Without it the backward
    derives that inverse from the parent map (``down_from_up``), with no
    order."""
    down_nbr = down_order = None
    if down is not None:
        down_nbr, down_order = down
    if up_parent.dim() == 1:
        up_parent, up_offset = up_parent[None], up_offset[None]
        if up_order is not None:
            up_order = up_order[None]
        if down_nbr is not None:
            down_nbr = down_nbr[:, None]
        if down_order is not None:
            down_order = down_order[None]
    elif up_parent.dim() != 2:
        raise ValueError(f"[B, S] or [N] parent maps only, got {tuple(up_parent.shape)}")
    out = _ConvTrChunk.apply(features.contiguous(), up_parent, up_offset, weights, up_order,
                             down_nbr, down_order)
    if bias is not None:
        out = out + bias.to(out.dtype)
    if valid_out is not None:
        out = mask_rows(out, valid_out)
    return out


class _GatherSum(torch.autograd.Function):
    """out[b,s] = sum_k F[b, map[k,b,s]] (over every row of a [K, B, S_out]
    map), divided by ``divisor`` [B*S_out, 1] when one is given (it carries
    no gradient).  Backward, the adjoint: scatter_sum of ct (/ divisor)
    through the same map, the source's pad rows left out: rows
    ``skip_from`` on, by default the last row S_in - 1, where missing
    children point (pad-row gradients are garbage by design).  bf16
    features run the bf16 forms: ``round_each_add`` the chunked pools'
    rounding after every add (the flat pools': once), ``inverse`` the
    sources of each destination for the unpool's adjoint
    (``scatter_sum_bf16``); the division and ct / divisor in bf16, as
    JAX's."""

    @staticmethod
    def forward(ctx, features, map_, divisor, skip_from=None, round_each_add=True,
                inverse=None):
        k, b_, s_out = map_.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        if features.dtype == BF16:
            out = gather_sum_bf16(f3, map_, range(k), 0, s_out, round_each_add)
        else:
            out = gather_sum(f3, map_, range(k), 0, s_out)
        out = out.reshape(b_ * s_out, -1)
        if divisor is not None:
            out = out / divisor
        ctx.save_for_backward(map_, divisor, inverse)
        ctx.s_in = f3.shape[1]
        ctx.skip_from = f3.shape[1] - 1 if skip_from is None else skip_from
        return out

    @staticmethod
    def backward(ctx, ct):
        map_, divisor, inverse = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None, None, None
        k, b_, s_out = map_.shape
        if divisor is not None:
            ct = ct / divisor
        ct3 = ct.contiguous().reshape(b_, s_out, -1)
        if ct3.dtype == BF16:
            df = scatter_sum_bf16(ct3, map_, range(k), 0, ctx.s_in, ctx.skip_from, inverse)
        else:
            df = scatter_sum(ct3, map_, range(k), 0, ctx.s_in, ctx.skip_from)
        return df.reshape(b_ * ctx.s_in, -1), None, None, None, None, None


def _down_map(name, m):
    """A k2s2 pooling map in the chunked form [K, B, S_out] (a flat
    [K, N_out] map as [K, 1, N_out])."""
    if m.dim() == 2:
        return m[:, None]
    if m.dim() != 3:
        raise ValueError(f"{name}: map of shape {tuple(m.shape)}")
    return m


def sparse_sum_pool(
    features: torch.Tensor,  # [B*S_in, C], padded rows zero
    down_nbr: torch.Tensor,  # [K, B, S_out] children of each coarse row (flat [K, N_out])
    valid_out: torch.Tensor | None = None,  # [B*S_out] float mask
) -> torch.Tensor:
    """Kernel-2 stride-2 sum pooling (ME.MinkowskiSumPooling).  In bf16 a
    chunked map rounds after every add, a flat one once (JAX's)."""
    flat = down_nbr.dim() == 2
    down_nbr = _down_map("sparse_sum_pool", down_nbr)
    out = _GatherSum.apply(features.contiguous(), down_nbr, None, None, not flat)
    return out if valid_out is None else mask_rows(out, valid_out)


def sparse_avg_pool(
    features: torch.Tensor,  # [B*S_in, C], padded rows zero
    down_nbr: torch.Tensor,  # [K, B, S_out] (flat [K, N_out])
    valid_in: torch.Tensor,  # [B*S_in] float mask
    valid_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Kernel-2 stride-2 average pooling over the children present
    (ME.MinkowskiAvgPooling): the sum over max(count, 1), the count a
    gather_sum of ``valid_in`` at C = 1 (in the features' dtype: exact up
    to 8 in bf16, as JAX's count cast to it)."""
    flat = down_nbr.dim() == 2
    down_nbr = _down_map("sparse_avg_pool", down_nbr)
    k, b_, s_out = down_nbr.shape
    with torch.no_grad():
        v3 = valid_in.to(features.dtype).reshape(b_, -1, 1).contiguous()
        count = gather_sum(v3, down_nbr, range(k), 0, s_out).reshape(-1, 1)
    out = _GatherSum.apply(features.contiguous(), down_nbr, count.clamp(min=1.0), None,
                           not flat)
    return out if valid_out is None else mask_rows(out, valid_out)


def sparse_avg_unpool(
    features: torch.Tensor,  # [B*S_coarse, C]
    up_parent: torch.Tensor,  # [B, S_fine] frame-local coarse parent (flat [N_fine])
    valid_out: torch.Tensor | None = None,  # [B*S_fine] float mask
    down_nbr: torch.Tensor | None = None,  # [8, B, S_coarse] (flat [8, N_coarse])
) -> torch.Tensor:
    """Kernel-2 stride-2 average unpooling: each fine row reads its parent
    (ME.MinkowskiAvgUnpooling onto the reused finer coords), a 1-tap
    gather_sum; its backward adds up to 8 children into each parent.  In
    bf16 that adjoint adds them in ascending fine row, every add rounded,
    through ``down_nbr``, the same level's k2s2 down map (each coarse row's
    children: the parent map's inverse), which bf16 features need."""
    if up_parent.dim() == 1:
        up_parent = up_parent[None]
    elif up_parent.dim() != 2:
        raise ValueError(f"sparse_avg_unpool: map of shape {tuple(up_parent.shape)}")
    inverse = None
    if features.dtype == BF16:
        if down_nbr is None:
            raise ValueError("sparse_avg_unpool in bfloat16 needs down_nbr, the level's "
                             "k2s2 down map (its adjoint adds each parent's children "
                             "in order)")
        inverse = _down_map("sparse_avg_unpool", down_nbr)
    out = _GatherSum.apply(features.contiguous(), up_parent[None], None, None, True, inverse)
    return out if valid_out is None else mask_rows(out, valid_out)


def _pool_counts(batch: torch.Tensor, num_batch: int) -> torch.Tensor:
    """Rows per sample, the count of ``batch == b`` for b < num_batch: a
    segment sum of ones (``index_add_`` of ones into num_batch + 1 slots
    spends its time on atomics to the same few addresses)."""
    ones = torch.ones(batch.shape[0], 1, device=batch.device)
    return segment_sum(ones, batch, num_batch + 1)[:num_batch, 0]


class _GlobalPool(torch.autograd.Function):
    """sums[b] = sum of the rows with batch == b (b < num_batch; the pad
    segment num_batch is dropped), over max(count, 1) when averaging (the
    counts a second segment_sum).
    Backward: row i gets ct[batch[i]] (/ count) and pad rows 0, a row gather
    from [ct (/ count); 0]."""

    @staticmethod
    def forward(ctx, features, batch, num_batch, average):
        sums = segment_sum(features, batch, num_batch + 1)[:num_batch]
        counts = None
        if average:
            counts = _pool_counts(batch, num_batch).clamp(min=1.0)
            sums = sums / counts[:, None]
        ctx.save_for_backward(batch, counts)
        return sums

    @staticmethod
    def backward(ctx, ct):
        batch, counts = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None, None, None
        if counts is not None:
            ct = ct / counts[:, None]
        table = torch.cat([ct, ct.new_zeros(1, ct.shape[1])])
        df = detect_kernels.gather_rows(table[None], batch[None])[0]
        return df, None, None, None


class _Broadcast(torch.autograd.Function):
    """out[i] = per_sample[min(batch[i], num_batch - 1)], a row gather; its
    backward is the segment sum of ct over those ids, so pad rows' ct lands
    in the last sample, as JAX's adjoint of the clamped take does."""

    @staticmethod
    def forward(ctx, per_sample, batch):
        idx = batch.clamp(max=per_sample.shape[0] - 1)
        out = detect_kernels.gather_rows(per_sample.contiguous()[None], idx[None])[0]
        ctx.save_for_backward(idx)
        ctx.num_batch = per_sample.shape[0]
        return out

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        if not ctx.needs_input_grad[0]:
            return None, None
        return segment_sum(ct.contiguous(), idx, ctx.num_batch), None


def global_pool(
    features: torch.Tensor,  # [N, C]
    batch: torch.Tensor,  # [N] int32 sample ids (pad rows -> num_batch)
    num_batch: int,
    average: bool = True,
) -> torch.Tensor:
    """Per-sample global pooling (ME.MinkowskiGlobalPooling): [num_batch, C]
    sums or means over each sample's rows; the pad segment is dropped."""
    return _GlobalPool.apply(features.contiguous(), batch, num_batch, average)


def broadcast_to_points(
    per_sample: torch.Tensor,  # [num_batch, C]
    batch: torch.Tensor,  # [N] int32
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per-sample values back to the rows (ME.MinkowskiBroadcast*); pad rows
    read the last sample unless ``valid`` masks them."""
    out = _Broadcast.apply(per_sample, batch)
    if valid is not None:
        out = mask_rows(out, valid)
    return out
