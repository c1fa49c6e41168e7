"""Sparse ops on the chunked layout: convolutions, masking, masked moments.

Port of the chunked branches of ``pointcontrast_tpu/sparse/ops.py``.  Each
convolution is a ``torch.autograd.Function`` carrying the JAX op's
hand-derived backward, built from the four kernels in ``sparse.kernels``:

  K1 ``_ConvChunkFused`` (JAX ``_conv_chunk_fused``): same-level conv,
     scatter-free backward through the offset-reversal permutation;
  K2 ``_ConvChunkDown2`` (JAX ``_conv_chunk_down2``): k2s2 down conv whose
     dF is a gather through the functional child -> (parent, offset) map;
  K3 ``_ConvTrChunk`` (JAX ``_conv_tr_chunk``): k2s2 transposed conv, one
     scatter-add of the cotangent into the stacked [8*S_c, Cout] table.

Zero-padding invariant: callers keep features of padded rows at exactly zero
(``mask_rows``) and missing neighbours point at a pad row, so gathered pad
rows contribute exactly zero.  Feature gradients at pad rows are garbage by
design (they differ between forms) and every producer masks them.
"""
from __future__ import annotations

import torch

from pointcontrast_tpu_torch.sparse.kernels import (
    gather_gemm,
    gather_wgrad,
    parent_gemm,
    scatter_parent,
)


def mask_rows(features: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Zero out padded rows. valid: [N] float (1 valid / 0 pad)."""
    return features * valid[:, None].to(features.dtype)


def masked_moments(features: torch.Tensor, valid: torch.Tensor):
    """Mean/variance over valid rows only (padding-aware BatchNorm stats).

    Returns (mean[C], var[C] biased, n scalar tensor)."""
    v = valid.float()[:, None]
    n = v.sum().clamp(min=1.0)
    f = features.float()
    mean = (f * v).sum(dim=0) / n
    var = ((f - mean).square() * v).sum(dim=0) / n
    return mean, var, n


def _center_of(rev) -> int | None:
    """Index of the zero offset: the unique fixed point of ``rev``."""
    if rev is None:
        return None
    for i, r in enumerate(rev):
        if r == i:
            return i
    return None


class _ConvChunkFused(torch.autograd.Function):
    """K1: out[b,s] = F[b,s] W_c + sum_{k != c} F[b, nbr[k,b,s]] W_k.

    Backward (gather only): dF = ct W_c^T + sum_{k != c} ct[nbr[rev[k]]] W_k^T
    and dW_k = sum F^T ct[nbr[rev[k]]]; the centre's map is the identity on
    valid rows and pad features are zero, so dW takes all K taps gathered."""

    @staticmethod
    def forward(ctx, features, nbr, weights, rev):
        k, b_, s = nbr.shape
        center = _center_of(rev)
        taps = [i for i in range(k) if i != center]
        f3 = features.reshape(b_, s, -1)
        wc = None if center is None else weights[center]
        out = gather_gemm(f3, nbr, taps, 0, weights[taps], wc, s)
        ctx.save_for_backward(features, nbr, weights)
        ctx.rev, ctx.center, ctx.taps = rev, center, taps
        return out.reshape(b_ * s, -1)

    @staticmethod
    def backward(ctx, ct):
        features, nbr, weights = ctx.saved_tensors
        rev, center, taps = ctx.rev, ctx.center, ctx.taps
        k, b_, s = nbr.shape
        f3 = features.reshape(b_, s, -1)
        ct3 = ct.contiguous().reshape(b_, s, -1)
        df = dw = None
        if ctx.needs_input_grad[0]:
            wt = weights.transpose(1, 2)
            wtc = None if center is None else wt[center].contiguous()
            df = gather_gemm(ct3, nbr, [rev[i] for i in taps], 0,
                             wt[taps].contiguous(), wtc, s)
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[2]:
            dw = gather_wgrad(f3, None, None, 0, ct3, nbr, rev, 0, k, s)
        return df, None, dw, None


class _ConvChunkDown2(torch.autograd.Function):
    """K2: out[b,s] = sum_{k<8} F[b, down_nbr[k,b,s]] W_k.

    Backward: dF[b,i] = ct[b, up_parent[b,i]] W_{up_offset[b,i]}^T (every
    fine voxel has exactly one (parent, offset), so no scatter) and dW
    re-gathers the im2col rows."""

    @staticmethod
    def forward(ctx, features, down_nbr, up_parent, up_offset, weights):
        k, b_, s_out = down_nbr.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        out = gather_gemm(f3, down_nbr, list(range(k)), 0, weights, None, s_out)
        ctx.save_for_backward(features, down_nbr, up_parent, up_offset, weights)
        return out.reshape(b_ * s_out, -1)

    @staticmethod
    def backward(ctx, ct):
        features, down_nbr, up_parent, up_offset, weights = ctx.saved_tensors
        k, b_, s_out = down_nbr.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        ct3 = ct.contiguous().reshape(b_, s_out, -1)
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = parent_gemm(ct3, up_parent, up_offset,
                             weights.transpose(1, 2).contiguous())
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[4]:
            dw = gather_wgrad(f3, down_nbr, list(range(k)), 0, ct3, None,
                              None, 0, k, s_out)
        return df, None, None, None, dw


class _ConvTrChunk(torch.autograd.Function):
    """K3: out[b,i] = F[b, up_parent[b,i]] W_{up_offset[b,i]}.

    Backward: dy = scatter of ct into the stacked [8*S_c, Cout] table (valid
    (offset, parent) pairs are unique; pad rows alias (0, pad) with zero
    cotangent), then dF = sum_k dy_k W_k^T and dW_k = F^T dy_k."""

    @staticmethod
    def forward(ctx, features, up_parent, up_offset, weights):
        b_, s_f = up_parent.shape
        f3 = features.reshape(b_, features.shape[0] // b_, -1)
        out = parent_gemm(f3, up_parent, up_offset, weights)
        ctx.save_for_backward(features, up_parent, up_offset, weights)
        return out.reshape(b_ * s_f, -1)

    @staticmethod
    def backward(ctx, ct):
        features, up_parent, up_offset, weights = ctx.saved_tensors
        k = weights.shape[0]
        b_, s_f = up_parent.shape
        s_c = features.shape[0] // b_
        f3 = features.reshape(b_, s_c, -1)
        dy = scatter_parent(ct.contiguous().reshape(b_, s_f, -1), up_parent,
                            up_offset, k, s_c)
        df = dw = None
        if ctx.needs_input_grad[0]:
            df = gather_gemm(dy, None, None, s_c,
                             weights.transpose(1, 2).contiguous(), None, s_c)
            df = df.reshape(features.shape)
        if ctx.needs_input_grad[3]:
            dw = gather_wgrad(f3, None, None, 0, dy, None, None, s_c, k, s_c)
        return df, None, None, dw


def sparse_conv(
    features: torch.Tensor,  # [B*S_in, Cin], padded rows zero
    nbr: torch.Tensor,  # [K, B, S_out] frame-local gather map (int32)
    weights: torch.Tensor,  # [K, Cin, Cout]
    bias: torch.Tensor | None = None,  # [Cout]
    valid_out: torch.Tensor | None = None,  # [B*S_out] float mask
    rev: tuple | None = None,  # offset-reversal perm (same-level maps only)
    up: tuple | None = None,  # (up_parent, up_offset) for k2s2 down maps
) -> torch.Tensor:
    """Chunked sparse convolution: a same-level map with ``rev`` runs K1, a
    k2s2 down map with ``up`` runs K2."""
    if nbr.dim() != 3:
        raise ValueError(f"chunked [K, B, S] maps only, got {tuple(nbr.shape)}")
    k, b_, s_out = nbr.shape
    features = features.contiguous()
    if rev is not None and b_ * s_out == features.shape[0] and valid_out is not None:
        out = _ConvChunkFused.apply(features, nbr, weights, tuple(rev))
    elif up is not None:
        out = _ConvChunkDown2.apply(features, nbr, up[0], up[1], weights)
    else:
        raise NotImplementedError(
            "k3s2 down conv (JAX _conv_chunk_down_fused) is not ported yet"
        )
    if bias is not None:
        out = out + bias
    if valid_out is not None:
        out = mask_rows(out, valid_out)
    return out


def sparse_conv_transpose(
    features: torch.Tensor,  # [B*S_coarse, Cin], padded rows zero
    up_parent: torch.Tensor,  # [B, S_fine] frame-local coarse parent
    up_offset: torch.Tensor,  # [B, S_fine] kernel offset id in [0, 8)
    weights: torch.Tensor,  # [8, Cin, Cout]
    bias: torch.Tensor | None = None,
    valid_out: torch.Tensor | None = None,
) -> torch.Tensor:
    """k2s2 transposed conv onto the reused finer level (K3)."""
    if up_parent.dim() != 2:
        raise ValueError("chunked [B, S] parent maps only")
    out = _ConvTrChunk.apply(features.contiguous(), up_parent, up_offset, weights)
    if bias is not None:
        out = out + bias
    if valid_out is not None:
        out = mask_rows(out, valid_out)
    return out
