"""K1 (``ops._ConvChunkFused``, the same-level conv) in tap groups.

The kernels take at most ``MAX_TAPS`` = 32 taps a launch, and their
wrappers on the CPU return through the plain twins before that check, so a
K1 of more than 32 off-centre taps passed here and raised on the card.
Since the tap groups (``ops.k1_groups``) the forward, dF and dW of such a
conv run one launch a group.  Here, on the CPU:

  - no kernel entry point that the sparse ops call receives more than
    MAX_TAPS taps in one forward and backward of a 3-D chunked and a voxel
    Res16UNet14 with a k = 5 stem (125 taps) and of STResTesseractUNet14
    (81 taps), in f32 and bf16 (narrow widths; the taps are the nets').
    ``scatter_gemm_bf16`` alone takes every tap of K4's dF: its wrapper
    launches one group of MAX_TAPS after another into one f32 table;
  - a conv of at most MAX_TAPS off-centre taps (the 3-D block convs, the
    hybrid 4-D ones) makes the one call of each form it made before the
    groups: its output and gradients bit-equal to those calls' (f32; bf16
    chunked, and voxel with each tap rounded);
  - past MAX_TAPS the grouped op against JAX's (``_conv_chunk_fused`` on a
    chunked map, ``_conv_sym`` on a flat one): a chunked and a flat
    125-tap map, a flat 81-tap Tesseract map; forward, dF at valid rows
    and dW within 1e-5 of JAX's largest magnitude in f32, 2^-7 in bf16 (the
    two sides round the same f32 sums, associated in another order)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu_torch.data.collate import PadScheme
from pointcontrast_tpu_torch.nn.registry import MODELS
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.sparse import kernels, ops
from pointcontrast_tpu_torch.sparse.kernels import MAX_TAPS
from pointcontrast_tpu_torch.tools import workload as W

BF = torch.bfloat16
F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7
# each entry point's taps from its arguments (positional, as the ops pass them)
TAPS = {
    "gather_gemm": lambda a, kw: a[4].shape[0],
    "gather_gemm_bf16": lambda a, kw: a[4].shape[0],
    "gather_wgrad": lambda a, kw: a[8],
    "gather_wgrad_bf16": lambda a, kw: a[8],
    "parent_gemm": lambda a, kw: a[3].shape[0],
    "parent_gemm_bf16": lambda a, kw: a[3].shape[0],
    "scatter_gemm": lambda a, kw: len(a[2]),
    "gather_sum": lambda a, kw: len(a[2]),
    "gather_sum_bf16": lambda a, kw: len(a[2]),
    "scatter_sum": lambda a, kw: len(a[2]),
    "scatter_sum_bf16": lambda a, kw: len(a[2]),
}


@pytest.fixture
def calls(monkeypatch):
    """{entry point: [taps of each call]} of the sparse ops' kernel calls
    while the test runs."""
    seen = {name: [] for name in TAPS}

    def wrap(name, fn):
        def call(*args, **kwargs):
            seen[name].append(int(TAPS[name](args, kwargs)))
            return fn(*args, **kwargs)
        return call

    for name in TAPS:
        monkeypatch.setattr(ops, name, wrap(name, getattr(ops, name)))
    return seen


def _narrow(name, **planes):
    return type(f"Narrow{name}", (MODELS[name],), planes)


NARROW_16 = dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 16, 8, 8))
NARROW_MINK = dict(INIT_DIM=8, PLANES=(8, 8, 16, 16, 16, 8, 8))


@functools.cache
def _batch(case):
    if case.startswith("STResTesseractUNet14"):
        scenes = W.SemsegScenes(scenes=2, points=120, room=1.0, voxel=0.05)
        return W.st_semseg_batch(scenes, npad0=1024, pad_ratios=(1.0, 0.8, 0.6, 0.4),
                                 model="STResTesseractUNet14").to("cpu")
    scenes = W.SemsegScenes(scenes=2, points=400, room=1.0, voxel=0.05)
    return collate_semseg(list(scenes.samples), PadScheme(npad0=1024), conv0_kernel_size=5,
                          rng=np.random.RandomState(0), num_chunks=2,
                          layout=case.split()[0]).to("cpu")


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["chunked k5", "voxel k5", "STResTesseractUNet14"])
def test_no_kernel_call_takes_more_than_max_taps(calls, case, dtype):
    batch = _batch(case)
    if case.startswith("ST"):
        net = _narrow("STResTesseractUNet14", **NARROW_MINK)(3, 6, dtype=dtype)
    else:
        net = _narrow("Res16UNet14", **NARROW_16)(3, 6, conv1_kernel_size=5, dtype=dtype)
    widest = max(p.shape[0] for p in net.parameters() if p.dim() == 3)
    assert widest == (81 if case.startswith("ST") else 125)
    x = batch.feats.clone().requires_grad_()
    out = net.train()(x, batch.pyramid)
    gen = torch.Generator().manual_seed(0)
    out.backward(torch.randn(out.shape, generator=gen).to(out.dtype))
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in net.parameters())
    most = {name: max(t) for name, t in calls.items() if t}
    assert max(most.values()) <= MAX_TAPS, most
    sfx = "_bf16" if dtype == BF else ""
    assert calls[f"gather_gemm{sfx}"] and calls[f"gather_wgrad{sfx}"]
    # the wide convs ran in groups: full groups of MAX_TAPS among the calls
    assert MAX_TAPS in calls[f"gather_gemm{sfx}"] and MAX_TAPS in calls[f"gather_wgrad{sfx}"]


@functools.cache
def _maps(kind):
    """(nbr [K, B, S] int32, rev, valid [B*S], live order [B, S], flat) of a
    K1 map: the 3-D block map of a chunked or voxel pyramid (27 taps), the
    hybrid 4-D block map (29), the 3-D k = 5 stem map (125, chunked or
    voxel), the Tesseract block map (81)."""
    if kind.startswith("hybrid") or kind.startswith("tesseract"):
        model = "STResTesseractUNet14" if kind.startswith("tesseract") else "STRes16UNet14"
        scenes = W.SemsegScenes(scenes=2, points=120, room=1.0, voxel=0.05)
        pyr = W.st_semseg_batch(scenes, npad0=1024, pad_ratios=(1.0, 0.8, 0.6, 0.4, 0.2),
                                model=model).to("cpu").pyramid
        lv = pyr.levels[0]
        return lv.nbr[:, None], lv.rev, lv.valid, lv.nbr_order[None], True
    layout = kind.split()[0]
    scenes = W.SemsegScenes(scenes=2, points=400, room=1.0, voxel=0.05)
    pyr = collate_semseg(list(scenes.samples), PadScheme(npad0=1024), conv0_kernel_size=5,
                         rng=np.random.RandomState(0), num_chunks=2,
                         layout=layout).to("cpu").pyramid
    lv = pyr.levels[0]
    stem = kind.endswith("stem")
    nbr, rev, order = ((lv.nbr0, lv.rev0, lv.nbr0_order) if stem
                       else (lv.nbr, lv.rev, lv.nbr_order))
    if layout == "voxel":
        return nbr[:, None], rev, lv.valid, order[None], True
    return nbr, rev, lv.valid, order, False


def _inputs(nbr, valid, dtype, seed, cin=4, cout=6):
    rng = np.random.RandomState(seed)
    n = valid.shape[0]
    f = torch.from_numpy(rng.randn(n, cin).astype(np.float32)) * valid[:, None]
    w = torch.from_numpy((0.3 * rng.randn(nbr.shape[0], cin, cout)).astype(np.float32))
    ct = torch.from_numpy(rng.randn(n, cout).astype(np.float32)) * valid[:, None]
    return f.to(dtype), w.to(dtype), ct.to(dtype)


def _port(nbr, rev, valid, order, flat, f, w, ct):
    """(out, dF, dW) of the port's K1 (sparse_conv with rev and valid_out)."""
    f, w = f.clone().requires_grad_(), w.clone().requires_grad_()
    m, o = (nbr[:, 0], order[0]) if flat else (nbr, order)
    out = ops.sparse_conv(f, m, w, valid_out=valid, rev=rev, order=o)
    out.backward(ct)
    return out.detach(), f.grad, w.grad


def _ungrouped(nbr, rev, valid, order, flat, f, w, ct):
    """(out, dF, dW) as the one call of each form K1 made before the tap
    groups, through the twins, the output masked as ``sparse_conv`` masks
    it."""
    k, b_, s = nbr.shape
    center = ops._center_of(rev)
    taps = [i for i in range(k) if i != center]
    bf16 = f.dtype == BF
    gemm = kernels.gather_gemm_bf16 if bf16 else kernels.gather_gemm
    wgrad = kernels.gather_wgrad_bf16 if bf16 else kernels.gather_wgrad
    f3, ct3 = f.reshape(b_, s, -1), ct.reshape(b_, s, -1)
    if bf16 and flat:
        out = gemm(f3, nbr, list(range(k)), 0, w, None, s, s - 1, order,
                   round_each_tap=True)
    else:
        out = gemm(f3, nbr, taps, 0, w[taps], w[center], s, s - 1, order)
    out = ops.mask_rows(out.reshape(b_ * s, -1), valid)
    wt = w.transpose(1, 2)
    df = gemm(ct3, nbr, [rev[i] for i in taps], 0, wt[taps].contiguous(),
              wt[center].contiguous(), s, s - 1, order).reshape(f.shape)
    dw = wgrad(f3, None, None, 0, ct3, nbr, rev, 0, k, s, skip_g=s - 1).to(w.dtype)
    return out, df, dw


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["chunked", "voxel", "hybrid"])
def test_one_group_is_the_ungrouped_call(calls, kind, dtype):
    maps = _maps(kind)
    assert maps[0].shape[0] == (29 if kind == "hybrid" else 27)
    f, w, ct = _inputs(maps[0], maps[2], dtype, seed=len(kind))
    got = _port(*maps, f, w, ct)
    sfx = "_bf16" if dtype == BF else ""
    assert len(calls[f"gather_gemm{sfx}"]) == 2 and len(calls[f"gather_wgrad{sfx}"]) == 1
    want = _ungrouped(*maps, f, w, ct)
    for what, a, b in zip(("out", "dF", "dW"), got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b), what


def _jax(nbr, rev, valid, flat, f, w, ct):
    """(out, dF, dW) of ``jax.vjp`` of JAX's sparse_conv (K1: rev and
    valid_out), jitted, f32 numpy."""
    def j(t):
        if t.is_floating_point():
            return jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == BF else None)
        return jnp.asarray(t.numpy())

    def run(x, k, ct, m, valid):
        out, vjp = jax.vjp(lambda x, k: jops.sparse_conv(x, m, k, valid_out=valid,
                                                         rev=tuple(rev)), x, k)
        return (out, *vjp(ct))

    with jax.default_matmul_precision("highest"):
        res = jax.jit(run)(j(f), j(w), j(ct), j(nbr[:, 0] if flat else nbr), j(valid))
    return tuple(np.asarray(jnp.asarray(a, jnp.float32)) for a in res)


@pytest.mark.parametrize("dtype", [torch.float32, BF], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["chunked stem", "voxel stem", "tesseract"])
def test_grouped_k1_matches_jax(calls, kind, dtype):
    nbr, rev, valid, order, flat = _maps(kind)
    k = nbr.shape[0]
    assert k == (81 if kind == "tesseract" else 125)
    f, w, ct = _inputs(nbr, valid, dtype, seed=k)
    got = _port(nbr, rev, valid, order, flat, f, w, ct)
    sfx = "_bf16" if dtype == BF else ""
    per_tap = dtype == BF and flat  # the voxel bf16 forward: every tap, each rounded
    fwd, df, dw = ops.k1_groups(k, rev, per_tap)
    assert sum(map(len, fwd)) == k - (not per_tap) and sum(map(len, dw)) == k
    assert calls[f"gather_gemm{sfx}"] == [len(g) for g in fwd + df]
    assert calls[f"gather_wgrad{sfx}"] == [len(g) for g in dw]
    assert max(calls[f"gather_gemm{sfx}"] + calls[f"gather_wgrad{sfx}"]) == MAX_TAPS
    want = _jax(nbr, rev, valid, flat, f, w, ct)
    rtol = BF16_RTOL if dtype == BF else F32_RTOL
    rows = valid.numpy() > 0
    for what, a, b, sel in zip(("out", "dF", "dW"), got, want, (rows, rows, None)):
        a = a.float().numpy()
        if sel is not None:
            a, b = a[sel], b[sel]
        err, ref = float(np.abs(a - b).max()), float(np.abs(b).max())
        assert ref > 0 and err <= rtol * ref, f"{kind} {what}: {err:.3e} of {ref:.3e}"
    assert not got[0][~torch.from_numpy(rows)].float().any()
