"""The port's bf16 mixed precision against the JAX package's, on the CPU:
activations and gathered tables bf16, parameters, norm statistics and
losses f32, every conv product bf16 x bf16 with an f32 sum and one
rounding (``tests/test_mixed_precision.py`` pins JAX's contract).  The
same numpy inputs go to both packages (the fixtures of that file: one
500-point pair, ``PadScheme(npad0=2048)``):

  - K1, K2 and K3 alone, in the chunked and the voxel layout: forward, dF
    and dW at valid rows within 2^-7 max|JAX| (two bf16 ulps at the
    largest magnitude: the two sides round the same f32 sums, added in
    other orders), and the K1 and K2 forwards equal to JAX's at every valid
    row (the voxel ones round each tap's product, as JAX's flat
    ``_conv_core``) but where a rounding lies at a boundary (``_boundary``);
    the voxel K2 and K3 dF equal to their f64 sums rounded once to bf16,
    but at a boundary (the delta the port keeps: JAX's autodiff rounds each
    tap's adjoint there);
  - Res16UNet34C in bf16 with JAX's parameters loaded (params are f32 in
    both modes, so ``tools.from_jax`` carries them as they are): per-row
    cosine >= 0.999 at valid rows, pad rows exactly zero, every parameter
    f32, every module's output bf16, the conv and linear weight gradients
    bf16 values (JAX rounds dW to the bf16 weights' dtype); one NCE loss
    within rel 1e-2 of JAX's; five bf16 SGD steps that descend;
  - ResUNet18INBN in bf16 the same way (the instance norm pools in f32,
    the head's final_fc / final_bn / final run in bf16): per-row cosine,
    pad rows, parameters and every module's output;
  - the sparse-conv VoteNet: bf16 backbone output, f32 seed features,
    finite losses and parameters that move;
  - the semseg and VoteNet CLIs on the shipped YAMLs' ``net.dtype:
    bfloat16`` (synthetic data; MinkUNetHyper14INBN, the BilateralCRF and
    the brick layout too, and a Hyper VoteNet backbone);
  - the flat K4's dF (the CRF filter's conv at 13 and 729 taps) one
    rounding of the f64 sum, as the voxel K2 / K3 dF (the delta kept).
The bf16 pools and K4 against JAX: ``tests/test_torch_bf16_pools.py``."""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.data.collate import collate_pair as j_collate_pair
from pointcontrast_tpu.data.pair_dataset import SyntheticPairDataset
from pointcontrast_tpu.losses.contrastive import point_info_nce_loss as j_nce
from pointcontrast_tpu.nn.registry import load_model as j_load_model
from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
from pointcontrast_tpu_torch.losses.contrastive import point_info_nce_loss
from pointcontrast_tpu_torch.nn import layers
from pointcontrast_tpu_torch.nn.registry import load_model
from pointcontrast_tpu_torch.sparse import kernels, ops
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params
from pointcontrast_tpu_torch.train import PretrainConfig, make_train_step, optim

BF, JBF = torch.bfloat16, jnp.bfloat16
OP_RTOL = 2.0 ** -7
COS_MIN = 0.999
LOSS_RTOL = 1e-2
OUT = 32


def _samples():
    return [SyntheticPairDataset(num_pairs=1, points_per_frame=500, seed=0)[0]]


def _collate(layout):
    """(JAX batch, the port's on the CPU) of the same pair: byte-identical."""
    j = j_collate_pair(_samples(), JPadScheme(npad0=2048), mode="nce", npos=64,
                       rng=np.random.RandomState(0), fuse_frames=True, layout=layout)
    t = collate_pair(_samples(), PadScheme(npad0=2048), npos=64,
                     rng=np.random.RandomState(0), layout=layout).to("cpu")
    return j, t


@pytest.fixture(scope="module")
def batches():
    return _collate("chunked")


@pytest.fixture(scope="module")
def voxel_batches():
    return _collate("voxel")


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _pair(rng, shape, valid=None):
    """The same bf16 values on both sides (numpy f32 rounded by each)."""
    x = rng.randn(*shape).astype(np.float32)
    if valid is not None:
        x *= _np(valid)[:, None]
    return jnp.asarray(x, JBF), torch.from_numpy(x).to(BF)


def _close(got, want, what, rows=None):
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if rows is not None:
        got, want = got[rows], want[rows]
    err = float(np.abs(got - want).max())
    ref = float(np.abs(want).max())
    assert err <= OP_RTOL * ref, f"{what}: {err:.3e} of {ref:.3e}"


# the f32 sums' error on the CPU (each add rounds to nearest: 2^-24
# relative): gamma(n) = n u / (1 - n u) of the sum of |products| over n
# terms, in any order of summation (Higham)
U32 = 2.0 ** -24


def _gamma(n):
    return n * U32 / (1 - n * U32)


def _ulp(x):
    """The bf16 ulp at each |x| (f64): 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


def _near_midpoint(exact, err):
    """Where a bf16 rounding midpoint lies within ``err`` of ``exact`` (f64
    tensors): an f32 sum within ``err`` of ``exact`` may round to either
    neighbour there."""
    ulp = _ulp(exact)
    frac = exact.abs() / ulp
    return (frac - frac.floor() - 0.5).abs() * ulp <= err


def _boundary(f, maps, w, per_tap):
    """[N_out, Cout] bool: the outputs of sum_t f[maps[t]] @ w[t] (f bf16
    [B, S, Cin], maps [T, B, S_out], w [T, Cin, Cout]) where an f32 sum
    may round to the other bf16 neighbour of the exact result: the whole
    sum (one rounding of T Cin products) or, ``per_tap``, the sum of the
    rounded taps, a tap whose own rounding sits at a boundary moving it by
    that tap's ulp."""
    from pointcontrast_tpu_torch.sparse.kernels import take_rows

    f64, w64 = f.double(), w.double()
    taps = [(take_rows(f64, m.long()) @ w64[t], take_rows(f64.abs(), m.long()) @ w64[t].abs())
            for t, m in enumerate(maps)]
    cin = f.shape[-1]
    if not per_tap:
        total, size = sum(t for t, _ in taps), sum(p for _, p in taps)
        hit = _near_midpoint(total, _gamma(len(taps) * cin) * size)
    else:
        rounded = [t.to(BF).double() for t, _ in taps]
        slack = _gamma(len(taps)) * sum(r.abs() for r in rounded)
        for t, p in taps:
            slack = slack + torch.where(_near_midpoint(t, _gamma(cin) * p), _ulp(t), 0.0)
        hit = _near_midpoint(sum(rounded), slack)
    return hit.reshape(-1, hit.shape[-1]).numpy()


def _explained(got, want, edge):
    """Outputs (bf16 values as f32 numpy) that differ, and those of them
    that are not one bf16 ulp apart at a boundary (``_boundary``)."""
    differ = got != want
    gap = np.abs(got.astype(np.float64) - want)
    one_ulp = gap <= _ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want))
                                           .astype(np.float64))).numpy()
    return differ, differ & ~(edge & one_ulp)


def _forward_maps(case, tb):
    """(features' chunk count, the forward's gather maps [T, B, S_out] with
    the centre gathered through its map): K1's nbr, K2's down_nbr."""
    lv = tb.pyramid0.levels[0]
    m = lv.nbr if case.startswith("K1") else lv.down_nbr
    return (m if m.dim() == 3 else m[:, None]), lv


def _op_case(case, tb, rng):
    """(JAX function of (features, weights), the port's, JAX inputs, the
    port's, cotangent pair, valid input rows, valid output rows)."""
    lv, lv1 = tb.pyramid0.levels[0], tb.pyramid0.levels[1]
    j = lambda a: jnp.asarray(_np(a))  # noqa: E731
    op = case.split()[0]
    if op == "K1":
        cin, cout = (3, 32) if "stem" in case else (32, 32)
        rev = tuple(lv.rev)
        f, w = _pair(rng, (lv.valid.shape[0], cin), lv.valid), _pair(rng, (27, cin, cout))
        jf = lambda x, k: jops.sparse_conv(x, j(lv.nbr), k, valid_out=j(lv.valid),  # noqa
                                           rev=rev)
        tf = lambda x, k: ops.sparse_conv(x, lv.nbr, k, valid_out=lv.valid, rev=rev,  # noqa
                                          order=lv.nbr_order)
        vin, vout = lv.valid, lv.valid
    elif op == "K2":
        f, w = _pair(rng, (lv.valid.shape[0], 32), lv.valid), _pair(rng, (8, 32, 64))
        jf = lambda x, k: jops.sparse_conv(x, j(lv.down_nbr), k,  # noqa: E731
                                           valid_out=j(lv1.valid),
                                           up=(j(lv.up_parent), j(lv.up_offset)))
        tf = lambda x, k: ops.sparse_conv(  # noqa: E731
            x, lv.down_nbr, k, valid_out=lv1.valid,
            up=(lv.up_parent, lv.up_offset, lv.up_order), order=lv.down_order)
        vin, vout = lv.valid, lv1.valid
    else:  # K3
        f, w = _pair(rng, (lv1.valid.shape[0], 64), lv1.valid), _pair(rng, (8, 64, 32))
        jf = lambda x, k: jops.sparse_conv_transpose(  # noqa: E731
            x, j(lv.up_parent), j(lv.up_offset), k, valid_out=j(lv.valid))
        tf = lambda x, k: ops.sparse_conv_transpose(  # noqa: E731
            x, lv.up_parent, lv.up_offset, k, valid_out=lv.valid, up_order=lv.up_order)
        vin, vout = lv1.valid, lv.valid
    ct = _pair(rng, (vout.shape[0], w[0].shape[-1]), vout)
    return jf, tf, f, w, ct, _np(vin) > 0, _np(vout) > 0


@pytest.mark.parametrize("case", ["K1 stem", "K1", "K2", "K3", "K1 stem voxel", "K1 voxel",
                                  "K2 voxel", "K3 voxel"])
def test_conv_ops_match_jax_bf16(batches, voxel_batches, case):
    """Forward, dF and dW of each conv op in bf16, at valid rows: the
    port's bf16 kernels' twins against JAX's custom VJPs (the voxel cases:
    JAX's flat ops), and the K1 and K2 forwards equal to JAX's at every
    valid row."""
    _, tb = voxel_batches if case.endswith("voxel") else batches
    jf, tf, (fj, ft), (wj, wt), (ctj, ctt), vin, vout = _op_case(
        case, tb, np.random.RandomState(len(case)))
    out_j, vjp = jax.vjp(jf, fj, wj)
    df_j, dw_j = vjp(ctj)
    ft, wt = ft.requires_grad_(), wt.requires_grad_()
    out_t = tf(ft, wt)
    out_t.backward(ctt)
    assert out_t.dtype == BF and ft.grad.dtype == BF and wt.grad.dtype == BF
    assert out_j.dtype == JBF and df_j.dtype == JBF and dw_j.dtype == JBF
    _close(out_t, out_j, f"{case} forward", vout)
    if case.split()[0] in ("K1", "K2"):
        maps, _ = _forward_maps(case, tb)
        f3 = ft.detach().reshape(maps.shape[1], -1, ft.shape[-1])
        edge = _boundary(f3, maps, wt.detach(), case.endswith("voxel"))[vout]
        differ, odd = _explained(out_t.detach().float().numpy()[vout],
                                 np.asarray(jnp.asarray(out_j, jnp.float32))[vout], edge)
        print(f"{case}: {differ.sum()} of {differ.size} differ, {edge.sum()} at a boundary")
        assert not odd.any(), f"{case}: {odd.sum()} differ off a boundary"
    assert not out_t.detach()[~torch.from_numpy(vout)].float().any()
    _close(ft.grad, df_j, f"{case} dF", vin)
    _close(wt.grad, dw_j, f"{case} dW")


def _k4_flat_dF(case):
    """(the port's dF, the f64 sum rounded once, its boundary, valid rows)
    of the flat K4 on a CRF bilateral map of 13 (hypercross) or 729
    (hypercube: 23 launches of 32 taps) taps over scattered rows."""
    from pointcontrast_tpu_torch.semseg.crf import build_bilateral_map

    region = "hypercube" if case.endswith("729") else "hypercross"
    rng = np.random.RandomState(3)
    coords = np.concatenate([rng.randint(0, 2, (300, 1)), rng.randint(0, 5, (300, 3))],
                            axis=1).astype(np.int32)
    coords = coords[np.sort(np.unique(coords, axis=0, return_index=True)[1])]
    colors = np.zeros((len(coords), 3), np.float32)
    colors[:, 0] = rng.randint(0, 2, len(coords)) * 12.0
    rows = np.sort(rng.choice(639, len(coords), replace=False))
    m = torch.from_numpy(build_bilateral_map(coords, colors, 640, region=region, rows=rows))
    valid = torch.zeros(640)
    valid[rows] = 1.0
    k = m.shape[0]
    _, ft = _pair(rng, (640, 8), valid)
    _, wt = _pair(rng, (k, 8, 8))
    _, ctt = _pair(rng, (640, 8), valid)
    ft, wt = ft.requires_grad_(), wt.requires_grad_()
    ops.sparse_conv(ft, m, wt).backward(ctt)
    f64 = torch.float64
    args = (ctt[None].to(f64), m[:, None], range(k), wt.detach().to(f64), 640, 639)
    exact = kernels.scatter_gemm_plain(*args)[0]
    size = kernels.scatter_gemm_plain(args[0].abs(), *args[1:3], args[3].abs(), 640, 639)[0]
    ones = torch.ones(1, 640, 1, dtype=f64)
    pairs = kernels.scatter_gemm_plain(ones, m[:, None], range(k), ones.new_ones(k, 1, 1), 640,
                                       639)[0]
    edge = _near_midpoint(exact, _gamma(pairs * 8) * size)
    return ft.grad, exact.to(BF), edge.numpy(), valid.numpy() > 0


@pytest.mark.parametrize("case", ["K2 voxel", "K3 voxel", "K4 flat 13", "K4 flat 729"])
def test_voxel_dF_rounds_the_f64_sum_once(voxel_batches, case):
    """The delta the port keeps on purpose: the voxel K2 and K3 dF and the
    flat K4's (the CRF filter's conv, one f32 table over every tap) are the
    f64 sum of their bf16 x bf16 products rounded once to bf16 at every
    valid input row (JAX's autodiff of its flat scans rounds each tap's
    adjoint and adds them in bf16)."""
    if case.startswith("K4"):
        got, want, edge, vin = _k4_flat_dF(case)
        differ, odd = _explained(got[vin].float().numpy(), want[vin].float().numpy(),
                                 edge[vin])
        print(f"{case} dF: {differ.sum()} of {differ.size} differ, {edge[vin].sum()} at a "
              "boundary")
        assert not odd.any(), f"{odd.sum()} differ off a boundary"
        return
    _, tb = voxel_batches
    _, tf, (_, ft), (_, wt), (_, ctt), vin, _ = _op_case(
        case, tb, np.random.RandomState(len(case)))
    ft, wt = ft.requires_grad_(), wt.requires_grad_()
    tf(ft, wt).backward(ctt)
    lv, lv1 = tb.pyramid0.levels[0], tb.pyramid0.levels[1]
    wt_t = wt.detach().transpose(1, 2)
    if case == "K2 voxel":  # dF[i] = ct[parent[i]] W_off[i]^T: one map a offset
        maps = torch.stack([torch.where(lv.up_offset == o, lv.up_parent, lv1.valid.shape[0] - 1)
                            for o in range(8)])[:, None]
        table = ctt
    else:  # dF[c] = sum_k dy[k S_c + c] W_k^T, dy the f32 scatter of ct
        s_c = lv1.valid.shape[0]
        table = kernels.scatter_parent_plain(ctt.float()[None], lv.up_parent[None],
                                             lv.up_offset[None], 8, s_c)[0].to(BF)
        assert torch.equal(table.float(), kernels.scatter_parent_plain(
            ctt.float()[None], lv.up_parent[None], lv.up_offset[None], 8, s_c)[0])
        maps = (torch.arange(s_c)[None] + s_c * torch.arange(8)[:, None])[:, None]
    want = sum(kernels.take_rows(table.double()[None], m.long()) @ wt_t[o].double()
               for o, m in enumerate(maps))[0].to(BF)
    edge = _boundary(table[None], maps, wt_t, False)
    v = torch.from_numpy(vin)
    differ, odd = _explained(ft.grad[v].float().numpy(), want[v].float().numpy(), edge[vin])
    print(f"{case} dF: {differ.sum()} of {differ.size} differ, {edge[vin].sum()} at a "
          "boundary")
    assert not odd.any(), f"{odd.sum()} differ off a boundary"


@pytest.fixture(scope="module")
def jax_run(batches):
    """JAX's bf16 Res16UNet34C: its f32 params and stats, and one jitted
    train-mode forward with the NCE loss on it."""
    jb, _ = batches
    model = j_load_model("Res16UNet34C")(in_channels=3, out_channels=OUT,
                                         normalize_feature=True, dtype=JBF)
    variables = jax.jit(lambda r: model.init(r, jb.feats0, jb.pyramid0, train=False))(
        jax.random.PRNGKey(0))

    def run(variables):
        out, _ = model.apply(variables, jb.feats0, jb.pyramid0, train=True,
                             mutable=["batch_stats"])
        return out, j_nce(out, out, jb.q_idx, jb.k_idx, jb.pair_valid, temperature=0.4)

    out, loss = jax.jit(run)(variables)
    return dict(params=jax.device_get(variables["params"]),
                stats=jax.device_get(variables["batch_stats"]),
                out=np.asarray(jnp.asarray(out, jnp.float32)), loss=float(loss),
                out_dtype=out.dtype)


def _net(dtype=BF):
    return load_model("Res16UNet34C")(in_channels=3, out_channels=OUT,
                                      normalize_feature=True, dtype=dtype)


def _bf16_forward(net, tb, want):
    """The port's bf16 net (JAX's params loaded) on the pair in train
    mode: params f32, every module's output bf16, pad rows exactly 0 on
    both sides, valid rows within cosine 0.999 of JAX's ``want``."""
    assert all(p.dtype == torch.float32 for p in net.parameters())
    seen = {}
    hooks = [m.register_forward_hook(
        lambda m, a, o, name=name: seen.__setitem__(name, o.dtype))
        for name, m in net.named_modules()]
    out = net(tb.feats0, tb.pyramid0)
    for h in hooks:
        h.remove()
    assert seen and all(d == BF for d in seen.values()), \
        {k: d for k, d in seen.items() if d != BF}
    valid = tb.pyramid0.levels[0].valid.numpy() > 0
    got = out.detach().float().numpy()
    assert not got[~valid].any() and not want[~valid].any()
    a, b = got[valid], want[valid]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert cos.min() >= COS_MIN, f"min cosine {cos.min():.6f}"
    return out, seen


def test_res16unet34c_bf16_matches_jax(batches, jax_run):
    """JAX's params in the port's bf16 net: rows within cosine 0.999 of
    JAX's bf16 output, pad rows 0, params f32, every module's output bf16,
    and one NCE loss within rel 1e-2 of JAX's, whose weight gradients are
    bf16 values held in f32."""
    _, tb = batches
    assert jax_run["out_dtype"] == JBF
    net = load_jax_params(_net(), jax_run["params"], jax_run["stats"]).train()
    out, _ = _bf16_forward(net, tb, jax_run["out"])
    loss = point_info_nce_loss(out, out, tb.q_idx, tb.k_idx, tb.pair_valid, 0.4)
    assert loss.dtype == torch.float32
    rel = abs(loss.item() - jax_run["loss"]) / abs(jax_run["loss"])
    assert rel <= LOSS_RTOL, f"loss {loss.item():.6f} vs JAX {jax_run['loss']:.6f}"
    loss.backward()
    weights = [(n, m.weight) for n, m in net.named_modules()
               if isinstance(m, (layers.SparseConv, layers.SparseConvTranspose,
                                 layers.SparseLinear))]
    assert len(weights) > 50
    for name, w in weights:
        assert w.grad.dtype == torch.float32
        assert torch.equal(w.grad, w.grad.to(BF).float()), name


def test_resunet18inbn_bf16_matches_jax(batches):
    """JAX's bf16 ResUNet18INBN, its params in the port's bf16 net: the
    instance norms (f32 pooling, bf16 out), the BatchNorms after them and
    the final_fc / final_bn / final head all give bf16, and the rows agree
    within cosine 0.999."""
    jb, tb = batches
    jmodel = j_load_model("ResUNet18INBN")(in_channels=3, out_channels=OUT, dtype=JBF)
    variables = jax.jit(lambda r: jmodel.init(r, jb.feats0, jb.pyramid0, train=False))(
        jax.random.PRNGKey(1))
    out_j, _ = jax.jit(lambda v: jmodel.apply(v, jb.feats0, jb.pyramid0, train=True,
                                              mutable=["batch_stats"]))(variables)
    assert out_j.dtype == JBF
    net = load_model("ResUNet18INBN")(in_channels=3, out_channels=OUT, dtype=BF)
    net = load_jax_params(net, jax.device_get(variables["params"]),
                          jax.device_get(variables["batch_stats"])).train()
    _, seen = _bf16_forward(net, tb, np.asarray(jnp.asarray(out_j, jnp.float32)))
    assert {"block1_0.norm1.inorm", "final_fc", "final_bn", "final"} <= set(seen)


def test_bf16_train_steps_descend(batches):
    """Five SGD steps of the bf16 net (lr 0.3, as JAX's bf16 step test):
    finite losses, the last below the first; params and grads f32."""
    _, tb = batches
    torch.manual_seed(0)
    model = load_model("Res16UNet34C")(in_channels=3, out_channels=OUT,
                                       normalize_feature=True, dtype=BF,
                                       generator=torch.Generator().manual_seed(0))
    cfg = PretrainConfig(lr=0.3)
    opt = optim.make_optimizer(model, cfg)
    sched = optim.make_scheduler(opt, cfg)
    step = make_train_step(cfg)
    losses = [float(step(model, opt, sched, tb)["loss"]) for _ in range(5)]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters() if p.grad is not None)


def test_votenet_sparseconv_bf16_backbone_trains():
    """The sparse-conv backbone computes in bf16, the heads take its f32
    cast; params stay f32; five steps give finite losses and move them."""
    from pointcontrast_tpu_torch.data import PadScheme as TPadScheme
    from pointcontrast_tpu_torch.detect.datasets import (
        SyntheticDetectionDataset,
        collate_detection,
    )
    from pointcontrast_tpu_torch.detect.train import (
        DetectConfig,
        DetectTrainer,
        batch_to_inputs,
    )
    from pointcontrast_tpu_torch.detect.votenet import VoteNet

    ds = SyntheticDetectionDataset(num_scenes=1, num_objects=3, num_points=1200, seed=0)
    dc = ds.dc
    batch = collate_detection([ds[0]], voxel_size=0.05, scheme=TPadScheme(npad0=2048),
                              layout="chunked").to("cpu")
    model = VoteNet(num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
                    num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
                    num_proposal=32, backbone="sparseconv", dtype=BF,
                    generator=torch.Generator().manual_seed(0))
    trainer = DetectTrainer(model, dc, DetectConfig(learning_rate=1e-4,
                                                    checkpoint_dir="/nonexistent"), "cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    seen = {}
    hook = model.backbone_net.net.register_forward_hook(
        lambda m, a, o: seen.__setitem__("net", o.dtype))
    model.eval()
    with torch.no_grad():
        end_points = model(batch_to_inputs(batch))
    hook.remove()
    assert seen["net"] == BF and end_points["fp2_features"].dtype == torch.float32
    before = [p.detach().clone() for p in model.parameters()]
    losses = [float(trainer._step(model, trainer.opt, batch)["loss"]) for _ in range(5)]
    assert np.all(np.isfinite(losses)), losses
    moved = sum(float((p.detach() - q).abs().sum())
                for p, q in zip(model.parameters(), before))
    assert moved > 0.0


SEMSEG_CLI = ["data.dataset=SyntheticSemsegDataset", "net.model=Res16UNet14A",
              "data.layout=chunked", "data.batch_size=2", "data.npad0=4096",
              "optimizer.max_iter=2", "train.stat_freq=1", "train.val_freq=2",
              "train.save_freq=100", "distributed.num_devices=1"]
VOTENET_CLI = ["data.dataset=synthetic", "data.num_scenes=2", "data.num_points=2000",
               "data.batch_size=2", "net.backbone_model=Res16UNet14A",
               "data.voxel_size=0.05", "data.npad0=2048", "net.num_proposal=16",
               "optimizer.max_epoch=1", "eval.eval_every=1", "distributed.num_devices=1"]


@pytest.mark.parametrize("layout", ["chunked", "voxel"])
def test_semseg_cli_runs_the_shipped_bf16(tmp_path, layout):
    """The semseg CLI on the shipped YAML, ``net.dtype: bfloat16`` as
    written: a bf16 net with f32 params trains, validates and saves."""
    _semseg_cli_trains_in_bf16(tmp_path, [f"data.layout={layout}"])


def test_semseg_cli_runs_resunet18inbn_in_bf16(tmp_path):
    """The ResUNet family, INBN included, through the CLI in bf16."""
    _semseg_cli_trains_in_bf16(tmp_path, ["net.model=ResUNet18INBN"])


def _semseg_cli_trains_in_bf16(tmp_path, overrides):
    from pointcontrast_tpu_torch.apps import semseg as app

    trainer, history = app.main(SEMSEG_CLI + overrides + [f"train.out_dir={tmp_path}"],
                                device="cpu")
    assert getattr(trainer.model, "net", trainer.model).dtype == BF
    assert all(p.dtype == torch.float32 for p in trainer.model.parameters())
    assert [i for i, _ in history] == [1, 2]
    assert all(np.isfinite(m["loss"]) for _, m in history)
    assert 0.0 <= trainer.best_miou <= 100.0
    assert (tmp_path / "weights" / "checkpoint_2.pth").exists()


def test_votenet_cli_runs_the_shipped_bf16(tmp_path):
    """The VoteNet CLI on the shipped YAML (sparse-conv backbone, chunked,
    ``net.dtype: bfloat16``): one epoch, an evaluation, a checkpoint."""
    from pointcontrast_tpu_torch.apps import votenet as app

    trainer = app.main(VOTENET_CLI + [f"misc.out_dir={tmp_path}"], device="cpu")
    assert trainer.epoch == 1 and trainer.model.backbone_net.net.dtype == BF
    assert (tmp_path / "weights" / "checkpoint_1.pth").exists()


@pytest.mark.parametrize("override", [
    ["net.model=MinkUNetHyper14INBN"],
    ["net.wrapper_type=BilateralCRF", "net.wrapper_iterations=2"],
    ["data.layout=brick"],
])
def test_semseg_cli_refuses_bf16_without_kernels(tmp_path, override):
    """MinkUNetHyper, the CRF filter and the brick layout, which the CLI
    refused in bf16 until their kernels had bf16 forms, train two steps in
    the shipped bf16 (the pools', the flat conv's and the brick convs'
    bf16 forms), validate and save."""
    _semseg_cli_trains_in_bf16(tmp_path, override)


def test_votenet_cli_refuses_a_bf16_hyper_backbone(tmp_path):
    """A MinkUNetHyper14INBN backbone in the shipped bf16, which raised
    item 5b before its unpools had bf16 forms: one epoch, an evaluation, a
    checkpoint."""
    from pointcontrast_tpu_torch.apps import votenet as app

    trainer = app.main(VOTENET_CLI + ["net.backbone_model=MinkUNetHyper14INBN",
                                      f"misc.out_dir={tmp_path / 'run'}"], device="cpu")
    net = trainer.model.backbone_net.net
    assert type(net).__name__ == "MinkUNetHyper14INBN" and net.dtype == BF
    assert trainer.epoch == 1 and (tmp_path / "run" / "weights" / "checkpoint_1.pth").exists()


@pytest.mark.parametrize("what", ["k4", "sum pool", "avg unpool", "brick conv",
                                  "resnet", "hyper"])
def test_ops_and_nets_refuse_bf16_without_kernels(batches, what):
    """K4, the k2s2 pools, the brick conv and the nets built on them, which
    raised on bf16 until their kernels had bf16 forms, run them: bf16 out,
    and the nets take ``dtype=bfloat16`` with f32 parameters."""
    _, tb = batches
    lv, lv1 = tb.pyramid0.levels[0], tb.pyramid0.levels[1]
    f = torch.ones(lv.valid.shape[0], 4, dtype=BF) * lv.valid[:, None].to(BF)
    calls = {
        "k4": lambda: ops.sparse_conv(f, lv.nbr, torch.ones(27, 4, 4, dtype=BF)),
        "sum pool": lambda: ops.sparse_sum_pool(f, lv.down_nbr),
        "avg unpool": lambda: ops.sparse_avg_unpool(f[:lv1.valid.shape[0]], lv.up_parent,
                                                    down_nbr=lv.down_nbr),
        # one brick, every neighbour row itself, all 8 slots occupied
        "brick conv": lambda: layers.SparseConv(4, 4, 27).forward(
            f[:8] + 1, _brick_map(), torch.ones(8), order=None),
        "resnet": lambda: load_model("ResNet18")(in_channels=3, out_channels=4, dtype=BF),
        "hyper": lambda: load_model("MinkUNetHyper14INBN")(in_channels=3, out_channels=4,
                                                           dtype=BF),
    }
    got = calls[what]()
    if isinstance(got, torch.nn.Module):
        assert got.dtype == BF and all(p.dtype == torch.float32 for p in got.parameters())
    else:
        assert got.dtype == BF and got.float().any()


def _brick_map():
    from pointcontrast_tpu_torch.sparse.brick import BrickMap, build_plan

    return BrickMap(nbr=torch.zeros(27, 1, dtype=torch.int32), plan=build_plan(3),
                    order=None)


def test_f32_mode_is_unchanged(batches):
    """dtype=None and dtype=float32 give the f32 net of before, bit for
    bit: no cast on the f32 path."""
    _, tb = batches
    a = _net(dtype=None).train()
    b = copy.deepcopy(a)
    b.dtype = torch.float32
    oa, ob = a(tb.feats0, tb.pyramid0), b(tb.feats0, tb.pyramid0)
    assert oa.dtype == torch.float32 and torch.equal(oa, ob)
