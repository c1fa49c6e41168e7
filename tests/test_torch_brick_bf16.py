"""The brick layout in bf16 (``brick_gemm_bf16``, ``brick_wgrad_bf16`` and
the dense brick convs' bf16 rounding) against the JAX package's bf16 mode
on the CPU, the same numpy inputs on both sides:

  - ``brick_conv``, ``brick_down_conv`` and ``brick_up_conv`` in bf16
    against ``jax.vjp`` of JAX's in bf16, at every brick level of a
    pyramid without truncation and of a tight-pad one that truncates, at
    brick:1 and brick:2 (the hybrid boundary included): the forward, dF at
    the valid rows, dW and the bias gradient.  Each output of the port is
    the f64 sum of its bf16 x bf16 products rounded once to bf16 at every
    valid entry (the brick conv's twins round the exact sum; the dense
    products' f32 sums may round the other way where a rounding midpoint
    lies within their error, gamma(n) of the sum of |products|), and equal
    to JAX's but where a midpoint lies within JAX's own f32 sum's error of
    the exact one, and there one bf16 ulp apart (the counts are printed).
    The forward adds the bias in bf16 after that rounding, as JAX does;
    the bias gradient is the f32 sum of the cotangent rounded once (JAX's,
    a bf16 reduction, within 2^-7 of the sum of its rows' magnitudes);
  - both twins against an independent f64 loop over the slot table, and
    the two bound helpers: f32 sums in another order, rounded once, lie
    within them, a sum with one tap left out does not;
  - the up gather's adjoint in bf16 is ``scatter_sum_bf16``'s store form
    (each kept coarse row named once) on both pyramids at brick:1, brick:2
    and all levels, equal to the f32 scatter of the widened cotangent;
  - a narrow Res16UNet on brick:2 in bf16 with JAX's parameters against
    JAX's bf16 net (one jitted program): the valid output within cosine
    0.999 (the whole output's, as ``chip_smoke.py``'s bf16 parity; the
    least row's is printed: one bf16 ulp that a BatchNorm's f32 statistics
    round the other way at level 2 spreads through the three decoder
    levels to rows of small norm, 0.97 on this input), pad rows zero, a
    loss within rel 1e-2, the conv weight gradients bf16 values held in
    f32.

JAX is imported in a fixture, so the card's machine (no JAX) runs the
``cuda`` tests of this file:
    python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_brick_bf16.py
There each kernel's output lies within its bound of the exact sum
(``kernels.brick_gemm_bf16_bound``, ``brick_wgrad_bf16_bound``), the
empty slots hold exact zeros, two launches give the same bits and the
slot order changes no bit, at the stem's Cin = 3, Cin % 8 != 0, the
pretraining widths, k = 5, one brick and a level with no occupied slot."""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.sparse import brick, kernels

BF = torch.bfloat16
F64 = torch.float64
ROOMY = [560, 520, 300, 100, 40, 16]  # tests/test_torch_brick.py's pyramids
TIGHT = [560, 400, 200, 60, 30, 10]  # truncates at every level past 0
OP_RTOL = 2.0 ** -7
COS_MIN = 0.999
LOSS_RTOL = 1e-2
U32 = 2.0 ** -24  # the CPU's f32 adds round to nearest


def _coords(seed=0, n=(200, 150, 170), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _pyramid(kind, bl):
    coords, npads = (_coords(), ROOMY) if kind == "roomy" else (_coords(1), TIGHT)
    pyr, _, _, orphan = brick.build_brick_pyramid(coords, num_levels=5, npads=npads,
                                                  num_batch=3, brick_levels=bl)
    assert orphan.any() or kind == "roomy"
    return pyr


@pytest.fixture(scope="module")
def pyramids():
    return {(kind, bl): _pyramid(kind, bl) for kind in ("roomy", "tight")
            for bl in (1, 2, None)}


@pytest.fixture(scope="module")
def jx():
    """JAX (CPU, "highest" matmul precision) and its brick module."""
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import brick as jbrick

    jax.config.update("jax_default_matmul_precision", "highest")
    return jax, jnp, jbrick


def _bf16(rng, shape, valid=None):
    """numpy f32 values already on the bf16 grid, exact zeros at the rows
    ``valid`` leaves out."""
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(BF).float().numpy()
    return x if valid is None else x * (np.asarray(valid).reshape(-1, 1) > 0)


def _ulp(x):
    """The bf16 ulp at each |x| (f64): 2^(e-8) for |x| in [2^(e-1), 2^e)."""
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


def _near_midpoint(exact, err):
    """Where a bf16 rounding midpoint lies within ``err`` of ``exact``."""
    ulp = _ulp(exact)
    frac = exact.abs() / ulp
    return (frac - frac.floor() - 0.5).abs() * ulp <= err


def _gamma(n):
    return n * U32 / (1 - n * U32)


# --------------------------------------------------------------------------
# the three brick convs against JAX's in bf16

# (op, pyramid, brick levels, level): every brick level of brick:1 and brick:2
OP_CASES = [(op, kind, bl, level) for kind in ("roomy", "tight") for bl in (1, 2)
            for level in range(bl) for op in ("conv", "down", "up")]


def _op_case(op, pyr, level, jnp, jbrick, cin=16):
    """(JAX fn of (f, w, b), the port's, input rows' valid, output rows'
    valid, (Cin, Cout, taps), the products an output, a dF and a dW entry
    sum); ``cin``: the brick conv's input channels."""
    lv, lv1 = pyr.levels[level], pyr.levels[level + 1]
    t = lambda a: None if a is None else torch.from_numpy(np.asarray(a))  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(np.asarray(a))  # noqa: E731
    if op == "conv":
        plan, jplan = brick.build_plan(3), jbrick.build_plan(3)
        nbr, valid = lv.nbr.nbr, lv.valid
        return (lambda f, w, b: jbrick.brick_conv(f, j(nbr), w, jplan, bias=b,
                                                  valid_out=j(valid)),
                lambda f, w, b: brick.brick_conv(f, t(nbr), w, plan, bias=b,
                                                 valid_out=t(valid), order=t(lv.nbr.order)),
                valid, valid, (cin, 16, 27), 27 * cin, 27 * 16, valid.shape[0])
    if op == "down":
        place, vout = lv.down_nbr.place, lv1.valid
        nb = lv.valid.shape[0] // 8
        return (lambda f, w, b: jbrick.brick_down_conv(f, j(place), w, bias=b,
                                                       valid_out=j(vout)),
                lambda f, w, b: brick.brick_down_conv(f, t(place), w, bias=b,
                                                      valid_out=t(vout)),
                lv.valid, vout, (16, 24, 8), 8 * 16, 24, nb)
    upg = lv.up_parent
    nb = lv.valid.shape[0] // 8
    return (lambda f, w, b: jbrick.brick_up_conv(f, j(upg), w, bias=b, valid_out=j(lv.valid)),
            lambda f, w, b: brick.brick_up_conv(f, t(upg), w, bias=b, valid_out=t(lv.valid)),
            lv1.valid, lv.valid, (24, 16, 8), 24, 8 * 16, nb)


def _port_exact(tfn, f, w, ct):
    """The port's op run in f64 (no bias) on the bf16-valued inputs and on
    their magnitudes: (value, dF, dW) and the sums of |products| of each."""
    out = []
    for sign in (lambda a: a, torch.abs):
        f64 = sign(torch.from_numpy(f).to(F64)).requires_grad_()
        w64 = sign(torch.from_numpy(w).to(F64)).requires_grad_()
        y = tfn(f64, w64, None)
        y.backward(sign(torch.from_numpy(ct).to(F64)))
        out.append((y.detach(), f64.grad, w64.grad))
    return out


def _hold(got, want, exact, size, n, rows, what, port_exact, bias=False):
    """bf16 ``got`` (the port's) equal to the exact sum rounded once (or,
    with ``bias``, rounded and then added to it in bf16) at ``rows``, but
    where the port's own f32 sum may round the other way (not for the
    twins: ``port_exact``); and equal to ``want`` (JAX's, f32 numpy) but
    where a midpoint lies within JAX's f32 error of the exact sum, and
    there one bf16 ulp apart (plus the bias's rounding)."""
    edge = _near_midpoint(exact, _gamma(n) * size).numpy()[rows]
    ex = exact.to(BF)
    if bias is not False:
        ex = (ex.float() + bias).to(BF)
    ex = ex.double().numpy()[rows]
    got = got.detach().double().numpy()[rows]
    slack = _ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want[rows])))).numpy()
    if bias is not False:
        slack = slack + _ulp(exact).numpy()[rows]
    if port_exact:
        assert np.array_equal(got, ex), f"{what}: not the exact sum rounded once"
    else:
        off = (got != ex) & ~(edge & (np.abs(got - ex) <= slack))
        assert not off.any(), f"{what}: {off.sum()} off the exact sum rounded once"
    differ = got != want[rows]
    off = differ & ~(edge & (np.abs(got - want[rows]) <= slack))
    print(f"{what}: {differ.sum()} of {differ.size} differ from JAX, {edge.sum()} at a "
          "boundary")
    assert not off.any(), f"{what}: {off.sum()} differ from JAX off a boundary"


@pytest.mark.parametrize("op,kind,bl,level", OP_CASES,
                         ids=[f"{o}-{k}-brick{b}-L{lv}" for o, k, b, lv in OP_CASES])
def test_brick_convs_match_jax_bf16(pyramids, jx, op, kind, bl, level):
    jax, jnp, jbrick = jx
    pyr = pyramids[(kind, bl)]
    stem = kind == "roomy" and bl == 1  # the brick conv at the stem's Cin = 3
    jfn, tfn, vin, vout, (cin, cout, k), n_out, n_df, n_dw = _op_case(
        op, pyr, level, jnp, jbrick, cin=3 if stem else 16)
    rng = np.random.RandomState(len(OP_CASES) * level + 7 * cin + len(op) + len(kind) + bl)
    f = _bf16(rng, (vin.shape[0], cin), vin)
    w = _bf16(rng, (k, cin, cout)) * np.float32(0.25)
    b = _bf16(rng, (cout,))
    ct = _bf16(rng, (vout.shape[0], cout), vout)
    jbf = jnp.bfloat16
    jout, vjp = jax.vjp(jfn, *(jnp.asarray(a, jbf) for a in (f, w, b)))
    jdf, jdw, jdb = vjp(jnp.asarray(ct, jbf))
    assert jout.dtype == jbf and jdf.dtype == jbf and jdw.dtype == jbf
    tf, tw, tb = (torch.from_numpy(a).to(BF).requires_grad_() for a in (f, w, b))
    out = tfn(tf, tw, tb)
    out.backward(torch.from_numpy(ct).to(BF))
    assert out.dtype == BF and tf.grad.dtype == BF and tw.grad.dtype == BF
    assert not out.detach()[torch.from_numpy(vout) == 0].float().any()
    (y, df, dw), (ys, dfs, dws) = _port_exact(tfn, f, w, ct)
    j32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32), np.float64)  # noqa: E731
    twins = op == "conv"  # the kernels' twins sum exactly; the dense products in f32
    ok_in, ok_out = np.asarray(vin) > 0, np.asarray(vout) > 0
    _hold(out, j32(jout), y, ys, n_out, ok_out, f"{op} forward", twins,
          bias=torch.from_numpy(b).double())
    _hold(tf.grad, j32(jdf), df, dfs, n_df, ok_in, f"{op} dF", twins)
    _hold(tw.grad, j32(jdw), dw, dws, n_dw, slice(None), f"{op} dW", twins)
    # the bias gradient, the cotangent's sum over the rows: the port's f32
    # sum rounded once; JAX's a bf16 reduction, held to 2^-7 of the sum of
    # the rows' magnitudes
    ct64 = torch.from_numpy(ct).double()
    db, dbs = ct64.sum(0), ct64.abs().sum(0)
    edge = _near_midpoint(db, _gamma(ct.shape[0]) * dbs)
    assert torch.equal(tb.grad.double()[~edge], db.to(BF).double()[~edge]), f"{op} db"
    assert np.all(np.abs(j32(jdb) - db.numpy()) <= OP_RTOL * dbs.numpy()), f"{op} JAX's db"


# --------------------------------------------------------------------------
# the twins and the bounds


def _level(pyramids, c=(16, 12), k=3, seed=0):
    """Inputs of the brick kernels at level 0 of the tight brick:2 pyramid:
    bf16 features and cotangent (zero at the empty slots), bf16 weights,
    the map, plan steps, valid and order."""
    lv = pyramids[("tight", 2)].levels[0]
    rng = np.random.RandomState(seed)
    taps = brick.build_plan(k).num_taps
    valid = lv.valid
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return dict(x=t(_bf16(rng, (valid.shape[0], c[0]), valid)).to(BF),
                w=t(_bf16(rng, (taps, c[0], c[1]))).to(BF),
                ct=t(_bf16(rng, (valid.shape[0], c[1]), valid)).to(BF),
                nbr=t(np.asarray(lv.nbr.nbr, np.int32)),
                steps=brick.slot_steps(brick.build_plan(k)), valid=t(valid),
                order=t(lv.nbr.order), taps=taps)


def _loop(c):
    """An independent f64 reference from the slot table: (out, dW), every
    (tap, output slot) pair whose output and source slots are occupied."""
    table, centre = kernels.brick_slot_table(c["steps"], c["taps"])
    x, ct = c["x"].double().numpy(), c["ct"].double().numpy()
    w = c["w"].double().numpy()
    nbr, occ = c["nbr"].numpy(), c["valid"].numpy() > 0
    rows = np.arange(x.shape[0])
    out = np.zeros((x.shape[0], w.shape[2]))
    dw = np.zeros(w.shape)
    for t in range(c["taps"]):
        ds = table[t, rows % 8]
        d, b = ds // 8, rows // 8
        src = np.where(d == centre, b, nbr[d, b]) * 8 + ds % 8
        kept = (occ & occ[src])[:, None]
        out += np.where(kept, x[src], 0.0) @ w[t]
        dw[t] = np.where(kept, x[src], 0.0).T @ ct
    return torch.from_numpy(out), torch.from_numpy(dw)


@pytest.mark.parametrize("k", [3, 5])
def test_twins_round_the_f64_loop_once(pyramids, k):
    """brick_gemm_bf16_plain and brick_wgrad_bf16_plain: the f64 loop over
    the slot table rounded once to bf16, exact zeros at the empty slots;
    the wrappers on CPU tensors are their twins and launch nothing."""
    c = _level(pyramids, (3, 16) if k == 5 else (16, 12), k, seed=k)
    out, dw = _loop(c)
    args = (c["nbr"], c["steps"])
    kernels.reset_launches()
    got = kernels.brick_gemm_bf16(c["x"], *args, c["w"], c["valid"], c["order"])
    assert got.dtype == BF and torch.equal(got, out.to(BF))
    assert torch.equal(got, kernels.brick_gemm_bf16_plain(c["x"], *args, c["w"], c["valid"]))
    assert not got[c["valid"] == 0].float().any()
    gw = kernels.brick_wgrad_bf16(c["x"], *args, c["ct"], c["taps"], c["valid"], c["order"])
    assert gw.dtype == BF and torch.equal(gw, dw.to(BF))
    assert kernels.launch_counts()["brick_gemm_bf16"] == 0
    assert kernels.launch_counts()["brick_wgrad_bf16"] == 0


def test_bounds_hold_for_f32_sums_and_catch_a_missing_tap(pyramids):
    """``brick_gemm_bf16_bound`` and ``brick_wgrad_bf16_bound``: the f32
    sums of the products in reverse tap order, rounded once, lie within
    them (``bound_ratio`` <= 1); the same with the last tap left out does
    not."""
    c = _level(pyramids, (32, 24), 3, seed=5)
    args = (c["nbr"], c["steps"])
    taps = c["taps"]
    gemm_bound = kernels.brick_gemm_bf16_bound(c["x"], *args, c["w"], c["valid"])
    wgrad_bound = kernels.brick_wgrad_bf16_bound(c["x"], *args, c["ct"], taps, c["valid"])
    rev = list(range(taps))[::-1]

    def gemm_f32(keep):  # tap by tap in f32, reversed, one rounding
        w = c["w"].float().clone()
        out = torch.zeros(c["x"].shape[0], w.shape[2])
        for t in rev[:keep]:
            one = torch.zeros_like(w)
            one[t] = w[t]
            out += kernels.brick_gemm_plain(c["x"].float(), *args, one, c["valid"])
        return out.to(BF)

    def wgrad_f32(keep):
        dw = kernels.brick_wgrad_plain(c["x"].float(), *args, c["ct"].float(), taps,
                                       c["valid"])
        return torch.cat([dw[:keep], torch.zeros_like(dw[keep:])]).to(BF)

    assert kernels.bound_ratio(gemm_f32(taps), *gemm_bound) <= 1.0
    assert kernels.bound_ratio(wgrad_f32(taps), *wgrad_bound) <= 1.0
    assert kernels.bound_ratio(gemm_f32(taps - 1), *gemm_bound) > 1.0
    assert kernels.bound_ratio(wgrad_f32(taps - 1), *wgrad_bound) > 1.0


@pytest.mark.parametrize("bl", [1, 2, None])
@pytest.mark.parametrize("kind", ["roomy", "tight"])
def test_up_gather_adjoint_is_the_store_form(pyramids, kind, bl):
    """At every brick level whose coarse level is a brick level too, the up
    gather names each kept coarse row (below the pad brick) once, so its
    bf16 adjoint is ``scatter_sum_bf16``'s store form: it passes the form's
    check and equals the f32 scatter of the widened cotangent."""
    lv = pyramids[(kind, bl)].levels
    ups = [(lv[l].up_parent, lv[l + 1].valid.shape[0]) for l in range(len(lv) - 1)
           if isinstance(lv[l].nbr, brick.BrickMap) and lv[l].up_parent is not None]
    assert len(ups) == {1: 0, 2: 1, None: 4}[bl]
    rng = np.random.RandomState(3)
    for upg, s_in in ups:
        upg = np.asarray(upg)
        kept = upg[upg < s_in - 8]  # the coarse pad brick's 8 slots left out
        assert len(np.unique(kept)) == len(kept)
        m = torch.from_numpy(upg.astype(np.int32)).reshape(1, 1, -1)
        ct = torch.from_numpy(_bf16(rng, (1, upg.shape[0], 5))).to(BF)
        got = kernels.scatter_sum_bf16(ct, m, [0], 0, s_in, s_in - 8)
        want = kernels.scatter_sum(ct.float(), m, [0], 0, s_in, s_in - 8)
        assert got.dtype == BF and torch.equal(got.float(), want)


# --------------------------------------------------------------------------
# a narrow Res16UNet on brick:2 in bf16


def test_res16unet_on_brick2_bf16_matches_jax(jx):
    """JAX's bf16 Res16UNet (BasicBlock, 8-16 channels) on a brick:2 batch,
    its f32 params loaded into the port's bf16 net: one train-mode forward
    each, the valid output within cosine 0.999 of JAX's, pad rows 0, a
    loss within rel 1e-2; the port's conv weight gradients bf16 values in
    f32."""
    from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
    from pointcontrast_tpu.data.collate import collate_pair as j_collate
    from pointcontrast_tpu.data.pair_dataset import SyntheticPairDataset
    from pointcontrast_tpu.nn import res16unet as jr16
    from pointcontrast_tpu.nn import resnet_block as jblocks
    from pointcontrast_tpu_torch.data.collate import PadScheme, collate_pair
    from pointcontrast_tpu_torch.nn import layers
    from pointcontrast_tpu_torch.nn import res16unet as tr16
    from pointcontrast_tpu_torch.nn import resnet_block as tblocks
    from pointcontrast_tpu_torch.tools.from_jax import load_jax_params

    jax, jnp, _ = jx
    sample = SyntheticPairDataset(num_pairs=1, points_per_frame=1200, room_size=1.0,
                                  seed=0)[0]
    kw = dict(npos=64, rng=np.random.RandomState(7), layout="brick:2")
    jb = j_collate([sample], JPadScheme(npad0=4096), fuse_frames=True, **kw)
    kw["rng"] = np.random.RandomState(7)
    tb = collate_pair([sample], PadScheme(npad0=4096), **kw).to("cpu")
    sizes = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16, 16, 16, 8, 8), LAYERS=(1,) * 8)
    jm = type("JTiny", (jr16.Res16UNetBase,), dict(BLOCK=jblocks.BasicBlock, **sizes))
    tm = type("TTiny", (tr16.Res16UNetBase,), dict(BLOCK=tblocks.BasicBlock, **sizes))
    jmodel = jm(in_channels=3, out_channels=6, dtype=jnp.bfloat16)
    model = tm(in_channels=3, out_channels=6, dtype=BF)
    variables = jax.jit(lambda r: jmodel.init(r, jb.feats0, jb.pyramid0, train=False))(
        jax.random.PRNGKey(2))
    out_j, _ = jax.jit(lambda v: jmodel.apply(v, jb.feats0, jb.pyramid0, train=True,
                                              mutable=["batch_stats"]))(variables)
    assert out_j.dtype == jnp.bfloat16
    want = np.asarray(jnp.asarray(out_j, jnp.float32))
    load_jax_params(model, jax.device_get(variables["params"]),
                    jax.device_get(variables["batch_stats"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = model.train()(tb.feats0, tb.pyramid0)
    assert out.dtype == BF
    assert sum(isinstance(lv.nbr, brick.BrickMap) for lv in tb.pyramid0.levels) == 2
    valid = tb.pyramid0.levels[0].valid.numpy() > 0
    got = out.detach().float().numpy()
    assert not got[~valid].any() and not want[~valid].any()
    a, b = got[valid].astype(np.float64), want[valid].astype(np.float64)
    cos = float((a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b)))
    na, nb = np.linalg.norm(a, axis=1), np.linalg.norm(b, axis=1)
    live = (na > 0) | (nb > 0)
    rows = (a * b).sum(1)[live] / (na * nb)[live]
    print(f"brick:2 Res16UNet: cosine {cos:.7f}, least row cosine {rows.min():.6f}, "
          f"{(rows < COS_MIN).sum()} of {live.sum()} rows below {COS_MIN}")
    assert cos >= COS_MIN, f"cosine {cos:.7f}"
    labels = np.random.RandomState(9).randint(0, 6, valid.size)[valid]
    logits = want[valid].astype(np.float64)
    logits -= logits.max(1, keepdims=True)
    logp = logits - np.log(np.exp(logits).sum(1, keepdims=True))
    loss_j = float(-logp[np.arange(len(labels)), labels].mean())
    loss = torch.nn.functional.cross_entropy(out.float()[torch.from_numpy(valid)],
                                             torch.from_numpy(labels))
    assert abs(loss.item() - loss_j) <= LOSS_RTOL * abs(loss_j), (loss.item(), loss_j)
    loss.backward()
    convs = [(n, m.weight) for n, m in model.named_modules()
             if isinstance(m, (layers.SparseConv, layers.SparseConvTranspose))]
    assert len(convs) > 10
    for n, w in convs:
        assert w.grad.dtype == torch.float32 and w.grad.abs().sum() > 0, n
        assert torch.equal(w.grad, w.grad.to(BF).float()), n


# --------------------------------------------------------------------------
# on the card: each kernel against its twin, within its bound


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return torch.device("cuda")


def _on_card(c, dev):
    return {n: v.to(dev) if torch.is_tensor(v) else v for n, v in c.items()}


def _hold_card(c):
    """brick_gemm_bf16 (forward, and dF with W[rev]^T) and brick_wgrad_bf16
    on the card: within their bound of the exact sum, exact zeros at the
    empty slots, the same bits from two launches and without the order."""
    plan = brick.build_plan(5 if c["taps"] == 125 else 3)
    rev = list(brick._tap_reversal(plan))
    wrev = c["w"][rev].transpose(1, 2).contiguous()
    args = (c["nbr"], c["steps"])
    kernels.reset_launches()
    for x, w in ((c["x"], c["w"]), (c["ct"], wrev)):
        got = kernels.brick_gemm_bf16(x, *args, w, c["valid"], c["order"])
        torch.cuda.synchronize()
        bound = kernels.brick_gemm_bf16_bound(x, *args, w, c["valid"])
        assert kernels.bound_ratio(got, *bound) <= 1.0
        assert not got[c["valid"] == 0].float().any()
        assert torch.equal(got, kernels.brick_gemm_bf16(x, *args, w, c["valid"], c["order"]))
        assert torch.equal(got, kernels.brick_gemm_bf16(x, *args, w, c["valid"]))
    dw = kernels.brick_wgrad_bf16(c["x"], *args, c["ct"], c["taps"], c["valid"], c["order"])
    torch.cuda.synchronize()
    bound = kernels.brick_wgrad_bf16_bound(c["x"], *args, c["ct"], c["taps"], c["valid"])
    assert dw.dtype == BF and kernels.bound_ratio(dw, *bound) <= 1.0
    again = kernels.brick_wgrad_bf16(c["x"], *args, c["ct"], c["taps"], c["valid"], c["order"])
    assert torch.equal(dw, again), "the same bits from two launches"
    assert kernels.launch_counts()["brick_gemm_bf16"] == 6
    assert kernels.launch_counts()["brick_wgrad_bf16"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("k,cin,cout", [(3, 3, 32), (3, 6, 20), (3, 32, 32), (3, 128, 96),
                                        (3, 96, 128), (3, 256, 256), (5, 3, 32), (5, 6, 5)])
def test_brick_bf16_kernels_within_bound_on_card(pyramids, card, k, cin, cout):
    _hold_card(_on_card(_level(pyramids, (cin, cout), k, seed=cin), card))


@pytest.mark.cuda
def test_brick_bf16_kernels_on_one_brick_and_no_occupied_slot(card):
    """A level whose only occupied brick holds 5 of its 8 slots, and the
    same level with no occupied slot (all zeros out)."""
    cell = np.array([[0, x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)])[:5]
    pyr = brick.build_brick_pyramid(cell.astype(np.int32), num_levels=3, npads=[16, 8, 4, 2],
                                    num_batch=1, brick_levels=1)[0]
    lv = pyr.levels[0]
    rng = np.random.RandomState(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    for empty in (False, True):
        valid = np.zeros_like(lv.valid) if empty else lv.valid
        c = dict(x=t(_bf16(rng, (valid.shape[0], 7), valid)).to(BF),
                 w=t(_bf16(rng, (27, 7, 9))).to(BF),
                 ct=t(_bf16(rng, (valid.shape[0], 9), valid)).to(BF),
                 nbr=t(np.asarray(lv.nbr.nbr, np.int32)),
                 steps=brick.slot_steps(brick.build_plan(3)), valid=t(valid),
                 order=t(brick.slot_order(valid)), taps=27)
        c = _on_card(c, card)
        _hold_card(c)
        if empty:
            args = (c["nbr"], c["steps"])
            assert not kernels.brick_gemm_bf16(c["x"], *args, c["w"], c["valid"]).float().any()
            assert not kernels.brick_wgrad_bf16(c["x"], *args, c["ct"], 27,
                                                c["valid"]).float().any()


def test_bf16_forms_check_their_operands():
    """The bf16 forms take bf16 x, w and ct only, and the f32 forms refuse
    bf16 weights or cotangent (TypeError, no cast), on either device."""
    steps, nbr = brick.slot_steps(brick.build_plan(3)), torch.zeros(27, 2, dtype=torch.int32)
    x, w = torch.zeros(16, 4, dtype=BF), torch.zeros(27, 4, 4, dtype=BF)
    f = torch.Tensor.float
    for call in (lambda: kernels.brick_gemm_bf16(x, nbr, steps, f(w)),
                 lambda: kernels.brick_gemm_bf16(f(x), nbr, steps, w),
                 lambda: kernels.brick_gemm(f(x), nbr, steps, w),
                 lambda: kernels.brick_wgrad_bf16(x, nbr, steps, f(x), 27),
                 lambda: kernels.brick_wgrad_bf16(f(x), nbr, steps, x, 27),
                 lambda: kernels.brick_wgrad(f(x), nbr, steps, x, 27)):
        with pytest.raises(TypeError):
            call()
