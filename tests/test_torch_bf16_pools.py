"""The bf16 forms of K4's dF and the k2s2 pools (``scatter_gemm_bf16``,
``gather_sum_bf16``, ``scatter_sum_bf16``) and the nets they open, against
the JAX package's bf16 mode on the CPU, the same numpy inputs on both
sides:

  - the sum pool, the average pool and the unpool, forward and adjoint,
    against ``jax.vjp`` in bf16: bit-equal at every valid row, on chunked
    and flat pyramids with truncation orphans.  XLA's CPU code fixes the
    roundings: the chunked pools' Python ``sum`` rounds every add, the flat
    pools' ``jnp.sum`` adds in f32 and rounds once, and the adjoints
    (bf16 scatter-adds) add each destination's rows in ascending source
    row, rounding every add;
  - the k2s2 down map is the parent map's inverse below the pad rows (the
    unpool's bf16 adjoint reads each parent's children through it), and
    ``scatter_sum_bf16`` refuses a map that breaks its forms' conditions
    (an inverse that misses a source or names one twice, a store map that
    names a destination twice);
  - K4 at 27 taps (the k3s2 map) and 1 tap against JAX's bf16
    ``_conv_chunk_down_fused``: forward, dF and dW equal at every valid row
    but where a bf16 rounding boundary lies within either side's f32 sum
    error (the count is printed); the flat K4 (a CRF bilateral map at 13
    and 729 taps) against JAX's ``_conv_core``: the forward the same way
    (each tap rounded), dW too, and dF within 2^-7 of JAX's largest
    magnitude (the delta the port keeps: one rounding of the f32 sum, where
    JAX's autodiff rounds each tap's adjoint);
  - narrow ResNets of both block types, a narrow MinkUNetHyper14INBN and a
    narrow Res16UNet in a BilateralCRF, bf16 with JAX's parameters: every
    valid row within cosine 0.999 of JAX's bf16 output, pad rows zero, a
    cross-entropy loss within rel 1e-2, parameters f32 and the conv,
    linear and filter weight gradients bf16 values held in f32.

JAX is imported in a fixture, so the card's machine (no JAX) runs the
``cuda`` tests of this file:
    python -m pytest --noconftest -p no:cacheprovider -m cuda
    tests/test_torch_bf16_pools.py
There ``gather_sum_bf16`` and ``scatter_sum_bf16`` must equal their twins
bit for bit (the same bits from two launches), the scatter kernels flag
exactly the maps that break their condition, and ``scatter_gemm_bf16``
lie within ``kernels.scatter_gemm_bf16_bound`` of the exact sum (its
atomics add in another order each run: the spread between two launches is
printed)."""
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds, pyramid_to
from pointcontrast_tpu_torch.semseg.crf import build_bilateral_map
from pointcontrast_tpu_torch.sparse import kernels, ops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse.topology import build_pyramid

BF = torch.bfloat16
NB = 3
TRUNCATING = [660, 300, 120, 45]  # every level past 0 drops coarse voxels
ROOMY = [1800, 1800, 1200, 600]
KINDS = ("chunked", "chunked truncated", "flat", "flat truncated")
OP_RTOL = 2.0 ** -7  # the flat K4 dF against JAX's: two bf16 ulps at the largest
COS_MIN = 0.999
LOSS_RTOL = 1e-2
CLASSES = 5


def _coords(seed=0, n=(220, 150, 180), extent=20):
    rng = np.random.RandomState(seed)
    out = []
    for b, k in enumerate(n):
        flat = rng.choice(extent ** 3, k, replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((k, 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _host_pyramid(kind):
    npads = TRUNCATING if kind.endswith("truncated") else ROOMY
    if kind.startswith("chunked"):
        return build_chunked_pyramid(_coords(), 4, npads, num_batch=NB, build_down3=True)[0]
    return build_pyramid(_coords(), 4, npads=npads, num_batch=NB)[0]


@pytest.fixture(scope="module")
def pyramids():
    return {kind: _host_pyramid(kind) for kind in KINDS}


@pytest.fixture(scope="module")
def jx():
    """JAX (CPU, "highest" matmul precision) and its sparse ops."""
    import jax
    import jax.numpy as jnp

    from pointcontrast_tpu.sparse import ops as jops

    jax.config.update("jax_default_matmul_precision", "highest")
    return jax, jnp, jops


def _wide_randn(rng, shape, valid=None):
    """Values over several binades (so that rounding order shows), exact
    zeros at the pad rows: numpy f32, to be rounded to bf16 by each side."""
    x = (rng.randn(*shape) * np.exp(rng.randn(*shape))).astype(np.float32)
    return x if valid is None else x * (np.asarray(valid).reshape(-1, 1) > 0)


def _bits_equal(got, want, rows):
    """bf16 values (torch, JAX as f32 numpy) equal at ``rows``."""
    return np.array_equal(got.detach().float().numpy()[rows], want[rows])


def _j32(jnp, a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# --------------------------------------------------------------------------
# the maps


@pytest.mark.parametrize("kind", KINDS)
def test_down_nbr_is_the_parent_maps_inverse(pyramids, kind):
    """At every level the k2s2 down map names each fine row whose parent is
    not the coarse pad row at its (offset, parent) slot and no other row
    below the fine pad row, orphans (truncated pyramids) left out; the
    unpool's adjoint (scatter_sum_bf16's inverse form) refuses a map with
    two children of two parents swapped."""
    pyr = pyramids[kind]
    check_pyramid_bounds(pyr)
    orphans = 0
    for lv, lv1 in zip(pyr.levels, pyr.levels[1:]):
        dn, up, off = (np.asarray(a) for a in (lv.down_nbr, lv.up_parent, lv.up_offset))
        if dn.ndim == 2:
            dn, up, off = dn[:, None], up[None], off[None]
        valid = np.asarray(lv.valid).reshape(up.shape) > 0
        s_c, s_f = dn.shape[2], up.shape[1]
        kept = up < s_c - 1
        for b in range(up.shape[0]):
            i = np.nonzero(kept[b])[0]
            assert (dn[off[b, i], b, up[b, i]] == i).all()
        assert int((dn < s_f - 1).sum()) == int(kept.sum())
        assert not (kept & ~valid).any(), "pad fine rows have the pad parent"
        orphans += int((~kept & valid).sum())
    assert (orphans > 0) == kind.endswith("truncated")
    lv, lv1 = pyr.levels[1], pyr.levels[2]
    nb = NB if lv.down_nbr.ndim == 3 else 1
    s_f, s_c = lv.valid.shape[0] // nb, lv1.valid.shape[0] // nb
    bad = np.asarray(lv.down_nbr).reshape(8, nb, s_c).copy()
    live = np.argwhere(bad < s_f - 1)
    a, b = tuple(live[0]), tuple(live[-1])
    assert a[1:] != b[1:], "two parents"
    bad[a], bad[b] = bad[b], bad[a]
    ct = torch.ones(nb, s_f, 2, dtype=BF)
    up = torch.from_numpy(np.asarray(lv.up_parent).reshape(1, nb, s_f).astype(np.int32))
    good = torch.from_numpy(np.asarray(lv.down_nbr).reshape(8, nb, s_c).astype(np.int32))
    kernels.scatter_sum_bf16(ct, up, [0], 0, s_c, s_c - 1, good)
    with pytest.raises(RuntimeError, match="does not name once"):
        kernels.scatter_sum_bf16(ct, up, [0], 0, s_c, s_c - 1,
                                 torch.from_numpy(bad.astype(np.int32)))


# --------------------------------------------------------------------------
# the pools against JAX's bf16 vjp


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
@pytest.mark.parametrize("op", ["sum pool", "avg pool", "avg unpool"])
def test_pools_match_jax_bf16(pyramids, jx, op, kind, level):
    """Forward and adjoint of each pool in bf16, bit for bit at every valid
    row, against ``jax.vjp`` of JAX's pool in bf16: the chunked pools round
    every add of their sum, the flat ones once; the adjoints add each
    destination's rows in ascending source row (the unpool: up to 8
    children a parent), every add rounded."""
    jax, jnp, jops = jx
    lv, lv1 = _host_pyramid(kind).levels[level: level + 2]
    rng = np.random.RandomState(level + 7 * len(op))
    dn, up = np.asarray(lv.down_nbr, np.int32), np.asarray(lv.up_parent, np.int32)
    v0, v1 = np.asarray(lv.valid, np.float32), np.asarray(lv1.valid, np.float32)
    t = torch.from_numpy
    if op == "avg unpool":  # coarse -> fine
        f, ct, vin, vout = _wide_randn(rng, (v1.size, 16), v1), None, v1, v0
        jfn = lambda x: jops.sparse_avg_unpool(x, jnp.asarray(up), v0)  # noqa: E731
        tfn = lambda x: ops.sparse_avg_unpool(x, t(up), t(v0), t(dn))  # noqa: E731
    else:
        f, vin, vout = _wide_randn(rng, (v0.size, 16), v0), v0, v1
        if op == "sum pool":
            jfn = lambda x: jops.sparse_sum_pool(x, jnp.asarray(dn), v1)  # noqa: E731
            tfn = lambda x: ops.sparse_sum_pool(x, t(dn), t(v1))  # noqa: E731
        else:
            jfn = lambda x: jops.sparse_avg_pool(x, jnp.asarray(dn), v0, v1)  # noqa: E731
            tfn = lambda x: ops.sparse_avg_pool(x, t(dn), t(v0), t(v1))  # noqa: E731
    ct = _wide_randn(rng, (vout.size, 16), vout)
    out_j, vjp = jax.vjp(jfn, jnp.asarray(f, jnp.bfloat16))
    (df_j,) = vjp(jnp.asarray(ct, jnp.bfloat16))
    assert out_j.dtype == df_j.dtype == jnp.bfloat16
    x = t(f).to(BF).requires_grad_()
    out = tfn(x)
    out.backward(t(ct).to(BF))
    assert out.dtype == x.grad.dtype == BF
    rows_out, rows_in = vout > 0, vin > 0
    assert _bits_equal(out, _j32(jnp, out_j), rows_out), f"{op} forward"
    assert _bits_equal(x.grad, _j32(jnp, df_j), rows_in), f"{op} adjoint"
    assert not out.detach()[t(~rows_out)].float().any()
    if op == "sum pool":  # the chunked rule is not one rounding of the f32 sum
        once = tfn(t(f).to(BF).float()).detach().to(BF)
        differ = int((once != out.detach())[t(rows_out)].sum())
        print(f"{kind} L{level} sum pool: {differ} outputs differ from one rounding")
        assert (differ > 0) == kind.startswith("chunked")
    if op == "avg unpool":  # nor is the ordered adjoint (a reading: few children at L0)
        xf = t(f).to(BF).float().requires_grad_()
        tfn(xf).backward(t(ct).to(BF).float())
        differ = int((xf.grad.to(BF) != x.grad)[t(rows_in)].sum())
        print(f"{kind} L{level} unpool adjoint: {differ} differ from one rounding")


def test_scatter_sum_bf16_twin_is_the_ordered_scatter():
    """The twin's rank passes equal a scatter-add done one row at a time in
    ascending source row (destinations named up to 8 times, one tap and
    two), and differ from one rounding of the f32 sum.  The wrapper refuses
    such a map without an inverse: its store form would race."""
    rng = np.random.RandomState(4)
    b_, s_g, s_in, c = 2, 300, 40, 6
    g3 = torch.from_numpy(_wide_randn(rng, (b_ * s_g, c)).reshape(b_, s_g, c)).to(BF)
    m = torch.from_numpy(rng.randint(0, s_in, (2, b_, s_g)).astype(np.int32))
    for taps in ([0], [0, 1]):
        got = kernels.scatter_sum_bf16_plain(g3, m, taps, 0, s_in, s_in - 1)
        with pytest.raises(RuntimeError, match="twice"):
            kernels.scatter_sum_bf16(g3, m, taps, 0, s_in, s_in - 1)
        want = torch.zeros(b_, s_in, c, dtype=BF)
        for j in taps:
            part = torch.zeros(b_, s_in, c, dtype=BF)
            for b in range(b_):
                for i in range(s_g):
                    d = int(m[j, b, i])
                    if d < s_in - 1:
                        part[b, d] = part[b, d] + g3[b, i]
            want = want + part
        assert torch.equal(got, want)
        once = kernels.scatter_sum_plain(g3.float(), m, taps, 0, s_in, s_in - 1).to(BF)
        assert not torch.equal(got, once)


FORM_CASES = ("store", "store named twice", "store twice past skip", "inverse",
              "inverse with spares", "inverse missing a source", "inverse naming one twice")
FORM_BREAKS = ("store named twice", "inverse missing a source", "inverse naming one twice")


def _form_case(case):
    """scatter_sum_bf16's arguments for one of FORM_CASES: the store form
    on a two-tap map of distinct kept rows, the inverse form on a parent
    map of up to 4 children a parent and its exact inverse, each changed
    as the case says (FORM_BREAKS break the form's condition)."""
    rng = np.random.RandomState(9)
    b_, s_f, s_c, c = 2, 20, 6, 4
    g3 = torch.from_numpy(_wide_randn(rng, (b_ * s_f, c)).reshape(b_, s_f, c)).to(BF)
    up = np.broadcast_to(np.where(np.arange(s_f) < s_f - 1, np.arange(s_f) % (s_c - 1),
                                  s_c - 1), (b_, s_f)).astype(np.int32)
    inv = np.full((8, b_, s_c), s_f - 1, np.int32)
    for b in range(b_):
        for d in range(s_c - 1):
            kids = np.nonzero(up[b] == d)[0]
            inv[:len(kids), b, d] = kids
    perm = np.stack([rng.permutation(s_f - 1) for _ in range(b_)]).astype(np.int32)
    store = np.full((2, b_, s_c), s_f - 1, np.int32)  # two taps, 5 kept rows each
    store[0, :, :5], store[1, :, :5] = perm[:, :5], perm[:, 5:10]
    if case == "store named twice":
        store[1, 1, 2] = store[0, 1, 4]
    if case == "store twice past skip":
        store[1, 1, 2] = store[0, 1, 4] = s_f - 1
    if case == "inverse with spares":  # each parent's slot 7: another parent's child
        inv[7, :, :s_c - 1] = np.roll(inv[0, :, :s_c - 1], 1, axis=1)
    if case == "inverse missing a source":
        inv[0, 1, 3] = s_f - 1
    if case == "inverse naming one twice":
        inv[7, 1, 3] = inv[0, 1, 3]
    if case.startswith("store"):
        return (g3[:, :s_c].contiguous(), torch.from_numpy(store), [0, 1], 0, s_f, s_f - 1)
    return (g3, torch.from_numpy(up[None].copy()), [0], 0, s_c, s_c - 1, torch.from_numpy(inv))


@pytest.mark.parametrize("case", FORM_CASES)
def test_scatter_sum_bf16_asserts_its_forms_condition(case):
    """Each call of scatter_sum_bf16 asserts the condition its kernel needs
    (on the CPU ``_scatter_sum_bf16_check``; the kernel checks it on the
    card): the store form, that no kept destination is named twice over
    the taps (rows from ``skip_from`` on may repeat); the inverse form,
    that every kept source is named once at its destination (spare entries
    that are not its sources are left out).  A map that meets it gets the
    twin's function."""
    args = _form_case(case)
    if case in FORM_BREAKS:
        with pytest.raises(RuntimeError, match="scatter_sum_bf16: the map"):
            kernels.scatter_sum_bf16(*args)
        return
    assert torch.equal(kernels.scatter_sum_bf16(*args), kernels.scatter_sum_bf16_plain(*args))


# --------------------------------------------------------------------------
# K4 against JAX's bf16 conv


def _ulp(x):
    return torch.ldexp(torch.ones_like(x), torch.frexp(x.abs())[1] - 8)


def _near_midpoint(exact, err):
    ulp = _ulp(exact)
    frac = exact.abs() / ulp
    return (frac - frac.floor() - 0.5).abs() * ulp <= err


def _gamma(n):  # the CPU's f32 adds round to nearest: 2^-24
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _held(got, want, exact, slack, rows, what):
    """bf16 ``got`` (torch) and ``want`` (f32 numpy) equal at ``rows`` but
    where a bf16 rounding midpoint lies within ``slack`` of the ``exact``
    (f64) value, and there one ulp apart; prints the counts."""
    got, want = got.detach().float().numpy()[rows], want[rows]
    edge = _near_midpoint(exact, slack).numpy()[rows]
    differ = got != want
    gap = np.abs(got.astype(np.float64) - want)
    one = gap <= _ulp(torch.from_numpy(np.maximum(np.abs(got), np.abs(want))
                                       .astype(np.float64))).numpy()
    print(f"{what}: {differ.sum()} of {differ.size} differ, {edge.sum()} at a boundary")
    assert not (differ & ~(edge & one)).any(), f"{what}: differs off a boundary"


def _gamma_bf16(n):  # a chain of n bf16 adds, each rounded to nearest: 2^-9
    u = 2.0 ** -9
    return torch.where(n * u < 1, n * u / (1 - n * u), torch.inf)


def _k4_exact(f3, nbr, w, ct3, s_in):
    """The exact (f64) forward, dF and dW of K4 on these bf16 operands, the
    sums of their |products| (``*_size``) and the kept (row, tap) pairs
    each dF row takes: the pad row ``s_in - 1`` left out, as both sides
    do."""
    f64 = torch.float64
    taps = list(range(w.shape[0]))
    f, g, wd = f3.to(f64), ct3.to(f64), w.to(f64)
    s_out = nbr.shape[2]
    r = dict(fwd=kernels.gather_gemm_plain(f, nbr, taps, 0, wd, None, s_out, s_in - 1),
             fwd_size=kernels.gather_gemm_plain(f.abs(), nbr, taps, 0, wd.abs(), None, s_out,
                                                s_in - 1),
             df=kernels.scatter_gemm_plain(g, nbr, taps, wd, s_in, s_in - 1),
             df_size=kernels.scatter_gemm_plain(g.abs(), nbr, taps, wd.abs(), s_in, s_in - 1))
    ones = torch.ones_like(g[..., :1])
    r["pairs"] = kernels.scatter_gemm_plain(ones, nbr, taps, ones.new_ones(len(taps), 1, 1),
                                            s_in, s_in - 1)
    dw, size = [], []
    for j in taps:
        rows = kernels.take_rows(f, nbr[j].long())
        rows = torch.where((nbr[j] != s_in - 1)[..., None], rows, 0.0)
        dw.append(torch.einsum("bsc,bsd->cd", rows, g))
        size.append(torch.einsum("bsc,bsd->cd", rows.abs(), g.abs()))
    r["dw"], r["dw_size"] = torch.stack(dw), torch.stack(size)
    return r


def _k4_pair(jx, case, pyramids):
    """(JAX conv of (features, weights), the port's, the map [K, B, S_out]
    as the kernels take it, S_in, B, valid input rows, valid output rows,
    JAX's map): K4 on the chunked k3s2 map (27 taps) or the k2s2 map's
    centre child (1 tap) at level 1, or on a flat CRF bilateral map of 13
    (hypercross) or 729 (hypercube) taps over scattered rows."""
    _, jnp, jops = jx
    if case.startswith("chunked"):
        lv, lv1 = pyramids["chunked"].levels[1:3]
        m = np.asarray(lv.down_nbr3 if case.endswith("27") else lv.down_nbr[0:1], np.int32)
        order = torch.from_numpy(np.asarray(lv.down3_order if case.endswith("27")
                                            else lv.down_order, np.int32))
        vin, vout = np.asarray(lv.valid) > 0, np.asarray(lv1.valid) > 0
        t_map, b_ = torch.from_numpy(m), NB
    else:
        region = "hypercube" if case.endswith("729") else "hypercross"
        rng = np.random.RandomState(3)
        coords = np.concatenate([rng.randint(0, 2, (300, 1)), rng.randint(0, 5, (300, 3))],
                                axis=1).astype(np.int32)
        _, first = np.unique(coords, axis=0, return_index=True)
        coords = coords[np.sort(first)]
        colors = np.zeros((len(coords), 3), np.float32)
        colors[:, 0] = rng.randint(0, 2, len(coords)) * 12.0
        rows = np.sort(rng.choice(639, len(coords), replace=False))
        m = build_bilateral_map(coords, colors, 640, region=region, rows=rows)
        vin = np.zeros(640, bool)
        vin[rows] = True
        vout, order, b_ = vin, None, 1
        t_map = torch.from_numpy(m)[:, None]

    def jf(x, k):
        return jops.sparse_conv(x, jnp.asarray(m), k)

    def tf(x, k):
        return ops.sparse_conv(x, torch.from_numpy(m), k,
                               order=None if order is None else order.reshape(m.shape[1:]))

    return jf, tf, t_map, vin.size // b_, b_, vin, vout


@pytest.mark.parametrize("case", ["chunked 27", "chunked 1", "flat 13", "flat 729"])
def test_k4_matches_jax_bf16(pyramids, jx, case):
    """Forward, dF and dW of K4 in bf16 at every valid row: JAX's chunked
    ``_conv_chunk_down_fused`` (one rounding of each f32 sum) and its flat
    ``_conv_core`` (each tap rounded before the f32 sum) equal the port's
    but where a rounding boundary lies within either side's f32 error;
    dF on the flat map, which JAX rounds a tap at a time, within 2^-7 of
    its largest magnitude (the delta kept on purpose)."""
    jax, jnp, _ = jx
    jf, tf, t_map, s_in, b_, vin, vout = _k4_pair(jx, case, pyramids)
    rng = np.random.RandomState(len(case))
    k = t_map.shape[0]
    cin, cout = (16, 24) if case.startswith("chunked") else (8, 8)
    f = _wide_randn(rng, (vin.size, cin), vin)
    w = (rng.randn(k, cin, cout) * 0.3).astype(np.float32)
    ct = _wide_randn(rng, (vout.size, cout), vout)
    out_j, vjp = jax.vjp(jf, jnp.asarray(f, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16))
    df_j, dw_j = vjp(jnp.asarray(ct, jnp.bfloat16))
    x = torch.from_numpy(f).to(BF).requires_grad_()
    wt = torch.from_numpy(w).to(BF).requires_grad_()
    out = tf(x, wt)
    out.backward(torch.from_numpy(ct).to(BF))
    assert out.dtype == x.grad.dtype == wt.grad.dtype == BF
    f3 = x.detach().reshape(b_, s_in, cin)
    ct3 = torch.from_numpy(ct).to(BF).reshape(b_, -1, cout)
    e = _k4_exact(f3, t_map, wt.detach(), ct3, s_in)
    fwd, fslack = e["fwd"], _gamma(k * cin) * e["fwd_size"]
    if case.startswith("flat"):  # each tap rounded, then the rounded taps summed
        fwd = fslack = 0
        for j in range(k):
            tap, size = (kernels.gather_gemm_plain(a.double(), t_map, [j], 0, b[j:j + 1].double(),
                                                   None, t_map.shape[2], s_in - 1)
                         for a, b in ((f3, wt.detach()), (f3.abs(), wt.detach().abs())))
            rounded = tap.to(BF).double()
            fwd = fwd + rounded
            fslack = (fslack + _gamma(k) * rounded.abs()
                      + torch.where(_near_midpoint(tap, _gamma(cin) * size), _ulp(tap), 0.0))
    _held(out.reshape(fwd.shape), _j32(jnp, out_j).reshape(fwd.shape),
          fwd, fslack, vout.reshape(fwd.shape[:2]), f"{case} forward")
    _held(wt.grad, _j32(jnp, dw_j), e["dw"], _gamma(t_map.shape[1] * t_map.shape[2])
          * e["dw_size"], slice(None), f"{case} dW")
    df, p = e["df"], e["df_size"]
    df_t, df_j = x.grad.reshape(df.shape), _j32(jnp, df_j).reshape(df.shape)
    dslack = _gamma(e["pairs"] * cout) * p
    if case.startswith("chunked"):
        _held(df_t, df_j, df, dslack, vin.reshape(df.shape[:2]), f"{case} dF")
    else:  # JAX rounds each tap's adjoint and adds the taps in bf16, n a row's
        # taps: within 2^-8 P + gamma_bf16(n) (1 + 2^-8) P of the exact sum
        # (P: the row's sum of |products|); the port rounds once
        bound = ((2.0 ** -8 + (1 + 2.0 ** -8) * _gamma_bf16(e["pairs"])) * p
                 + 2.0 ** -8 * df.abs() + (1 + 2.0 ** -8) * dslack)
        rows = torch.from_numpy(vin.reshape(df.shape[:2]))
        ratio = kernels.bound_ratio(torch.tensor(df_j)[rows], df_t[rows].double(),
                                    bound[rows])
        print(f"{case} dF: the two sides {ratio:.3e} of their derived bound apart")
        assert ratio <= 1.0
    assert not out.detach().float().numpy()[~vout.reshape(-1)].any()


def test_chunked_bf16_k4_past_32_taps_refuses(pyramids):
    """A chunked bf16 K4 of more than MAX_TAPS taps has no form that keeps
    its f32 sum across launches: NotImplementedError, never an f32 run."""
    lv = pyramids["chunked"].levels[1]
    m = torch.from_numpy(np.concatenate([lv.down_nbr3, lv.down_nbr3]).astype(np.int32))
    x = torch.zeros(lv.valid.shape[0], 4, dtype=BF)
    with pytest.raises(NotImplementedError, match="more than 32"):
        ops.sparse_conv(x, m, torch.zeros(54, 4, 4, dtype=BF))


def test_bf16_unpool_needs_the_down_map(pyramids):
    lv = pyramids["chunked"].levels[0]
    x = torch.zeros(pyramids["chunked"].levels[1].valid.shape[0], 4, dtype=BF)
    with pytest.raises(ValueError, match="down_nbr"):
        ops.sparse_avg_unpool(x, torch.from_numpy(lv.up_parent.astype(np.int32)))


# --------------------------------------------------------------------------
# the nets in bf16 against JAX's bf16 nets

CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0, chromatic_sigma=12.0)
NETS = ("resnet basic", "resnet bottleneck", "hyper", "res16unet crf")


@pytest.fixture(scope="module")
def net_inputs():
    """Both packages' inputs of the narrow nets: two 5 cm scenes through a
    6-level chunked pyramid with the k3s2 maps (the ResNets), and two
    through ``collate_semseg`` with the CRF map (the U-Nets); random labels
    at the output rows."""
    from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
    from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate
    from pointcontrast_tpu.sparse.chunk import build_chunked_pyramid as j_build
    from pointcontrast_tpu_torch.data import PadScheme
    from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
    from pointcontrast_tpu_torch.tools.workload import SemsegScenes

    samples = SemsegScenes(scenes=2, points=2500, room=2.4, voxel=0.05).samples
    coords = np.concatenate([np.concatenate([np.full((len(c), 1), b), c], 1)
                             for b, (c, _, _) in enumerate(samples)]).astype(np.int32)
    npads = PadScheme.scannet(4096, 6).npads
    jp = j_build(coords, 6, npads, num_batch=2, build_down3=True)[0]
    tp, _, rows, orphan = build_chunked_pyramid(coords, 6, npads, num_batch=2,
                                                build_down3=True)
    assert not orphan.any()
    feats = np.zeros((tp.levels[0].valid.shape[0], 3), np.float32)
    feats[rows] = np.concatenate([f for _, f, _ in samples]) / 255.0 - 0.5
    semseg = SemsegScenes(scenes=2, points=1500, room=1.2, voxel=0.05,
                          classes=CLASSES).samples
    kw = dict(rng=np.random.RandomState(0), num_chunks=2, layout="chunked", crf=CRF)
    jb = j_collate(semseg, JPadScheme(npad0=4096), **kw)
    tb = collate_semseg(semseg, PadScheme(npad0=4096), **kw).to("cpu")
    return dict(jp=jp, tp=pyramid_to(tp, "cpu"), feats=feats, jb=jb, tb=tb)


def _net_pair(name, jnp, inp):
    """(JAX module, the port's, JAX call args of (train), the port's call
    args, valid output rows)."""
    from pointcontrast_tpu.nn import res16unet as jr16
    from pointcontrast_tpu.nn import resnet as jresnet
    from pointcontrast_tpu.nn import resnet_block as jblocks
    from pointcontrast_tpu.nn import resunet as jres
    from pointcontrast_tpu.semseg import crf as jcrf
    from pointcontrast_tpu_torch.nn import res16unet as tr16
    from pointcontrast_tpu_torch.nn import resnet as tresnet
    from pointcontrast_tpu_torch.nn import resnet_block as tblocks
    from pointcontrast_tpu_torch.nn import resunet as tres
    from pointcontrast_tpu_torch.semseg.crf import BilateralCRF

    jbf = jnp.bfloat16
    if name.startswith("resnet"):
        sizes = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16), LAYERS=(1, 2, 1, 1))
        blk = "BasicBlock" if name.endswith("basic") else "Bottleneck"
        jm = type("JTiny", (jresnet.ResNetBase,), dict(BLOCK=getattr(jblocks, blk), **sizes))
        tm = type("TTiny", (tresnet.ResNetBase,), dict(BLOCK=getattr(tblocks, blk), **sizes))
        feats = inp["feats"]
        return (jm(in_channels=3, out_channels=CLASSES, dtype=jbf),
                tm(in_channels=3, out_channels=CLASSES, dtype=BF),
                lambda train: (feats, inp["jp"], train),
                (torch.from_numpy(feats), inp["tp"]), inp["tp"].levels[5].valid.numpy() > 0)
    jb, tb = inp["jb"], inp["tb"]
    valid = tb.pyramid.levels[0].valid.numpy() > 0
    if name == "hyper":
        sizes = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16, 16, 8, 8))
        jm = type("JTiny", (jres.MinkUNetHyper14INBN,), sizes)
        tm = type("TTiny", (tres.MinkUNetHyper14INBN,), sizes)
        return (jm(in_channels=3, out_channels=CLASSES, dtype=jbf),
                tm(in_channels=3, out_channels=CLASSES, dtype=BF),
                lambda train: (jb.feats, jb.pyramid, train), (tb.feats, tb.pyramid), valid)
    sizes = dict(INIT_DIM=8, PLANES=(8, 16, 16, 16, 16, 16, 8, 8), LAYERS=(1,) * 8)
    jm = type("JTiny", (jr16.Res16UNetBase,), dict(BLOCK=jblocks.BasicBlock, **sizes))
    tm = type("TTiny", (tr16.Res16UNetBase,), dict(BLOCK=tblocks.BasicBlock, **sizes))
    return (jcrf.BilateralCRF(net=jm(in_channels=3, out_channels=CLASSES, dtype=jbf),
                              nchannels=CLASSES, kernel_volume=13, meanfield_iterations=2),
            BilateralCRF(tm(in_channels=3, out_channels=CLASSES, dtype=BF), CLASSES, 13, 2),
            lambda train: (jb.feats, jb.pyramid, jb.crf_nbr, train),
            (tb.feats, tb.pyramid, tb.crf_nbr), valid)


@pytest.mark.parametrize("name", NETS)
def test_bf16_nets_match_jax(jx, net_inputs, name):
    """JAX's bf16 net, its f32 params loaded into the port's bf16 net (as
    the f32 nets load them), one train-mode forward each: the output bf16,
    every valid row within cosine 0.999 of JAX's, pad rows 0, a
    cross-entropy over random labels at the valid rows within rel 1e-2;
    params f32, and the conv, linear and filter weight gradients bf16
    values held in f32 (JAX rounds dW to the bf16 weights)."""
    from pointcontrast_tpu_torch.nn import layers
    from pointcontrast_tpu_torch.tools.from_jax import load_jax_params

    jax, jnp, _ = jx
    jmodel, model, jargs, targs, valid = _net_pair(name, jnp, net_inputs)
    variables = jax.jit(lambda r: jmodel.init(r, *jargs(False)))(jax.random.PRNGKey(2))
    out_j, _ = jax.jit(lambda v: jmodel.apply(v, *jargs(True), mutable=["batch_stats"]))(
        variables)
    assert out_j.dtype == jnp.bfloat16
    want = _j32(jnp, out_j)
    load_jax_params(model, jax.device_get(variables["params"]),
                    jax.device_get(variables["batch_stats"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    out = model.train()(*targs)
    assert out.dtype == BF
    got = out.detach().float().numpy()
    assert not got[~valid].any() and not want[~valid].any()
    a, b = got[valid], want[valid]
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    print(f"{name}: least row cosine {cos.min():.6f} over {valid.sum()} rows")
    assert cos.min() >= COS_MIN, f"min cosine {cos.min():.6f}"
    labels = np.random.RandomState(9).randint(0, CLASSES, valid.size)
    logp = want[valid] - np.log(np.exp(want[valid] - want[valid].max(1, keepdims=True))
                                .sum(1, keepdims=True)) - want[valid].max(1, keepdims=True)
    loss_j = float(-logp[np.arange(valid.sum()), labels[valid]].mean())
    loss = torch.nn.functional.cross_entropy(out.float()[torch.from_numpy(valid)],
                                             torch.from_numpy(labels[valid]))
    assert abs(loss.item() - loss_j) <= LOSS_RTOL * abs(loss_j), (loss.item(), loss_j)
    loss.backward()
    weights = [(n, m.weight) for n, m in model.named_modules()
               if isinstance(m, (layers.SparseConv, layers.SparseConvTranspose,
                                 layers.SparseLinear))]
    if name.endswith("crf"):
        weights.append(("filter", model.filter.weight))
    assert len(weights) > 10
    for n, w in weights:
        assert w.grad.dtype == torch.float32 and w.grad.abs().sum() > 0, n
        assert torch.equal(w.grad, w.grad.to(BF).float()), n


# --------------------------------------------------------------------------
# dtypes, and the card: each bf16 form against its twin


@pytest.mark.parametrize("case", ["gather f32 x3", "scatter f32 g3", "gemm f32 w",
                                  "gemm f32 g3", "inverse of two taps",
                                  "inverse of 9 rows"])
def test_bf16_forms_check_their_operands(case):
    """A bf16 form takes bf16 operands only (TypeError, no cast), and the
    inverse form of scatter_sum_bf16 one mapped tap and at most 8 sources
    a destination (ValueError), on either device."""
    x = torch.zeros(2, 16, 4, dtype=BF)
    m = torch.zeros(2, 2, 16, dtype=torch.int32)
    w = torch.zeros(1, 4, 4, dtype=BF)
    inv = torch.zeros(2, 2, 16, dtype=torch.int32)
    f = torch.Tensor.float
    calls = {
        "gather f32 x3": lambda: kernels.gather_sum_bf16(f(x), m, [0], 0, 16),
        "scatter f32 g3": lambda: kernels.scatter_sum_bf16(f(x), m, [0], 0, 16, -1),
        "gemm f32 w": lambda: kernels.scatter_gemm_bf16(x, m, [0], f(w), 16, -1),
        "gemm f32 g3": lambda: kernels.scatter_gemm_bf16(f(x), m, [0], w, 16, -1),
        "inverse of two taps": lambda: kernels.scatter_sum_bf16(x, m, [0, 1], 0, 16, -1, inv),
        "inverse of 9 rows": lambda: kernels.scatter_sum_bf16(
            x, m, [0], 0, 16, -1, torch.zeros(9, 2, 16, dtype=torch.int32)),
    }
    with pytest.raises(ValueError if case.startswith("inverse") else TypeError):
        calls[case]()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _dev_pyramid(kind, dev):
    return pyramid_to(_host_pyramid(kind), dev)


def _masked_bf16(gen, shape, valid, dev):
    x = torch.randn(shape, device=dev, generator=gen) * torch.exp(
        torch.randn(shape, device=dev, generator=gen))
    return (x * valid.to(dev).reshape(shape[0], shape[1], 1)).to(BF)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 32), (32, 32), (64, 128), (20, 12), (128, 64)])
@pytest.mark.parametrize("case", ["k3s2 27 taps", "1 tap", "flat 13", "flat 40"])
def test_scatter_gemm_bf16_within_bound_on_card(card, case, cin, cout):
    """The tensor-core scatter-GEMM against the exact sum: every output
    within ``scatter_gemm_bf16_bound`` (one rounding of an f32 sum in any
    order), with and without the live order, over the k3s2 and 1-tap maps
    of a chunked pyramid and flat maps past one launch's 32 taps; the
    spread between two launches printed (f32 atomics)."""
    gen = torch.Generator(device=card).manual_seed(cin + cout)
    if case.startswith("flat"):
        lv = _dev_pyramid("flat", card).levels[0]
        k = int(case.split()[1])
        n = lv.valid.shape[0]
        m = torch.cat([lv.nbr] * 2)[:k, None].contiguous()
        order, s_in, b_, valid_out = None, n, 1, lv.valid
    else:
        pyr = _dev_pyramid("chunked", card)
        lv, lv1 = pyr.levels[0], pyr.levels[1]
        m = lv.down_nbr3 if case.startswith("k3s2") else lv.down_nbr[0:1].contiguous()
        order = lv.down3_order if case.startswith("k3s2") else lv.down_order
        s_in, b_, valid_out = lv.valid.shape[0] // NB, NB, lv1.valid
        k = m.shape[0]
    s_out = m.shape[2]
    g3 = _masked_bf16(gen, (b_, s_out, cout), valid_out, card)
    w = (torch.randn(k, cin, cout, device=card, generator=gen) * 0.2).to(BF)
    for o in (order, None):
        args = (g3, m, list(range(k)), w, s_in, s_in - 1, o)
        before = kernels.scatter_gemm_bf16.launches
        got = kernels.scatter_gemm_bf16(*args)
        assert kernels.scatter_gemm_bf16.launches - before == -(-k // kernels.MAX_TAPS)
        assert got.dtype == BF and torch.isfinite(got.float()).all()
        ratio = kernels.bound_ratio(got, *kernels.scatter_gemm_bf16_bound(*args))
        again = kernels.scatter_gemm_bf16(*args)
        spread = float((again.double() - got.double()).abs().max())
        print(f"{case} {cin}->{cout} order={o is not None}: bound_ratio {ratio:.3e}, "
              f"repeat spread {spread:.3e}")
        assert ratio <= 1.0
        assert not got[:, s_in - 1:].float().any()  # the skipped pad row: exact +0


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1, 3, 16, 64, 130])
@pytest.mark.parametrize("kind", ["chunked truncated", "flat truncated"])
def test_gather_and_scatter_sum_bf16_are_exact_on_card(card, kind, c):
    """gather_sum_bf16 (the sum pool's 8 taps, rounding every add or once,
    and the unpool's 1 tap) and scatter_sum_bf16 (the pools' store form and
    the unpool's inverse form) equal their twins bit for bit, twice, at
    widths that take each lane group and the 2-byte path; a table 2 bytes
    off its alignment takes the plain loads."""
    pyr = _dev_pyramid(kind, card)
    flat = kind.startswith("flat")
    nb = 1 if flat else NB
    gen = torch.Generator(device=card).manual_seed(c)
    for lv, lv1 in zip(pyr.levels, pyr.levels[1:]):
        s0, s1 = lv.valid.shape[0] // nb, lv1.valid.shape[0] // nb
        dn = lv.down_nbr[:, None] if flat else lv.down_nbr
        up = lv.up_parent.reshape(1, nb, -1)
        f0, f1 = (_masked_bf16(gen, (nb, s, c), v, card)
                  for s, v in ((s0, lv.valid), (s1, lv1.valid)))
        checks = [(kernels.gather_sum_bf16, (f0, dn, list(range(8)), 0, s1, each))
                  for each in (True, False)]
        checks += [(kernels.gather_sum_bf16, (f1, up, [0], 0, s0)),
                   (kernels.scatter_sum_bf16, (f1, dn, list(range(8)), 0, s0, s0 - 1)),
                   (kernels.scatter_sum_bf16, (f0, up, [0], 0, s1, s1 - 1, dn))]
        raw = torch.empty(f0.numel() + 1, dtype=BF, device=card)
        odd = raw[1:].view(f0.shape)
        odd.copy_(f0)
        checks.append((kernels.gather_sum_bf16, (odd, dn, list(range(8)), 0, s1)))
        for fn, args in checks:
            want = getattr(kernels, fn.__name__ + "_plain")(*args)
            got, again = fn(*args), fn(*args)
            assert got.dtype == BF
            assert torch.equal(got, want) and torch.equal(got, again), fn.__name__


@pytest.mark.cuda
def test_scatter_sum_bf16_kernel_checks_its_forms_condition(card):
    """On the card each form's kernel flags a map that breaks its
    condition (``check[0]``, which the wrapper asserts is 0) and no other,
    and computes the twin's function where the condition holds.  The
    launch is called without the wrapper, whose assert would end the
    process's CUDA context."""
    for case in FORM_CASES:
        args = [a.to(card) if torch.is_tensor(a) else a for a in _form_case(case)]
        g3, m, taps, stride, s_in, skip_from = args[:6]
        inverse = args[6] if len(args) > 6 else None
        check = torch.zeros(1 + (0 if inverse is not None else g3.shape[0] * s_in),
                            dtype=torch.int32, device=card)
        out, _ = kernels._scatter_sum_launch("scatter_sum_bf16", g3, m, taps, stride, s_in,
                                             skip_from, BF, inverse, check)
        assert bool(check[0]) == (case in FORM_BREAKS), case
        if case not in FORM_BREAKS:
            assert torch.equal(out, kernels.scatter_sum_bf16_plain(*args)), case


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 8), (20, 20), (32, 64)])
def test_gather_gemm_bf16_f32_out_on_card(card, cin, cout):
    """The per-tap form's f32 sums (a flat conv past 32 taps adds its
    launches' sums and rounds once): within ``gather_gemm_bf16_bound``
    with ``f32_out`` of the exact sum of the rounded taps."""
    lv = _dev_pyramid("flat", card).levels[0]
    n = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin)
    x = _masked_bf16(gen, (1, n, cin), lv.valid, card)
    w = (torch.randn(27, cin, cout, device=card, generator=gen) * 0.2).to(BF)
    args = (x, lv.nbr[:, None], list(range(27)), 0, w, None, n, n - 1, None, True, True)
    got = kernels.gather_gemm_bf16(*args)
    assert got.dtype == torch.float32
    assert kernels.bound_ratio(got, *kernels.gather_gemm_bf16_bound(*args)) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(8, 8), (32, 32), (32, 128)])
def test_gather_gemm_bf16_f32_out_one_rounding_on_card(card, cin, cout):
    """``f32_out`` without ``round_each_tap`` (a K1 of more than 32 taps,
    chunked or in dF, adds its tap groups' f32 sums and rounds once): the
    first group's off-centre taps with the centre, within
    ``gather_gemm_bf16_bound`` of the exact sum, and rounded to bf16 the
    one-launch output within its own bound."""
    lv = _dev_pyramid("flat", card).levels[0]
    n = lv.valid.shape[0]
    gen = torch.Generator(device=card).manual_seed(cin + cout)
    x = _masked_bf16(gen, (1, n, cin), lv.valid, card)
    w = (torch.randn(27, cin, cout, device=card, generator=gen) * 0.2).to(BF)
    taps = [t for t in range(27) if t != 13]
    args = (x, lv.nbr[:, None], taps, 0, w[taps].contiguous(), w[13], n, n - 1, None,
            False, True)
    got = kernels.gather_gemm_bf16(*args)
    assert got.dtype == torch.float32
    assert kernels.bound_ratio(got, *kernels.gather_gemm_bf16_bound(*args)) <= 1.0
    one = kernels.gather_gemm_bf16(*args[:9])
    assert one.dtype == BF
    assert kernels.bound_ratio(one, *kernels.gather_gemm_bf16_bound(*args[:9])) <= 1.0
