"""The port's K5 pooling ops, K4 k3s2 down conv and ``down_nbr3`` maps
against the JAX package, on the CPU, and ``gather_sum``'s plain twin
against the Pallas gather probes' own reference.

Inputs are made with numpy from seeds and go through both packages, f32.
Tolerances: pooling values and gradients 1e-6 (sums of at most 8 rows; the
unpooling adjoint adds up to 8 children per parent in another order); K4
1e-5 (rows of up to 27 products summed in other orders); the probes 1e-6
(the same additions in the same order).  Only valid rows are compared:
pad-row gradients are garbage by design, and the port leaves the pad row
out of the pooling and K4 scatters."""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu.sparse.chunk import build_chunked_pyramid as j_build
from pointcontrast_tpu_torch.data.collate import check_pyramid_bounds, pyramid_to
from pointcontrast_tpu_torch.sparse import kernels, ops
from pointcontrast_tpu_torch.sparse.chunk import build_chunked_pyramid

NB = 3
NPADS = [1500, 1200, 600, 300, 150, 60]
EXPERIMENTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                           "experiments")


def _coords(seed=0, n=(400, 260, 330), extent=30):
    rng = np.random.RandomState(seed)
    out = []
    for b in range(NB):
        flat = rng.choice(extent ** 3, n[b], replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((n[b], 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyramids():
    c = _coords()
    jp = j_build(c, 6, NPADS, num_batch=NB, build_down3=True)[0]
    tp = build_chunked_pyramid(c, 6, NPADS, num_batch=NB, build_down3=True)[0]
    return jp, tp


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int(valid.sum()), c)
    return f


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _i(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def test_down_nbr3_maps_are_byte_identical(pyramids):
    jp, tp = pyramids
    for l in range(5):
        a, b = np.asarray(jp.levels[l].down_nbr3), tp.levels[l].down_nbr3
        assert a.dtype == b.dtype and a.shape == b.shape == (27, NB, NPADS[l + 1] // NB)
        assert a.tobytes() == b.tobytes(), l
    assert tp.levels[5].down_nbr3 is None
    # the bridge checks them per chunk and widens them to int32
    check_pyramid_bounds(tp)
    dev = pyramid_to(tp, "cpu")
    assert dev.levels[1].down_nbr3.dtype == torch.int32
    bad = tp.levels[2].down_nbr3.copy()
    bad[3, 1, 0] = NPADS[2] // NB
    tp.levels[2].down_nbr3, keep = bad, tp.levels[2].down_nbr3
    try:
        with pytest.raises(ValueError, match="down_nbr3"):
            check_pyramid_bounds(tp)
    finally:
        tp.levels[2].down_nbr3 = keep


def _grad_jax(fn, f, ct):
    out, vjp = jax.vjp(fn, jnp.asarray(f))
    return np.asarray(out), np.asarray(vjp(jnp.asarray(ct))[0])


def _grad_torch(fn, f, ct):
    x = _t(f).requires_grad_(True)
    out = fn(x)
    out.backward(_t(ct))
    return out.detach().numpy(), x.grad.numpy()


@pytest.mark.parametrize("op", ["sum_pool", "avg_pool", "avg_unpool"])
@pytest.mark.parametrize("level", [0, 2])
def test_pooling_matches_jax(pyramids, op, level):
    jp, tp = pyramids
    rng = np.random.RandomState(level)
    src, dst = tp.levels[level], tp.levels[level + 1]
    jsrc, jdst = jp.levels[level], jp.levels[level + 1]
    if op == "avg_unpool":  # coarse -> fine
        f = _feats(rng, dst.valid, 6)
        ct = _feats(rng, src.valid, 6)
        jfn = lambda x: jops.sparse_avg_unpool(  # noqa: E731
            x, jnp.asarray(np.asarray(jsrc.up_parent, np.int32)), jsrc.valid)
        tfn = lambda x: ops.sparse_avg_unpool(  # noqa: E731
            x, _i(src.up_parent), _t(src.valid))
        vin, vout = dst.valid, src.valid
    else:
        f = _feats(rng, src.valid, 6)
        ct = _feats(rng, dst.valid, 6)
        jmap = jnp.asarray(np.asarray(jsrc.down_nbr, np.int32))
        if op == "sum_pool":
            jfn = lambda x: jops.sparse_sum_pool(x, jmap, jdst.valid)  # noqa: E731
            tfn = lambda x: ops.sparse_sum_pool(  # noqa: E731
                x, _i(src.down_nbr), _t(dst.valid))
        else:
            jfn = lambda x: jops.sparse_avg_pool(  # noqa: E731
                x, jmap, jsrc.valid, jdst.valid)
            tfn = lambda x: ops.sparse_avg_pool(  # noqa: E731
                x, _i(src.down_nbr), _t(src.valid), _t(dst.valid))
        vin, vout = src.valid, dst.valid
    jout, jgrad = _grad_jax(jfn, f, ct)
    tout, tgrad = _grad_torch(tfn, f, ct)
    vin, vout = vin > 0, vout > 0
    np.testing.assert_allclose(tout[vout], jout[vout], rtol=1e-6, atol=1e-6)
    assert not tout[~vout].any()
    np.testing.assert_allclose(tgrad[vin], jgrad[vin], rtol=1e-6, atol=1e-6)


def test_avg_pool_divides_by_the_children_present(pyramids):
    _, tp = pyramids
    src, dst = tp.levels[1], tp.levels[2]
    ones = _t(np.repeat(src.valid[:, None], 2, axis=1))
    got = ops.sparse_avg_pool(ones, _i(src.down_nbr), _t(src.valid), _t(dst.valid))
    np.testing.assert_array_equal(got.numpy()[:, 0], dst.valid)
    sums = ops.sparse_sum_pool(ones, _i(src.down_nbr)).numpy()[:, 0]
    assert sums[dst.valid > 0].max() > 1  # some coarse rows have many children


@pytest.mark.parametrize("taps", [27, 1])
@pytest.mark.parametrize("level", [0, 2])
def test_k4_down_conv_matches_jax(pyramids, taps, level):
    """K4 on the k3s2 map (27 taps) and the 1-tap downsample map
    ``down_nbr[0:1]``: forward, dF and dW against JAX's
    ``_conv_chunk_down_fused``."""
    jax.config.update("jax_default_matmul_precision", "highest")
    jp, tp = pyramids
    rng = np.random.RandomState(10 + level)
    src, dst = tp.levels[level], tp.levels[level + 1]
    m = src.down_nbr3 if taps == 27 else src.down_nbr[0:1]
    cin, cout = 5, 7
    f = _feats(rng, src.valid, cin)
    ct = _feats(rng, dst.valid, cout)
    w = (rng.randn(taps, cin, cout) / np.sqrt(taps * cin)).astype(np.float32)
    jmap = jnp.asarray(np.asarray(m, np.int32))

    def jfn(x, wt):
        return jops._conv_chunk_down_fused(x, jmap, wt, jops._fused_group())

    jout, vjp = jax.vjp(jfn, jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = (np.asarray(a) for a in vjp(jnp.asarray(ct)))
    x, wt = _t(f).requires_grad_(True), _t(w).requires_grad_(True)
    out = ops.sparse_conv(x, _i(m), wt)
    out.backward(_t(ct))
    vin, vout = src.valid > 0, dst.valid > 0
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy()[vout], np.asarray(jout)[vout], **tol)
    np.testing.assert_allclose(x.grad.numpy()[vin], jdf[vin], **tol)
    np.testing.assert_allclose(wt.grad.numpy(), jdw, **tol)


def test_k4_same_level_map_without_rev_equals_k1(pyramids):
    """A same-level map passed without ``rev`` (a BasicBlock-shaped strided
    block's second conv, as JAX passes it) runs K4: the same function and
    gradients as K1's scatter-free form."""
    _, tp = pyramids
    lv = tp.levels[1]
    rng = np.random.RandomState(3)
    f = _feats(rng, lv.valid, 4)
    ct = _feats(rng, lv.valid, 6)
    w = rng.randn(27, 4, 6).astype(np.float32)
    grads = []
    for rev in (None, lv.rev):
        x, wt = _t(f).requires_grad_(True), _t(w).requires_grad_(True)
        out = ops.sparse_conv(x, _i(lv.nbr), wt, valid_out=_t(lv.valid), rev=rev)
        out.backward(_t(ct))
        grads.append((out.detach().numpy(), x.grad.numpy(), wt.grad.numpy()))
    v = lv.valid > 0
    for a, b in zip(*grads):
        np.testing.assert_allclose(a[v] if a.ndim == 2 else a,
                                   b[v] if b.ndim == 2 else b, rtol=1e-5, atol=1e-5)


def _probe(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXPERIMENTS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["pallas_gather_probe", "pallas_gather_probe2",
                                  "pallas_gather_probe3", "pallas_gather_probe4"])
def test_gather_sum_is_the_pallas_probes_function(name):
    """Each probe's table and index, at its module constants and from its
    own seed, through ``gather_sum_plain`` as a [1, N, C] table and a
    [K, 1, M] map, against the probe's reference (``table[idx]`` or
    ``table[nbr].sum(0)``) and its XLA form (``make_xla_take`` /
    ``make_xla_scan``), which runs on the CPU."""
    probe = _probe(name)
    rng = np.random.RandomState(0)
    n, c = probe.N, probe.C
    table = rng.randn(n, c).astype(np.float32)
    if name == "pallas_gather_probe":
        idx = rng.randint(0, n, size=probe.M).astype(np.int32)
        want = table[idx]
        xla = probe.make_xla_take()(jnp.asarray(table), jnp.asarray(idx))
        nbr = idx[None]
    else:
        m = getattr(probe, "M", n)  # probe4 gathers N rows
        nbr = rng.randint(0, n, size=(probe.K, m)).astype(np.int32)
        want = table[nbr].sum(axis=0)
        xla = probe.make_xla_scan()(jnp.asarray(table), jnp.asarray(nbr))
    got = kernels.gather_sum_plain(_t(table)[None], _i(nbr)[:, None],
                                   range(nbr.shape[0]), 0, nbr.shape[1])[0].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-6, atol=1e-6)


def test_scatter_sum_is_the_adjoint_of_gather_sum(pyramids):
    """<gather_sum(x), g> == <x, scatter_sum(g)> with no row skipped, and
    the skipped row gets nothing; a stacked table reads j * stride + s."""
    _, tp = pyramids
    lv = tp.levels[0]
    rng = np.random.RandomState(5)
    s_in, s_out = lv.valid.shape[0] // NB, tp.levels[1].valid.shape[0] // NB
    m = _i(lv.down_nbr)
    x = _t(rng.randn(NB, s_in, 3).astype(np.float32))
    g = _t(rng.randn(NB, s_out, 3).astype(np.float32))
    taps = range(8)
    fwd = kernels.gather_sum(x, m, taps, 0, s_out)
    adj = kernels.scatter_sum(g, m, taps, 0, s_in, -1)
    torch.testing.assert_close((fwd * g).sum(), (x * adj).sum(), rtol=1e-5, atol=1e-4)
    skipped = kernels.scatter_sum(g, m, taps, 0, s_in, s_in - 1)
    assert not skipped[:, s_in - 1].any()
    stacked = kernels.gather_sum(x, None, range(2), 100, 50)
    torch.testing.assert_close(stacked, x[:, :50] + x[:, 100:150])
    with pytest.raises(ValueError):
        kernels.gather_sum(x, None, range(2), s_in, 50)  # overruns the table
