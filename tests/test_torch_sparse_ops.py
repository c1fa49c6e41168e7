"""The port's chunked sparse convolutions (K1 same-level, K2 k2s2 down, K3
k2s2 transposed) against the JAX ops, values and gradients, on the
``tests/test_chunked.py`` fixture scale.  On the CPU the kernel wrappers run
their plain-torch twins, so this holds the twins -- the CUDA kernels'
reference -- against the JAX package.

Tolerances (f32, JAX at "highest" matmul precision): values and gradients
rtol/atol 1e-4; the two sides sum the same products in different orders,
and dW sums ~1000 rows.  Pad rows of every output must be exactly 0; feature
gradients are compared at valid rows only (pad-row dF is garbage by design
and differs between forms)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.sparse import ops as tops

TOL = dict(rtol=1e-4, atol=1e-4)
NPADS = [512, 512, 480, 96, 30]


def _coords(rng, num_batch=3, n_per=(150, 90, 120), extent=24):
    out = []
    for b in range(num_batch):
        flat = rng.choice(extent ** 3, n_per[b], replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((n_per[b], 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


@pytest.fixture(scope="module")
def pyr():
    pyr, _, _, orphan = build_chunked_pyramid(_coords(np.random.RandomState(0)),
                                              5, NPADS, num_batch=3)
    assert not orphan.any()
    return pyr


def _feats(rng, valid, c):
    f = np.zeros((valid.shape[0], c), np.float32)
    f[valid > 0] = rng.randn(int(valid.sum()), c)
    return f


def _idx(a):
    return torch.from_numpy(np.asarray(a).astype(np.int32))


def _jax_grads(fn, f, w, proj):
    def loss(f, w):
        out = fn(f, w)
        return jnp.sum(jnp.sin(out) * proj), out

    (_, out), (gf, gw) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(f), jnp.asarray(w))
    return np.asarray(out), np.asarray(gf), np.asarray(gw)


def _torch_grads(fn, f, w, proj):
    ft = torch.from_numpy(f).requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    out = fn(ft, wt)
    (torch.sin(out) * torch.from_numpy(proj)).sum().backward()
    return out.detach().numpy(), ft.grad.numpy(), wt.grad.numpy()


def _compare(j, t, valid_in, valid_out):
    (jo, jf, jw), (to, tf, tw) = j, t
    np.testing.assert_allclose(to, jo, **TOL)
    assert np.all(to[valid_out == 0] == 0), "pad rows must stay exactly 0"
    ok = valid_in > 0
    np.testing.assert_allclose(tf[ok], jf[ok], **TOL)
    np.testing.assert_allclose(tw, jw, **TOL)


@pytest.mark.parametrize("level,cin,cout", [(0, 3, 8), (0, 6, 5), (1, 5, 7)])
def test_k1_same_level_conv_matches_jax(pyr, level, cin, cout):
    """K1 (_conv_chunk_fused), incl. the Cin=3 stem shape."""
    rng = np.random.RandomState(level * 10 + cin)
    lv = pyr.levels[level]
    f = _feats(rng, lv.valid, cin)
    w = rng.randn(27, cin, cout).astype(np.float32) * 0.3
    proj = rng.randn(cout).astype(np.float32)
    j = _jax_grads(lambda f, w: jops.sparse_conv(
        f, jnp.asarray(lv.nbr), w, valid_out=jnp.asarray(lv.valid), rev=lv.rev),
        f, w, proj)
    nbr, valid = _idx(lv.nbr), torch.from_numpy(lv.valid)
    t = _torch_grads(lambda f, w: tops.sparse_conv(
        f, nbr, w, valid_out=valid, rev=lv.rev), f, w, proj)
    _compare(j, t, lv.valid, lv.valid)


@pytest.mark.parametrize("level,cin,cout", [(0, 6, 5), (1, 4, 9)])
def test_k2_down_conv_matches_jax(pyr, level, cin, cout):
    """K2 (_conv_chunk_down2): gather fwd, parent-gather dF."""
    rng = np.random.RandomState(100 + level)
    lv, lv1 = pyr.levels[level], pyr.levels[level + 1]
    f = _feats(rng, lv.valid, cin)
    w = rng.randn(8, cin, cout).astype(np.float32) * 0.3
    proj = rng.randn(cout).astype(np.float32)
    up = (jnp.asarray(lv.up_parent), jnp.asarray(lv.up_offset))
    j = _jax_grads(lambda f, w: jops.sparse_conv(
        f, jnp.asarray(lv.down_nbr), w, valid_out=jnp.asarray(lv1.valid), up=up),
        f, w, proj)
    down, valid1 = _idx(lv.down_nbr), torch.from_numpy(lv1.valid)
    up_t = (_idx(lv.up_parent), _idx(lv.up_offset))
    t = _torch_grads(lambda f, w: tops.sparse_conv(
        f, down, w, valid_out=valid1, up=up_t), f, w, proj)
    _compare(j, t, lv.valid, lv1.valid)


@pytest.mark.parametrize("level,cin,cout", [(0, 5, 3), (2, 8, 6)])
def test_k3_transpose_conv_matches_jax(pyr, level, cin, cout):
    """K3 (_conv_tr_chunk): parent-gather fwd, scatter + stacked-table bwd."""
    rng = np.random.RandomState(200 + level)
    lv, lv1 = pyr.levels[level], pyr.levels[level + 1]
    f = _feats(rng, lv1.valid, cin)
    w = rng.randn(8, cin, cout).astype(np.float32) * 0.3
    proj = rng.randn(cout).astype(np.float32)
    j = _jax_grads(lambda f, w: jops.sparse_conv_transpose(
        f, jnp.asarray(lv.up_parent), jnp.asarray(lv.up_offset), w,
        valid_out=jnp.asarray(lv.valid)), f, w, proj)
    upp, upo = _idx(lv.up_parent), _idx(lv.up_offset)
    valid = torch.from_numpy(lv.valid)
    t = _torch_grads(lambda f, w: tops.sparse_conv_transpose(
        f, upp, upo, w, valid_out=valid), f, w, proj)
    _compare(j, t, lv1.valid, lv.valid)


def test_masked_moments_match_jax(pyr):
    rng = np.random.RandomState(3)
    lv = pyr.levels[1]
    f = _feats(rng, lv.valid, 7) + 0.5 * (lv.valid[:, None] > 0)
    jm, jv, jn = jops.masked_moments(jnp.asarray(f), jnp.asarray(lv.valid))
    tm, tv, tn = tops.masked_moments(torch.from_numpy(f), torch.from_numpy(lv.valid))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)
    assert float(tn) == float(jn)


def test_unported_down_conv_raises(pyr):
    """A chunked down map passed without ``up`` once raised here (K4,
    JAX's ``_conv_chunk_down_fused``, was not ported).  It now runs K4, as
    JAX's dispatch does: JAX's values and gradients, and the values of the
    same map through K2 (with ``up``)."""
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    rng = np.random.RandomState(9)
    f = _feats(rng, lv.valid, 2)
    w = rng.randn(8, 2, 3).astype(np.float32)
    ct = _feats(rng, lv1.valid, 3)
    jout, vjp = jax.vjp(
        lambda x, wt: jops.sparse_conv(x, jnp.asarray(np.asarray(lv.down_nbr, np.int32)),
                                       wt, valid_out=jnp.asarray(lv1.valid)),
        jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = vjp(jnp.asarray(ct))
    x, wt = torch.from_numpy(f).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    out = tops.sparse_conv(x, _idx(lv.down_nbr), wt, valid_out=torch.from_numpy(lv1.valid))
    out.backward(torch.from_numpy(ct))
    vin = lv.valid > 0
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(x.grad.numpy()[vin], np.asarray(jdf)[vin], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(jdw), rtol=1e-5, atol=1e-5)
    k2 = tops.sparse_conv(torch.from_numpy(f), _idx(lv.down_nbr), torch.from_numpy(w),
                          valid_out=torch.from_numpy(lv1.valid),
                          up=(_idx(lv.up_parent), _idx(lv.up_offset)))
    np.testing.assert_allclose(out.detach().numpy(), k2.numpy(), rtol=1e-6, atol=1e-6)



@pytest.mark.parametrize("form", ["same_level", "down"])
def test_fused_group_zero_forms_are_k1_and_k4(pyr, form):
    """``PC_TPU_CONV_FUSED_GROUP=0`` (a TPU tuning switch) sends JAX's
    chunked convs to its scan forms: ``_conv_chunk_sym`` for a same-level
    map with ``rev``, ``_conv_chunk_core`` for any other map.  They compute
    the functions of K1 (``_ConvChunkFused``) and K4
    (``_ConvChunkDownFused``): values and gradients here."""
    rng = np.random.RandomState(31 if form == "down" else 32)
    lv, lv1 = pyr.levels[0], pyr.levels[1]
    if form == "same_level":
        m, k, out_valid = np.asarray(lv.nbr, np.int32), 27, lv.valid
        f = _feats(rng, lv.valid, 4)
        w = rng.randn(k, 4, 6).astype(np.float32) * 0.3
        jfn = lambda f, w: jops._conv_chunk_sym(f, jnp.asarray(m), w, lv.rev)  # noqa: E731
        tfn = lambda f, w: tops._ConvChunkFused.apply(f, _idx(m), w, lv.rev)  # noqa: E731
    else:
        m, k, out_valid = np.asarray(lv.down_nbr, np.int32), 8, lv1.valid
        f = _feats(rng, lv.valid, 4)
        w = rng.randn(k, 4, 6).astype(np.float32) * 0.3
        jfn = lambda f, w: jops._conv_chunk_core(f, jnp.asarray(m), w)  # noqa: E731
        tfn = lambda f, w: tops._ConvChunkDownFused.apply(f, _idx(m), w)  # noqa: E731
    proj = rng.randn(6).astype(np.float32)
    valid = jnp.asarray(out_valid)
    j = _jax_grads(lambda f, w: jops.mask_rows(jfn(f, w), valid), f, w, proj)
    tvalid = torch.from_numpy(out_valid)
    t = _torch_grads(lambda f, w: tops.mask_rows(tfn(f, w), tvalid), f, w, proj)
    _compare(j, t, lv.valid, out_valid)
