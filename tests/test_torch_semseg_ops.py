"""The port's semseg ops and host pipeline against the JAX package's, on
the CPU (where every kernel wrapper runs its plain twin):

- ``global_pool`` and ``broadcast_to_points``: values and gradients, with
  random cotangents on the pad rows too (the broadcast's adjoint adds them
  into the last sample, as JAX's does);
- the flat-map ``sparse_conv`` on a real ``build_bilateral_map`` map, at
  13 taps (hypercross, the shipped CRF) and 729 (hypercube: 23 tap groups):
  values, dF and dW;
- ``SparseInstanceNorm`` and ``SparseLayerNorm``;
- ``build_bilateral_map`` and ``collate_semseg`` (chunked, with and without
  the CRF map), byte for byte; the semseg loss and metrics; the schedules.

Tolerances (f32 both sides, JAX at "highest" matmul precision): pooling and
norms 1e-6 relative to each result's largest entry (sums of ~100 rows in
another order); the flat conv 2e-6 (13 taps) and 2e-5 (729 taps, a longer
sum).  dF is compared on every row but the global pad row, where JAX sums
the products of all missing neighbours and the port leaves 0 (that row's
gradient is masked by every producer)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.losses import semseg as jloss
from pointcontrast_tpu.nn import layers as jlayers
from pointcontrast_tpu.semseg.crf import build_bilateral_map as j_bilateral
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate
from pointcontrast_tpu.sparse import ops as jops
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.losses import semseg as tloss
from pointcontrast_tpu_torch.nn.layers import SparseInstanceNorm, SparseLayerNorm
from pointcontrast_tpu_torch.semseg.crf import build_bilateral_map
from pointcontrast_tpu_torch.semseg.dataset import SemsegBatch, collate_semseg
from pointcontrast_tpu_torch.sparse import ops
from pointcontrast_tpu_torch.tools.workload import SemsegScenes
from pointcontrast_tpu_torch.train import optim

CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0,
           chromatic_sigma=12.0)


@pytest.fixture(scope="module", autouse=True)
def _highest():
    jax.config.update("jax_default_matmul_precision", "highest")


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got / scale, want / scale, rtol=0, atol=rel,
                               err_msg=what)


def _chunked_ids(rng, nb=3, s=40):
    """Chunked sample ids: b on a slice's valid rows, nb on its pad tail."""
    batch = np.full(nb * s, nb, np.int32)
    for b in range(nb):
        n = rng.randint(s // 2, s - 1)
        batch[b * s: b * s + n] = b
    return batch


@pytest.mark.parametrize("average", [True, False])
def test_global_pool_and_broadcast_match_jax(average):
    rng = np.random.RandomState(0)
    nb, c = 3, 5
    batch = _chunked_ids(rng, nb)
    valid = (batch < nb).astype(np.float32)
    f = rng.randn(len(batch), c).astype(np.float32) * valid[:, None]
    ct_pool = rng.randn(nb, c).astype(np.float32)
    ct_rows = rng.randn(len(batch), c).astype(np.float32)  # pad rows too

    def jpool(x):
        return jops.global_pool(x, jnp.asarray(batch), nb, average=average)

    jout, jvjp = jax.vjp(jpool, jnp.asarray(f))
    xf = torch.tensor(f, requires_grad=True)
    out = ops.global_pool(xf, torch.from_numpy(batch), nb, average=average)
    out.backward(torch.from_numpy(ct_pool))
    _close(out.detach(), jout, 1e-6, "pool")
    _close(xf.grad, jvjp(jnp.asarray(ct_pool))[0], 1e-6, "pool grad")
    assert not xf.grad[batch == nb].any()  # pad rows get nothing

    jb, bvjp = jax.vjp(lambda p: jops.broadcast_to_points(p, jnp.asarray(batch)),
                       jnp.asarray(ct_pool))
    ps = torch.tensor(ct_pool, requires_grad=True)
    got = ops.broadcast_to_points(ps, torch.from_numpy(batch))
    got.backward(torch.from_numpy(ct_rows))
    _close(got.detach(), jb, 0, "broadcast")
    _close(ps.grad, bvjp(jnp.asarray(ct_rows))[0], 1e-6, "broadcast grad")


@pytest.mark.parametrize("norm", ["instance", "layer"])
def test_sparse_norms_match_jax(norm):
    rng = np.random.RandomState(1)
    nb, c = 3, 6
    batch = _chunked_ids(rng, nb)
    valid = (batch < nb).astype(np.float32)
    f = (rng.randn(len(batch), c) * 2 + 1).astype(np.float32) * valid[:, None]
    ct = rng.randn(len(batch), c).astype(np.float32)
    jmod = (jlayers.SparseInstanceNorm() if norm == "instance"
            else jlayers.SparseLayerNorm())
    args = (jnp.asarray(valid), jnp.asarray(batch), nb)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(f), *args)
    scale = rng.rand(c).astype(np.float32) + 0.5
    bias = rng.randn(c).astype(np.float32)
    params = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    assert set(variables["params"]) == set(params)
    jout, jvjp = jax.vjp(
        lambda p, x: jmod.apply({"params": p}, x, *args), params, jnp.asarray(f))
    jgp, jgx = jvjp(jnp.asarray(ct))

    tmod = SparseInstanceNorm(c) if norm == "instance" else SparseLayerNorm(c)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(scale))
        tmod.bias.copy_(torch.from_numpy(bias))
    x = torch.tensor(f, requires_grad=True)
    out = tmod(x, torch.from_numpy(valid), torch.from_numpy(batch), nb)
    out.backward(torch.from_numpy(ct))
    _close(out.detach(), jout, 1e-6, "out")
    _close(x.grad, jgx, 1e-6, "dx")
    _close(tmod.weight.grad, jgp["scale"], 1e-6, "dscale")
    _close(tmod.bias.grad, jgp["bias"], 1e-6, "dbias")


def _crf_scene(rng, n=300, nrows=640):
    """A 2-sample scene on few colours (so bilateral neighbours exist),
    scattered over chunk-like rows, with its CRF map from both packages."""
    coords = np.concatenate([rng.randint(0, 2, (n, 1)),
                             rng.randint(0, 5, (n, 3))], axis=1).astype(np.int32)
    _, first = np.unique(coords, axis=0, return_index=True)
    coords = coords[np.sort(first)]
    n = len(coords)
    colors = np.zeros((n, 3), np.float32)
    colors[:, 0] = rng.randint(0, 2, n) * 12.0
    rows = np.sort(rng.choice(nrows - 1, n, replace=False))
    return coords, colors, rows


@pytest.mark.parametrize("kernel_size,region", [(3, "hypercross"), (3, "hypercube")])
def test_bilateral_map_byte_identical(kernel_size, region):
    coords, colors, rows = _crf_scene(np.random.RandomState(2))
    for kw in ({}, {"rows": rows}):
        want = j_bilateral(coords, colors, 640, kernel_size=kernel_size,
                           region=region, **kw)
        got = build_bilateral_map(coords, colors, 640, kernel_size=kernel_size,
                                  region=region, **kw)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("region,taps,tol", [("hypercross", 13, 2e-6),
                                             ("hypercube", 729, 2e-5)])
def test_flat_conv_matches_jax(region, taps, tol):
    rng = np.random.RandomState(3)
    coords, colors, rows = _crf_scene(rng)
    nbr = build_bilateral_map(coords, colors, 640, region=region, rows=rows)
    assert nbr.shape == (taps, 640)
    assert (nbr[:, rows] != 639).sum() > 1.5 * len(rows)  # neighbours besides self
    c_in, c_out = 4, 3
    valid = np.zeros(640, np.float32)
    valid[rows] = 1.0
    f = rng.randn(640, c_in).astype(np.float32) * valid[:, None]
    w = (rng.randn(taps, c_in, c_out) * 0.1).astype(np.float32)
    ct = rng.randn(640, c_out).astype(np.float32) * valid[:, None]

    def jconv(x, k):
        return jops.sparse_conv(x, jnp.asarray(nbr), k, valid_out=jnp.asarray(valid))

    jout, jvjp = jax.vjp(jconv, jnp.asarray(f), jnp.asarray(w))
    jdf, jdw = jvjp(jnp.asarray(ct))
    x = torch.tensor(f, requires_grad=True)
    k = torch.tensor(w, requires_grad=True)
    out = ops.sparse_conv(x, torch.from_numpy(nbr), k,
                          valid_out=torch.from_numpy(valid))
    out.backward(torch.from_numpy(ct))
    _close(out.detach(), jout, tol, "out")
    _close(x.grad[:-1], np.asarray(jdf)[:-1], tol, "dF")
    assert not x.grad[-1].any()  # the pad row gets no gradient
    _close(k.grad, jdw, tol, "dW")


def _samples(collate_cls=None):
    scenes = SemsegScenes(scenes=3, points=1500, room=1.2, voxel=0.05)
    return scenes.samples


@pytest.mark.parametrize("crf", [None, CRF])
def test_collate_semseg_byte_identical(crf):
    samples = _samples()
    kw = dict(ignore_label=255, shift_coords=True, limit_numpoints=0,
              layout="chunked", crf=crf, num_chunks=4)
    jb = j_collate(samples, JPadScheme(npad0=4096), rng=np.random.RandomState(5), **kw)
    tb = collate_semseg(samples, PadScheme(npad0=4096), rng=np.random.RandomState(5),
                        **kw)
    assert jb.num_samples == tb.num_samples == 3
    for f in ("feats", "labels", "truncated_voxels", "crf_nbr"):
        a, b = getattr(jb, f), getattr(tb, f)
        assert (a is None) == (b is None) == (f == "crf_nbr" and crf is None), f
        if a is not None:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    for l, (jl, tl) in enumerate(zip(jb.pyramid.levels, tb.pyramid.levels)):
        for f in ("nbr", "valid", "batch", "down_nbr", "up_parent", "up_offset"):
            a, b = getattr(jl, f), getattr(tl, f)
            assert (a is None) == (b is None), (l, f)
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (l, f)


def test_semseg_batch_to_checks_and_refuses_other_layouts():
    tb = collate_semseg(_samples(), PadScheme(npad0=4096), crf=CRF, num_chunks=3)
    dev = tb.to("cpu")
    assert dev.labels.dtype == torch.int64 and dev.crf_nbr.dtype == torch.int32
    bad = tb.crf_nbr.copy()
    bad[0, 0] = bad.shape[1]
    with pytest.raises(ValueError, match="crf_nbr"):
        SemsegBatch(**{**tb.__dict__, "crf_nbr": bad}).to("cpu")
    for layout in ("voxl", "bricks"):
        with pytest.raises(ValueError, match="layout"):
            collate_semseg(_samples(), PadScheme(npad0=4096), layout=layout)


def test_loss_and_metrics_match_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(200, 7).astype(np.float32)
    labels = rng.randint(0, 9, 200).astype(np.int32)
    labels[::7] = 255  # ignored; 7 and 8 are out of range
    weights = rng.rand(7).astype(np.float32)
    for w in (None, weights):
        want = jloss.cross_entropy_ignore(jnp.asarray(logits), jnp.asarray(labels),
                                          weights=None if w is None else jnp.asarray(w))
        got = tloss.cross_entropy_ignore(torch.from_numpy(logits),
                                         torch.from_numpy(labels).long(),
                                         weights=None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    pred = rng.randint(0, 7, 200)
    np.testing.assert_allclose(
        float(tloss.precision_at_one(torch.from_numpy(pred), torch.from_numpy(labels))),
        float(jloss.precision_at_one(jnp.asarray(pred), jnp.asarray(labels))), rtol=1e-6)
    hist = tloss.fast_hist(pred, labels, 7)
    np.testing.assert_array_equal(hist, jloss.fast_hist(pred, labels, 7))
    np.testing.assert_array_equal(tloss.per_class_iu(hist), jloss.per_class_iu(hist))


@pytest.mark.parametrize("name", ["polylr", "steplr", "squaredlr", "explr"])
def test_schedules_match_jax(name):
    class Cfg:
        max_iter, poly_power, step_size, step_gamma = 50, 0.9, 7, 0.5
        exp_gamma, exp_step_size = 0.9, 3
        lr, momentum, weight_decay = 0.1, 0.9, 1e-4

    jfac = j_optim.make_scheduler(name, Cfg)
    opt = optim.make_optimizer(torch.nn.Linear(2, 2), Cfg)
    sched = optim.make_scheduler(opt, Cfg, name)
    for s in range(20):
        np.testing.assert_allclose(sched.get_last_lr()[0], 0.1 * float(jfac(s)),
                                   rtol=1e-6)
        opt.step()
        sched.step()
