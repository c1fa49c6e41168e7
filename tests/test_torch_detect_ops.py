"""The port's PointNet++ ops (``pointcontrast_tpu_torch.detect``) against the
JAX package's ``detect/ops.py`` on numpy-seeded inputs, the CPU contract of
their kernel wrappers, and (``cuda``-marked) each CUDA kernel against its
plain twin on a card.

Tolerances: FPS and ball-query indices equal exactly (the twins spell out
the JAX distance sums as XLA's CPU code does, in chains of FMAs, and the
ball-query inputs are drawn so that no squared distance lies within 1e-5 of
r^2, where XLA's roundings differ from one fusion to another); gathered values equal exactly; gradients rtol
1e-6 (scatter-adds of a few colliding rows, summed in another order).

JAX is imported inside the fixture, so the card's machine, which has none,
runs the ``cuda`` tests:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_detect_ops.py"""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.detect import kernels, ops


@pytest.fixture(scope="module")
def jops():
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    from pointcontrast_tpu.detect import ops as j_ops

    return j_ops


def _dup_cloud(rng, b_, distinct, n, scale=1.0):
    """[B, n, 3] f32 clouds of ``distinct`` points padded with repeats, as
    ``detect/datasets.py::random_sampling`` pads a scene: most of the
    points are exact duplicates, so the FPS argmax ties on most steps."""
    out = np.empty((b_, n, 3), np.float32)
    for b in range(b_):
        base = (rng.rand(distinct, 3) * scale).astype(np.float32)
        extra = rng.choice(distinct, n - distinct, replace=True)
        out[b] = base[np.concatenate([np.arange(distinct), extra])]
    return out


@pytest.mark.parametrize("b_,distinct,n,npoint", [
    (2, 300, 300, 64),      # no duplicates
    (2, 120, 500, 100),     # 3/4 duplicates, as the shipped scenes
    (1, 40, 160, 60),       # more samples than distinct points: zero ties
])
def test_fps_matches_jax(jops, b_, distinct, n, npoint):
    xyz = _dup_cloud(np.random.RandomState(distinct), b_, distinct, n, scale=3.0)
    want = np.asarray(jops.furthest_point_sample(xyz, npoint))
    got = ops.furthest_point_sample(torch.from_numpy(xyz), npoint)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _ball_inputs(radius, seed):
    """Points in a unit box, centres among them plus a few far away (zero
    hits); redrawn until no squared distance lies within 1e-5 of r^2."""
    for s in range(seed, seed + 100):
        rng = np.random.RandomState(s)
        xyz = rng.rand(2, 400, 3).astype(np.float32)
        centres = np.concatenate(
            [xyz[:, rng.choice(400, 40, replace=False)],
             rng.rand(2, 8, 3).astype(np.float32) + 5.0], axis=1)
        d2 = ((centres[:, :, None, :].astype(np.float64)
               - xyz[:, None, :, :]) ** 2).sum(-1)
        if np.abs(d2 - radius * radius).min() > 1e-5:
            return centres, xyz
    raise AssertionError("no clean draw")


@pytest.mark.parametrize("radius,nsample", [(0.3, 16), (0.1, 8), (0.05, 16)])
def test_ball_query_matches_jax(jops, radius, nsample):
    centres, xyz = _ball_inputs(radius, seed=int(radius * 1000))
    want = np.asarray(jops.ball_query(centres, xyz, radius, nsample))
    got = ops.ball_query(torch.from_numpy(centres), torch.from_numpy(xyz),
                         radius, nsample)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[:, -8:] == 0).all()  # the far centres have no hit
    short = want[:, :-8]
    assert (short[..., -1] == short[..., 0]).any()  # some lists are padded


def _gather_case(seed, c=5, n=30, m=12, s=4):
    rng = np.random.RandomState(seed)
    points = rng.randn(2, c, n).astype(np.float32)
    idx = rng.randint(0, n, (2, m)).astype(np.int32)
    gidx = rng.randint(0, n, (2, m, s)).astype(np.int32)
    gidx[:, :, 2:] = gidx[:, :, :1]  # repeated first hits collide
    return points, idx, gidx, rng


@pytest.mark.parametrize("which", ["gather_points", "group_points"])
def test_gather_and_group_match_jax(jops, which):
    import jax
    import jax.numpy as jnp

    points, idx, gidx, rng = _gather_case(3)
    index = idx if which == "gather_points" else gidx
    jfn, tfn = getattr(jops, which), getattr(ops, which)
    want = np.asarray(jfn(points, index))
    tp = torch.from_numpy(points).requires_grad_(True)
    got = tfn(tp, torch.from_numpy(index))
    np.testing.assert_array_equal(got.detach().numpy(), want)

    w = rng.randn(*want.shape).astype(np.float32)
    jgrad = jax.grad(lambda p: jnp.sum(jfn(p, index) * w))(points)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-6)


def test_composed_gather_equals_two_step_gather():
    """The backbone gathers the seeds' voxel rows through the composed map
    ``point_voxel_idx[b, seed_inds[b]]``; values and gradients equal the JAX
    module's two gathers (all points, then the seeds)."""
    rng = np.random.RandomState(5)
    b_, s0, c, n, k = 2, 20, 6, 50, 9
    vout = torch.from_numpy(rng.randn(b_ * s0, c).astype(np.float32))
    pvi = torch.from_numpy(np.stack([rng.randint(b * s0, (b + 1) * s0, n)
                                     for b in range(b_)]).astype(np.int32))
    seeds = torch.from_numpy(rng.randint(0, n, (b_, k)).astype(np.int32))
    w = torch.from_numpy(rng.randn(b_, k, c).astype(np.float32))

    a = vout.clone().requires_grad_(True)
    rows = torch.gather(pvi, 1, seeds.long())
    composed = ops.gather(a.unsqueeze(0), rows.reshape(1, -1)).reshape(b_, k, c)
    (composed * w).sum().backward()

    b = vout.clone().requires_grad_(True)
    point_feats = b[pvi.long().reshape(-1)].reshape(b_, n, c)
    two_step = torch.gather(point_feats, 1,
                            seeds.long()[:, :, None].expand(-1, -1, c))
    (two_step * w).sum().backward()
    torch.testing.assert_close(composed, two_step, rtol=0, atol=0)
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_run_plain_twins_without_counting():
    points, idx, gidx, rng = _gather_case(7)
    table = torch.from_numpy(points.transpose(0, 2, 1).copy())
    xyz = torch.from_numpy(_dup_cloud(rng, 2, 40, 80))
    grad = torch.from_numpy(rng.randn(2, 12, 4, 5).astype(np.float32))
    calls = [
        (kernels.furthest_point_sample, (xyz, 20)),
        (kernels.ball_query, (xyz[:, :10], xyz, 0.2, 8)),
        (kernels.gather_rows, (table, torch.from_numpy(gidx))),
        (kernels.scatter_add_rows, (grad, torch.from_numpy(gidx), 30)),
    ]
    kernels.reset_launches()
    for fn, args in calls:
        want = getattr(kernels, fn.__name__ + "_plain")(*args)
        torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
    assert kernels.launch_counts() == {
        "furthest_point_sample": 0, "ball_query": 0, "gather_rows": 0,
        "scatter_add_rows": 0, "three_nn": 0, "three_interpolate": 0,
        "three_interpolate_grad": 0}


@pytest.mark.parametrize("case", ["fps_shape", "fps_npoint", "bq_batch",
                                  "gather_batch", "scatter_grad"])
def test_wrappers_reject_bad_operands(case):
    xyz = torch.zeros(2, 10, 3)
    calls = {
        "fps_shape": lambda: kernels.furthest_point_sample(torch.zeros(2, 10, 4), 3),
        "fps_npoint": lambda: kernels.furthest_point_sample(xyz, 0),
        "bq_batch": lambda: kernels.ball_query(xyz[:1], xyz, 0.1, 4),
        "gather_batch": lambda: kernels.gather_rows(
            torch.zeros(2, 10, 4), torch.zeros(3, 5, dtype=torch.int32)),
        "scatter_grad": lambda: kernels.scatter_add_rows(
            torch.zeros(2, 6, 4), torch.zeros(2, 5, dtype=torch.int32), 10),
    }
    with pytest.raises(ValueError):
        calls[case]()


@pytest.mark.cuda
def test_detect_kernels_match_plain_twins_on_card():
    """Each CUDA kernel against its plain twin on the card: FPS (on a cloud
    of 3/4 duplicates) and ball query index for index, the gather exactly,
    the scatter-add to 1e-5 + 1e-4 of its largest entry (unordered f32
    atomics).  chip_smoke.py repeats this at the VoteNet step's shapes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    dev = torch.device("cuda")
    rng = np.random.RandomState(0)
    xyz = torch.from_numpy(_dup_cloud(rng, 3, 500, 2000, scale=4.0)).to(dev)
    feats = torch.from_numpy(rng.randn(3, 2000, 37).astype(np.float32)).to(dev)
    kernels.reset_launches()
    inds = kernels.furthest_point_sample(xyz, 256)
    torch.testing.assert_close(inds, kernels.furthest_point_sample_plain(xyz, 256),
                               rtol=0, atol=0)
    centres = kernels.gather_rows(xyz, inds)
    torch.testing.assert_close(centres, kernels.gather_rows_plain(xyz, inds),
                               rtol=0, atol=0)
    for radius in (0.3, 0.05):
        idx = kernels.ball_query(centres, xyz, radius, 16)
        torch.testing.assert_close(
            idx, kernels.ball_query_plain(centres, xyz, radius, 16), rtol=0, atol=0)
    g = kernels.gather_rows(feats, idx)
    torch.testing.assert_close(g, kernels.gather_rows_plain(feats, idx), rtol=0, atol=0)
    grad = torch.randn_like(g)
    got = kernels.scatter_add_rows(grad, idx, 2000)
    want = kernels.scatter_add_rows_plain(grad, idx, 2000)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 + 1e-4 * float(want.abs().max())
    assert kernels.launch_counts() == {
        "furthest_point_sample": 1, "ball_query": 2, "gather_rows": 2,
        "scatter_add_rows": 1, "three_nn": 0, "three_interpolate": 0,
        "three_interpolate_grad": 0}
