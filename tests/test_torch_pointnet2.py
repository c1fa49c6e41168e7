"""The port's PointNet++ path against the JAX package's: the K9 ops
(``three_nn``, ``interpolation_weights``, ``three_interpolate`` and its
gradients), ``PointnetFPModule``, FPS with more samples than points, the
PointNet++ VoteNet (train- and eval-mode ``end_points``, three steps each
from the same JAX state), the K9 wrappers' CPU contract, and
(``cuda``-marked) the K9 kernels against their plain twins on a card.
BoxNet (``tests/test_torch_boxnet.py``) reuses this file's reference run;
the CLI is in ``tests/test_torch_votenet_app.py``.

Size: 2 synthetic scenes x 2000 points (SA1 samples 2048 of them, so FPS
runs on past the distinct points), 16 proposals by vote FPS.

Two choices make the model comparison exact where it can be:
  - the scenes' coordinates lie on a 1/64 m grid.  Every squared distance
    of the backbone (FPS, the four ball queries, three_nn) is then an exact
    f32 value in any summation order, and at least 3.9e-5 from each radius^2.
    XLA on the CPU contracts these sums into FMAs in some fusions and not in
    others: off the grid, a point a few 1e-6 inside SA1's radius fell
    outside it in the JAX model's step and inside it in a standalone jit;
  - the JAX steps run in float64 (``jax.enable_x64``; the package's FPS
    keeps float32 running distances, so the fixture swaps in a float64 copy
    of it).  Two float32 steps differ by both sides' rounding, which SA1's
    BatchNorm statistics over 262,144 grouped rows make large; so the port
    is held to the JAX float64 step in float64 (one step's loss rtol 1e-5;
    moments, running stats and weights to 1e-7 .. 1e-8) and in float32
    (fields to 2e-4 of each field's largest entry, loss rtol 3e-5).
Indices (FPS, ball query through the fields, three_nn, object assignment)
are equal.  The K9 unit checks run in float32 against the JAX ops as jitted:
indices equal (duplicated and near-duplicated points included), distances
and the interpolation and its gradients rtol 1e-6 of each tensor's largest
entry (XLA's CPU sqrt is not correctly rounded; gradients add colliding rows
in another order).

JAX is imported inside the fixtures, so the card's machine, which has none,
runs the ``cuda`` test:  python -m pytest --noconftest -p no:cacheprovider
-m cuda tests/test_torch_pointnet2.py"""
import contextlib

import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.detect import kernels, ops
from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
from pointcontrast_tpu_torch.detect.datasets import (
    LABEL_FIELDS,
    SyntheticDetectionDataset,
    collate_detection,
)
from pointcontrast_tpu_torch.detect.modules import PointnetFPModule
from pointcontrast_tpu_torch.detect.train import (
    DetectConfig,
    DetectTrainer,
    batch_to_inputs,
    loss_of,
)
from pointcontrast_tpu_torch.tools.from_jax import (
    jax_state_dict,
    load_jax_params,
    load_optax_adam,
    torch_name,
)
from pointcontrast_tpu_torch.tools.workload import votenet_model

PROPOSALS = 16
LR = 1e-3
BN_MOMENTUM = 0.5  # get_bn_momentum at epoch 0
GRID = 64  # coordinates on a 1/64 m grid
INT_FIELDS = ("seed_inds", "fp2_inds", "sa1_inds", "aggregated_vote_inds",
              "object_assignment", "objectness_label")
RTOL32 = 2e-4  # float32 fields, of each field's largest entry
TOL64 = dict(rtol=1e-8, atol=1e-8)


@pytest.fixture(scope="module")
def jops():
    import jax

    jax.config.update("jax_default_matmul_precision", "highest")
    from pointcontrast_tpu.detect import ops as j_ops

    return j_ops


def _rel_close(got, want, rtol, msg=""):
    """|got - want| <= rtol * max|want| (1 where want is all zero)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1.0 if not want.any() else 0.0)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f"{msg}: max err {err:.3e} of {scale:.3e}"


# --------------------------------------------------------------------------
# the arithmetic the kernels and twins spell out


def test_fma_plain_rounds_once():
    """``fma_plain`` against exact rational arithmetic rounded once to f32
    (to nearest, ties to even), on products that nearly cancel too."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    n = 3000
    a = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    b = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    c = (rng.randn(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    c[: n // 2] = -(a[: n // 2].astype(np.float64) * b[: n // 2]).astype(np.float32)
    got = kernels.fma_plain(*(torch.from_numpy(v) for v in (a, b, c))).numpy()

    def rounded(x, y, z):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z))
        f = np.float32(float(exact))
        near = (np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf)))
        return min(near, key=lambda v: (abs(Fraction(float(v)) - exact),
                                        int(np.array(v).view(np.int32)) & 1))

    want = np.array([rounded(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_xla_sums_three_products_as_an_fma_chain(jops):
    """Why the kernels and twins spell distances as FMA chains: XLA's CPU
    code for the JAX ``_sqdist`` and the FP interpolation equals
    ``fma(a2, b2, fma(a1, b1, a0 b0))`` bit for bit, and the unfused sum,
    ``(a0 b0 + a1 b1) + a2 b2``, differs."""
    import jax

    rng = np.random.RandomState(1)
    a = (rng.rand(2, 200, 3) * 6 - 3).astype(np.float32)
    b = (rng.rand(2, 100, 3) * 6 - 3).astype(np.float32)
    want = np.asarray(jax.jit(jops._sqdist)(a, b))
    ta, tb = torch.from_numpy(a)[:, :, None], torch.from_numpy(b)[:, None]

    def sqdist(dot):
        return torch.clamp_min((dot(ta, ta) + dot(tb, tb)) - 2.0 * dot(ta, tb), 0.0).numpy()

    def unfused(x, y):
        return (x[..., 0] * y[..., 0] + x[..., 1] * y[..., 1]) + x[..., 2] * y[..., 2]

    np.testing.assert_array_equal(sqdist(kernels.dot3_fma), want)
    assert (sqdist(unfused) != want).any()
    feats, idx, w, _ = _interp_case(3)
    want = np.asarray(jax.jit(_jax_interpolate)(feats, idx, w))
    got = kernels.three_interpolate_plain(*(torch.from_numpy(v) for v in (feats, idx, w)))
    np.testing.assert_array_equal(got.numpy(), want)


# --------------------------------------------------------------------------
# K9 ops


def _nn_clouds(seed, b_=2, n=300, m=100):
    """Unknown points in a 6 m box; the known ones are m of them, with
    exact duplicates among the known points and near-duplicates (1e-6 to
    1e-4 away) next to exact ones, where distance ties and cancellation
    decide the order."""
    rng = np.random.RandomState(seed)
    unknown = (rng.rand(b_, n, 3) * 6 - 3).astype(np.float32)
    known = unknown[:, rng.choice(n, m, replace=False)].copy()
    known[:, 10:15] = known[:, 0:5]
    for j in range(20, 60, 2):
        known[:, j + 1] = known[:, j] + (rng.randn(b_, 3)
                                         * 10 ** rng.uniform(-6, -4)).astype(np.float32)
    return unknown, known


@pytest.mark.parametrize("seed", [0, 1])
def test_three_nn_matches_jax(jops, seed):
    import jax

    unknown, known = _nn_clouds(seed)
    jd, ji = (np.asarray(x) for x in jax.jit(jops.three_nn)(unknown, known))
    dist, idx = ops.three_nn(torch.from_numpy(unknown), torch.from_numpy(known))
    assert idx.dtype == torch.int32 and dist.dtype == torch.float32
    np.testing.assert_array_equal(idx.numpy(), ji)
    np.testing.assert_allclose(dist.numpy(), jd, rtol=1e-6, atol=0)
    assert (jd[..., 0] == 0).any()  # the known points among the unknown ones
    want_w = np.asarray(jax.jit(jops.interpolation_weights)(jd))
    got_w = ops.interpolation_weights(torch.from_numpy(jd)).numpy()
    np.testing.assert_allclose(got_w, want_w, rtol=1e-6, atol=0)


def _interp_case(seed, b_=2, m=40, n=90, c=12):
    rng = np.random.RandomState(seed)
    feats = rng.randn(b_, m, c).astype(np.float32)
    idx = rng.randint(0, m, (b_, n, 3)).astype(np.int32)
    idx[:, :10, 1] = idx[:, :10, 0]  # rows collide in the backward
    w = rng.rand(b_, n, 3).astype(np.float32) + 0.1
    w /= w.sum(-1, keepdims=True)
    ct = rng.randn(b_, n, c).astype(np.float32)
    return feats, idx, w, ct


def _jax_interpolate(known_feats, idx, w):
    """The JAX FP module's inline interpolation (detect/modules.py:116-120)."""
    import jax.numpy as jnp

    g = jnp.take_along_axis(known_feats[:, None, :, :], idx[:, :, :, None], axis=2)
    return jnp.sum(g * w[:, :, :, None], axis=2)


@pytest.mark.parametrize("seed", [0, 1])
def test_three_interpolate_and_grads_match_jax(jops, seed):
    import jax
    import jax.numpy as jnp

    feats, idx, w, ct = _interp_case(seed)
    want = np.asarray(jax.jit(_jax_interpolate)(feats, idx, w))
    jf, jw = jax.grad(lambda f, w_: jnp.sum(_jax_interpolate(f, idx, w_) * ct),
                      argnums=(0, 1))(feats, w)
    tf = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = ops.three_interpolate(tf, torch.from_numpy(idx), tw)
    (got * torch.from_numpy(ct)).sum().backward()
    _rel_close(got.detach(), want, 1e-6, "interpolation")
    _rel_close(tf.grad, jf, 1e-6, "feature gradient")
    _rel_close(tw.grad, jw, 1e-6, "weight gradient")


def test_three_interpolate_feature_gradient_is_the_scatter_twin():
    """With weights that need no gradient, as on the VoteNet path, the
    backward is ``three_interpolate_grad`` alone."""
    feats, idx, w, ct = (torch.from_numpy(a) for a in _interp_case(2))
    tf = feats.clone().requires_grad_(True)
    (ops.three_interpolate(tf, idx, w) * ct).sum().backward()
    want = kernels.three_interpolate_grad_plain(ct, idx, w, feats.shape[1])
    torch.testing.assert_close(tf.grad, want, rtol=0, atol=0)
    assert w.grad is None


def test_fp_module_matches_jax(jops):
    """PointnetFPModule (train mode: output and running stats) from the
    flax module's parameters, known points a subset of the unknown ones as
    in FP1 and FP2."""
    import jax

    from pointcontrast_tpu.detect.modules import PointnetFPModule as JFP

    rng = np.random.RandomState(3)
    uxyz = (np.round(rng.rand(2, 64, 3) * 4 * GRID) / GRID).astype(np.float32)
    kxyz = uxyz[:, ::4].copy()
    ufeat = rng.randn(2, 64, 6).astype(np.float32)
    kfeat = rng.randn(2, 16, 10).astype(np.float32)
    jm = JFP(mlp=[16, 8], bn_momentum=BN_MOMENTUM)
    variables = jm.init(jax.random.PRNGKey(1), uxyz, kxyz, ufeat, kfeat, train=False)
    want, mut = jax.jit(lambda v: jm.apply(v, uxyz, kxyz, ufeat, kfeat, train=True,
                                           mutable=["batch_stats"]))(variables)
    tm = load_jax_params(PointnetFPModule([16, 8], in_channels=16,
                                          bn_momentum=BN_MOMENTUM),
                         jax.device_get(variables["params"]),
                         jax.device_get(variables["batch_stats"]))
    got = tm(*(torch.from_numpy(a) for a in (uxyz, kxyz, ufeat, kfeat)))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    stats = jax_state_dict({}, jax.device_get(mut["batch_stats"]))
    for name, v in tm.named_buffers():
        np.testing.assert_allclose(v.numpy(), stats[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_fps_past_the_distinct_points_matches_jax(jops):
    """SA1 samples 2048 of a 2000-point scene: once every distance is 0 the
    argmax takes index 0, in the JAX op and in the port."""
    import jax

    ds = SyntheticDetectionDataset(num_scenes=2, num_objects=4, num_points=2000,
                                   seed=0)
    xyz = np.stack([ds[i]["point_clouds"][:, :3] for i in range(2)])
    want = np.asarray(jax.jit(jops.furthest_point_sample, static_argnums=1)(xyz, 2048))
    got = ops.furthest_point_sample(torch.from_numpy(xyz), 2048).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[:, 2000:] == 0).all() and len(np.unique(want[0])) == 2000


def test_k9_wrappers_run_plain_twins_on_cpu_without_counting():
    unknown, known = (torch.from_numpy(a) for a in _nn_clouds(4))
    feats, idx, w, ct = (torch.from_numpy(a) for a in _interp_case(4))
    kernels.reset_launches()
    for fn, args in ((kernels.three_nn, (unknown, known)),
                     (kernels.three_interpolate, (feats, idx, w)),
                     (kernels.three_interpolate_grad, (ct, idx, w, 40))):
        want = getattr(kernels, fn.__name__ + "_plain")(*args)
        torch.testing.assert_close(fn(*args), want, rtol=0, atol=0)
    assert all(v == 0 for v in kernels.launch_counts().values())


@pytest.mark.parametrize("case", ["nn_known", "nn_batch", "interp_idx",
                                  "interp_weight", "grad_rows"])
def test_k9_wrappers_reject_bad_operands(case):
    xyz = torch.zeros(2, 10, 3)
    f = torch.zeros(2, 10, 4)
    idx = torch.zeros(2, 5, 3, dtype=torch.int32)
    w = torch.zeros(2, 5, 3)
    calls = {
        "nn_known": lambda: kernels.three_nn(xyz, xyz[:, :2]),
        "nn_batch": lambda: kernels.three_nn(xyz, xyz[:1]),
        "interp_idx": lambda: kernels.three_interpolate(f, idx[:, :, :2], w[:, :, :2]),
        "interp_weight": lambda: kernels.three_interpolate(f, idx, w[:, :4]),
        "grad_rows": lambda: kernels.three_interpolate_grad(
            torch.zeros(2, 6, 4), idx, w, 10),
    }
    with pytest.raises(ValueError):
        calls[case]()


# --------------------------------------------------------------------------
# the PointNet++ VoteNet


def _samples():
    ds = SyntheticDetectionDataset(num_scenes=2, num_objects=4, num_points=2000,
                                   seed=0)
    out = []
    for i in range(2):
        s = dict(ds[i])
        pc = s["point_clouds"].copy()
        pc[:, :3] = np.round(pc[:, :3] * GRID) / GRID
        s["point_clouds"] = pc
        out.append(s)
    return out


@contextlib.contextmanager
def _float64_fps(j_ops):
    """The package's FPS with running distances in the input's dtype (its
    own are float32 arrays, which a float64 trace rejects)."""
    import jax
    import jax.numpy as jnp

    def fps(xyz, npoint):
        b, n, _ = xyz.shape

        def body(i, state):
            idxs, dists, last = state
            last_xyz = jnp.take_along_axis(xyz, last[:, None, None], axis=1)
            dists = jnp.minimum(dists, jnp.sum(jnp.square(xyz - last_xyz), axis=-1))
            nxt = jnp.argmax(dists, axis=1).astype(jnp.int32)
            return idxs.at[:, i].set(nxt), dists, nxt

        state = (jnp.zeros((b, npoint), jnp.int32), jnp.full((b, n), jnp.inf, xyz.dtype),
                 jnp.zeros((b,), jnp.int32))
        return jax.lax.fori_loop(1, npoint, body, state)[0]

    saved = j_ops.furthest_point_sample
    j_ops.furthest_point_sample = fps
    try:
        yield
    finally:
        j_ops.furthest_point_sample = saved


def _np_tree(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _jax_run(jops, model, loss_fn, jbatch, steps, eval_mode=True):
    """float32 init, then ``steps`` float64 Adam steps: the states, each
    step's loss and train-mode end_points, and (``eval_mode``) the eval
    end_points after step 1."""
    import jax
    import optax

    from pointcontrast_tpu.detect.train import _batch_to_inputs, _batch_to_labels

    dc = ScannetDatasetConfig()
    inputs, labels = _batch_to_inputs(jbatch), _batch_to_labels(jbatch)
    variables = jax.jit(lambda r: model.init(r, inputs, train=False))(
        jax.random.PRNGKey(0))

    def f64(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float64)
                            if np.asarray(a).dtype.kind == "f" else np.asarray(a), tree)

    with jax.enable_x64(True), _float64_fps(jops):
        inputs, labels = f64(inputs), f64(labels)
        tx = optax.adam(LR)

        @jax.jit
        def step(params, bs, opt_state):
            def loss_of_params(p):
                ep, mut = model.apply({"params": p, "batch_stats": bs}, inputs,
                                      train=True, mutable=["batch_stats"])
                ep.update(labels)
                loss, ep = loss_fn(ep, dc)
                return loss, (mut["batch_stats"], ep)

            (loss, (new_bs, ep)), grads = jax.value_and_grad(
                loss_of_params, has_aux=True)(params)
            updates, opt_state = tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), new_bs, opt_state, loss, ep

        params = f64(variables["params"])
        states = [(params, f64(variables["batch_stats"]), tx.init(params))]
        losses, eps = [], []
        for _ in range(steps):
            p, bs, o, loss, ep = step(*states[-1])
            states.append((p, bs, o))
            losses.append(float(loss))
            eps.append(_np_tree(ep))
        states = [_np_tree(s) for s in states]
        eval_ep = _np_tree(jax.jit(lambda p, bs: model.apply(
            {"params": p, "batch_stats": bs}, inputs, train=False))(*states[1][:2])
        ) if eval_mode else None
    return dict(states=states, losses=losses, train_eps=eps, eval_ep=eval_ep)


@pytest.fixture(scope="module")
def run(jops):
    from pointcontrast_tpu.detect.datasets import collate_detection as j_collate
    from pointcontrast_tpu.detect.loss import get_loss as j_get_loss
    from pointcontrast_tpu.detect.votenet import VoteNet as JVoteNet

    samples = _samples()
    dc = ScannetDatasetConfig()
    kw = dict(num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
              num_size_cluster=dc.num_size_cluster, mean_size_arr=dc.mean_size_arr,
              num_proposal=PROPOSALS, backbone="pointnet2", bn_momentum=BN_MOMENTUM)
    jbatch = j_collate(samples)
    return dict(
        dc=dc, tbatch=collate_detection(samples).to("cpu"),
        votenet=_jax_run(jops, JVoteNet(sampling="vote_fps", **kw), j_get_loss,
                         jbatch, 3))


def _double(batch):
    return type(batch)(**{k: v.double() if torch.is_tensor(v) and v.is_floating_point()
                          else v for k, v in batch.__dict__.items()})


def _model(state, dtype, use_voting=True):
    params, bs, _ = state
    model = votenet_model(0, num_proposal=PROPOSALS, backbone="pointnet2",
                          use_voting=use_voting).to(dtype)
    return load_jax_params(model, params, bs,
                           np.float64 if dtype == torch.float64 else np.float32)


def _compare_end_points(got: dict, want: dict, rtol: float) -> int:
    """Integer fields equal, float fields to ``rtol`` of each field's
    largest entry."""
    compared = 0
    for k, w in want.items():
        if k not in got or not isinstance(w, np.ndarray):
            continue
        g = got[k].detach().numpy()
        if k in INT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            _rel_close(g, w, rtol, k)
        compared += 1
    return compared


def test_strict_weight_load(run):
    params, bs, _ = run["votenet"]["states"][0]
    names = set(jax_state_dict(params, bs))
    model = _model(run["votenet"]["states"][0], torch.float32)
    assert set(model.state_dict()) == names
    for name in ("backbone_net.sa1.mlp.layer0.weight", "backbone_net.sa4.mlp.bn2.running_var",
                 "backbone_net.fp1.mlp.layer0.weight", "backbone_net.fp2.mlp.bn1.bias",
                 "vgen.conv3.bias", "pnet.vote_aggregation.mlp.layer0.weight"):
        assert name in names, name


def test_end_points_match_jax(run):
    """float32, as on the card: train mode at the initial state (the first
    step's forward and loss) and eval mode after one step, against the
    float64 JAX step."""
    vn = run["votenet"]
    batch = run["tbatch"]
    model = _model(vn["states"][0], torch.float32)
    for m in model.modules():
        if hasattr(m, "momentum"):
            m.momentum = BN_MOMENTUM
    ep = model.train()(batch_to_inputs(batch))
    ep.update({k: getattr(batch, k) for k in LABEL_FIELDS})
    loss, ep = loss_of(model)(ep, run["dc"])
    np.testing.assert_allclose(float(loss.detach()), vn["losses"][0], rtol=3e-5)
    assert _compare_end_points(ep, vn["train_eps"][0], RTOL32) >= 40
    model = _model(vn["states"][1], torch.float32).eval()
    with torch.no_grad():
        ep = model(batch_to_inputs(batch))
    assert _compare_end_points(ep, vn["eval_ep"], RTOL32) >= 20


def _trainer(jrun, k, checkpoint_dir, use_voting=True):
    """A float64 DetectTrainer at the JAX trajectory's state ``k`` (params,
    batch stats, Adam moments and count), at epoch 0's LR and BN momentum."""
    trainer = DetectTrainer(_model(jrun["states"][k], torch.float64, use_voting),
                            ScannetDatasetConfig(),
                            DetectConfig(checkpoint_dir=str(checkpoint_dir)), "cpu")
    adam = jrun["states"][k][2][0]
    load_optax_adam(trainer.opt, trainer.model, adam.mu, adam.nu, adam.count,
                    np.float64)
    return trainer


def _check_step(trainer, jrun, k, batch):
    """The torch step from state k against JAX's, float64 on both sides:
    loss, Adam's moments (to 1e-7 of each tensor's largest), running stats
    and parameters.  Adam moves a weight by about lr whatever its gradient's
    size, so a weight whose gradient is at float64 noise level (a BN bias
    whose gradient cancels) may move either way: those are held to the
    step's bound, 2 lr, the others to 1e-8."""
    loss = trainer.train_epoch(iter([batch]), 1)
    np.testing.assert_allclose(loss, jrun["losses"][k], rtol=1e-5)
    params, bs, opt = jrun["states"][k + 1]
    named = dict(trainer.model.named_parameters())
    clear = {}
    for path, mu in _flat(opt[0].mu):
        got = trainer.opt.state[named[torch_name(path)]]["exp_avg"].numpy()
        _rel_close(got, mu, 1e-7, torch_name(path))
        clear[path] = np.abs(mu) > 1e-9 * float(np.abs(mu).max())
    buffers = dict(trainer.model.named_buffers())
    for path, v in _flat(bs):
        np.testing.assert_allclose(buffers[torch_name(path)].numpy(), v,
                                   err_msg=torch_name(path), **TOL64)
    for path, v in _flat(params):
        got = named[torch_name(path)].detach().numpy()
        np.testing.assert_allclose(got[clear[path]], v[clear[path]],
                                   err_msg=torch_name(path), **TOL64)
        assert np.abs(got - v).max() <= 2 * LR + TOL64["atol"], torch_name(path)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("k", [0, 1, 2])
def test_steps_match_jax_from_the_same_state(run, k, tmp_path):
    trainer = _trainer(run["votenet"], k, tmp_path)
    _check_step(trainer, run["votenet"], k, _double(run["tbatch"]))


# --------------------------------------------------------------------------
# on the card


@pytest.mark.cuda
def test_k9_kernels_match_plain_twins_on_card():
    """three_nn index for index and distance for distance (both spell the
    distances with single-rounding FMAs), three_interpolate exactly and its
    gradient to 1e-5 + 1e-4 of the largest entry (the gradient's f32
    atomics add colliding rows in no fixed order), at FP2's widths; FPS
    with more samples than points."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100)")
    dev = torch.device("cuda")
    unknown, known = (torch.from_numpy(a).to(dev) for a in _nn_clouds(5, 2, 1024, 512))
    kernels.reset_launches()
    dist, idx = kernels.three_nn(unknown, known)
    want_d, want_i = kernels.three_nn_plain(unknown, known)
    torch.testing.assert_close(idx, want_i, rtol=0, atol=0)
    torch.testing.assert_close(dist, want_d, rtol=0, atol=0)
    w = ops.interpolation_weights(dist)
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(rng.randn(2, 512, 256).astype(np.float32)).to(dev)
    ct = torch.from_numpy(rng.randn(2, 1024, 256).astype(np.float32)).to(dev)
    for c in (256, 3):  # float4 and scalar paths
        f, g = feats[..., :c].contiguous(), ct[..., :c].contiguous()
        got = kernels.three_interpolate(f, idx, w)
        torch.testing.assert_close(got, kernels.three_interpolate_plain(f, idx, w),
                                   rtol=0, atol=0)
        got = kernels.three_interpolate_grad(g, idx, w, 512)
        want = kernels.three_interpolate_grad_plain(g, idx, w, 512)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= 1e-5 + 1e-4 * float(want.abs().max())
    # FPS past the distinct points: index 0 once every distance is 0
    few = unknown[:, :300].contiguous()
    inds = kernels.furthest_point_sample(few, 400)
    torch.testing.assert_close(inds, kernels.furthest_point_sample_plain(few, 400),
                               rtol=0, atol=0)
    assert bool((inds[:, 300:] == 0).all())
    assert kernels.launch_counts() == {
        "furthest_point_sample": 1, "ball_query": 0, "gather_rows": 0,
        "scatter_add_rows": 0, "three_nn": 1, "three_interpolate": 2,
        "three_interpolate_grad": 2}
