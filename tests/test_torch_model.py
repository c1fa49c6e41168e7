"""Res16UNet14A in the port against the JAX model, from the same converted
weights on the same chunked batch: train- and eval-mode forward, the updated
BN running statistics, and the parameter gradients of a scalar loss.

Tolerances (f32, JAX at "highest" matmul precision): outputs and running
stats rtol/atol 2e-4 (the same bound ``tests/test_chunked.py`` holds the
chunked and flat JAX networks to: train-mode BN amplifies summation-order
noise); gradients atol 2e-4 relative to each tensor's largest entry."""
import jax
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.nn.registry import load_model as j_load_model
from pointcontrast_tpu.sparse.chunk import build_chunked_pyramid
from pointcontrast_tpu_torch.data.collate import PairBatch
from pointcontrast_tpu_torch.nn.registry import load_model
from pointcontrast_tpu_torch.sparse.topology import LevelTopo, Pyramid
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name

TOL = dict(rtol=2e-4, atol=2e-4)


def _coords(rng, num_batch=3, n_per=(150, 90, 120), extent=24):
    out = []
    for b in range(num_batch):
        flat = rng.choice(extent ** 3, n_per[b], replace=False)
        xyz = np.stack(np.unravel_index(flat, (extent,) * 3), axis=1)
        out.append(np.concatenate([np.full((n_per[b], 1), b), xyz], axis=1))
    return np.concatenate(out).astype(np.int32)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _perturb(tree, rng, positive=False):
    """Random BN statistics/affines so eval mode and grads see non-trivial
    values (a fresh init has scale 1, bias 0, mean 0, var 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb(v, rng, positive)
        else:
            v = np.asarray(v)
            noise = rng.uniform(0.5, 1.5, v.shape) if positive and k == "var" \
                else rng.uniform(-0.2, 0.2, v.shape)
            out[k] = (v * noise if positive and k == "var" else v + noise).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    rng = np.random.RandomState(11)
    pyr, _, rows, orphan = build_chunked_pyramid(
        _coords(rng), 5, [512, 512, 480, 96, 30], num_batch=3)
    assert not orphan.any()
    feats = np.zeros((pyr.levels[0].valid.shape[0], 3), np.float32)
    feats[rows] = rng.randn(len(rows), 3)
    jmodel = j_load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                          normalize_feature=True)
    variables = jax.jit(lambda r, f: jmodel.init(r, f, pyr, train=False))(
        jax.random.PRNGKey(0), feats)
    params = jax.device_get(variables["params"])
    params = {k: dict(v) for k, v in params.items()}
    params = _perturb(params, rng)
    stats = _perturb(jax.device_get(variables["batch_stats"]), rng, positive=True)
    tmodel = load_model("Res16UNet14A")(in_channels=3, out_channels=8,
                                        normalize_feature=True)
    load_jax_params(tmodel, params, stats)
    # host batch -> torch through the port's checked move
    tpyr = Pyramid(levels=tuple(LevelTopo(**{
        f: getattr(lv, f) for f in ("nbr", "valid", "batch", "down_nbr",
                                    "up_parent", "up_offset", "nbr0", "rev",
                                    "rev0")}) for lv in pyr.levels),
        num_batch=pyr.num_batch)
    host = PairBatch(feats0=feats, pyramid0=tpyr, q_idx=np.zeros(1, np.int32),
                     k_idx=np.zeros(1, np.int32),
                     pair_valid=np.zeros(1, np.float32),
                     truncated_voxels=np.zeros((), np.float32))
    return dict(jmodel=jmodel, params=params, stats=stats, pyr=pyr,
                feats=feats, tmodel=tmodel, batch=host.to("cpu"), rows=rows)


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(setup, train):
    s = setup
    v = {"params": s["params"], "batch_stats": s["stats"]}
    tmodel = s["tmodel"]
    before = {k: b.clone() for k, b in tmodel.named_buffers()}
    if train:
        jout, mut = s["jmodel"].apply(v, s["feats"], s["pyr"], train=True,
                                      mutable=["batch_stats"])
    else:
        jout = s["jmodel"].apply(v, s["feats"], s["pyr"], train=False)
    tmodel.train(train)
    with torch.no_grad():
        tout = tmodel(s["batch"].feats0, s["batch"].pyramid0).numpy()
    np.testing.assert_allclose(tout, np.asarray(jout), **TOL)
    pad = np.ones(len(tout), bool)
    pad[s["rows"]] = False
    assert np.all(tout[pad] == 0), "pad rows must stay exactly 0"
    if train:
        # the updated running statistics equal JAX's mutated batch_stats
        for path, leaf in _flat(jax.device_get(mut["batch_stats"])):
            got = dict(tmodel.named_buffers())[torch_name(path)].numpy()
            np.testing.assert_allclose(got, np.asarray(leaf), **TOL)
    for k, b in before.items():  # restore for the other tests
        dict(tmodel.named_buffers())[k].copy_(b)


def test_param_grads_match_jax(setup):
    s = setup
    rng = np.random.RandomState(5)
    proj = rng.randn(8).astype(np.float32)

    def jloss(params):
        out, _ = s["jmodel"].apply({"params": params, "batch_stats": s["stats"]},
                                   s["feats"], s["pyr"], train=True,
                                   mutable=["batch_stats"])
        return (jax.numpy.sin(out * 3.0) * proj).sum()

    jgrads = jax.device_get(jax.grad(jloss)(s["params"]))
    tmodel = s["tmodel"]
    before = {k: b.clone() for k, b in tmodel.named_buffers()}
    tmodel.train(True)
    tmodel.zero_grad(set_to_none=True)
    out = tmodel(s["batch"].feats0, s["batch"].pyramid0)
    (torch.sin(out * 3.0) * torch.from_numpy(proj)).sum().backward()
    named = dict(tmodel.named_parameters())
    checked = 0
    for path, g in _flat(jgrads):
        t = named[torch_name(path)].grad.numpy()
        g = np.asarray(g)
        scale = max(float(np.abs(g).max()), 1e-3)
        np.testing.assert_allclose(t, g, rtol=2e-4, atol=2e-4 * scale,
                                   err_msg=torch_name(path))
        checked += 1
    assert checked == len(named)
    for k, b in before.items():
        dict(tmodel.named_buffers())[k].copy_(b)
