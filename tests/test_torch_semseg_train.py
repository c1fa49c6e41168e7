"""The port's semseg train step, trajectory and validation against the JAX
package's ``make_semseg_train_step`` and ``evaluate_dataset``, on the CPU,
from the same initial variables (a narrow Res16UNet, and a BilateralCRF of
2 mean-field iterations over it, defined here on both sides):

- one step with iter_size 1 and with iter_size 2 (two different
  sub-batches, BN statistics carried from one to the next);
- the CRF wrapper's step with the filter applied and skipped (a skipped
  filter's kernel still moves by SGD's weight decay, as in JAX), with the
  filter's own LR group;
- a 3-step trajectory under PolyLR;
- ``evaluate_dataset``'s mIoU over a whole synthetic split.

Tolerances (f32, JAX at "highest" matmul precision): the first loss rtol
1e-5; later losses rtol 1e-4; parameters and running statistics rtol/atol
1e-4 (SGD at lr 0.1 through train-mode BN amplifies summation-order noise);
accuracies and the validation's confusion counts equal."""
import jax
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.nn.res16unet import Res16UNetBase as JBase
from pointcontrast_tpu.nn.resnet_block import BasicBlock as JBlock
from pointcontrast_tpu.semseg import crf as jcrf
from pointcontrast_tpu.semseg.dataset import collate_semseg as j_collate
from pointcontrast_tpu.semseg.datasets.synthetic import (
    SyntheticSemsegDataset as JSynthetic,
)
from pointcontrast_tpu.semseg.train import SemsegConfig as JConfig
from pointcontrast_tpu.semseg.train import evaluate_dataset as j_evaluate_dataset
from pointcontrast_tpu.semseg.train import make_semseg_train_step as j_make_step
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu.train.state import create_train_state
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.nn.res16unet import Res16UNetBase
from pointcontrast_tpu_torch.nn.resnet_block import BasicBlock
from pointcontrast_tpu_torch.semseg.crf import BilateralCRF
from pointcontrast_tpu_torch.semseg.dataset import collate_semseg
from pointcontrast_tpu_torch.semseg.datasets.synthetic import SyntheticSemsegDataset
from pointcontrast_tpu_torch.semseg.train import (
    SemsegConfig,
    evaluate_dataset,
    make_semseg_train_step,
)
from pointcontrast_tpu_torch.tools.from_jax import load_jax_params, torch_name
from pointcontrast_tpu_torch.tools.workload import SemsegScenes
from pointcontrast_tpu_torch.train import optim

CLASSES = 5
TOL = dict(rtol=1e-4, atol=1e-4)
CRF = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0,
           chromatic_sigma=12.0)
_TINY = dict(INIT_DIM=4, PLANES=(4, 8, 8, 8, 8, 8, 4, 4), LAYERS=(1,) * 8)
JTiny = type("JTiny", (JBase,), dict(BLOCK=JBlock, **_TINY))
TTiny = type("TTiny", (Res16UNetBase,), dict(BLOCK=BasicBlock, **_TINY))
CFG = dict(lr=0.1, max_iter=60, wrapper_lr=0.05)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.fixture(scope="module")
def batches():
    """Three batches of two scenes each (with the CRF map), both packages."""
    scenes = SemsegScenes(scenes=6, points=1500, room=1.2, voxel=0.05,
                          classes=CLASSES).samples
    out = {}
    for name, collate, scheme in (("j", j_collate, JPadScheme),
                                  ("t", collate_semseg, PadScheme)):
        rng = np.random.RandomState(0)
        out[name] = [collate(scenes[2 * i: 2 * i + 2], scheme(npad0=4096), rng=rng,
                             shift_coords=True, layout="chunked", crf=CRF,
                             num_chunks=2) for i in range(3)]
    return out


@pytest.fixture(scope="module")
def jax_init(batches):
    """``init(crf, tx)``: JAX's initial train state of the narrow net (the
    CRF wrapper's with ``crf``) with optimizer ``tx``.  One
    ``create_train_state`` (one traced init) a model, shared by the cases
    that start from it: a case swaps in its own optimizer."""
    jb = batches["j"]
    states = {}

    def init(crf, tx):
        if crf not in states:
            model = JTiny(in_channels=3, out_channels=CLASSES)
            if crf:
                model = jcrf.BilateralCRF(net=model, nchannels=CLASSES, kernel_volume=13,
                                          meanfield_iterations=2)
            inputs = (jb[0].feats, jb[0].pyramid) + ((jb[0].crf_nbr,) if crf else ())
            states[crf] = create_train_state(jax.random.PRNGKey(0), model, tx, inputs)
        state = states[crf]
        return state.replace(tx=tx, opt_state=tx.init(state.params))

    return init


def _jax_run(batches, jax_init, crf: bool, iter_size: int, apply_filter: bool, steps: int):
    jax.config.update("jax_default_matmul_precision", "highest")
    jb = batches["j"]
    cfg = JConfig(iter_size=iter_size, **CFG)
    tx = j_optim.make_optimizer("sgd", cfg.lr, j_optim.make_scheduler("polylr", cfg),
                                cfg, param_lr_scales={"filter": 0.5} if crf else None)
    state = jax_init(crf, tx)
    init = (jax.device_get(state.params), jax.device_get(state.batch_stats))
    step = jax.jit(lambda s, b: j_make_step(cfg, wrapper=crf,
                                            apply_filter=apply_filter)(s, b))
    metrics = []
    for i in range(steps):
        if iter_size == 1:
            batch = jb[i % 3]
        else:
            batch = jax.tree.map(lambda *xs: np.stack(xs), *jb[:iter_size])
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return dict(init=init, metrics=metrics, params=jax.device_get(state.params),
                stats=jax.device_get(state.batch_stats))


def _torch_run(batches, jrun, crf: bool, iter_size: int, apply_filter: bool,
               steps: int):
    model = TTiny(in_channels=3, out_channels=CLASSES)
    if crf:
        model = BilateralCRF(model, CLASSES, 13, 2)
    load_jax_params(model, *jrun["init"])
    cfg = SemsegConfig(iter_size=iter_size, **CFG)
    opt = optim.make_optimizer(model, cfg, {"filter": 0.5} if crf else None)
    sched = optim.make_scheduler(opt, cfg, "polylr")
    step = make_semseg_train_step(cfg)
    dev = [b.to("cpu") for b in batches["t"]]
    metrics = []
    for i in range(steps):
        subs = [dev[i % 3]] if iter_size == 1 else dev[:iter_size]
        metrics.append({k: float(v)
                        for k, v in step(model, opt, sched, subs, apply_filter).items()})
    return model, metrics


def _check(model, metrics, jrun):
    for got, want in zip(metrics, jrun["metrics"]):
        assert set(got) == set(want)
        assert got["acc"] == pytest.approx(want["acc"], abs=1e-6)
        assert got["truncated_voxels"] == want["truncated_voxels"]
    np.testing.assert_allclose(metrics[0]["loss"], jrun["metrics"][0]["loss"], rtol=1e-5)
    np.testing.assert_allclose([m["loss"] for m in metrics],
                               [m["loss"] for m in jrun["metrics"]], rtol=1e-4)
    named = dict(model.named_parameters())
    for path, v in _flat(jrun["params"]):
        name = torch_name(path, model)
        np.testing.assert_allclose(named[name].detach().numpy(), v, err_msg=name, **TOL)
    buffers = dict(model.named_buffers())
    for path, v in _flat(jrun["stats"]):
        name = torch_name(path, model)
        np.testing.assert_allclose(buffers[name].numpy(), v, err_msg=name, **TOL)


@pytest.mark.parametrize("crf,iter_size,apply_filter,steps", [
    (False, 1, True, 3),  # one step, then the 3-step trajectory
    (False, 2, True, 1),
    (True, 1, True, 1),
    (True, 1, False, 1),
])
def test_train_steps_match_jax(batches, jax_init, crf, iter_size, apply_filter, steps):
    jrun = _jax_run(batches, jax_init, crf, iter_size, apply_filter, steps)
    model, metrics = _torch_run(batches, jrun, crf, iter_size, apply_filter, steps)
    _check(model, metrics, jrun)
    if crf:
        kernel = model.filter.weight.detach().numpy()
        moved = np.abs(kernel - jrun["init"][0]["filter"]["kernel"]).max()
        assert moved > 0  # weight decay moves even a skipped filter


def test_evaluate_dataset_matches_jax(batches):
    jax.config.update("jax_default_matmul_precision", "highest")
    kw = dict(num_scenes=3, points=1500)
    jds, tds = JSynthetic(phase="val", **kw), SyntheticSemsegDataset(phase="val", **kw)
    for i in range(3):
        for a, b in zip(jds.__getitem__(i, rng=np.random.RandomState(i)),
                        tds.__getitem__(i, rng=np.random.RandomState(i))):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    model = JTiny(in_channels=3, out_channels=tds.num_classes)
    jb = batches["j"][0]
    state = create_train_state(jax.random.PRNGKey(1), model,
                               j_optim.sgd(0.1), (jb.feats, jb.pyramid))
    want = j_evaluate_dataset(state, jds, JPadScheme(npad0=4096), tds.num_classes,
                              batch_size=2, layout="chunked")
    tmodel = load_jax_params(TTiny(in_channels=3, out_channels=tds.num_classes),
                             jax.device_get(state.params),
                             jax.device_get(state.batch_stats))
    got = evaluate_dataset(tmodel, tds, PadScheme(npad0=4096), tds.num_classes, "cpu",
                           batch_size=2)
    assert got[3] == want[3] == 3  # every scene once
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-9)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-9)
