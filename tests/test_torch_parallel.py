"""Data parallelism in the port (``pointcontrast_tpu_torch/parallel``) on the
CPU: two gloo ranks, spawned with a join timeout, against JAX's
``data_parallel_step`` over a 2-device virtual CPU mesh and against one
process that averages the ranks' gradients.

- Shards: rank r's ``PairLoader`` and semseg loader batches are JAX's
  shard r's, byte for byte (the pair loader's cases are in
  ``tests/test_torch_pretrain_app.py``).
- Against JAX: ``PretrainTrainer`` on 2 ranks, 3 steps of NCE and 1 of
  hardest, from JAX ``tests/test_parallel.py``'s ``TinyUNet`` weights
  carried across with ``tools/from_jax.py``; each rank its own batch, JAX's
  mesh the two stacked.  Tolerances of ``tests/test_torch_pretrain.py``:
  the first loss rtol 1e-5, later losses rtol 1e-4, parameters rtol and
  atol 1e-4; rank 0's BN running stats against JAX's returned state
  (device 0's copy) to the same.  The ranks' parameters are bit-equal.
  The hardest mode's argmin picks flip at near-ties once the two sides'
  parameters differ in their last bits (``tests/test_torch_hardest.py``
  prints how many): in one process, without DDP, its pos_loss is 6e-6
  off JAX's at the second step and 4.5e-4 at the third, so one step is
  what rtol 1e-4 can hold after the first.
- Identities of the port (exact: DDP's all-reduce of two ranks is
  ``g0 / 2 + g1 / 2``, one rounding, as the one process computes it): the
  same batch on both ranks is the one-process step; 5 semseg steps with
  the CRF filter (skipped on steps 1-4, applied on 5, the same coin on
  both ranks) and ``iter_size=2``, and a sparse VoteNet step, each equal to
  one process that averages the two ranks' gradients.
- Checkpoints hold the module's names (no ``module.``) under DDP, load
  into an unwrapped model and back, and through ``tools/from_jax.py``.
- The pretrain CLI at ``distributed.num_devices=2``: one checkpoint, by
  rank 0; ``metrics.jsonl`` holds the mean of the ranks' losses; a resume
  at world 1, then one at world 2 from that world-1 checkpoint that a
  SIGUSR1 to rank 1 alone preempts: both ranks exit requeueable at the
  same step, and the marker is written.
- The launcher fails with a failing rank's traceback and leaves no rank
  behind; ``distributed.num_devices`` resolves to the visible cards.
"""
import contextlib
import json
import multiprocessing
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)
import torch_parallel_ranks as ranks

from pointcontrast_tpu.apps import semseg as jsemseg_app
from pointcontrast_tpu.config import load_config as j_load_config
from pointcontrast_tpu.data import PadScheme as JPadScheme
from pointcontrast_tpu.data import SyntheticPairDataset as JDataset
from pointcontrast_tpu.data import collate_pair as j_collate
from pointcontrast_tpu.nn.res16unet import Res16UNetBase as JBase
from pointcontrast_tpu.nn.resnet_block import BasicBlock as JBlock
from pointcontrast_tpu.parallel import make_mesh, replicate, shard_batch
from pointcontrast_tpu.parallel.mesh import data_parallel_step
from pointcontrast_tpu.semseg.dataset import SemsegLoader
from pointcontrast_tpu.train import PretrainConfig as JConfig
from pointcontrast_tpu.train import make_train_step as j_make_train_step
from pointcontrast_tpu.train import optim as j_optim
from pointcontrast_tpu.train.state import create_train_state
from pointcontrast_tpu_torch.apps import pretrain as app
from pointcontrast_tpu_torch.apps import semseg as semseg_app
from pointcontrast_tpu_torch.config import load_config
from pointcontrast_tpu_torch.data import PadScheme, SyntheticPairDataset, collate_pair
from pointcontrast_tpu_torch.losses.semseg import cross_entropy_ignore
from pointcontrast_tpu_torch.nn import registry
from pointcontrast_tpu_torch.parallel import launch
from pointcontrast_tpu_torch.semseg.dataset import SemsegBatches
from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer, forward
from pointcontrast_tpu_torch.tools.from_jax import jax_state_dict, torch_name
from pointcontrast_tpu_torch.train import PretrainConfig, PretrainTrainer, make_train_step
from pointcontrast_tpu_torch.train import optim
from pointcontrast_tpu_torch.utils import preemption

JOIN_S = 180  # a deadlock fails its test, not the suite
LR_FREQ = 2  # the 3 steps cross an ExpLR step
STEPS = {"nce": 3, "hardest": 1}
SEMSEG_STEPS = 5  # RandomState(0)'s coin skips the filter on 1-4, applies it on 5
PAIR = dict(npos=64, num_pos=64, num_hn=32, fuse_frames=True, layout="chunked")


class JTiny(JBase):
    BLOCK = JBlock
    LAYERS, PLANES, INIT_DIM = ranks.TinyUNet.LAYERS, ranks.TinyUNet.PLANES, ranks.TinyUNet.INIT_DIM


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _pair_batches(collate, ds_cls, scheme_cls, mode):
    """One batch a rank: pair r, collated with RandomState(r)."""
    ds = ds_cls(num_pairs=2, points_per_frame=400, seed=0)
    scheme = scheme_cls(npad0=2048, level_ratios=(1.0,) * 5)
    return [collate([ds[r]], scheme, mode=mode, rng=np.random.RandomState(r), **PAIR)
            for r in range(2)]


def _jax_data_parallel(mode):
    """JAX's 2-device data_parallel_step, STEPS[mode] times on the two stacked
    batches: (initial params, initial stats, losses, final state)."""
    jb = _pair_batches(j_collate, JDataset, JPadScheme, mode)
    jcfg = JConfig(mode=mode, npos=PAIR["npos"], lr=0.1, lr_update_freq=LR_FREQ)
    tx = j_optim.make_optimizer(
        "sgd", jcfg.lr, j_optim.exp_lr(jcfg.exp_gamma, LR_FREQ, stepped=True), jcfg)
    state = create_train_state(jax.random.PRNGKey(0),
                               JTiny(in_channels=3, out_channels=8, normalize_feature=True),
                               tx, (jb[0].feats0, jb[0].pyramid0))
    params0, stats0 = jax.device_get(state.params), jax.device_get(state.batch_stats)
    stacked = jax.tree.map(lambda *xs: np.stack([np.asarray(x) for x in xs])
                           if hasattr(xs[0], "ndim") else xs[0], *jb)
    mesh = make_mesh(2)
    step = data_parallel_step(j_make_train_step(jcfg), mesh, donate_state=False)
    state, batch = replicate(state, mesh), shard_batch(stacked, mesh)
    metrics = []
    for _ in range(STEPS[mode]):
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in jax.device_get(m).items()})
    return params0, stats0, metrics, jax.device_get(state)


@contextlib.contextmanager
def _join_timeout():
    """Kill the spawned ranks after JOIN_S seconds: the launch then fails
    with their exit codes, and a deadlock fails its test."""
    done = threading.Event()

    def watchdog():
        if not done.wait(JOIN_S):
            for p in multiprocessing.active_children():
                p.kill()

    thread = threading.Thread(target=watchdog, daemon=True)
    thread.start()
    try:
        yield
    finally:
        done.set()
        thread.join()


def _semseg_spec(tmp):
    from pointcontrast_tpu_torch.semseg.datasets.synthetic import SyntheticSemsegDataset
    from pointcontrast_tpu_torch.tools.workload import semseg_model

    crf = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0, chromatic_sigma=12.0)
    ds = SyntheticSemsegDataset(num_scenes=4, points=400)
    model = semseg_model(seed=3, model="TinyUNet", classes=ds.num_classes,
                         crf=crf, iterations=1)
    batches = []
    for r in range(2):
        loader = SemsegBatches(ds, 1, PadScheme(npad0=2048), crf=crf,
                               num_shards=2, shard_id=r)
        batches.append([next(loader) for _ in range(1 + 2 * SEMSEG_STEPS)])
    config = dict(lr=0.1, iter_size=2, stat_freq=1, val_freq=10 ** 9,
                  save_freq=10 ** 9)
    return dict(model=model, batches=batches, config=config, crf=crf,
                classes=ds.num_classes, steps=SEMSEG_STEPS, dir=str(tmp / "semseg"))


def _votenet_spec(tmp):
    from pointcontrast_tpu_torch.detect.datasets import (
        SyntheticDetectionDataset,
        collate_detection,
    )
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    ds = SyntheticDetectionDataset(num_scenes=4, num_objects=3, num_points=2000,
                                   augment=False)
    scheme = PadScheme(npad0=4096, level_ratios=(1.0, 1.0, 0.5, 0.25, 0.12))
    batches = [collate_detection([ds[2 * r], ds[2 * r + 1]], voxel_size=0.05,
                                 scheme=scheme, layout="chunked") for r in range(2)]
    return dict(model=votenet_model(seed=0, backbone_model="TinyUNet", num_proposal=16),
                dc=ds.dc, batches=batches, dir=str(tmp / "votenet"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    jax_runs, spec = {}, {}
    for mode in ("nce", "hardest"):
        params0, stats0, metrics, state = _jax_data_parallel(mode)
        jax_runs[mode] = dict(metrics=metrics, state=state)
        tb = _pair_batches(collate_pair, SyntheticPairDataset, PadScheme, mode)
        start = jax_state_dict(params0, stats0)
        config = dict(mode=mode, lr=0.1, lr_update_freq=LR_FREQ)
        spec[mode] = dict(state=start, config=config, dir=str(tmp / mode),
                          batches=[[b] * STEPS[mode] for b in tb])
        if mode == "nce":
            spec["same"] = dict(state=start, config=config, dir=str(tmp / "same"),
                                batches=[[tb[0]], [tb[0]]])
            spec["names"] = dict(jax_params=params0, jax_stats=stats0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.MODELS, "TinyUNet", ranks.TinyUNet)
        spec["semseg"] = _semseg_spec(tmp)
        spec["votenet"] = _votenet_spec(tmp)
    got = launch.run(2, ranks.all_ranks, (ranks.rank_checks, spec), timeout=JOIN_S)
    return dict(jax=jax_runs, spec=spec, ranks=got, tmp=tmp)


def _bit_equal(a: dict, b: dict, what):
    assert a.keys() == b.keys(), what
    for k in a:
        assert np.array_equal(a[k], b[k]), f"{what}: {k}"


@pytest.mark.parametrize("mode", ["nce", "hardest"])
def test_two_ranks_match_jax_data_parallel_step(runs, mode):
    r0, r1 = (r[mode] for r in runs["ranks"])
    assert r0["net"] == "DistributedDataParallel"
    want = runs["jax"][mode]
    keys = ("loss",) + (("pos_loss", "neg_loss") if mode == "hardest" else ())
    for k in keys:
        got = [m[k] for m in r0["history"]]
        jax_k = [m[k] for m in want["metrics"]]
        np.testing.assert_allclose(got[0], jax_k[0], rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(got, jax_k, rtol=1e-4, err_msg=k)
    assert [m["loss"] for m in r1["history"]] == [m["loss"] for m in r0["history"]]
    for path, p in _flat(want["state"].params):
        name = torch_name(path)
        np.testing.assert_allclose(r0["params"][name], np.asarray(p), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    for path, v in _flat(want["state"].batch_stats):  # device 0's copy
        name = torch_name(path)
        np.testing.assert_allclose(r0["buffers"][name], np.asarray(v), rtol=1e-4,
                                   atol=1e-4, err_msg=name)
    _bit_equal(r0["params"], r1["params"], f"{mode}: rank 0 vs rank 1")


def test_identical_batches_equal_one_process(runs):
    s = runs["spec"]["same"]
    model = ranks.TinyUNet(in_channels=3, out_channels=8, normalize_feature=True)
    model.load_state_dict(s["state"])
    cfg = PretrainConfig(**s["config"], stat_freq=1, save_freq=10 ** 9,
                         checkpoint_dir=str(runs["tmp"] / "same_single"))
    trainer = PretrainTrainer(model, s["batches"][0], cfg, "cpu")
    (_, m), = trainer.train(1)
    for r in runs["ranks"]:
        assert r["same"]["history"][0]["loss"] == m["loss"]
        _bit_equal(r["same"]["params"], ranks.params_of(trainer.model), "same batch")


def _averaged(model, grads: list) -> None:
    """Set each parameter's gradient to DDP's mean of the ranks' (absent on
    every rank: left absent)."""
    for name, p in model.named_parameters():
        gs = [g[name] for g in grads]
        p.grad = None if gs[0] is None else gs[0] / 2 + gs[1] / 2


def _grads(model) -> dict:
    return {n: None if p.grad is None else p.grad.clone()
            for n, p in model.named_parameters()}


def test_semseg_crf_iter_size_equals_averaged_step(runs):
    s = runs["spec"]["semseg"]
    r0, r1 = (r["semseg"] for r in runs["ranks"])
    assert r0["draws"] == r1["draws"] == [False] * 4 + [True]
    _bit_equal(r0["params"], r1["params"], "semseg: rank 0 vs rank 1")

    ref = SemsegTrainer(s["model"], iter(s["batches"][0]), None,
                        SemsegConfig(**s["config"], checkpoint_dir=s["dir"] + "_ref"),
                        num_classes=s["classes"], device="cpu", crf=s["crf"])
    coin = np.random.RandomState(0)
    losses = []
    for step in range(SEMSEG_STEPS):
        apply_filter = coin.rand() < 0.5
        grads, loss = [], 0.0
        for r in range(2):
            ref.model.train()
            ref.opt.zero_grad(set_to_none=True)
            for sub in s["batches"][r][1 + 2 * step:3 + 2 * step]:
                sub = sub.to("cpu")
                out = cross_entropy_ignore(forward(ref.model, sub, apply_filter),
                                           sub.labels, 255)
                out.backward()
                loss += float(out.detach()) / 4
            grads.append(_grads(ref.model))
        _averaged(ref.model, grads)
        for p in ref.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            else:
                p.grad.mul_(0.5)
        ref.opt.step()
        ref.sched.step()
        losses.append(loss)
    np.testing.assert_allclose(r0["loss"], losses, rtol=1e-6)
    _bit_equal(r0["params"], ranks.params_of(ref.model), "semseg vs one process")


def test_votenet_step_equals_averaged_step(runs):
    from pointcontrast_tpu_torch.detect.train import (
        DetectConfig,
        DetectTrainer,
        batch_to_inputs,
        batch_to_labels,
        get_bn_momentum,
        get_current_lr,
        loss_of,
    )

    s = runs["spec"]["votenet"]
    r0, r1 = (r["votenet"] for r in runs["ranks"])
    _bit_equal(r0["params"], r1["params"], "votenet: rank 0 vs rank 1")
    cfg = DetectConfig(checkpoint_dir=s["dir"] + "_ref")
    ref = DetectTrainer(s["model"], s["dc"], cfg, "cpu")
    ref.set_lr(get_current_lr(0, cfg))
    ref.set_bn_momentum(get_bn_momentum(0, cfg))
    grads, losses = [], []
    for r in range(2):
        ref.model.train()
        ref.opt.zero_grad(set_to_none=True)
        batch = s["batches"][r].to("cpu")
        end_points = ref.model(batch_to_inputs(batch))
        end_points.update(batch_to_labels(batch))
        loss, _ = loss_of(ref.model)(end_points, s["dc"])
        loss.backward()
        losses.append(float(loss))
        grads.append(_grads(ref.model))
    _averaged(ref.model, grads)
    ref.opt.step()
    np.testing.assert_allclose(r0["loss"], np.mean(losses), rtol=1e-6)
    _bit_equal(r0["params"], ranks.params_of(ref.model), "votenet vs one process")


def test_checkpoints_carry_no_ddp_prefix(runs):
    names = runs["ranks"][0]["names"]
    plain = ranks.TinyUNet(in_channels=3, out_channels=8, normalize_feature=True)
    assert names["saved_names"] == sorted(plain.state_dict())
    assert names["wrapped_names"] == sorted("module." + k for k in plain.state_dict())
    spec = runs["spec"]["names"]
    want = jax_state_dict(spec["jax_params"], spec["jax_stats"])
    for k, v in want.items():
        assert np.array_equal(names["reloaded"][k], v.numpy()), k
    # the 2-rank NCE run's only checkpoint, rank 0's, into an unwrapped model
    ckpt_dir = runs["tmp"] / "nce"
    assert sorted(os.listdir(ckpt_dir)) == ["checkpoint_3.pth", "metrics.jsonl"]
    payload = torch.load(ckpt_dir / "checkpoint_3.pth")
    plain.load_state_dict(payload["model"], strict=True)
    r0 = runs["ranks"][0]["nce"]
    _bit_equal(ranks.params_of(plain), r0["params"], "checkpoint")
    _bit_equal(ranks.buffers_of(plain), r0["buffers"], "checkpoint buffers")
    logged = [json.loads(l)["loss"] for l in
              (ckpt_dir / "metrics.jsonl").read_text().splitlines()]
    assert logged == [m["loss"] for m in r0["history"]]


def test_launch_fails_with_the_rank_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose") as err:
        launch.run(2, ranks.fail_on, (1,), timeout=JOIN_S)
    assert "rank 1 of 2 failed" in str(err.value) and "Traceback" in str(err.value)
    assert time.monotonic() - t0 < JOIN_S
    assert not multiprocessing.active_children()


@pytest.mark.parametrize("requested,visible,want", [
    (0, 3, 3), (2, 3, 2), (4, 3, ValueError), (-1, 3, ValueError)])
def test_num_devices_resolves_to_the_visible_cards(monkeypatch, requested, visible, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: visible)
    if want is ValueError:
        with pytest.raises(ValueError, match=f"num_devices={requested}"):
            launch.resolve_world_size(requested, "cuda")
        return
    assert launch.resolve_world_size(requested, "cuda") == want
    assert launch.resolve_world_size(requested, "cpu") == (requested or 1)


def test_parallel_package_imports_without_jax():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'pointcontrast_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import pointcontrast_tpu_torch.parallel.launch\n"
        "import pointcontrast_tpu_torch.parallel.mesh\n"
        "import pointcontrast_tpu_torch.parallel.multihost\n"
        "import pointcontrast_tpu_torch.train.checkpoint\n"
        "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


@pytest.mark.parametrize("shard", [0, 1])
def test_semseg_loader_shards_match_jax(tmp_path, shard):
    args = ["data.dataset=SyntheticSemsegDataset", "data.batch_size=2",
            "net.wrapper_type=BilateralCRF", f"train.out_dir={tmp_path}"]
    jtrain, _ = jsemseg_app.build_datasets(j_load_config(jsemseg_app.DEFAULT_CONFIG, list(args)))
    ttrain, _ = semseg_app.build_datasets(load_config(semseg_app.DEFAULT_CONFIG, list(args)))
    crf = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0,
               chromatic_sigma=12.0)
    kw = dict(augment_shift=True, layout="chunked", crf=crf, seed=5, num_shards=2,
              shard_id=shard)
    jloader = SemsegLoader(jtrain, 2, JPadScheme(npad0=4096), num_workers=1, **kw)
    try:
        want = [next(jloader) for _ in range(2)]
    finally:
        jloader.close()
    tloader = SemsegBatches(ttrain, 2, PadScheme(npad0=4096), **kw)
    for jb in want:
        tb = next(tloader)
        for f in ("feats", "labels", "crf_nbr"):
            x, y = np.asarray(getattr(jb, f)), getattr(tb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        assert (np.asarray(jb.pyramid.levels[1].nbr).tobytes()
                == tb.pyramid.levels[1].nbr.tobytes())


def _cli(out, max_iter, world):
    return ["data.dataset=SyntheticPairDataset", "data.num_pairs=4",
            "data.points_per_frame=300", "data.npad0=2048", "trainer.batch_size=1",
            "trainer.trainer=HardestContrastiveLossTrainer",
            "trainer.num_pos_per_batch=32", "trainer.num_hn_samples_per_batch=16",
            "misc.npos=64", "misc.num_workers=1", "net.model=TinyUNet",
            "net.model_n_out=8", "net.dtype=float32", "trainer.stat_freq=1",
            f"opt.max_iter={max_iter}", f"misc.out_dir={out}",
            f"distributed.num_devices={world}"]


def _first_losses(out) -> list:
    """Each rank's first-step loss, recomputed in this process: the CLI's
    model from its seed on the first batch of shard r."""
    from pointcontrast_tpu_torch.data.loader import PairLoader

    cfg = load_config(app.DEFAULT_CONFIG, _cli(out, 2, 2))
    scheme = PadScheme(npad0=2048, level_ratios=tuple(cfg.data.pad_ratios))
    losses = []
    for r in range(2):
        loader = PairLoader(app.build_dataset(cfg), batch_size=1, scheme=scheme,
                            mode="hardest", npos=64, num_pos=32, num_hn=16,
                            num_workers=1, seed=0, layout=cfg.data.layout,
                            num_shards=2, shard_id=r)
        try:
            batch = next(loader).to("cpu")
        finally:
            loader.close()
        model = ranks.TinyUNet(in_channels=3, out_channels=8, bn_momentum=0.05,
                               normalize_feature=True,
                               generator=torch.Generator().manual_seed(0))
        tcfg = PretrainConfig(mode="hardest", lr=0.1)
        opt = optim.make_optimizer(model, tcfg)
        losses.append(float(make_train_step(tcfg)(model, opt, optim.make_scheduler(opt, tcfg),
                                                  batch)["loss"]))
    return losses


def _signal_rank1_when(path, at_least: int, done: threading.Event):
    """Send SIGUSR1 to rank 1 alone once ``path`` logs iter ``at_least``."""
    while not done.is_set():
        lines = path.read_text().splitlines() if path.exists() else []
        if lines and json.loads(lines[-1])["iter"] >= at_least:
            for p in multiprocessing.active_children():
                if p.name == "rank1":
                    os.kill(p.pid, signal.SIGUSR1)
                    return
        time.sleep(0.02)


def test_cli_two_ranks_save_once_log_the_mean_resume_and_requeue(tmp_path, monkeypatch):
    monkeypatch.setitem(registry.MODELS, "TinyUNet", ranks.TinyUNet)
    monkeypatch.setenv("OMP_NUM_THREADS", str(ranks.THREADS))
    out, weights = tmp_path / "run", tmp_path / "run" / "weights"
    with _join_timeout():
        trainer, history = app.main(_cli(out, 2, 2), device="cpu")
    assert trainer is None and [i for i, _ in history] == [1, 2]
    assert sorted(os.listdir(weights)) == ["checkpoint_2.pth", "metrics.jsonl"]
    logged = [json.loads(l) for l in (weights / "metrics.jsonl").read_text().splitlines()]
    assert [l["iter"] for l in logged] == [1, 2]
    np.testing.assert_allclose(logged[0]["loss"], np.mean(_first_losses(out)), rtol=1e-6)
    assert logged[0]["loss"] == history[0][1]["loss"]

    # the 2-rank checkpoint resumes in one process
    resumed, history = app.main(_cli(out, 3, 1), device="cpu")
    assert resumed.curr_iter == 3 and [i for i, _ in history] == [3]
    assert (weights / "checkpoint_3.pth").exists()

    # the 1-process checkpoint resumes on 2 ranks; a SIGUSR1 to rank 1 alone
    # stops both at one step: rank 0 saves and writes the marker, both requeue
    done = threading.Event()
    watcher = threading.Thread(target=_signal_rank1_when,
                               args=(weights / "metrics.jsonl", 4, done), daemon=True)
    watcher.start()
    try:
        with pytest.raises(SystemExit) as exit_, _join_timeout():
            app.main(_cli(out, 60, 2), device="cpu")
    finally:
        done.set()
        watcher.join()
    assert exit_.value.code == preemption.REQUEUE_EXIT_CODE
    step = int((out / preemption.REQUEUE_MARKER).read_text())
    assert 4 <= step < 60
    assert f"checkpoint_{step}.pth" in os.listdir(weights)
    logged = [json.loads(l)["iter"] for l in (weights / "metrics.jsonl").read_text().splitlines()]
    assert logged[-1] == step
