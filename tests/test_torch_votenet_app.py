"""The port's ``votenet`` CLI (``pointcontrast_tpu_torch.apps.votenet``) on
the CPU: the shipped config with ``net.backbone=pointnet2`` on 2 synthetic
scenes of 2000 points trains one epoch, evaluates, saves a checkpoint, and
a second call resumes from it without training again; what the port does
not run raises before any work starts; without a card and with no device
given it raises instead of falling back to the CPU.  Also the config
module: the three shipped YAML files load as ``yaml.safe_load`` reads them,
with ``k=v`` overrides, and ``save_config`` round-trips."""
import os
import types

import pytest
import torch

PROPOSALS = 16


CLI_ARGS = ["data.dataset=synthetic", "data.num_scenes=2", "data.num_points=2000",
            "data.batch_size=2", "net.backbone=pointnet2",
            f"net.num_proposal={PROPOSALS}", "optimizer.max_epoch=1",
            "eval.eval_every=1", "distributed.num_devices=1"]


def test_cli_trains_evaluates_saves_and_resumes(tmp_path):
    from pointcontrast_tpu_torch.apps import votenet as app

    out = str(tmp_path / "run")
    args = CLI_ARGS + [f"misc.out_dir={out}"]
    trainer = app.main(args, device="cpu")
    assert trainer.epoch == 1 and trainer.device.type == "cpu"
    assert os.path.exists(os.path.join(out, "weights", "checkpoint_1.pth"))
    assert os.path.exists(os.path.join(out, "config.yaml"))
    state = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    resumed = app.main(args, device="cpu")  # nothing left to train
    assert resumed.epoch == 1
    for k, v in resumed.model.state_dict().items():
        torch.testing.assert_close(v, state[k], rtol=0, atol=0, msg=k)


HYPER_BF16 = ["net.backbone=sparseconv", "net.backbone_model=MinkUNetHyper14INBN"]


@pytest.mark.parametrize("override,match", [
    # the shipped YAML's bf16 on a MinkUNetHyper backbone: refused (its
    # unpools' "net.dtype=float32" advice) until their bf16 forms, ROADMAP
    # item 5b's first part; now it passes the check
    (HYPER_BF16, "net.dtype=float32"),
    (["data.dataset=sunrgbd"], "SUN RGB-D"),
    (["distributed.num_devices=2"], "item 7"),
    (["net.backbone=sparseconv", "net.dtype=float32", "data.layout=brick"], "chunked"),
])
def test_cli_refuses_what_is_not_ported(tmp_path, override, match):
    """What the port does not run raises before any work starts; the bf16
    Hyper backbone, which it runs since its pools' bf16 forms, passes
    ``check_supported`` in the shipped bf16 (its training run:
    ``tests/test_torch_bf16.py::test_votenet_cli_refuses_a_bf16_hyper_backbone``)."""
    from pointcontrast_tpu_torch.apps import votenet as app
    from pointcontrast_tpu_torch.config import load_config, net_dtype

    args = [f"misc.out_dir={tmp_path / 'run'}"] + override
    if override is HYPER_BF16:
        cfg = load_config(app.DEFAULT_CONFIG, args)
        assert net_dtype(cfg) == torch.bfloat16
        app.check_supported(cfg, torch.device("cpu"))
        return
    with pytest.raises(NotImplementedError, match=match):
        app.main(args, device="cpu")
    assert not os.path.exists(tmp_path / "run")


def test_cli_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    from pointcontrast_tpu_torch.apps import votenet as app

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(CLI_ARGS + [f"misc.out_dir={tmp_path / 'run'}"])


def test_config_round_trips_and_parses_the_shipped_yaml(tmp_path):
    import yaml

    from pointcontrast_tpu_torch.config import load_config, save_config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name in ("pretrain_default.yaml", "semseg_default.yaml",
                 "votenet_default.yaml"):
        path = os.path.join(root, "configs", name)
        cfg = load_config(path, ["net.extra=[1.0, 0.8]", "misc.flag=true"])
        with open(path) as f:
            want = yaml.safe_load(f)
        want.setdefault("net", {})["extra"] = [1.0, 0.8]
        want.setdefault("misc", {})["flag"] = True
        assert cfg.to_dict() == want, name
        save_config(cfg, str(tmp_path / name))
        assert load_config(str(tmp_path / name)).to_dict() == want, name


@pytest.mark.parametrize("sampler,kw", [
    ("InfSampler", {}),
    ("DistributedInfSampler", {}),
    ("DistributedInfSampler", {"num_shards": 3, "shard_id": 0}),
    ("DistributedInfSampler", {"num_shards": 3, "shard_id": 2}),
])
def test_samplers_draw_as_the_jax_package_does(sampler, kw):
    """The port's copies draw the JAX package's sequence: the CLI's
    single-shard ``DistributedInfSampler`` visits the scenes in the JAX
    app's order (``InfSampler`` pops them in another), and shards stay
    disjoint across passes of a length that does not divide."""
    from pointcontrast_tpu.data import sampler as jax_sampler

    from pointcontrast_tpu_torch.data import sampler as port_sampler

    want = getattr(jax_sampler, sampler)(7, seed=3, **kw)
    got = getattr(port_sampler, sampler)(7, seed=3, **kw)
    assert [next(got) for _ in range(30)] == [next(want) for _ in range(30)]


def test_net_weights_transfer_a_pretrained_backbone(tmp_path):
    """``net.weights``: a PretrainTrainer checkpoint (Res16UNet 3 -> 32)
    loads into the sparse-conv VoteNet's ``backbone_net.net`` (3 -> 256)
    where names and shapes match; the rest keeps its own weights."""
    from pointcontrast_tpu_torch.apps import votenet as app
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer
    from pointcontrast_tpu_torch.nn.registry import load_model
    from pointcontrast_tpu_torch.train.checkpoint import lenient_filter
    from pointcontrast_tpu_torch.tools.workload import votenet_model

    pretrained = load_model("Res16UNet14A")(
        in_channels=3, out_channels=32, generator=torch.Generator().manual_seed(7))
    os.makedirs(tmp_path / "pretrain")
    torch.save({"model": pretrained.state_dict()},
               tmp_path / "pretrain" / "checkpoint_40.pth")
    trainer = DetectTrainer(votenet_model(0, "Res16UNet14A", PROPOSALS),
                            ScannetDatasetConfig(),
                            DetectConfig(checkpoint_dir=str(tmp_path / "w")), "cpu")
    net = trainer.model.backbone_net.net
    before = {k: v.clone() for k, v in net.state_dict().items()}
    _, loaded, skipped = lenient_filter(before, pretrained.state_dict())
    assert loaded and skipped  # the 256-wide head does not fit
    app._transfer_backbone(trainer, str(tmp_path / "pretrain"))
    after, source = net.state_dict(), pretrained.state_dict()
    for k in loaded:
        torch.testing.assert_close(after[k], source[k], rtol=0, atol=0, msg=k)
    for k in skipped:
        torch.testing.assert_close(after[k], before[k], rtol=0, atol=0, msg=k)


def test_trainer_saves_and_stops_when_preempted(tmp_path):
    """A fired PreemptionGuard: after the step the trainer saves, raises
    Preempted, and a new trainer resumes from that checkpoint.  (The step
    itself is stubbed: the model tests hold it to JAX.)"""
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.train import DetectConfig, DetectTrainer
    from pointcontrast_tpu_torch.tools.workload import votenet_model
    from pointcontrast_tpu_torch.utils.preemption import Preempted, PreemptionGuard

    cfg = DetectConfig(checkpoint_dir=str(tmp_path))
    trainer = DetectTrainer(votenet_model(0, num_proposal=8, backbone="pointnet2"),
                            ScannetDatasetConfig(), cfg, "cpu")
    batch = types.SimpleNamespace(point_clouds=torch.zeros(1))  # already on the device
    steps = []
    trainer._step = lambda model, opt, batch: steps.append(batch) or {
        "loss": torch.tensor(1.0)}
    guard = PreemptionGuard(install=False)
    trainer.preemption_guard = guard
    assert trainer.train_epoch(iter([batch]), 1) == 1.0 and trainer.epoch == 1
    guard.trigger()
    with pytest.raises(Preempted) as err:
        trainer.train_epoch(iter([batch]), 1)
    assert err.value.step == 1 and len(steps) == 2
    assert os.path.exists(tmp_path / "checkpoint_1.pth")
    resumed = DetectTrainer(votenet_model(1, num_proposal=8, backbone="pointnet2"),
                            ScannetDatasetConfig(), cfg, "cpu")
    assert resumed.epoch == 1
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)
