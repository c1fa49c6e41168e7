"""The port's pretraining host pipeline and CLI on the CPU: ``Compose`` /
``Jitter`` draw what JAX's draw; ``ScanNetMatchPairDataset`` on a
fabricated ``data_f25`` tree gives JAX's samples; ``PairLoader``'s first two
hardest batches (2 workers) are the JAX loader's, byte for byte, a dataset
error is raised from ``__next__`` while production goes on, and ``close()``
ends the producer; ``apps.pretrain.main`` in both trainer modes writes
checkpoints, resumes, exits requeueable on a triggered preemption guard,
and leaves weights the semseg CLI loads; what the port does not run raises
before any work.  A resumed run takes the command line on top of its
snapshot, except a change to ``net.*`` or ``data.*``, which all three CLIs
refuse."""
import os

import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.data import PadScheme as JPadScheme
from pointcontrast_tpu.data import PairLoader as JPairLoader
from pointcontrast_tpu.data import ScanNetMatchPairDataset as JScanNet
from pointcontrast_tpu.data import SyntheticPairDataset as JDataset
from pointcontrast_tpu.data import transforms as jtransforms
from pointcontrast_tpu_torch.apps import pretrain as app
from pointcontrast_tpu_torch.apps import semseg as semseg_app
from pointcontrast_tpu_torch.apps import votenet as votenet_app
from pointcontrast_tpu_torch.apps.semseg import _pretrained
from pointcontrast_tpu_torch.config import (
    Config,
    load_config,
    maybe_resume_config,
    save_config,
)
from pointcontrast_tpu_torch.data import (
    PadScheme,
    PairLoader,
    ScanNetMatchPairDataset,
    SyntheticPairDataset,
)
from pointcontrast_tpu_torch.data import transforms
from pointcontrast_tpu_torch.data.collate import HARDEST_FIELDS
from pointcontrast_tpu_torch.nn import registry
from pointcontrast_tpu_torch.nn.res16unet import Res16UNet14
from pointcontrast_tpu_torch.utils import preemption


def _same_bytes(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), what


def test_compose_jitter_draws_equal_jax():
    rng = np.random.RandomState(0)
    coords = rng.randint(0, 50, (200, 3)).astype(np.float64)
    feats = np.ones((200, 3))
    for seed in range(6):  # p = 0.95: both branches among these seeds
        got = transforms.Compose([transforms.Jitter(), transforms.Jitter(p=0.5)])(
            coords, feats, rng=np.random.RandomState(seed))
        want = jtransforms.Compose([jtransforms.Jitter(), jtransforms.Jitter(p=0.5)])(
            coords, feats, rng=np.random.RandomState(seed))
        for g, w in zip(got, want):
            _same_bytes(g, w, f"seed {seed}")


def _pair_tree(root):
    """Two pairs of .npz frames with a 'pcd' array in the nested
    data_f25/<scene>/pcd/<frame>.npz layout, and their three-column list
    (as tests/test_real_format_fixtures.py::test_scannet_pair_tree)."""
    rng = np.random.RandomState(0)
    lines = []
    for scene, (f0, f1) in [("scene0589_00", (850, 1150)), ("scene0571_00", (125, 1275))]:
        d = root / "data_f25" / scene / "pcd"
        os.makedirs(d)
        base = rng.rand(800, 3) * 1.5
        np.savez(d / f"{f0}.npz", pcd=np.concatenate([base, rng.rand(100, 3) * 1.5]))
        np.savez(d / f"{f1}.npz", pcd=np.concatenate(
            [base + rng.randn(*base.shape) * 0.005, rng.rand(100, 3) * 1.5]))
        lines.append(f"data_f25/{scene}/pcd/{f0}.npz data_f25/{scene}/pcd/{f1}.npz "
                     "0.794144556267")
    (root / "overlap-30.txt").write_text("\n".join(lines) + "\n")
    return "overlap-30.txt"


def test_scannet_pair_dataset_matches_jax(tmp_path):
    listing = _pair_tree(tmp_path)
    kw = dict(random_scale=True, seed=0)
    got = ScanNetMatchPairDataset(str(tmp_path), listing,
                                  transform=transforms.Compose([transforms.Jitter()]), **kw)
    want = JScanNet(str(tmp_path), listing,
                    transform=jtransforms.Compose([jtransforms.Jitter()]), **kw)
    assert len(got) == len(want) == 2
    # the dataset's own stream in order, then a per-task RandomState
    samples = [(got[i], want[i]) for i in (0, 1, 0)]
    samples.append((got.__getitem__(1, rng=np.random.RandomState(5)),
                    want.__getitem__(1, rng=np.random.RandomState(5))))
    for n, (g, w) in enumerate(samples):
        assert len(g[6]) > 100  # overlapping views match
        assert not np.all(g[4] == 1.0)  # the features were jittered
        for k, (a, b) in enumerate(zip(g, w)):
            _same_bytes(a, b, f"sample {n} item {k}")


LOADER = dict(batch_size=2, mode="hardest", npos=16, num_pos=128, num_hn=64,
              num_workers=2, seed=3, layout="chunked")


@pytest.mark.parametrize("shard", [None, 0, 1])
def test_pair_loader_batches_match_jax(shard):
    """One loader, or shard ``shard`` of 2 (a data-parallel rank's: sampler
    shard and rng salt 13, as JAX's)."""
    kw = dict(num_pairs=4, points_per_frame=300, seed=0)
    shards = {} if shard is None else dict(num_shards=2, shard_id=shard)
    tl = PairLoader(SyntheticPairDataset(**kw), scheme=PadScheme(npad0=2048), **LOADER,
                    **shards)
    jl = JPairLoader(JDataset(**kw), scheme=JPadScheme(npad0=2048), fuse_frames=True,
                     **LOADER, **shards)
    try:
        for _ in range(2):
            tb, jb = next(tl), next(jl)
            for name in ("feats0", "truncated_voxels") + HARDEST_FIELDS:
                _same_bytes(getattr(tb, name), getattr(jb, name), name)
            for t, j in zip(tb.pyramid0.levels, jb.pyramid0.levels):
                _same_bytes(t.nbr, j.nbr, "nbr")
    finally:
        tl.close()
        jl.close()
    assert not tl._thread.is_alive()


class _Flaky(SyntheticPairDataset):
    """Raises on its first sample, then serves."""

    calls = 0

    def __getitem__(self, idx, rng=None):
        type(self).calls += 1
        if type(self).calls == 1:
            raise OSError("unreadable frame")
        return super().__getitem__(idx, rng)


def test_loader_reraises_and_keeps_producing():
    loader = PairLoader(_Flaky(num_pairs=2, points_per_frame=200, seed=0),
                        scheme=PadScheme(npad0=2048), **LOADER)
    try:
        with pytest.raises(OSError, match="unreadable"):
            next(loader)
        batch = next(loader)
        assert batch.pos_valid.sum() > 0
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    # a loader feeds one device: data parallelism runs a process per device
    with pytest.raises(ValueError, match="one process per device"):
        PairLoader(_Flaky(num_pairs=2), 2, PadScheme(npad0=2048), num_device_batches=2)


class Res16UNetNarrow(Res16UNet14):
    PLANES, INIT_DIM = (4, 8, 16, 32, 32, 16, 8, 8), 4


def _cli(tmp_path, trainer, max_iter, *extra):
    return ["data.dataset=SyntheticPairDataset", "data.num_pairs=4",
            "data.points_per_frame=300", "data.npad0=2048", "trainer.batch_size=2",
            f"trainer.trainer={trainer}", "trainer.num_pos_per_batch=32",
            "trainer.num_hn_samples_per_batch=16", "misc.npos=64",
            "net.model=Res16UNetNarrow", "net.model_n_out=8", "net.dtype=float32",
            f"opt.max_iter={max_iter}", "trainer.stat_freq=1",
            f"misc.out_dir={tmp_path}", "distributed.num_devices=1", *extra]


@pytest.fixture
def narrow_model(monkeypatch):
    monkeypatch.setitem(registry.MODELS, "Res16UNetNarrow", Res16UNetNarrow)


@pytest.mark.parametrize("trainer", ["HardestContrastiveLossTrainer", "PointNCELossTrainer"])
def test_cli_trains_resumes_requeues_and_feeds_semseg(tmp_path, trainer, narrow_model,
                                                      monkeypatch):
    weights = tmp_path / "weights"
    run, history = app.main(_cli(tmp_path, trainer, 2), device="cpu")
    assert [i for i, _ in history] == [1, 2] and run.config.mode == (
        "hardest" if trainer.startswith("Hardest") else "nce")
    assert all(np.isfinite(m["loss"]) for _, m in history)
    assert ("pos_loss" in history[0][1]) == trainer.startswith("Hardest")
    assert (weights / "checkpoint_2.pth").exists()
    assert (tmp_path / "config.yaml").exists()

    # a second call resumes from the checkpoint: the command line's larger
    # max_iter holds over the snapshot's
    resumed, history = app.main(_cli(tmp_path, trainer, 3), device="cpu")
    assert [i for i, _ in history] == [3] and resumed.curr_iter == 3

    # a preemption signal: checkpoint, requeue marker, requeueable exit
    monkeypatch.setattr(preemption.PreemptionGuard, "preempted", property(lambda g: True))
    with pytest.raises(SystemExit) as exit_:
        app.main(_cli(tmp_path, trainer, 5), device="cpu")
    assert exit_.value.code == preemption.REQUEUE_EXIT_CODE
    assert (tmp_path / preemption.REQUEUE_MARKER).read_text().strip() == "4"
    assert (weights / "checkpoint_4.pth").exists()

    state = _pretrained(str(weights))
    model = Res16UNetNarrow(in_channels=3, out_channels=8, normalize_feature=True)
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("override,error", [
    ("distributed.num_devices=-1", ValueError),
    ("data.fuse_frames=false", NotImplementedError),
    ("trainer.trainer=ContrastiveLossTrainer", ValueError),
    ("data.dataset=ScanNetPairs", ValueError),
])
def test_cli_refuses_what_is_not_ported(tmp_path, override, error, narrow_model):
    with pytest.raises(error):
        app.main(_cli(tmp_path, "HardestContrastiveLossTrainer", 1, override),
                 device="cpu")
    assert not (tmp_path / "weights").exists()


def test_cli_needs_a_card_unless_told_otherwise(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        app.main(_cli(tmp_path, "HardestContrastiveLossTrainer", 1))


def test_resume_takes_overrides_but_keeps_net_and_data(tmp_path):
    fresh = Config({"net": {"model": "B"}})
    assert maybe_resume_config(str(tmp_path), fresh, ["net.model=B"]) is fresh
    save_config(Config({"net": {"model": "A", "dtype": "bfloat16"}, "data": {"npad0": 8},
                        "opt": {"max_iter": 3}}), str(tmp_path / "config.yaml"))
    cfg = maybe_resume_config(str(tmp_path), fresh,
                              ["opt.max_iter=5", "net.model=A", "data.npad0=8"])
    assert cfg.to_dict() == {"net": {"model": "A", "dtype": "bfloat16"},
                             "data": {"npad0": 8}, "opt": {"max_iter": 5}}
    for ov in ("net.model=B", "net.dtype=float32", "data.npad0=16", "data.layout=voxel",
               "data={}"):
        with pytest.raises(ValueError, match=ov.partition("=")[0].replace(".", r"\.")):
            maybe_resume_config(str(tmp_path), fresh, ["opt.max_iter=5", ov])


@pytest.mark.parametrize("cli,out_key", [(app, "misc.out_dir"), (semseg_app, "train.out_dir"),
                                         (votenet_app, "misc.out_dir")])
def test_every_cli_refuses_a_resume_that_changes_the_net(tmp_path, cli, out_key):
    out = f"{out_key}={tmp_path}"
    snap = load_config(cli.DEFAULT_CONFIG, [out])
    save_config(snap, str(tmp_path / "config.yaml"))
    with pytest.raises(ValueError, match=r"net\.model"):
        cli.main([out, "net.model=SomeOtherNet"], device="cpu")
    assert sorted(os.listdir(tmp_path)) == ["config.yaml"]
