"""The port's CLIs in the voxel and brick layouts, on the CPU: ``semseg``
trains two steps and validates the whole split under ``data.layout=voxel``
and ``data.layout=brick``, ``votenet`` trains and evaluates its sparse-conv
backbone under ``data.layout=voxel``, and a config without ``data.layout``
takes ``voxel``, as the JAX apps do."""
import os

import numpy as np
import pytest
import yaml

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu_torch.apps import semseg as semseg_app
from pointcontrast_tpu_torch.apps import votenet as votenet_app
from pointcontrast_tpu_torch.detect import datasets as detect_datasets
from pointcontrast_tpu_torch.sparse.brick import BrickMap

SEMSEG = ["data.dataset=SyntheticSemsegDataset", "net.model=Res16UNet14A",
          "net.dtype=float32", "data.batch_size=2", "data.npad0=4096",
          "optimizer.max_iter=2", "train.stat_freq=1", "train.val_freq=2",
          "train.save_freq=100", "distributed.num_devices=1"]
VOTENET = ["data.dataset=synthetic", "data.num_scenes=2", "data.num_points=2000",
           "data.batch_size=2", "net.backbone=sparseconv", "net.dtype=float32",
           "net.backbone_model=Res16UNet14A", "data.voxel_size=0.05",
           "data.npad0=2048", "net.num_proposal=16", "optimizer.max_epoch=1",
           "eval.eval_every=1", "distributed.num_devices=1"]


def _bricked(trainer) -> int:
    batch = next(trainer._feed)
    return sum(isinstance(l.nbr, BrickMap) for l in batch.pyramid.levels)


@pytest.mark.parametrize("layout,bricked", [("voxel", 0), ("brick", 2)])
def test_semseg_cli_runs_the_layout(tmp_path, layout, bricked):
    trainer, history = semseg_app.main(
        SEMSEG + [f"data.layout={layout}", f"train.out_dir={tmp_path}"], device="cpu")
    assert [i for i, _ in history] == [1, 2] and trainer.layout == layout
    assert all(np.isfinite(m["loss"]) for _, m in history)
    assert 0.0 <= trainer.best_miou <= 100.0  # validated in the layout
    assert _bricked(trainer) == bricked
    assert (tmp_path / "weights" / "checkpoint_2.pth").exists()


def test_votenet_cli_runs_the_voxel_layout(tmp_path, monkeypatch):
    layouts = []
    collate = detect_datasets.collate_detection

    def spy(*args, **kw):
        layouts.append(kw.get("layout"))
        return collate(*args, **kw)

    monkeypatch.setattr(detect_datasets, "collate_detection", spy)
    trainer = votenet_app.main(VOTENET + ["data.layout=voxel",
                                          f"misc.out_dir={tmp_path}"], device="cpu")
    assert trainer.epoch == 1 and set(layouts) == {"voxel"}
    assert (tmp_path / "weights" / "checkpoint_1.pth").exists()


def _without_layout(path, tmp_path):
    with open(path) as f:
        cfg = yaml.safe_load(f)
    del cfg["data"]["layout"]
    out = tmp_path / os.path.basename(path)
    out.write_text(yaml.safe_dump(cfg))
    return str(out)


@pytest.mark.parametrize("app", ["semseg", "votenet"])
def test_config_without_layout_takes_voxel(tmp_path, monkeypatch, app):
    """The shipped YAMLs name ``data.layout``; without it both CLIs take
    ``voxel``, as the JAX apps do (the votenet CLI once took ``chunked``)."""
    if app == "semseg":
        cfg = _without_layout(semseg_app.DEFAULT_CONFIG, tmp_path)
        args = [a for a in SEMSEG if not a.startswith("optimizer.max_iter")]
        trainer, _ = semseg_app.main([cfg] + args + ["optimizer.max_iter=1",
                                                     f"train.out_dir={tmp_path / 'run'}"],
                                     device="cpu")
        assert trainer.layout == "voxel"
        batch = next(trainer._feed)
        assert batch.pyramid.levels[0].nbr.ndim == 2  # flat [K, N]
        return
    layouts = []
    collate = detect_datasets.collate_detection
    monkeypatch.setattr(detect_datasets, "collate_detection",
                        lambda *a, **kw: layouts.append(kw.get("layout")) or collate(*a, **kw))
    cfg = _without_layout(votenet_app.DEFAULT_CONFIG, tmp_path)
    votenet_app.main([cfg] + VOTENET + [f"misc.out_dir={tmp_path / 'run'}"], device="cpu")
    assert layouts and set(layouts) == {"voxel"}
