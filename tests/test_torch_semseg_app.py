"""The port's semseg app on the CPU: the ``semseg`` CLI trains, validates
the whole split, saves and resumes with nothing left to train; what it does
not run raises before any work; its augmented samples and its loader's
batches are the JAX app's, byte for byte; and a pretraining checkpoint
transfers leniently into the backbone (of a CRF wrapper too)."""
import json
import os

import numpy as np
import pytest
import torch

from torch_threads import two_torch_threads  # noqa: F401  (autouse)

from pointcontrast_tpu.apps import semseg as japp
from pointcontrast_tpu.config import load_config as j_load_config
from pointcontrast_tpu.data.collate import PadScheme as JPadScheme
from pointcontrast_tpu.semseg.dataset import SemsegLoader
from pointcontrast_tpu_torch.apps import semseg as app
from pointcontrast_tpu_torch.config import load_config
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.semseg.dataset import SemsegBatches
from pointcontrast_tpu_torch.semseg.train import SemsegConfig, SemsegTrainer
from pointcontrast_tpu_torch.tools.workload import semseg_model

CLI = ["data.dataset=SyntheticSemsegDataset", "net.model=Res16UNet14A",
       "net.dtype=float32", "data.layout=chunked", "data.batch_size=2",
       "data.npad0=4096", "optimizer.max_iter=2", "train.stat_freq=1",
       "train.val_freq=2", "train.save_freq=100", "distributed.num_devices=1"]


def test_cli_trains_validates_saves_and_resumes(tmp_path):
    args = CLI + [f"train.out_dir={tmp_path}"]
    trainer, history = app.main(args, device="cpu")
    assert [i for i, _ in history] == [1, 2]
    assert all(np.isfinite(m["loss"]) for _, m in history)
    weights = tmp_path / "weights"
    assert (weights / "checkpoint_2.pth").exists()
    best = json.loads((weights / "best" / "best.json").read_text())
    assert best["step"] == 2 and 0.0 <= best["miou"] <= 100.0
    assert trainer.best_miou == best["miou"]
    lines = [json.loads(l) for l in (weights / "metrics.jsonl").read_text().splitlines()]
    assert [l["iter"] for l in lines] == [1, 2, 2] and "val_miou" in lines[-1]

    resumed, history = app.main(args, device="cpu")
    assert history == [] and resumed.curr_iter == 2
    assert resumed.best_miou == best["miou"]
    for (k, a), b in zip(trainer.model.state_dict().items(),
                         resumed.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=k)


CRF_BF16 = ["net.dtype=bfloat16", "net.wrapper_type=BilateralCRF"]


@pytest.mark.parametrize("override,error", [
    # the shipped YAML's bf16 with the CRF filter: refused until its flat
    # conv's bf16 forms (ROADMAP item 5b's first part); now it trains
    (CRF_BF16, NotImplementedError),
    (["data.dataset=ScannetVoxelization2cmDataset"], NotImplementedError),
    (["net.model=MinkUNetHyper14INBN", "data.layout=brick"], ValueError),
    (["distributed.num_devices=2"], NotImplementedError),
    (["net.wrapper_type=TrilateralCRF"], ValueError),
])
def test_cli_refuses_what_is_not_ported(tmp_path, override, error):
    """What the port does not run raises before any work starts; the bf16
    CRF filter, which it runs since its flat conv's bf16 forms, trains two
    steps with a bf16 backbone and validates."""
    if override is CRF_BF16:
        trainer, history = app.main(CLI + override + ["net.wrapper_iterations=2",
                                                      f"train.out_dir={tmp_path}"],
                                    device="cpu")
        assert trainer.model.net.dtype == torch.bfloat16
        assert [i for i, _ in history] == [1, 2]
        assert (tmp_path / "weights" / "checkpoint_2.pth").exists()
        return
    with pytest.raises(error):
        app.main(CLI + override + [f"train.out_dir={tmp_path}"], device="cpu")
    assert not os.path.exists(tmp_path / "weights")


def test_cli_needs_a_card_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(CLI + [f"train.out_dir={tmp_path}"])


def test_augmented_samples_and_batches_match_the_jax_app(tmp_path):
    args = CLI + ["net.wrapper_type=BilateralCRF", f"train.out_dir={tmp_path}"]
    jcfg = j_load_config(japp.DEFAULT_CONFIG, list(args))
    tcfg = load_config(app.DEFAULT_CONFIG, list(args))
    jtrain, _ = japp.build_datasets(jcfg)
    ttrain, _ = app.build_datasets(tcfg)
    for i in range(3):
        a = jtrain.__getitem__(i, rng=np.random.RandomState(10 + i))
        b = ttrain.__getitem__(i, rng=np.random.RandomState(10 + i))
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes()
    crf = dict(kernel_size=3, region="hypercross", spatial_sigma=1.0,
               chromatic_sigma=12.0)
    jloader = SemsegLoader(jtrain, 2, JPadScheme(npad0=4096), augment_shift=True,
                           num_workers=1, layout="chunked", crf=crf)
    try:
        want = [next(jloader) for _ in range(2)]
    finally:
        jloader.close()
    tloader = SemsegBatches(ttrain, 2, PadScheme(npad0=4096), augment_shift=True,
                            crf=crf)
    for jb in want:
        tb = next(tloader)
        for f in ("feats", "labels", "crf_nbr"):
            x, y = np.asarray(getattr(jb, f)), getattr(tb, f)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
        assert (np.asarray(jb.pyramid.levels[1].nbr).tobytes()
                == tb.pyramid.levels[1].nbr.tobytes())


@pytest.mark.parametrize("crf", [False, True])
def test_pretrained_weights_transfer_leniently(tmp_path, crf):
    crf_cfg = dict(kernel_size=3, region="hypercross") if crf else None
    source = semseg_model(seed=1, model="Res16UNet14A", classes=32).state_dict()
    source["bn0.running_var"] = torch.full((32,), 2.0)
    model = semseg_model(seed=2, model="Res16UNet14A", classes=4, crf=crf_cfg,
                         iterations=1)
    scenes = [(np.array([[0, 0, 0], [1, 0, 0]], np.int32),
               np.full((2, 3), 100.0, np.float32), np.zeros(2, np.int32))]
    from pointcontrast_tpu_torch.semseg.dataset import collate_semseg

    batch = collate_semseg(scenes, PadScheme(npad0=1024), crf=crf_cfg and {
        **crf_cfg, "spatial_sigma": 1.0, "chromatic_sigma": 12.0})
    trainer = SemsegTrainer(model, iter([batch]), None,
                            SemsegConfig(checkpoint_dir=str(tmp_path)), 4, "cpu",
                            pretrained=source, crf=crf_cfg)
    net = trainer.model.net if crf else trainer.model
    state = net.state_dict()
    torch.testing.assert_close(state["conv0p1s1.weight"], source["conv0p1s1.weight"])
    assert not torch.equal(state["final.weight"][:, :4], source["final.weight"][:, :4])
    # running statistics stay as they were: the transfer takes parameters
    torch.testing.assert_close(state["bn0.running_var"], torch.ones(32))
