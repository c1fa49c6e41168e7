"""The port's BoxNet (``VoteNet(use_voting=False)`` over PointNet++, with
``get_loss_boxnet``) against the JAX package's ``BoxNet`` on the scenes of
``tests/test_torch_pointnet2.py`` (2 synthetic scenes x 2000 points on a
1/64 m grid, 16 proposals by seed FPS), whose reference run this file
reuses: a strict weight load, the float64 loss and end_points (indices
equal, fields to 1e-7 of each field's largest entry), and one float64 step
(loss rtol 1e-5; moments, running stats and weights as that file holds
them)."""
import numpy as np
import pytest
import torch

from pointcontrast_tpu_torch.detect.datasets import LABEL_FIELDS
from pointcontrast_tpu_torch.detect.train import batch_to_inputs, loss_of
from pointcontrast_tpu_torch.detect.votenet import BoxNet
from pointcontrast_tpu_torch.tools.from_jax import jax_state_dict
from test_torch_pointnet2 import (  # noqa: F401  (jops is a fixture)
    BN_MOMENTUM,
    PROPOSALS,
    _check_step,
    _compare_end_points,
    _double,
    _jax_run,
    _model,
    _samples,
    _trainer,
    jops,
)


@pytest.fixture(scope="module")
def run(jops):
    from pointcontrast_tpu.detect.datasets import collate_detection as j_collate
    from pointcontrast_tpu.detect.loss import get_loss_boxnet as j_get_loss_boxnet
    from pointcontrast_tpu.detect.votenet import BoxNet as JBoxNet
    from pointcontrast_tpu_torch.detect.configs import ScannetDatasetConfig
    from pointcontrast_tpu_torch.detect.datasets import collate_detection

    samples = _samples()
    dc = ScannetDatasetConfig()
    model = JBoxNet(num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
                    num_size_cluster=dc.num_size_cluster,
                    mean_size_arr=dc.mean_size_arr, num_proposal=PROPOSALS,
                    backbone="pointnet2", bn_momentum=BN_MOMENTUM)
    return dict(dc=dc, tbatch=collate_detection(samples).to("cpu"),
                boxnet=_jax_run(jops, model, j_get_loss_boxnet, j_collate(samples),
                                1, eval_mode=False))


def test_boxnet_strict_weight_load(run):
    params, bs, _ = run["boxnet"]["states"][0]
    model = _model(run["boxnet"]["states"][0], torch.float32, use_voting=False)
    assert set(model.state_dict()) == set(jax_state_dict(params, bs))
    assert not any(n.startswith("vgen.") for n in model.state_dict())
    assert model.pnet.sampling == "seed_fps"
    dc = run["dc"]
    boxnet = BoxNet(num_class=dc.num_class, num_heading_bin=dc.num_heading_bin,
                    num_size_cluster=dc.num_size_cluster,
                    mean_size_arr=dc.mean_size_arr, num_proposal=PROPOSALS)
    assert not boxnet.use_voting and boxnet.pnet.sampling == "seed_fps"
    assert {k: v.shape for k, v in boxnet.state_dict().items()} == {
        k: v.shape for k, v in model.state_dict().items()}


def test_boxnet_loss_matches_jax(run, tmp_path):
    bn = run["boxnet"]
    model = _model(bn["states"][0], torch.float64, use_voting=False)
    assert loss_of(model).__name__ == "get_loss_boxnet"
    for m in model.modules():
        if hasattr(m, "momentum"):
            m.momentum = BN_MOMENTUM
    batch = _double(run["tbatch"])
    with torch.no_grad():
        ep = model.train()(batch_to_inputs(batch))
        ep.update({k: getattr(batch, k) for k in LABEL_FIELDS})
        loss, ep = loss_of(model)(ep, run["dc"])
    np.testing.assert_allclose(float(loss), bn["losses"][0], rtol=1e-8)
    assert float(ep["vote_loss"]) == 0.0 and "vote_xyz" not in ep
    assert _compare_end_points(ep, bn["train_eps"][0], 1e-7) >= 40


def test_boxnet_step_matches_jax(run, tmp_path):
    _check_step(_trainer(run["boxnet"], 0, tmp_path, use_voting=False),
                run["boxnet"], 0, _double(run["tbatch"]))
