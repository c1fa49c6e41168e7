"""The port's VoteNet against the JAX package's, on a small VoteNet
(Res16UNet14A sparse-conv backbone, 2 scenes x 2000 points, 5 cm voxels,
16 proposals by vote FPS; set-up in ``torch_votenet_common.py``):
byte-identical batches, a strict weight load, train- and eval-mode
``end_points`` and the LR / BN-momentum schedules.  The steps, the AP
evaluation and the trainer's save / resume are in
``test_torch_votenet_steps.py``.

Tolerances (f32, JAX at "highest" matmul precision): end_points rtol/atol
2e-4, as ``tests/test_torch_model.py`` holds the backbone: train-mode BN
amplifies summation-order noise.  Integer outputs (FPS, ball query, object
assignment) are equal."""
import numpy as np
import pytest
import torch
from torch_threads import two_torch_threads  # noqa: F401  (autouse)
from torch_votenet_common import (  # noqa: F401  (run: a module fixture)
    BN_MOMENTUM,
    INT_FIELDS,
    TOL,
    _flat,
    _torch_model,
    run,
)

from pointcontrast_tpu.detect.train import DetectConfig as JDetectConfig
from pointcontrast_tpu.detect.train import get_bn_momentum as j_bn_momentum
from pointcontrast_tpu.detect.train import get_current_lr as j_current_lr
from pointcontrast_tpu_torch.data import PadScheme
from pointcontrast_tpu_torch.detect.datasets import LABEL_FIELDS, collate_detection
from pointcontrast_tpu_torch.detect.train import (
    DetectConfig,
    batch_to_inputs,
    get_bn_momentum,
    get_current_lr,
)
from pointcontrast_tpu_torch.tools.from_jax import jax_state_dict


def test_detection_batch_byte_identical(run):
    jb, tb = run["jbatch"], run["tbatch"]
    for f in ("point_clouds", "voxel_feats", "point_voxel_idx") + LABEL_FIELDS:
        a, b = np.asarray(getattr(jb, f)), np.asarray(getattr(tb, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert a.tobytes() == b.tobytes(), f
    jp, tp = jb.voxel_pyramid, tb.voxel_pyramid
    assert jp.num_batch == tp.num_batch and len(jp.levels) == len(tp.levels)
    for l, (jl, tl) in enumerate(zip(jp.levels, tp.levels)):
        for f in ("nbr", "valid", "batch", "down_nbr", "up_parent", "up_offset",
                  "nbr0"):
            a, b = getattr(jl, f), getattr(tl, f)
            assert (a is None) == (b is None), (l, f)
            if a is not None:
                assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), (l, f)
        assert jl.rev == tl.rev


def test_detection_batch_to_rejects_foreign_rows(run):
    tb = run["tbatch"]
    tb.to("cpu")
    s0 = tb.voxel_feats.shape[0] // 2
    bad = tb.point_voxel_idx.copy()
    bad[1, 7] = s0 - 1  # sample 1 pointing into sample 0's slice
    with pytest.raises(ValueError, match="point_voxel_idx"):
        type(tb)(**{**tb.__dict__, "point_voxel_idx": bad}).to("cpu")
    with pytest.raises(ValueError, match="layout"):
        collate_detection([{"point_clouds": np.zeros((4, 3), np.float32)}],
                          voxel_size=0.05, scheme=PadScheme(npad0=512),
                          layout="brick")


def test_strict_weight_load(run):
    params, bs, _ = run["states"][0]
    model = _torch_model(run["states"][0])
    n_jax = sum(1 for _ in _flat(params)) + sum(1 for _ in _flat(bs))
    assert len(model.state_dict()) == n_jax
    names = set(jax_state_dict(params, bs))
    for name in ("backbone_net.net.conv0p1s1.weight", "vgen.conv1.weight",
                 "vgen.bn1.running_var", "pnet.vote_aggregation.mlp.layer0.weight",
                 "pnet.vote_aggregation.mlp.bn0.weight", "pnet.conv3.bias"):
        assert name in names, name


def _compare_end_points(got: dict, want: dict):
    compared = 0
    for k, w in want.items():
        if k not in got or not isinstance(w, np.ndarray):
            continue
        g = got[k].detach().numpy()
        if k in INT_FIELDS or k in ("object_assignment", "objectness_label"):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, err_msg=k, **TOL)
        compared += 1
    return compared


def test_end_points_match_jax(run):
    """Train mode at the initial state (the fields of the first step's
    forward and loss) and eval mode after one step (running stats set)."""
    from pointcontrast_tpu_torch.detect.loss import get_loss

    tb = run["tbatch"].to("cpu")
    model = _torch_model(run["states"][0])
    for m in model.modules():
        if hasattr(m, "momentum"):
            m.momentum = BN_MOMENTUM
    model.train()
    ep = model(batch_to_inputs(tb))
    ep.update({k: getattr(tb, k) for k in LABEL_FIELDS})
    _, ep = get_loss(ep, run["dc"])
    assert _compare_end_points(ep, run["train_eps"][0]) >= 30

    model = _torch_model(run["states"][1]).eval()
    with torch.no_grad():
        ep = model(batch_to_inputs(tb))
    assert _compare_end_points(ep, run["eval_ep"]) >= 15


def test_schedules_match_jax():
    tcfg = DetectConfig(bn_decay_step=3, lr_decay_steps=(2, 5, 7))
    jcfg = JDetectConfig(bn_decay_step=3, lr_decay_steps=(2, 5, 7))
    for epoch in range(40):
        assert get_current_lr(epoch, tcfg) == j_current_lr(epoch, jcfg)
        assert get_bn_momentum(epoch, tcfg) == j_bn_momentum(epoch, jcfg)
