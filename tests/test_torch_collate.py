"""The port's host pipeline against the JAX package's: byte-identical
fused-frame chunked batches, the layout-aware bounds check, and a package
that imports with no JAX installed."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pointcontrast_tpu.data import PadScheme as JPadScheme
from pointcontrast_tpu.data import SyntheticPairDataset as JDataset
from pointcontrast_tpu.data import collate_pair as j_collate
from pointcontrast_tpu.sparse import native as j_native
from pointcontrast_tpu_torch.data import PadScheme, SyntheticPairDataset, collate_pair
from pointcontrast_tpu_torch.sparse import native as t_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# npad0 4096 with flat ratios fits; the ScanNet ratios truncate deep levels
# of this sparse spray; npad0 1024 overflows level 0 and subsamples frames.
SCHEMES = {
    "fits": lambda P: P(npad0=4096, level_ratios=(1.0,) * 5),
    "truncates": lambda P: P.scannet(npad0=4096),
    "overflows": lambda P: P(npad0=1024, level_ratios=(1.0,) * 5),
}
_LEVEL_FIELDS = ("nbr", "valid", "batch", "down_nbr", "up_parent", "up_offset",
                 "nbr0")


def _samples(ds_cls):
    ds = ds_cls(num_pairs=2, points_per_frame=400, seed=0)
    return [ds[0], ds[1]]


def _both_batches(scheme_name):
    kw = dict(mode="nce", npos=128, fuse_frames=True, layout="chunked")
    jb = j_collate(_samples(JDataset), SCHEMES[scheme_name](JPadScheme),
                   rng=np.random.RandomState(7), **kw)
    tb = collate_pair(_samples(SyntheticPairDataset),
                      SCHEMES[scheme_name](PadScheme),
                      rng=np.random.RandomState(7), **kw)
    return jb, tb


def _assert_same_bytes(a, b, what):
    if a is None or b is None:
        assert a is None and b is None, what
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    assert a.tobytes() == b.tobytes(), what


@pytest.mark.parametrize("maps", ["native", "numpy"])
@pytest.mark.parametrize("scheme_name", sorted(SCHEMES))
def test_collate_byte_identical(maps, scheme_name, monkeypatch):
    """Same samples + RandomState -> the same arrays, byte for byte, with
    both kernel-map implementations (native hash join and numpy searchsorted)."""
    if maps == "numpy":
        monkeypatch.setattr(j_native, "get_lib", lambda: None)
        monkeypatch.setattr(t_native, "get_lib", lambda: None)
    else:
        assert j_native.get_lib() is not None and t_native.get_lib() is not None
    jb, tb = _both_batches(scheme_name)
    for name in ("feats0", "q_idx", "k_idx", "pair_valid", "truncated_voxels"):
        _assert_same_bytes(getattr(jb, name), getattr(tb, name), name)
    assert jb.num_pairs == tb.num_pairs
    assert jb.pyramid0.num_batch == tb.pyramid0.num_batch
    assert len(jb.pyramid0.levels) == len(tb.pyramid0.levels)
    for l, (jl, tl) in enumerate(zip(jb.pyramid0.levels, tb.pyramid0.levels)):
        for f in _LEVEL_FIELDS:
            _assert_same_bytes(getattr(jl, f), getattr(tl, f), f"level {l} {f}")
        assert jl.rev == tl.rev and jl.rev0 == tl.rev0
    if scheme_name == "truncates":
        assert float(tb.truncated_voxels) > 0


def test_to_widens_and_keeps_values():
    _, tb = _both_batches("fits")
    moved = tb.to("cpu")
    for hl, tl in zip(tb.pyramid0.levels, moved.pyramid0.levels):
        for f in ("nbr", "down_nbr", "up_parent", "up_offset"):
            if getattr(hl, f) is None:
                continue
            t = getattr(tl, f)
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), getattr(hl, f).astype(np.int32))
        assert tl.rev == hl.rev
    assert moved.q_idx.dtype == torch.int64
    np.testing.assert_array_equal(moved.feats0.numpy(), tb.feats0)


def _corrupt(batch, what):
    lv = batch.pyramid0.levels
    s0 = lv[0].valid.shape[0] // batch.pyramid0.num_batch
    s1 = lv[1].valid.shape[0] // batch.pyramid0.num_batch
    if what == "nbr":
        lv[0].nbr = lv[0].nbr.astype(np.int32)
        lv[0].nbr[3, 1, 5] = s0  # one past its chunk (still < B*S)
    elif what == "down_nbr":
        lv[1].down_nbr = lv[1].down_nbr.astype(np.int32)
        lv[1].down_nbr[0, 0, 0] = s1
    elif what == "up_parent":
        lv[0].up_parent = lv[0].up_parent.astype(np.int32)
        lv[0].up_parent[2, 0] = s1
    elif what == "up_offset":
        lv[2].up_offset = lv[2].up_offset.copy()
        lv[2].up_offset[0, 0] = 8
    elif what == "k_idx":
        batch.k_idx = batch.k_idx.copy()
        batch.k_idx[0] = batch.feats0.shape[0]


@pytest.mark.parametrize(
    "what", ["nbr", "down_nbr", "up_parent", "up_offset", "k_idx"])
def test_bounds_check_rejects_corrupt_map(what):
    """The per-chunk check accepts the real batch and rejects one index past
    its chunk, though it would still lie inside the flat table."""
    _, tb = _both_batches("fits")
    tb.to("cpu")  # accepted
    _corrupt(tb, what)
    with pytest.raises(ValueError, match=what):
        tb.to("cpu")


def test_unsupported_collate_modes_raise():
    samples = _samples(SyntheticPairDataset)
    scheme = SCHEMES["fits"](PadScheme)
    for kw in (dict(mode="hardest"), dict(fuse_frames=False),
               dict(layout="voxl")):
        with pytest.raises(ValueError):
            collate_pair(samples, scheme, **kw)


def test_imports_without_jax():
    """The port, its host pipeline, the brick module, the votenet app and
    its config, sampler, checkpoint and preemption modules import with
    jax/flax/optax and the JAX package unavailable, and build a pretraining
    batch in each layout and a detection batch in both of its own."""
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'optax', 'pointcontrast_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import pointcontrast_tpu_torch\n"
        "from pointcontrast_tpu_torch.data import PadScheme, SyntheticPairDataset, collate_pair\n"
        "import pointcontrast_tpu_torch.nn, pointcontrast_tpu_torch.train\n"
        "import pointcontrast_tpu_torch.tools.from_jax\n"
        "import pointcontrast_tpu_torch.detect.train\n"
        "import pointcontrast_tpu_torch.detect.votenet\n"
        "import pointcontrast_tpu_torch.apps.votenet as app\n"
        "import pointcontrast_tpu_torch.data.sampler\n"
        "import pointcontrast_tpu_torch.train.checkpoint\n"
        "import pointcontrast_tpu_torch.utils.preemption\n"
        "import pointcontrast_tpu_torch.tools.profile_step\n"
        "import pointcontrast_tpu_torch.sparse.brick\n"
        "import pointcontrast_tpu_torch.semseg.dataset\n"
        "from pointcontrast_tpu_torch.config import load_config\n"
        "assert load_config(app.DEFAULT_CONFIG).net.num_proposal == 256\n"
        "from pointcontrast_tpu_torch.detect.datasets import (\n"
        "    SyntheticDetectionDataset, collate_detection)\n"
        "ds = SyntheticPairDataset(num_pairs=1, points_per_frame=200, seed=0)\n"
        "for layout in ('chunked', 'voxel', 'brick:2'):\n"
        "    b = collate_pair([ds[0]], PadScheme(npad0=2048), npos=16,\n"
        "                     rng=np.random.RandomState(0), layout=layout).to('cpu')\n"
        "dd = SyntheticDetectionDataset(num_scenes=1, num_points=1500, seed=0)\n"
        "for layout in ('voxel', 'chunked'):\n"
        "    d = collate_detection([dd[0]], voxel_size=0.05, layout=layout,\n"
        "                          scheme=PadScheme(npad0=4096)).to('cpu')\n"
        "print('ok', b.feats0.shape[0], d.point_voxel_idx.shape[1])\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok")
