"""The pretraining workload the JAX package's ``bench.py`` times, for the
port's chip runs: Res16UNet34C, 4 frame pairs per step fused into one sparse
batch of 8 chunks, saturated-surface synthetic frames (~15.5k voxels each at
2.5 cm), ``PadScheme.scannet(npad0=131072)``, 4096 PointInfoNCE pairs."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

PAIRS = 4
NPAD0 = PAIRS * 32768  # both frames fused: 8 chunks of 16384 rows
POINTS_PER_FRAME = 45000  # saturates the visible surfaces at 2.5 cm
ROOM_SIZE = 1.75
NPOS = 4096


def pretrain_batches(device, n_batches: int = 2, pairs: int = PAIRS,
                     npad0: int = NPAD0, points: int = POINTS_PER_FRAME,
                     room: float = ROOM_SIZE, npos: int = NPOS,
                     seed: int = 0) -> list:
    """``n_batches`` collated batches moved (bounds-checked) to ``device``."""
    from pointcontrast_tpu_torch.data import (
        PadScheme,
        SyntheticPairDataset,
        collate_pair,
    )

    ds = SyntheticPairDataset(num_pairs=pairs * 2, points_per_frame=points,
                              room_size=room, seed=seed)
    scheme = PadScheme.scannet(npad0=npad0)
    rng = np.random.RandomState(seed)
    return [
        collate_pair([ds[(b * pairs + i) % len(ds)] for i in range(pairs)],
                     scheme, npos=npos, rng=rng).to(device)
        for b in range(n_batches)
    ]


@contextlib.contextmanager
def plain_ops():
    """Route ``sparse.ops`` through the kernels' plain-torch twins while the
    block runs, on any device: the reference side of a kernels-vs-plain
    comparison of a whole step on the card.  The wrappers themselves never
    fall back; this swaps what ``ops`` calls, process-wide (autograd runs
    CUDA backward functions on its own threads)."""
    from pointcontrast_tpu_torch.sparse import kernels, ops

    saved = {fn.__name__: getattr(ops, fn.__name__) for fn in kernels.KERNELS}
    try:
        for name in saved:
            setattr(ops, name, getattr(kernels, name + "_plain"))
        yield
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)


def pretrain_model(seed: int = 0) -> torch.nn.Module:
    """Res16UNet34C (3 -> 32 channels, L2-normalised), random weights from
    ``seed``, on the CPU."""
    from pointcontrast_tpu_torch.nn.registry import load_model

    return load_model("Res16UNet34C")(
        in_channels=3, out_channels=32, normalize_feature=True,
        generator=torch.Generator().manual_seed(seed))
