"""Feature transforms for pretraining (copy of
``pointcontrast_tpu/data/transforms.py``): ``Compose`` applies (coords,
feats) transforms in order; ``Jitter`` adds gaussian noise to the features
with probability p.  Each draws from the ``rng`` it is given (the loader's
per-task ``RandomState``), else from the global ``np.random``."""
from __future__ import annotations

import numpy as np


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, coords, feats, rng: np.random.RandomState | None = None):
        for t in self.transforms:
            coords, feats = t(coords, feats, rng=rng)
        return coords, feats


class Jitter:
    """Gaussian feature jitter (reference lib/transforms.py:19-30)."""

    def __init__(self, mu: float = 0.0, sigma: float = 0.01, p: float = 0.95):
        self.mu = mu
        self.sigma = sigma
        self.p = p

    def __call__(self, coords, feats, rng: np.random.RandomState | None = None):
        gen = rng if rng is not None else np.random
        if gen.rand() < self.p:
            feats = feats + gen.normal(self.mu, self.sigma, feats.shape)
        return coords, feats
