"""Semseg input transforms: chromatic feature aug + coordinate aug (host
numpy; a copy of ``pointcontrast_tpu/semseg/transforms.py``).

Behavioral mirror of the reference's downstream/semseg/lib/transforms.py
(ChromaticTranslation / ChromaticAutoContrast / ChromaticJitter /
HueSaturationTranslation; RandomDropout / RandomHorizontalFlip /
ElasticDistortion).  All transforms take and return (coords, feats, labels);
randomness draws from an explicit RandomState when provided (the reference
uses global RNG).
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage
from scipy.interpolate import RegularGridInterpolator


def _rng(rng):
    return rng if rng is not None else np.random


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, *args, **kw):
        for t in self.transforms:
            args = t(*args, **kw)
        return args


# --- feature (chromatic) transforms -------------------------------------


class ChromaticTranslation:
    """Random global color shift: 255 * 2 * ratio * (rand - 0.5), p=0.95."""

    def __init__(self, trans_range_ratio: float = 1e-1):
        self.trans_range_ratio = trans_range_ratio

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        if r.rand() < 0.95:
            tr = (r.rand(1, 3) - 0.5) * 255 * 2 * self.trans_range_ratio
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast:
    """Blend with per-cloud contrast-stretched colors, p=0.2."""

    def __init__(self, randomize_blend_factor: bool = True, blend_factor: float = 0.5):
        self.randomize_blend_factor = randomize_blend_factor
        self.blend_factor = blend_factor

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        if r.rand() < 0.2:
            lo = feats[:, :3].min(0, keepdims=True)
            hi = feats[:, :3].max(0, keepdims=True)
            assert hi.max() > 1, "colors must be in [0, 255]"
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (feats[:, :3] - lo) * scale
            blend = r.rand() if self.randomize_blend_factor else self.blend_factor
            feats[:, :3] = (1 - blend) * feats[:, :3] + blend * contrast
        return coords, feats, labels


class ChromaticJitter:
    def __init__(self, std: float = 0.01):
        self.std = std

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        if r.rand() < 0.95:
            noise = r.randn(feats.shape[0], 3) * self.std * 255
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized colorsys-convention RGB([0,255]) -> HSV(h,s in [0,1], v in
    [0,255]) conversion (behavioral equivalent of the reference's helper,
    lib/transforms.py:84-105; the math is the standard hexcone formula).

    Channels beyond the first three pass through unchanged."""
    rgb = np.asarray(rgb, dtype=float)
    out = rgb.copy()
    c = rgb[..., :3]
    v = c.max(axis=-1)
    delta = v - c.min(axis=-1)
    chromatic = delta != 0
    safe_delta = np.where(chromatic, delta, 1.0)
    # Dominant channel decides the hue sextant; argmax resolves ties in
    # r-then-g order, exactly as colorsys's if/elif chain does.
    dom = c.argmax(axis=-1)
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    frac = np.stack([g - b, b - r, r - g], axis=-1)
    frac = np.take_along_axis(frac, dom[..., None], axis=-1)[..., 0] / safe_delta
    hue = ((2.0 * dom + frac) / 6.0) % 1.0
    out[..., 0] = np.where(chromatic, hue, 0.0)
    out[..., 1] = np.where(chromatic, delta / np.where(v == 0, 1.0, v), 0.0)
    out[..., 2] = v
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Inverse of :func:`rgb_to_hsv` via the branch-free hexcone identity
    f(n) = v - v*s*clip(min(k, 4-k), 0, 1) with k = (n + 6h) mod 6
    (r, g, b = f(5), f(3), f(1)); returns uint8 like the reference."""
    hsv = np.asarray(hsv)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    out = np.empty_like(hsv)
    out[..., 3:] = hsv[..., 3:]
    for channel, n in ((0, 5.0), (1, 3.0), (2, 1.0)):
        k = np.mod(n + h * 6.0, 6.0)
        out[..., channel] = v * (1.0 - s * np.clip(np.minimum(k, 4.0 - k), 0.0, 1.0))
    return out.astype("uint8")


class HueSaturationTranslation:
    def __init__(self, hue_max: float, saturation_max: float):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        hsv = rgb_to_hsv(feats[:, :3])
        hue_val = (r.rand() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (r.rand() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


# --- coordinate transforms ------------------------------------------------


class RandomDropout:
    def __init__(self, dropout_ratio: float = 0.2, dropout_application_ratio: float = 0.5):
        self.dropout_ratio = dropout_ratio
        self.dropout_application_ratio = dropout_application_ratio

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        # Faithful reference quirk (lib/transforms.py:154): the APPLICATION
        # gate tests dropout_ratio, and dropout_application_ratio is stored
        # but never used.  Kept bug-for-bug for training parity.
        if r.rand() < self.dropout_ratio:
            n = len(coords)
            inds = r.choice(n, int(n * (1 - self.dropout_ratio)), replace=False)
            return coords[inds], feats[inds], labels[inds]
        return coords, feats, labels


class RandomHorizontalFlip:
    def __init__(self, upright_axis: str, is_temporal: bool = False):
        self.is_temporal = is_temporal
        self.d = 4 if is_temporal else 3
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.horz_axes = set(range(self.d)) - {self.upright_axis}

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        if r.rand() < 0.95:
            for ax in self.horz_axes:
                if r.rand() < 0.5:
                    coord_max = np.max(coords[:, ax])
                    coords[:, ax] = coord_max - coords[:, ax]
        return coords, feats, labels


class ElasticDistortion:
    """Blurred noise grid + trilinear displacement interpolation
    (reference lib/transforms.py:182-225)."""

    def __init__(self, distortion_params):
        self.distortion_params = distortion_params

    @staticmethod
    def elastic_distortion(coords, granularity, magnitude, rng=None):
        """Displace coords by a smoothed random vector field.

        The field lives on a coarse grid with cell size ``granularity``
        covering the cloud's bounding box (one spare cell on each side), is
        smoothed by two passes of a separable 3-tap box filter, and is
        sampled at each point by trilinear interpolation; out-of-grid points
        are left undisplaced."""
        r = _rng(rng)
        lo = coords.min(0)
        cells = ((coords.max(0) - lo) // granularity).astype(int) + 3
        field = r.randn(*cells, 3).astype(np.float32)
        for _ in range(2):
            for axis in range(3):
                field = ndimage.uniform_filter1d(
                    field, size=3, axis=axis, mode="constant"
                )
        grid_axes = [
            lo[a] + granularity * (np.arange(cells[a]) - 1.0) for a in range(3)
        ]
        sample = RegularGridInterpolator(
            grid_axes, field, bounds_error=False, fill_value=0
        )
        return coords + sample(coords) * magnitude

    def __call__(self, coords, feats, labels, rng=None):
        r = _rng(rng)
        if self.distortion_params is not None and r.rand() < 0.95:
            for granularity, magnitude in self.distortion_params:
                coords = self.elastic_distortion(coords, granularity, magnitude, rng)
        return coords, feats, labels
