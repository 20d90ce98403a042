"""Point-cloud train-time augmentation (host-side numpy).

Copy of ``dropclip_tpu/data/augmentations.py`` (numpy and scipy, both on
the card's machine). Same transform set and distributions as the reference
(reference utils/augmentations.py:19-284, itself adapted from OpenScene):
color translation / auto-contrast / jitter / HSV shift on RGB features,
horizontal flips, elastic distortion, and per-object blob removal on
coordinates. These run on the host inside the input pipeline, beside the
device's work. Every transform takes an explicit ``np.random.Generator``
(deterministic, per-worker foldable seeds; the reference uses process
globals) and blob removal returns a KEEP MASK instead of deleting rows,
so downstream padding stays static-shape.
"""

from __future__ import annotations

import colorsys
from typing import List, Optional, Sequence, Tuple

import numpy as np
import scipy.interpolate
import scipy.ndimage


class ChromaticTranslation:
    """Random global color offset (reference augmentations.py:19-32)."""

    def __init__(self, trans_range_ratio: float = 0.1, p: float = 0.95):
        self.ratio = trans_range_ratio
        self.p = p

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        if rng.random() < self.p:
            tr = (rng.random((1, 3)) - 0.5) * 255 * 2 * self.ratio
            feats = feats.copy()
            feats[:, :3] = np.clip(tr + feats[:, :3], 0, 255)
        return coords, feats, labels


class ChromaticAutoContrast:
    """Blend toward min-max contrast stretch (reference :35-56)."""

    def __init__(self, randomize_blend_factor: bool = True,
                 blend_factor: float = 0.4, p: float = 0.2):
        self.randomize = randomize_blend_factor
        self.blend = blend_factor
        self.p = p

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        if rng.random() < self.p:
            lo = np.min(feats, 0, keepdims=True)
            hi = np.max(feats, 0, keepdims=True)
            scale = 255 / np.maximum(hi - lo, 1e-6)
            contrast = (feats - lo) * scale
            b = rng.random() if self.randomize else self.blend
            feats = (1 - b) * feats + b * contrast
        return coords, feats, labels


class ChromaticJitter:
    """Per-point gaussian color noise (reference :59-70 — note the
    reference multiplies by BOTH mean and std*255; kept)."""

    def __init__(self, std: float = 0.1, mean: float = 0.5, p: float = 0.95):
        self.std = std
        self.mean = mean
        self.p = p

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        if rng.random() < self.p:
            noise = rng.standard_normal((feats.shape[0], 3)) * self.mean
            noise *= self.std * 255
            feats = feats.copy()
            feats[:, :3] = np.clip(noise + feats[:, :3], 0, 255)
        return coords, feats, labels


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.rgb_to_hsv on 0..255 arrays -> h,s in 0..1,
    v in 0..255 (reference :76-97)."""
    rgb = rgb.astype(float)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb[..., :3].max(-1)
    minc = rgb[..., :3].min(-1)
    hsv = np.zeros_like(rgb)
    hsv[..., 2] = maxc
    rngc = np.where(maxc != minc, maxc - minc, 1.0)
    hsv[..., 1] = np.where(maxc != minc, (maxc - minc) / np.maximum(maxc, 1e-12), 0)
    rc = (maxc - r) / rngc
    gc = (maxc - g) / rngc
    bc = (maxc - b) / rngc
    h = np.select([r == maxc, g == maxc], [bc - gc, 2.0 + rc - bc],
                  default=4.0 + gc - rc)
    hsv[..., 0] = np.where(maxc != minc, (h / 6.0) % 1.0, 0.0)
    return hsv


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Vectorized colorsys.hsv_to_rgb -> uint8 (reference :100-120,
    including the uint8 truncation)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype("uint8")
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = i % 6
    conds = [s == 0.0, i == 1, i == 2, i == 3, i == 4, i == 5]
    rgb = np.empty_like(hsv)
    rgb[..., 0] = np.select(conds, [v, q, p, p, t, v], default=v)
    rgb[..., 1] = np.select(conds, [v, v, v, q, p, p], default=t)
    rgb[..., 2] = np.select(conds, [v, p, t, v, v, q], default=p)
    return rgb.astype("uint8")


class HueSaturationTranslation:
    """Random hue shift + saturation scale (reference :123-134)."""

    def __init__(self, hue_max: float = 0.5, saturation_max: float = 0.2):
        self.hue_max = hue_max
        self.saturation_max = saturation_max

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        feats = feats.copy()
        hsv = rgb_to_hsv(feats[:, :3])
        hue_val = (rng.random() - 0.5) * 2 * self.hue_max
        sat_ratio = 1 + (rng.random() - 0.5) * 2 * self.saturation_max
        hsv[..., 0] = np.remainder(hue_val + hsv[..., 0] + 1, 1)
        hsv[..., 1] = np.clip(sat_ratio * hsv[..., 1], 0, 1)
        feats[:, :3] = np.clip(hsv_to_rgb(hsv), 0, 255)
        return coords, feats, labels


class RandomHorizontalFlip:
    """Mirror each non-upright axis w.p. 0.5 (reference :209-227)."""

    def __init__(self, upright_axis: str = "z", p: float = 0.95):
        self.upright_axis = {"x": 0, "y": 1, "z": 2}[upright_axis.lower()]
        self.p = p

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        if rng.random() < self.p:
            coords = coords.copy()
            for ax in sorted(set(range(3)) - {self.upright_axis}):
                if rng.random() < 0.5:
                    coords[:, ax] = np.max(coords[:, ax]) - coords[:, ax]
        return coords, feats, labels


class ElasticDistortion:
    """Smoothed-noise-grid warp (reference :230-272)."""

    def __init__(self, distortion_params: Optional[Sequence[Tuple[float, float]]],
                 p: float = 0.95):
        self.params = distortion_params
        self.p = p

    @staticmethod
    def distort(coords: np.ndarray, granularity: float, magnitude: float,
                rng: np.random.Generator) -> np.ndarray:
        blur = [np.ones([3 if i == a else 1 for i in range(3)] + [1],
                        np.float32) / 3 for a in range(3)]
        cmin = coords.min(0)
        dim = ((coords - cmin).max(0) // granularity).astype(int) + 3
        noise = rng.standard_normal((*dim, 3)).astype(np.float32)
        for _ in range(2):
            for b in blur:
                noise = scipy.ndimage.convolve(noise, b, mode="constant", cval=0)
        # grid spans [cmin - g, cmin + g*(d-2)] with d samples — i.e. the
        # upper bound is g*(d-1) above lo (reference :258-262; round-2
        # reference-executing parity caught an off-by-one-granularity
        # upper bound here)
        ax = [np.linspace(lo, lo + granularity * (d - 1), d)
              for lo, d in zip(cmin - granularity, dim)]
        interp = scipy.interpolate.RegularGridInterpolator(
            ax, noise, bounds_error=False, fill_value=0)
        return coords + interp(coords) * magnitude

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        if self.params is not None and rng.random() < self.p:
            for granularity, magnitude in self.params:
                coords = self.distort(coords, granularity, magnitude, rng)
        return coords, feats, labels


class RandomBlobRemovalPerObj:
    """Simulate partial views by carving nearest-neighbor blobs out of each
    object (reference :141-206). Returns a keep-mask via ``last_keep``
    instead of deleting rows, so fixed-capacity padding stays static."""

    def __init__(self, n_blobs_range: Tuple[int, int],
                 blob_size_range: Tuple[int, int]):
        self.n_blobs_range = n_blobs_range
        self.blob_size_range = blob_size_range
        self.last_keep: Optional[np.ndarray] = None

    @staticmethod
    def blob_keep_mask(pointcloud: np.ndarray, n_blobs: int, blob_size: int,
                       rng: np.random.Generator) -> np.ndarray:
        keep = np.ones(len(pointcloud), bool)
        blob_size = min(blob_size, len(pointcloud) // 4)
        for _ in range(n_blobs):
            alive = np.where(keep)[0]
            if len(alive) == 0 or blob_size == 0:
                break
            center = pointcloud[alive[rng.integers(0, len(alive))]]
            dist = np.linalg.norm(pointcloud[alive] - center, axis=1)
            keep[alive[np.argsort(dist)[:blob_size]]] = False
        return keep

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        keep = np.ones(len(coords), bool)
        for obj in np.unique(labels):
            sel = labels == obj
            n_blobs = int(rng.integers(self.n_blobs_range[0],
                                       self.n_blobs_range[1]))
            if not n_blobs:
                continue
            blob_size = int(rng.integers(self.blob_size_range[0],
                                         self.blob_size_range[1]))
            keep[sel] = self.blob_keep_mask(coords[sel], n_blobs, blob_size, rng)
        self.last_keep = keep
        return coords[keep], feats[keep], labels[keep]


class Compose:
    """Chain transforms, threading one Generator through
    (reference :275-284)."""

    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, coords, feats, labels, rng: np.random.Generator):
        for t in self.transforms:
            coords, feats, labels = t(coords, feats, labels, rng)
        return coords, feats, labels
