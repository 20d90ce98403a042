"""Scene generators, driven by a traffic file's parameters and a seed.

Every seed gets the same set of scene sizes, in another order, so that
two seeds differ in where the voxels lie and not in how much work there
is. Copied from the port's own generators and frozen here:
``make_tabletop_coords`` (a z-thin table plane and object shells, the
occupancy of MV-TOD clouds) and the REGRAD raw phase's object piles (a
pile of sphere surfaces seen by a depth camera, sampled at millimetre
voxels)."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng_for(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator of ``seed`` (any size) and a stream number."""
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def scene_sizes(n: int, lo: int, hi: int, rng: np.random.Generator
                ) -> np.ndarray:
    """``n`` voxel counts evenly spaced over [lo, hi], in an order drawn
    from ``rng``: the same set for every seed."""
    return rng.permutation(np.linspace(lo, hi, n).round().astype(np.int64))


def tabletop(rng: np.random.Generator, n_occ: int, ext: int = 40,
             n_blobs: int = 6) -> np.ndarray:
    """(n_occ, 3) unique int voxel coords: a table plane (z in {0, 1})
    over [-ext, ext)^2 and ``n_blobs`` spherical shells of radius 3-5
    standing on it."""
    while True:
        xy = rng.integers(-ext, ext, size=(3 * n_occ, 2))
        z = rng.integers(0, 2, size=(3 * n_occ, 1))
        parts = [np.concatenate([xy, z], axis=1)]
        for _ in range(n_blobs):
            c = rng.integers(-ext + 6, ext - 6, size=3)
            c[2] = rng.integers(2, 8)
            th = rng.standard_normal((n_occ // 4, 3))
            th /= np.linalg.norm(th, axis=1, keepdims=True)
            parts.append((c + th * rng.integers(3, 6)).astype(np.int64))
        uniq = np.unique(np.concatenate(parts), axis=0)
        if len(uniq) >= n_occ:
            return rng.permutation(uniq)[:n_occ].astype(np.int32)


def surfaces(rng: np.random.Generator, n_occ: int, n_objects: int = 10,
             radius_mm=(15.0, 15.0), spread_mm: float = 18.75,
             spread_z_mm: float = 12.5, voxel_mm: float = 1.0
             ) -> np.ndarray:
    """(n_occ, 3) unique int voxel coords at ``voxel_mm``: a pile of
    ``n_objects`` sphere surfaces (radius drawn from ``radius_mm``,
    centres within ``spread_mm`` across and ``spread_z_mm`` in height),
    sampled uniformly by area and quantized until ``n_occ`` voxels are
    occupied, as a 10000-point sample of a REGRAD scene's surfaces
    quantizes at 1 mm. The defaults are the REGRAD raw phase's pile: 15 mm
    spheres within a tenth of an 840x840 view at f = 1120."""
    r = rng.uniform(*radius_mm, n_objects)
    centers = np.c_[rng.uniform(-spread_mm, spread_mm, (n_objects, 2)),
                    rng.uniform(-spread_z_mm, spread_z_mm, n_objects)]
    area = r ** 2 / (r ** 2).sum()
    pts = []
    while True:
        obj = rng.choice(n_objects, n_occ // 2, p=area)
        u = rng.standard_normal((len(obj), 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts.append(centers[obj] + r[obj, None] * u)
        vox = np.unique(np.floor(np.concatenate(pts) / voxel_mm)
                        .astype(np.int64), axis=0)
        if len(vox) >= n_occ:
            return rng.permutation(vox)[:n_occ].astype(np.int32)


SHAPES = {"tabletop": tabletop, "surfaces": surfaces}


def make_scenes(spec: Dict, n: int, rng: np.random.Generator
                ) -> List[np.ndarray]:
    """``n`` scenes of voxel coords under a traffic file's ``scenes``
    entry: {"shape": name of SHAPES, "voxels": [lo, hi], ...keyword
    arguments of the shape}."""
    kw = {k: v for k, v in spec.items() if k not in ("shape", "voxels")}
    sizes = scene_sizes(n, *spec["voxels"], rng)
    return [SHAPES[spec["shape"]](rng, int(s), **kw) for s in sizes]


def padded(scenes: List[np.ndarray], capacity: int):
    """(coords (B, capacity, 3) int32, mask (B, capacity) bool)."""
    coords = np.zeros((len(scenes), capacity, 3), np.int32)
    mask = np.zeros((len(scenes), capacity), bool)
    for b, c in enumerate(scenes):
        if len(c) > capacity:
            raise ValueError(f"scene of {len(c)} voxels past the capacity "
                             f"{capacity}")
        coords[b, :len(c)] = c
        mask[b, :len(c)] = True
    return coords, mask


def point_cloud(coords: np.ndarray, voxel_size: float, points_per_voxel:
                float, rng: np.random.Generator):
    """A cloud in metres over the voxels of ``coords``: one jittered
    point in every voxel and a second in a share ``points_per_voxel - 1``
    of them; rgb uniform in [0, 1]. (xyz (N, 3), rgb (N, 3)) float32."""
    extra = int(round((points_per_voxel - 1) * len(coords)))
    c = np.concatenate([coords, coords[rng.permutation(len(coords))[:extra]]])
    xyz = (c + rng.random(c.shape)) * voxel_size
    return xyz.astype(np.float32), rng.random(c.shape).astype(np.float32)
