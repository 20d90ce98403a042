"""Synthetic scenes for smoke runs and benchmarks.

Copies of ``dropclip_tpu/data/synthetic.py`` (same generators, same
numbers from the same random state), numpy only:

- ``make_tabletop_coords``: voxel coordinates with tabletop brick
  statistics (the serve path);
- ``make_raw_scene``: a miniature raw multi-view MV-TOD scene (box-cluster
  objects on a table, cameras on a ring, depth, instance segs and RGB
  rendered from the points, COCO-style object metadata) for ingest;
- ``make_volumetric_coords``: voxel coordinates of bin and shelf scenes,
  solid boxes through the z range (the pillar engine's path).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

CLS_NAMES = ["mug", "bowl", "bottle", "box", "can", "plate", "spoon", "fork"]
COLORS = ["red", "green", "blue", "yellow", "white", "black"]


def make_camera_ring(n_views: int, radius: float = 1.2, height: float = 1.5,
                     ) -> np.ndarray:
    """cam->world poses looking (roughly) down at the origin, with the
    Blender camera convention (the o3d flip makes +z point at the scene)."""
    poses = []
    for v in range(n_views):
        a = 2 * np.pi * v / max(n_views, 1)
        t = np.array([radius * np.cos(a) * 0.1, radius * np.sin(a) * 0.1,
                      height + 0.05 * v], np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = t
        poses.append(T)
    return np.stack(poses)


def make_intrinsics(h: int = 48, w: int = 64, f: float = 50.0) -> np.ndarray:
    return np.array([[f, 0, w / 2 - 0.5], [0, f, h / 2 - 0.5], [0, 0, 1]],
                    np.float32)


def make_objects_info(n_objects: int, rng: np.random.Generator) -> Dict:
    info = {0: {"cls_name": "table", "queries": {}, "concepts": None}}
    for k in range(1, n_objects + 1):
        cls = CLS_NAMES[int(rng.integers(0, len(CLS_NAMES)))]
        color = COLORS[int(rng.integers(0, len(COLORS)))]
        q = {"Color": [color], "State": [], "Material": ["plastic"],
             "Affordance": [f"grasp the {cls}"],
             "More descriptions": [f"a {color} {cls}"]}
        info[k] = {"cls_name": cls, "queries": q,
                   "concepts": {**q, "Brand": None}}
    return info


def make_raw_scene(rng: np.random.Generator, n_objects: int = 3,
                   n_points_per_obj: int = 120, n_views: int = 4,
                   hw: Tuple[int, int] = (48, 64)):
    """Returns dict with points/colors/labels (world cloud), depths, segs,
    rgb images, poses, K, objects_info."""
    h, w = hw
    K = make_intrinsics(h, w)
    poses = make_camera_ring(n_views)

    pts, cols, labs = [], [], []
    # table plane (label 0)
    nt = n_points_per_obj
    table = np.stack([rng.uniform(-0.3, 0.3, nt), rng.uniform(-0.3, 0.3, nt),
                      np.zeros(nt)], axis=1)
    pts.append(table)
    cols.append(np.full((nt, 3), 0.55))
    labs.append(np.zeros(nt, np.int32))
    for k in range(1, n_objects + 1):
        c = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.2, 0.2),
                      rng.uniform(0.03, 0.1)])
        blob = c + rng.normal(0, 0.025, (n_points_per_obj, 3))
        blob[:, 2] = np.abs(blob[:, 2])
        pts.append(blob)
        cols.append(np.tile(rng.uniform(0.1, 0.9, 3), (n_points_per_obj, 1)))
        labs.append(np.full(n_points_per_obj, k, np.int32))
    points = np.concatenate(pts).astype(np.float32)
    colors = np.concatenate(cols).astype(np.float32)
    labels = np.concatenate(labs)

    n = len(points)
    # background depth beyond the 25 m aggregation truncation, like the
    # MV-TOD Blender renders (reference geometry.py:140)
    depths = np.full((n_views, h, w), 100.0, np.float32)
    segs = np.zeros((n_views, h, w), np.int32)
    images = np.full((n_views, h, w, 3), 140, np.uint8)
    col8 = (colors * 255).astype(np.uint8)
    for v in range(n_views):
        cam = (np.linalg.inv(poses[v]) @ np.c_[points, np.ones(n)].T).T[:, :3]
        cam[:, 1] *= -1
        cam[:, 2] *= -1
        uvw = (K @ cam.T).T
        z = uvw[:, 2]
        ok = z > 0
        uv = np.zeros((n, 2), int)
        uv[ok] = (uvw[ok, :2] / z[ok, None]).astype(int)
        inside = (ok & (uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < w)
                  & (uv[:, 1] < h))
        # nearest point wins the pixel: write far-to-near, vectorized
        # (later fancy-index writes overwrite earlier ones)
        order = np.argsort(-z)
        order = order[inside[order]]
        ys, xs = uv[order, 1], uv[order, 0]
        depths[v, ys, xs] = z[order]
        segs[v, ys, xs] = labels[order]
        images[v, ys, xs] = col8[order]

    return {
        "points": points, "colors": colors, "labels": labels,
        "depths": depths, "segs": segs, "images": images,
        "poses": poses, "K": K,
        "objects_info": make_objects_info(n_objects, rng),
    }


def make_tabletop_coords(rng: np.random.RandomState, batch: int,
                         capacity: int, n_occ: int = 6000, ext: int = 40,
                         n_blobs: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Padded voxel coords with tabletop brick statistics.

    A z-thin table plane (z in {0, 1}) plus ``n_blobs`` object shells —
    the occupancy pattern that drives brick-engine cost on real MV-TOD
    clouds. Returns (coords (B, capacity, 3) int32, mask (B, capacity)
    bool), so synthetic runs exercise realistic brick occupancy, not
    uniform noise.
    """
    coords = np.zeros((batch, capacity, 3), np.int32)
    mask = np.zeros((batch, capacity), bool)
    for b in range(batch):
        xy = rng.randint(-ext, ext, size=(3 * n_occ, 2))
        z = rng.randint(0, 2, size=(3 * n_occ, 1))
        parts = [np.concatenate([xy, z], axis=1)]
        if ext > 6:  # blob centers need randint(-ext+6, ext-6) nonempty
            for _ in range(n_blobs):
                c = rng.randint(-ext + 6, ext - 6, size=3)
                c[2] = rng.randint(2, 8)
                th = rng.randn(n_occ // 4, 3)
                th /= np.linalg.norm(th, axis=1, keepdims=True)
                parts.append((c + th * rng.randint(3, 6)).astype(int))
        pts = np.concatenate(parts).astype(np.int32)
        uniq = np.unique(pts, axis=0)
        rng.shuffle(uniq)
        uniq = uniq[: min(n_occ, capacity)]
        coords[b, : len(uniq)] = uniq
        mask[b, : len(uniq)] = True
    return coords, mask


def make_volumetric_coords(rng: np.random.RandomState, batch: int,
                           capacity: int, n_occ: int = 6000, ext: int = 20,
                           zext: int = 32) -> Tuple[np.ndarray, np.ndarray]:
    """Padded voxel coords with VOLUMETRIC occupancy statistics.

    Bin-picking / shelf scenes: solid object boxes stacked through the
    full z range, so occupied (x, y) sites carry DEEP z columns — the
    regime where the pillar layout's full-height columns fill well
    (vs the z-thin tabletop scenes of make_tabletop_coords, where
    pillars pay a 3-4x padding tax). The scenes of the pillar serve
    path in chip_smoke.py.
    Returns (coords (B, capacity, 3) int32, mask (B, capacity) bool);
    z values lie in [0, zext).
    """
    coords = np.zeros((batch, capacity, 3), np.int32)
    mask = np.zeros((batch, capacity), bool)
    budget = min(n_occ, capacity)
    for b in range(batch):
        seen: set = set()
        pts = []
        # add WHOLE boxes until the budget is met — truncating a random
        # voxel subset would punch holes in the z columns and erase the
        # very depth statistic this generator exists to produce
        while len(pts) < budget:
            c = np.array([rng.randint(-ext + 7, ext - 6),
                          rng.randint(-ext + 7, ext - 6),
                          rng.randint(6, max(zext - 6, 7))])
            h = np.array([rng.randint(3, 7), rng.randint(3, 7),
                          rng.randint(4, 9)])
            xs = np.arange(max(c[0] - h[0], -ext), min(c[0] + h[0], ext))
            ys = np.arange(max(c[1] - h[1], -ext), min(c[1] + h[1], ext))
            zs = np.arange(max(c[2] - h[2], 0), min(c[2] + h[2], zext))
            box = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"),
                           axis=-1).reshape(-1, 3)
            for q in map(tuple, box.tolist()):
                if q not in seen and len(pts) < budget:
                    seen.add(q)
                    pts.append(q)
        uniq = np.asarray(pts, np.int32)
        coords[b, : len(uniq)] = uniq
        mask[b, : len(uniq)] = True
    return coords, mask
