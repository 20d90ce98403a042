"""Synthetic scenes for smoke runs and benchmarks.

Copies of ``dropclip_tpu/data/synthetic.py`` (same generators, same
numbers from the same random state), numpy only:

- ``make_tabletop_coords``: voxel coordinates with tabletop brick
  statistics (the serve path);
- ``make_raw_scene``: a miniature raw multi-view MV-TOD scene (box-cluster
  objects on a table, cameras on a ring, depth, instance segs and RGB
  rendered from the points, COCO-style object metadata) for ingest;
- ``make_volumetric_coords``: voxel coordinates of bin and shelf scenes,
  solid boxes through the z range (the pillar engine's path);
- ``write_fake_processed_dataset``: a miniature processed dataset for the
  trainer, in the h5 schema or as ``.npz`` archives of it;
- ``write_fake_raw_blender``: a raw MV-TOD tree in the reference on-disk
  layout (the JAX writer's numbers at its defaults);
- ``write_fake_raw_regrad``: a raw REGRAD tree in the layout of the JAX
  package's REGRAD ingest fixture (``tests/test_regrad_ingest.py``).

cv2 (the image files) is imported inside the raw writers only.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np

from .scene_io import write_scene

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


def write_fake_processed_dataset(root: str, n_scenes: int = 3,
                                 splits: Tuple[str, ...] = ("train", "test"),
                                 n_objects: int = 3, feat_dim: int = 16,
                                 n_views: int = 4, seed: int = 0,
                                 fmt: str = "h5") -> None:
    """Write a miniature processed dataset in the reference scene schema
    (tools/preprocess_data.py:285-297), one dir per scene: ``fmt`` "h5"
    gives ``.h5py`` files (the JAX package's scenes, from the same seed),
    "npz" numpy archives of the same arrays."""
    ext = {"h5": "h5py", "npz": "npz"}[fmt]
    rng = np.random.default_rng(seed)
    for split in splits:
        for s in range(n_scenes):
            raw = make_raw_scene(rng, n_objects=n_objects, n_views=n_views)
            n = len(raw["points"])
            k = n_objects + 1
            feats = rng.normal(size=(k, feat_dim)).astype(np.float32)
            feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
            vis = rng.random((n_views, n)) > 0.3
            vis[0] = True  # every point visible somewhere
            scene_id = f"{split}_{s:04d}"
            write_scene(
                os.path.join(root, split, scene_id, f"{scene_id}.{ext}"),
                xyz=raw["points"], rgb=raw["colors"], label=raw["labels"],
                vis_mask=vis, obj_feats=feats,
                objects_info=raw["objects_info"])


def write_fake_raw_blender(root: str, n_scenes: int = 1, n_objects: int = 2,
                           n_views: int = 3, split: str = "train",
                           hw: Tuple[int, int] = (48, 64), seed: int = 0,
                           n_points_per_obj: int = 120) -> None:
    """Write a raw MV-TOD tree in the reference on-disk layout (reference
    data/blender.py:167-280; the JAX package's ``write_fake_raw_blender``,
    the same files at the same arguments): per scene dir, rgb pngs, depth
    as ``.npy`` (the reader's fallback to EXR), iseg pngs, a COCO annos
    json with compressed-RLE masks and ``seg_color_hex``, camera poses
    json, ``objects[.init]`` json with ``base_scale`` and hex colours; the
    category list at the root. ``n_points_per_obj`` sizes the rendered
    objects (``make_raw_scene``)."""
    import json

    import cv2

    from .rle import encode_rle

    rng = np.random.default_rng(seed)
    for sid in range(n_scenes):
        raw = make_raw_scene(rng, n_objects=n_objects,
                             n_points_per_obj=n_points_per_obj,
                             n_views=n_views, hw=hw)
        d = os.path.join(root, split, f"{sid:06d}")
        os.makedirs(d, exist_ok=True)
        hexes = [f"#{(k * 40 + 30):02x}{(k * 20 + 10):02x}{(k * 10 + 5):02x}"
                 for k in range(1, n_objects + 1)]
        images_meta, annos_meta = [], []
        cameras = {}
        aid = 0
        for v in range(n_views):
            view_id = f"{v:04d}"
            rgb_f = f"image.{sid:06d}.rgb.{view_id}.png"
            cv2.imwrite(os.path.join(d, rgb_f), raw["images"][v][:, :, ::-1])
            np.save(os.path.join(d, f"image.{sid:06d}.raw_depth.{view_id}.npy"),
                    raw["depths"][v])
            cv2.imwrite(os.path.join(d, f"image.{sid:06d}.iseg.{view_id}.png"),
                        (raw["segs"][v] * 30).astype(np.uint8))
            images_meta.append({"file_name": rgb_f, "id": v})
            cameras[view_id] = {"world_matrix": raw["poses"][v].tolist()}
            for k in range(1, n_objects + 1):
                m = (raw["segs"][v] == k).astype(np.uint8)
                if m.sum() == 0:
                    continue
                annos_meta.append({"id": aid, "image_id": v,
                                   "segmentation": encode_rle(m),
                                   "seg_color_hex": hexes[k - 1]})
                aid += 1
        with open(os.path.join(d, f"annos.{sid:06d}.coco.json"), "w") as f:
            json.dump({"images": images_meta, "annotations": annos_meta}, f)
        with open(os.path.join(d, f"cameras.{sid:06d}.json"), "w") as f:
            json.dump(cameras, f)
        objs_init = [{
            "color": {"hex": hexes[k - 1]},
            "path": f"models/shapenet/{CLS_NAMES[k % len(CLS_NAMES)]}/m{k}",
            "cls_name": raw["objects_info"][k]["cls_name"],
            "source": "shapenet", "sim_scale": 1.0,
        } for k in range(1, n_objects + 1)]
        objs_init.append({"base_scale": 10.0})
        objs_final = [{"size": [0.1] * 3, "pose": [0, 0, 0],
                       "bbox": [0, 0, 1, 1], "rotation": [0, 0, 0, 1]}
                      for _ in range(n_objects)]
        with open(os.path.join(d, f"objects.init.{sid:06d}.json"), "w") as f:
            json.dump(objs_init, f)
        with open(os.path.join(d, f"objects.{sid:06d}.json"), "w") as f:
            json.dump(objs_final, f)
    meta = {"categories": [{"id": i, "name": n}
                           for i, n in enumerate(CLS_NAMES)]}
    with open(os.path.join(root, "annos.meta.coco.json"), "w") as f:
        json.dump(meta, f)


#: the raw REGRAD reader's image view for each cloud view
#: (``data.regrad.VIEWS_MAPPING``)
_REGRAD_VIEWS = {1: 9, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 8: 7, 9: 8}


def _merge_json(path: str, entries: Dict) -> None:
    import json

    old = {}
    if os.path.exists(path):
        with open(path) as f:
            old = json.load(f)
    with open(path, "w") as f:
        json.dump({**old, **entries}, f)


def write_fake_raw_regrad(root: str, n_scenes: int = 1, n_objects: int = 2,
                          n_views: int = 2, points_per_obj: int = 150,
                          hw: Tuple[int, int] = (48, 64),
                          K: np.ndarray = None, split: str = "train",
                          seed: int = 0) -> list:
    """Write a raw REGRAD tree in the layout of the JAX package's REGRAD
    ingest fixture (``tests/test_regrad_ingest.py``, with the reader
    settings of ``configs/REGRAD.yaml``): under ``root/split``,
    ``Points/<sid>/<sid>_view_<v>.p`` (world-frame view cloud with 0-based
    labels, colours, scene cloud and grasp frames, scores and labels),
    ``RGBImages/<sid>_<iv>.jpg``, ``DepthImages/<sid>_<iv>.png`` (uint16
    mm) and ``SegmentationImages/<sid>_<iv>.png`` (labels + 1, background
    0) at the image view ``iv`` of cloud view ``v``, and ``objects.json``
    (``objects_16k.json`` off the train split); ``root/camera_info.npy``
    (extrinsics of views 1-9 and, when ``K`` is given, the intrinsics;
    without it the ingest's default K, which centres 840x840 images).

    Objects are a pile of sphere surfaces at z < 0 seen by cameras that
    look down -z (the REGRAD y/z flip puts them in front), so the
    segmentation drawn from the same projections keeps the clouds
    through the ingest's 2D/3D cleanup. For the distillation dataset, the per-scene
    object lists go to ``objects_single.json`` (train) or
    ``objects_refer_test.json`` (other splits) and the model-name classes
    to ``cls_map.json`` at the root. Returns the scene ids."""
    import json
    import pickle

    import cv2

    rng = np.random.RandomState(seed)
    h, w = hw
    Kc = (np.array([[1120.0, 0, 420], [0, 1120.0, 420], [0, 0, 1]])
          if K is None else np.asarray(K, np.float64))
    d = os.path.join(root, split)
    for sub in ("RGBImages", "DepthImages", "SegmentationImages"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    # cameras shifted in x and y, all looking down -z
    extr = {}
    for v in range(1, 10):
        T = np.eye(4)
        a = 2 * np.pi * v / 9
        T[:2, 3] = 0.04 * np.cos(a), 0.04 * np.sin(a)
        extr[v] = T
    info = {"extrinsic": extr}
    if K is not None:
        info["intrinsic"] = np.asarray(K, np.float32)
    np.save(os.path.join(root, "camera_info.npy"), info, allow_pickle=True)

    # a pile of spheres of radius spread / 5 within spread / 4 of the
    # view's axis at z = -1: spread is a tenth of the image at z = 1
    # (0.075 m at 840x840 and f = 1120)
    spread = 0.1 * min(h, w) / Kc[0, 0]
    sids, distil_objs = [], {}
    for s in range(n_scenes):
        sid = f"s{seed:02d}{s:04d}"
        sids.append(sid)
        os.makedirs(os.path.join(d, "Points", sid), exist_ok=True)
        names = [CLS_NAMES[(s + k) % len(CLS_NAMES)]
                 for k in range(n_objects)]
        centers = np.c_[rng.uniform(-1, 1, (n_objects, 2)) * spread / 4,
                        rng.uniform(-1, 1, n_objects) * spread / 6 - 1.0]
        # sphere surfaces, as a depth camera sees objects (a cloud in
        # bricks, not one voxel a brick at millimetre voxels)
        u = rng.normal(size=(n_objects * points_per_obj, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        pts = (np.repeat(centers, points_per_obj, 0)
               + spread / 5 * u).astype(np.float32)
        labs = np.repeat(np.arange(n_objects), points_per_obj)
        obj_col = rng.uniform(0.1, 0.9, (n_objects, 3))
        cols = np.clip(obj_col[labs] + rng.normal(0, 0.03, (len(pts), 3)),
                       0, 1).astype(np.float32)
        n_g = 4 * n_objects
        glab = rng.randint(0, n_objects, n_g)
        frames = np.tile(np.eye(4), (n_g, 1, 1))
        frames[:, :3, 3] = centers[glab] + np.array([0, 0, 0.08])
        for v in range(1, n_views + 1):
            cam = pts.astype(np.float64) - extr[v][:3, 3]
            cam[:, 1:] *= -1
            uvw = cam @ Kc.T
            uv = (uvw[:, :2] / uvw[:, 2:3]).astype(int)
            inside = ((uv[:, 0] >= 0) & (uv[:, 1] >= 0) & (uv[:, 0] < w)
                      & (uv[:, 1] < h))
            order = np.argsort(-uvw[:, 2])  # near points drawn last
            order = order[inside[order]]
            ys, xs = uv[order, 1], uv[order, 0]
            seg = np.zeros((h, w), np.uint8)
            seg[ys, xs] = labs[order] + 1
            depth = np.zeros((h, w), np.uint16)
            depth[ys, xs] = (uvw[order, 2] * 1000).astype(np.uint16)
            img = np.full((h, w, 3), 128, np.uint8)
            img[ys, xs] = (cols[order] * 255).astype(np.uint8)
            data = {"view_cloud": pts[inside],
                    "view_cloud_color": cols[inside],
                    "view_cloud_label": labs[inside],
                    "scene_cloud": pts[::7],
                    "valid_index": np.arange(n_g),
                    "select_frame": frames,
                    "select_score": rng.rand(n_g),
                    "select_frame_label": glab}
            with open(os.path.join(d, "Points", sid, f"{sid}_view_{v}.p"),
                      "wb") as f:
                pickle.dump(data, f)
            iv = _REGRAD_VIEWS[v]
            cv2.imwrite(os.path.join(d, "RGBImages", f"{sid}_{iv}.jpg"),
                        img[:, :, ::-1])
            cv2.imwrite(os.path.join(d, "DepthImages", f"{sid}_{iv}.png"),
                        depth)
            cv2.imwrite(os.path.join(d, "SegmentationImages",
                                     f"{sid}_{iv}.png"), seg)
        objs = [{"obj_id": k + 1, "model_name": names[k],
                 "6D_pose": [*centers[k], 0, 0, 0, 1], "bbox": None,
                 "minAreaRect": None} for k in range(n_objects)]
        fname = "objects.json" if split == "train" else "objects_16k.json"
        _merge_json(os.path.join(d, fname),
                    {sid: {str(v): objs for v in range(1, 10)}})
        distil_objs[sid] = [{"obj_id": k + 1, "model_name": names[k],
                             "exists": True} for k in range(n_objects)]
    _merge_json(os.path.join(root, "objects_single.json" if split == "train"
                             else "objects_refer_test.json"), distil_objs)
    _merge_json(os.path.join(root, "cls_map.json"),
                {n: i for i, n in enumerate(CLS_NAMES)})
    return sids
