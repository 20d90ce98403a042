"""Visualization utilities (host-side numpy, dependency-light).

Port of ``dropclip_tpu/viz.py``, which replaces the reference's
Open3D/matplotlib helpers (reference utils/viz.py): a deterministic
85-color label palette, PCA feature colormaps (reference
utils/projections.py:100-105, numpy SVD), similarity heatmap coloring,
ASCII .pcd export (replacing o3d.io.write_point_cloud in
engine/distil.py:586-603) and PNG grids. matplotlib and PIL are imported
only inside the functions that use them (the card's machine has
neither). ``export_grasp_scene`` writes a ranked grasp scene with the
gripper meshes of ``grasp/gripper.py``.
"""

from __future__ import annotations

import colorsys
import os
from typing import Optional

import numpy as np

N_PALETTE = 85  # reference utils/viz.py:25-285 ships a fixed 85-color table


def _make_palette(n: int = N_PALETTE) -> np.ndarray:
    """Deterministic, well-separated label colors (golden-ratio hue walk;
    id 0 = gray for the table, like the reference's PALLETE[0])."""
    cols = [(0.6, 0.6, 0.6)]
    h = 0.0
    for i in range(1, n):
        h = (h + 0.61803398875) % 1.0
        s = 0.55 + 0.4 * ((i * 7) % 3) / 2
        v = 0.95 - 0.35 * ((i * 5) % 4) / 3
        cols.append(colorsys.hsv_to_rgb(h, s, v))
    return np.asarray(cols, np.float32)


PALETTE = _make_palette()


def label_colors(labels: np.ndarray) -> np.ndarray:
    """(N,) int labels -> (N, 3) float colors."""
    return PALETTE[np.asarray(labels) % len(PALETTE)]


def apply_pca(features: np.ndarray, n_components: int = 3,
              mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Project (N, C) features to (N, 3) colors in [0, 1] via PCA
    (reference utils/projections.py:100-105)."""
    f = np.asarray(features, np.float64)
    sel = np.asarray(mask, bool) if mask is not None else np.ones(len(f), bool)
    mu = f[sel].mean(0) if sel.any() else f.mean(0)
    centered = f - mu
    _, _, vt = np.linalg.svd(centered[sel], full_matrices=False)
    proj = centered @ vt[:n_components].T
    lo = proj[sel].min(0) if sel.any() else proj.min(0)
    hi = proj[sel].max(0) if sel.any() else proj.max(0)
    out = (proj - lo) / np.maximum(hi - lo, 1e-9)
    out[~sel] = 0.0
    return out.astype(np.float32)


def coord_frame_points(scale: float = 0.25,
                       transform: Optional[np.ndarray] = None,
                       n: int = 32):
    """Coordinate-frame axis triad as sample points (file-output
    counterpart of the reference's o3d coord-frame meshes,
    utils/viz.py get_coord_frame used by data/regrad.py:319-329):
    (3n, 3) xyz along +x/+y/+z of the frame, colored r/g/b."""
    t = np.linspace(0.0, scale, n, dtype=np.float32)
    zeros = np.zeros_like(t)
    xyz = np.concatenate([np.stack([t, zeros, zeros], -1),
                          np.stack([zeros, t, zeros], -1),
                          np.stack([zeros, zeros, t], -1)])
    colors = np.concatenate([np.tile([1.0, 0.0, 0.0], (n, 1)),
                             np.tile([0.0, 1.0, 0.0], (n, 1)),
                             np.tile([0.0, 0.0, 1.0], (n, 1))]
                            ).astype(np.float32)
    if transform is not None:
        T = np.asarray(transform, np.float64)
        xyz = (np.c_[xyz, np.ones(len(xyz))] @ T.T)[:, :3].astype(np.float32)
    return xyz, colors


def similarity_colors(sims: np.ndarray) -> np.ndarray:
    """(N,) similarity in [0,1] -> blue->red heat colors (reference
    utils/viz.py similarity viewers)."""
    s = np.clip(np.asarray(sims, np.float32), 0, 1)
    return np.stack([s, 0.2 * (1 - np.abs(2 * s - 1)), 1 - s], axis=-1)


def save_pcd(path: str, xyz: np.ndarray, colors: Optional[np.ndarray] = None
             ) -> None:
    """ASCII .pcd writer (xyz [+ packed rgb])."""
    xyz = np.asarray(xyz, np.float32)
    n = len(xyz)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        fields = "x y z rgb" if colors is not None else "x y z"
        ncols = 4 if colors is not None else 3
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\n")
        f.write(f"FIELDS {fields}\n")
        f.write(f"SIZE {' '.join(['4'] * ncols)}\n")
        f.write(f"TYPE {'F F F U' if colors is not None else 'F F F'}\n")
        f.write(f"COUNT {' '.join(['1'] * ncols)}\n")
        f.write(f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {n}\nDATA ascii\n")
        if colors is not None:
            rgb8 = (np.clip(colors, 0, 1) * 255).astype(np.uint32)
            packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
            for p, c in zip(xyz, packed):
                f.write(f"{p[0]} {p[1]} {p[2]} {c}\n")
        else:
            for p in xyz:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")


def load_pcd(path: str):
    """Minimal ASCII .pcd reader (round-trip of save_pcd)."""
    with open(path) as f:
        lines = f.read().splitlines()
    start = next(i for i, l in enumerate(lines) if l.startswith("DATA")) + 1
    has_rgb = "rgb" in lines[next(
        i for i, l in enumerate(lines) if l.startswith("FIELDS"))]
    rows = [l.split() for l in lines[start:] if l]
    xyz = np.asarray([[float(x) for x in r[:3]] for r in rows], np.float32)
    if not has_rgb:
        return xyz, None
    packed = np.asarray([int(float(r[3])) for r in rows], np.uint32)
    colors = np.stack([(packed >> 16) & 255, (packed >> 8) & 255,
                       packed & 255], -1).astype(np.float32) / 255.0
    return xyz, colors


def export_similarity_heatmap(path: str, xyz: np.ndarray, sims: np.ndarray,
                              threshold: Optional[float] = None) -> None:
    """Similarity heatmap as a .pcd (file-output counterpart of the
    reference's interactive CLIP-similarity viewers, utils/viz.py:493-625:
    turbo-style colormap over normalized sims; below-threshold points
    dimmed to gray when a threshold is given). The colormap is min-max
    scaled for contrast, but ``threshold`` cuts on the RAW similarity —
    the same absolute scale as sim_norm_thresh everywhere else — so a
    query matching nothing in the scene dims everything instead of
    always painting the relatively-best quarter hot."""
    sims = np.asarray(sims, np.float32)
    rng = sims.max() - sims.min()
    norm = (sims - sims.min()) / (rng if rng > 0 else 1.0)
    colors = similarity_colors(norm)
    if threshold is not None:
        colors = np.where(sims[:, None] >= threshold, colors, 0.35)
    save_pcd(path, xyz, colors)


def export_grasp_scene(path_prefix: str, xyz: np.ndarray,
                       colors: Optional[np.ndarray], grasps,
                       order: Optional[np.ndarray] = None,
                       top_k: int = 10,
                       gripper_type: str = "franka_panda") -> list:
    """Language-ranked grasp scene as files (file-output counterpart of
    the reference's o3d grasp viewers, utils/viz.py:426-492 and
    data/regrad.py:334-398): writes ``{prefix}_cloud.pcd`` plus one
    ``{prefix}_grasps.obj`` containing the posed gripper mesh at each of
    the top-k grasps as named groups (grasp_000 = best). Returns the
    written paths.

    ``grasps``: grasp.SceneGrasps; ``order``: best-first indices from
    grasp.rank_grasps_by_query (defaults to score order).
    """
    from .grasp.gripper import make

    written = []
    cloud_path = f"{path_prefix}_cloud.pcd"
    save_pcd(cloud_path, xyz, colors)
    written.append(cloud_path)

    idx = (np.asarray(order) if order is not None
           else np.argsort(-np.asarray(grasps.scores)))
    idx = idx[: min(top_k, len(idx))]
    v, f = make(gripper_type)
    obj_path = f"{path_prefix}_grasps.obj"
    os.makedirs(os.path.dirname(obj_path) or ".", exist_ok=True)
    with open(obj_path, "w") as out:
        out.write("# dropclip_tpu ranked grasps (grasp_000 = best)\n")
        base = 0
        for rank, g in enumerate(idx):
            pose = np.asarray(grasps.poses[g])
            vh = np.c_[v, np.ones(len(v))] @ pose.T
            out.write(f"o grasp_{rank:03d}\n")
            for p in vh[:, :3]:
                out.write(f"v {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
            for tri in f + 1 + base:
                out.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
            base += len(v)
    written.append(obj_path)
    return written


def heat_colors(x: np.ndarray) -> np.ndarray:
    """(...,) values in [0,1] -> (..., 3) colors via matplotlib's turbo
    when available (the reference viewers' cmap, utils/viz.py:495,557),
    else the built-in blue->red map."""
    try:
        import matplotlib

        return np.asarray(matplotlib.colormaps["turbo"](np.clip(x, 0, 1))
                          )[..., :3].astype(np.float32)
    except Exception:
        return similarity_colors(np.reshape(x, (-1,))).reshape(
            np.shape(x) + (3,))


def _draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """In-place numpy line rasterizer (keeps viz.py cv2-free)."""
    p0 = np.asarray(p0, np.float32)
    p1 = np.asarray(p1, np.float32)
    n = int(max(abs(p1 - p0).max(), 1)) * 2 + 1
    pts = np.round(np.linspace(p0, p1, n)).astype(np.int64)
    h, w = img.shape[:2]
    r = thickness // 2
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            x = np.clip(pts[:, 0] + dx, 0, w - 1)
            y = np.clip(pts[:, 1] + dy, 0, h - 1)
            img[y, x] = color


def draw_2d_grasps_in_image(img: np.ndarray, grasp_rectangles) -> np.ndarray:
    """Draw 2D grasp rectangles on an RGB image (reference
    utils/viz.py:415-423): finger edges (A-B, D-C) in red, jaw edges
    (B-C, A-D) in blue. ``grasp_rectangles``: iterable of (4, 2) corner
    arrays in (x, y) pixels — grasp.Grasp2D.as_rect / SceneGrasps2D.get_rects."""
    out = np.array(img, copy=True)
    red, blue = (255, 0, 0), (0, 0, 255)
    for rect in grasp_rectangles:
        a, b, c, d = np.asarray(rect, np.float32)
        _draw_line(out, a, b, red)
        _draw_line(out, d, c, red)
        _draw_line(out, b, c, blue)
        _draw_line(out, a, d, blue)
    return out


def _save_png(path: str, img: np.ndarray) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    from PIL import Image

    Image.fromarray(np.ascontiguousarray(img)).save(path)


def _title_bar(width: int, text: str, height: int = 24) -> np.ndarray:
    bar = np.full((height, width, 3), 255, np.uint8)
    try:
        from PIL import Image, ImageDraw

        im = Image.fromarray(bar)
        ImageDraw.Draw(im).text((4, 4), text, fill=(0, 0, 0))
        bar = np.asarray(im)
    except Exception:
        pass
    return bar


def export_multiview_similarity(path: str, images, sims, text_query: str,
                                threshold: Optional[float] = 0.9) -> str:
    """PNG-grid counterpart of the reference's interactive
    ``viz_multiview_clip_sim`` (utils/viz.py:493-520): top row = each
    view with per-pixel sims min-max normalized and points above
    ``threshold`` painted red; bottom row = the turbo heatmap of the
    normalized sims; title carries the language query."""
    tops, bots = [], []
    for image, sim in zip(images, sims):
        sim = np.asarray(sim, np.float32)
        rng = sim.max() - sim.min()
        sim_norm = (sim - sim.min()) / (rng if rng > 0 else 1.0)
        top = np.array(image, np.uint8, copy=True)
        if threshold is not None:
            top[sim_norm > threshold] = (255, 0, 0)
        tops.append(top)
        bots.append((heat_colors(sim_norm) * 255).astype(np.uint8))
    grid = np.concatenate([np.concatenate(tops, 1),
                           np.concatenate(bots, 1)], 0)
    title = _title_bar(grid.shape[1],
                       f'Similarity to language query "{text_query}"')
    _save_png(path, np.concatenate([title, grid], 0))
    return path


def export_multiview_similarity_obj_prior(path: str, images, segms, obj_map,
                                          sims, text_query: str) -> str:
    """PNG-grid counterpart of ``viz_multiview_clip_sim_obj_prior``
    (utils/viz.py:523-554): per view, sims are per-OBJECT (K,); top row
    paints the argmax object's mask red, bottom row splats normalized
    per-object sims over each object's segmentation mask."""
    tops, bots = [], []
    for image, seg, sim, objs in zip(images, segms, sims, obj_map):
        sim = np.asarray(sim, np.float32)
        rng = sim.max() - sim.min()
        sim_norm = (sim - sim.min()) / (rng if rng > 0 else 1.0)
        seg = np.asarray(seg)
        top = np.array(image, np.uint8, copy=True)
        top[seg == objs[int(sim.argmax())]] = (255, 0, 0)
        tops.append(top)
        splat = np.zeros(seg.shape, np.float32)
        for i, obj in enumerate(objs):
            splat[seg == obj] = sim_norm[i]
        bots.append((heat_colors(splat) * 255).astype(np.uint8))
    grid = np.concatenate([np.concatenate(tops, 1),
                           np.concatenate(bots, 1)], 0)
    title = _title_bar(
        grid.shape[1],
        f'Similarity to language query "{text_query}" with object prior')
    _save_png(path, np.concatenate([title, grid], 0))
    return path


def export_feat_scene(path: str, xyz: np.ndarray, rgb: np.ndarray,
                      label: np.ndarray, feat: np.ndarray,
                      patch_feat: Optional[np.ndarray] = None,
                      trans_factor: float = 15.0) -> str:
    """Side-by-side feature-scene panels in ONE .pcd (file-output
    counterpart of ``viz_feat_scene`` / ``viz_multiview_feat_scene``,
    utils/viz.py:557-604): rgb | label palette | PCA of the L2-normalized
    per-point features, each panel translated +trans_factor along x
    (+ an optional PCA(patch_feat) panel, the multiview variant's 4th)."""
    f = np.asarray(feat, np.float64)
    f = f / np.maximum(np.linalg.norm(f, axis=-1, keepdims=True), 1e-12)
    panels = [(np.clip(rgb, 0, 1), 0.0),
              (label_colors(label), 1.0),
              (apply_pca(f), 2.0)]
    if patch_feat is not None:
        panels.append((apply_pca(np.asarray(patch_feat, np.float64)), 3.0))
    xyz = np.asarray(xyz, np.float32)
    all_xyz = np.concatenate(
        [xyz + np.array([t * trans_factor, 0, 0], np.float32)
         for _, t in panels])
    all_col = np.concatenate([c for c, _ in panels])
    save_pcd(path, all_xyz, all_col)
    return path


def export_clip_pred(path: str, xyz: np.ndarray, pred: np.ndarray,
                     sims_norm: np.ndarray, background: np.ndarray,
                     gt: Optional[np.ndarray] = None,
                     trans_factor: float = 15.0) -> str:
    """Grounding-prediction panels in ONE .pcd (file-output counterpart
    of ``viz_clip_pred`` / ``viz_clip_pred_gt``, utils/viz.py:607-625):
    turbo heatmap of sims_norm | [gt mask in grayscale] | background
    with predicted points painted red; panels translated along x."""
    xyz = np.asarray(xyz, np.float32)
    back = np.array(background, np.float32, copy=True)
    back[np.asarray(pred, bool)] = (1.0, 0.0, 0.0)
    panels = [heat_colors(np.asarray(sims_norm, np.float32))]
    if gt is not None:
        g = np.asarray(gt, np.float32)
        panels.append(np.repeat(g[:, None], 3, axis=1))
    panels.append(back)
    all_xyz = np.concatenate(
        [xyz + np.array([i * trans_factor, 0, 0], np.float32)
         for i in range(len(panels))])
    save_pcd(path, all_xyz, np.concatenate(panels))
    return path


def export_boxes(path: str, boxes, colors=None, n: int = 24) -> str:
    """Axis-aligned 3D box outlines as edge-sampled points in a .pcd
    (file-output counterpart of get_wireframe/draw_box_outline,
    utils/viz.py:320-355). ``boxes``: (B, 2, 3) [min, max] corners."""
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    pts, cols = [], []
    boxes = np.asarray(boxes, np.float32).reshape(-1, 2, 3)
    for b, (lo, hi) in enumerate(boxes):
        corners = np.array([[lo[0] if not i & 1 else hi[0],
                             lo[1] if not i & 2 else hi[1],
                             lo[2] if not i & 4 else hi[2]]
                            for i in range(8)], np.float32)
        color = (np.asarray(colors[b], np.float32) if colors is not None
                 else PALETTE[(b + 1) % len(PALETTE)])
        for e0, e1 in edges:
            seg = np.linspace(corners[e0], corners[e1], n)
            pts.append(seg)
            cols.append(np.tile(color, (n, 1)))
    save_pcd(path, np.concatenate(pts), np.concatenate(cols))
    return path


def draw_relation_boxes_on_image(img: np.ndarray, boxes, source, targets,
                                 thickness: int = 2) -> np.ndarray:
    """Highlight a source/targets spatial relation on an RGB image
    (reference ``paint_image_rel``, utils/viz.py:382-390): source object's
    bbox in green, each target's in red. ``boxes``: mapping obj -> 
    (x0, y0, x1, y1)."""
    out = np.array(img, copy=True)

    def rect(b, color):
        x0, y0, x1, y1 = [float(v) for v in b]
        _draw_line(out, (x0, y0), (x1, y0), color, thickness)
        _draw_line(out, (x1, y0), (x1, y1), color, thickness)
        _draw_line(out, (x1, y1), (x0, y1), color, thickness)
        _draw_line(out, (x0, y1), (x0, y0), color, thickness)

    rect(boxes[source], (0, 255, 0))
    for t in targets:
        rect(boxes[t], (255, 0, 0))
    return out
