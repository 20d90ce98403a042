"""DROP-CLIP's offline ingest of one multi-view scene (reference
``tools/preprocess_data.py``, ``models/features/extractor.py``,
``utils/geometry.py``, ``utils/feature_fusion.py``), in plain PyTorch,
written from the reference's semantics and not from the program's code.

- ``cloud``: every pixel with 0 < depth < 25 m is unprojected (OpenCV
  pinhole at integer pixel coordinates, the Blender/Open3D axis flip,
  the view's camera-to-world matrix) and the points of all views are
  voxel-downsampled together: per voxel the mean position and the
  majority segment (ties to the smaller id). In float64.
- ``visibility``: a point is visible in a view when its truncated
  pixel lies inside the image and the depth there is within
  ``threshold`` of the point's camera-frame depth.
- ``prompts``: the crop-mask visual prompt of one (view, object) pair:
  the object's bounding box (expanded by ``ratio * level`` of its size
  at level ``level``; level 0 is the box itself), the pixels outside
  the object's mask painted with the background colour (black where the
  object's mean colour is nearer white, else white), the crop padded to
  the view's aspect ratio with that colour, resized bicubically
  (``F.interpolate``, a = -0.75, no antialiasing) to the teacher's
  input and CLIP-normalised. Each crop is its own canvas.
- ``queries``: each object's query texts (``open``: its descriptions
  and its class name; ``table`` for id 0) encoded by the text tower,
  averaged and L2-normalised.
- ``fuse``: the object-prior fusion with semantic view filtering: per
  view, each present object's unit feature against every object's
  query, min-max normalised over the present rows of that view, the
  weight ``max(own - max(others), eps)``; each object's feature the
  weighted mean of its views' features; an object seen in no view takes
  its query. In float64.

Departures from the reference: the teacher and text tower run in bf16
(the configuration's ``teacher_dtype``); the crop-mask prompt is built
with torch's bicubic resize in place of OpenCV's; a voxel's label is
the majority of its points' segments, as Open3D's trace and the
reference's Counter give it; the query texts of the ``open`` scenario
are averaged before normalisation."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import clip_text, clip_vision

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
_BIAS = 1 << 20


def pack(grid: torch.Tensor) -> torch.Tensor:
    """(..., 3) int64 voxel coords -> int64 keys."""
    g = grid.to(torch.int64) + _BIAS
    return (g[..., 0] << 42) | (g[..., 1] << 21) | g[..., 2]


def unproject(depths: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
              trunc: float):
    """(V, H, W) depths -> (world points (N, 3) float64, flat pixel
    index (N,)) of every pixel with 0 < depth < trunc."""
    v, h, w = depths.shape
    d = depths.double()
    K = K.double()
    u = torch.arange(w, dtype=torch.float64, device=d.device)
    r = torch.arange(h, dtype=torch.float64, device=d.device)
    x = (u[None, None, :] - K[0, 2]) * d / K[0, 0]
    y = (r[None, :, None] - K[1, 2]) * d / K[1, 1]
    cam = torch.stack([x, -y, -d], -1).reshape(v, h * w, 3)  # Blender axes
    P = poses.double()
    world = torch.einsum("vij,vnj->vni", P[:, :3, :3], cam) \
        + P[:, None, :3, 3]
    flat_d = d.reshape(-1)
    keep = torch.nonzero((flat_d > 0) & (flat_d < trunc))[:, 0]
    return world.reshape(-1, 3)[keep], keep


def cloud(depths, segs, poses, K, voxel: float, trunc: float,
          device) -> Dict[str, torch.Tensor]:
    """The labelled voxel cloud of a scene's views: ``key`` (N,) sorted,
    ``xyz`` (N, 3) float64 mean positions, ``label`` (N,) majority
    segments."""
    dev = torch.device(device)
    pts, idx = unproject(torch.as_tensor(depths, device=dev),
                         torch.as_tensor(poses, device=dev),
                         torch.as_tensor(K, device=dev), trunc)
    seg = torch.as_tensor(segs, device=dev).reshape(-1)[idx].to(torch.int64)
    keys = pack(torch.floor(pts / voxel))
    key, inv = torch.unique(keys, return_inverse=True)
    n = key.shape[0]
    cnt = torch.bincount(inv, minlength=n).double()
    xyz = torch.zeros((n, 3), dtype=torch.float64, device=dev)
    xyz.index_add_(0, inv, pts)
    votes = torch.bincount(inv * 256 + seg, minlength=n * 256).view(n, 256)
    return dict(key=key, xyz=xyz / cnt[:, None], label=votes.argmax(-1))


def project(points: torch.Tensor, poses: torch.Tensor, K: torch.Tensor):
    """(N, 3) world points -> (u, v) float64 pixel coordinates and
    camera-frame depth, each (V, N)."""
    P = poses.double()
    R, t = P[:, :3, :3], P[:, :3, 3]
    cam = torch.einsum("vji,vnj->vni", R, points.double()[None]
                       - t[:, None, :])
    x, y, z = cam[..., 0], -cam[..., 1], -cam[..., 2]  # OpenCV axes
    K = K.double()
    zs = torch.where(z == 0, 1.0, z)
    return K[0, 0] * x / zs + K[0, 2], K[1, 1] * y / zs + K[1, 2], z


def visibility(points, depths, poses, K, threshold: float,
               depth_test: bool = True):
    """(visible (V, N) bool, borderline (V, N) bool): borderline where
    the point's pixel coordinate lies within 0.01 pixel of an integer or
    its depth test within 1e-4 m of ``threshold``, where float32
    arithmetic may decide either way. Without ``depth_test`` (a planted
    fault) a point is visible wherever it projects inside the image."""
    dev = points.device
    depths = torch.as_tensor(depths, device=dev)
    u, v, z = project(points, torch.as_tensor(poses, device=dev),
                      torch.as_tensor(K, device=dev))
    n_views, h, w = depths.shape
    ui, vi = torch.trunc(u), torch.trunc(v)
    inside = (ui >= 0) & (vi >= 0) & (ui < w) & (vi < h)
    uc = ui.clamp(0, w - 1).long()
    vc = vi.clamp(0, h - 1).long()
    views = torch.arange(n_views, device=dev)[:, None]
    gap = (depths[views, vc, uc].double() - z).abs()
    near = lambda c: (c - c.round()).abs() < 0.01  # noqa: E731
    border = near(u) | near(v) | ((gap - threshold).abs() < 1e-4)
    return (inside & (gap <= threshold) if depth_test else inside), border


def present_pairs(segs: np.ndarray, max_objects: int) -> np.ndarray:
    """(V, max_objects) bool: object id k (k > 0) appears in view v."""
    out = np.zeros((segs.shape[0], max_objects), bool)
    for v in range(segs.shape[0]):
        ids = np.unique(segs[v])
        ids = ids[(ids > 0) & (ids < max_objects)]
        out[v, ids] = True
    return out


def background(image: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Black where the object's mean colour is nearer white, else white."""
    mean = image[mask].double().mean(0)
    white = torch.linalg.vector_norm(mean - 255.0)
    black = torch.linalg.vector_norm(mean)
    return torch.full((3,), 0.0 if white < black else 255.0,
                      dtype=torch.float64, device=image.device)


def box_of(mask: torch.Tensor, level: int, ratio: float):
    """(x1, y1, x2, y2), x2 and y2 exclusive, of the mask, expanded by
    ``int(ratio * size) * level`` on each side and clipped."""
    h, w = mask.shape
    ys = torch.nonzero(mask.any(1))[:, 0]
    xs = torch.nonzero(mask.any(0))[:, 0]
    x1, x2 = int(xs[0]), int(xs[-1]) + 1
    y1, y2 = int(ys[0]), int(ys[-1]) + 1
    ex = int(abs(x2 - x1) * ratio) * level
    ey = int(abs(y2 - y1) * ratio) * level
    return (max(x1 - ex, 0), max(y1 - ey, 0), min(x2 + ex, w),
            min(y2 + ey, h))


def prompt(image: torch.Tensor, mask: torch.Tensor, out_hw, level: int,
           ratio: float, use_mask: bool = True) -> torch.Tensor:
    """One crop-mask prompt: (oh, ow, 3) CLIP-normalised float32."""
    h, w = mask.shape
    bg = background(image, mask)
    src = image.double()
    if use_mask:
        src = torch.where(mask[..., None], src, bg)
    x1, y1, x2, y2 = box_of(mask, level, ratio)
    crop = src[y1:y2, x1:x2]
    ch, cw = crop.shape[:2]
    target = w / h
    ph = int(cw / target) if cw / ch > target else ch
    pw = int(ch * target) if cw / ch < target else cw
    top, left = (ph - ch) // 2, (pw - cw) // 2
    canvas = bg.expand(ph, pw, 3).clone()
    canvas[top:top + ch, left:left + cw] = crop
    out = F.interpolate(canvas.float().permute(2, 0, 1)[None],
                        size=tuple(out_hw), mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0)
    mean = torch.tensor(CLIP_MEAN, device=out.device)
    std = torch.tensor(CLIP_STD, device=out.device)
    return (out / 255.0 - mean) / std


def crop_features(w, images, segs, pairs: np.ndarray, teacher: Dict,
                  ing: Dict, device, batch: int, precision: str = "bf16",
                  use_mask: bool = True) -> torch.Tensor:
    """(P, E) float32 class-token features of the present (view, object)
    ``pairs``, each the mean over its prompt levels."""
    dev = torch.device(device)
    levels = int(ing["crop_num_levels"])
    out_hw = teacher["img_resize"]
    feats, todo = [], []
    for v, k in pairs:
        image = torch.as_tensor(images[v], device=dev)
        mask = torch.as_tensor(segs[v] == k, device=dev)
        todo += [prompt(image, mask, out_hw, lv,
                        float(ing["crop_expansion_ratio"]), use_mask)
                 for lv in range(levels)]
        while len(todo) >= batch:
            feats.append(clip_vision.encode(
                w, torch.stack(todo[:batch]), teacher["vision_heads"],
                teacher["patch_size"], precision))
            todo = todo[batch:]
    if todo:
        feats.append(clip_vision.encode(w, torch.stack(todo),
                                        teacher["vision_heads"],
                                        teacher["patch_size"], precision))
    f = torch.cat(feats) if feats else torch.zeros(
        (0, w[f"{clip_vision.PREFIX}proj"].shape[1]), device=dev)
    return f.reshape(len(pairs), levels, -1).mean(1)


def query_texts(obj_info: Dict) -> Dict[int, List[str]]:
    """{object id: texts} of the ``open`` scenario: id 0 is the table;
    an object's descriptions, then its class name where they lack it."""
    out = {0: ["table"]}
    for k, v in obj_info.items():
        if int(k) == 0 or not isinstance(v, dict):
            continue
        c = v.get("concepts") or {}
        texts = list(c.get("More descriptions", [])) or [v["cls_name"]]
        if v["cls_name"] not in texts:
            texts.append(v["cls_name"])
        out[int(k)] = texts
    return out


def queries(w_text, tokenizer, obj_info: Dict, heads: int, device,
            precision: str = "bf16") -> torch.Tensor:
    """(n_objects + 1, E) float32 unit query features, id 0 the table."""
    texts = query_texts(obj_info)
    n = max(texts) + 1
    flat = [t for k in sorted(texts) for t in texts[k]]
    with torch.no_grad():
        emb = clip_text.encode(w_text, tokenizer(flat).to(device), heads,
                               precision)
    out = torch.zeros((n, emb.shape[1]), dtype=torch.float32, device=device)
    at = 0
    for k in sorted(texts):
        m = emb[at:at + len(texts[k])].mean(0)
        out[k] = m / m.norm()
        at += len(texts[k])
    return out


def margins(feats: torch.Tensor, present: torch.Tensor,
            query: torch.Tensor) -> torch.Tensor:
    """(V, Q) own-query similarity less the best other query's, after
    each view's min-max normalisation over its present rows; float64.
    ``feats`` (V, Q, C), ``present`` (V, Q), ``query`` (Q, C)."""
    f = feats.double()
    f = f / torch.linalg.vector_norm(f, dim=-1, keepdim=True)
    sim = f @ query.double().T                     # (V, Q, Q)
    q = query.shape[0]
    rows = present[:, :, None].expand(-1, q, q)
    lo = torch.where(rows, sim, torch.inf).amin((1, 2), keepdim=True)
    hi = torch.where(rows, sim, -torch.inf).amax((1, 2), keepdim=True)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    sim = (sim - lo) / span
    own = torch.diagonal(sim, dim1=-2, dim2=-1)
    eye = torch.eye(q, dtype=torch.bool, device=sim.device)
    other = torch.where(eye, -torch.inf, sim).amax(-1)
    return torch.where(present, own - other, torch.nan)


def fuse(feats: torch.Tensor, present: torch.Tensor, query: torch.Tensor,
         use_similarity: bool = True, eps: float = 1e-6,
         skip_view: Optional[int] = None):
    """(weights (V, Q), margins (V, Q)) of the semantic view filter (or
    of presence alone), float64. ``skip_view`` gives one view no weight
    (a planted fault)."""
    m = margins(feats, present, query)
    wgt = torch.where(present, m.clamp_min(eps), 0.0) if use_similarity \
        else present.double()
    if skip_view is not None:
        wgt[skip_view] = 0.0
    return wgt, m


def weighted_mean(feats: torch.Tensor, wgt: torch.Tensor) -> torch.Tensor:
    """(Q, C) float64: each object's view features weighted by ``wgt``
    (V, Q); NaN rows for objects with no weight."""
    f = feats.double()
    return (f * wgt[..., None]).sum(0) / wgt.sum(0)[:, None]


def scene(w_vision, w_text, tokenizer, data: Dict, teacher: Dict,
          ing: Dict, text_heads: int, device, batch: int,
          precision: str = "bf16", fault: Optional[str] = None) -> Dict:
    """One scene's ingest: the cloud (every voxel, with its visibility,
    ``sel`` the voxels written: an object's and seen in some view;
    ``doubt`` an object's voxel seen only where the visibility is
    borderline, or unseen but borderline somewhere), the crop features,
    the queries, the view weights and the fused features (``obj_feats``,
    a never-fused object's query in its row); ``fault`` plants one of
    ``FAULTS``."""
    n_real = max(int(k) for k in data["obj_info"]) + 1
    present = present_pairs(data["segs"], int(ing["max_objects"]))
    pairs = np.argwhere(present)
    v = present.shape[0]
    with torch.no_grad():
        feats = crop_features(w_vision, data["images"], data["segs"], pairs,
                              teacher, ing, device, batch, precision,
                              use_mask=fault != "crop_unmasked")
        query = queries(w_text, tokenizer, data["obj_info"], text_heads,
                        device, precision)
        grid = torch.zeros((v, n_real, feats.shape[1]), dtype=torch.float32,
                           device=feats.device)
        pres = torch.zeros((v, n_real), dtype=torch.bool,
                           device=feats.device)
        grid[pairs[:, 0], pairs[:, 1]] = feats
        pres[pairs[:, 0], pairs[:, 1]] = True
        wgt, m = fuse(grid, pres, query,
                      use_similarity=(fault != "similarity_off"
                                      and bool(ing["use_similarity"])),
                      skip_view=0 if fault == "view_left_out" else None)
        half = wgt.clone()
        if fault == "fusion_half_views":
            half[v // 2:] = 0.0
        fused = weighted_mean(grid, half)
        out = torch.where(torch.isnan(fused).any(-1, keepdim=True),
                          query.double(), fused)
        views = slice(0, v // 2 if fault == "cloud_half_views" else v)
        c = cloud(data["depths"][views],
                  data["segs"][views], data["poses"][views], data["K"],
                  float(ing["voxel_size"]), float(ing["depth_trunc_m"]),
                  device)
        vis, border = visibility(c["xyz"], data["depths"], data["poses"],
                                 data["K"], float(ing["vis_threshold"]),
                                 depth_test=fault != "visibility_untested")
    obj = c["label"] != 0
    sel = obj & vis.any(0)
    doubt = obj & ~(vis & ~border).any(0) & border.any(0)
    return dict(key=c["key"], xyz=c["xyz"], label=c["label"], vis=vis,
                border=border, sel=sel, doubt=doubt, feats=grid,
                present=pres, query=query, weights=wgt, margins=m,
                fused=fused, obj_feats=out)


# planted faults: the mask left off the crop; one view given no weight in
# the fusion; the semantic filter off; the fused mean taken over half of
# the views; the cloud aggregated from half of the views; the
# visibility's depth test left out
FAULTS = ("crop_unmasked", "view_left_out", "similarity_off",
          "fusion_half_views", "cloud_half_views", "visibility_untested")
