"""Fusion-quality ablation runs: grounding metrics straight from the
fusion stage, no student involved.

Port of ``dropclip_tpu/tools/run_eval.py`` (reference scripts/run_eval.py:
103-329): per raw scene, aggregate the cloud, extract teacher features
(object-prior class tokens, or dense MaskCLIP patches), fuse them
(object-level, or point-level through ``fusion.core.fuse_points``) with
every design axis a flag (#views, visibility, similarity kernel, visual
prompt, negatives, method, threshold), then ground each eval query and
report mIoU / Pr@{25,50,75}. Runs on the card (the ViT teacher through
K3, K6 and K7) unless ``--device`` says otherwise.

Usage:
  python -m dropclip_tpu_torch.tools.run_eval -ds Synthetic \\
      --clip-model tiny-test [--clip-checkpoint CLIP.pt] [--device cpu] \\
      --use_obj_prior 1 --use_similarity 1 --use_sim_kernel max ...
  python -m dropclip_tpu_torch.tools.run_eval -ds Blender -r RAW_ROOT \\
      [--split train --start 0 --end 9] ...

``-ds Blender`` reads raw MV-TOD scenes ``[--start, --end]`` (``--end``
INCLUSIVE here, -1 = the last, as in the JAX tool; ``preprocess_data``'s
``--end`` is exclusive).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import time
from typing import Dict, List

import numpy as np
import torch

from ..core.metrics import grounding_metrics
from ..data.queries import prepare_queries
from ..fusion.core import (FusionConfig, fuse_obj_prior, fuse_points,
                           splat_object_features)
from ..geom.aggregate import aggregate_views
from ..similarity import (NEGATIVE_PROMPT_GENERIC, l2_normalize,
                          predict_from_embeddings)
from .preprocess_data import build_extractor, embed_fusion_queries


def _dump_query_viz(viz_dir: str, scene_id: str, obj_id: int, text: str,
                    xyz, rgb, sel, pred, sims, gt) -> None:
    """Heatmap | gt | thresholded-prediction panels of one query as a .pcd
    (the reference's viz_clip_pred_gt hook, scripts/run_eval.py:28-41).
    ``obj_id`` keys the file, so two instances of one class (the same
    query text) do not overwrite each other."""
    from ..viz import export_clip_pred

    p = np.asarray(xyz)[sel]
    if p.size == 0:  # no visible point survived the masks for this query
        return
    s = np.asarray(sims, np.float32)[sel]
    rng = s.max() - s.min()
    slug = re.sub(r"[^a-z0-9]+", "_", text.lower())[:40]
    export_clip_pred(
        os.path.join(viz_dir, f"{scene_id}_o{obj_id}_{slug}.pcd"), p,
        np.asarray(pred, bool)[sel],
        (s - s.min()) / (rng if rng > 0 else 1.0),
        background=np.clip(np.asarray(rgb)[sel], 0, 1),
        gt=np.asarray(gt, np.float32)[sel],
        trans_factor=float(np.ptp(p[:, 0]) * 1.2 + 1e-3) if len(p) else 1.0)


def _teacher_cache(args, scene_id: str, mode: str, names, compute):
    """Per-scene teacher outputs cached as .npz under ``--cache-dir``
    (reference scripts/run_eval.py:165-227 caches per-scene CLIP features),
    so sweeps over the fusion and grounding axes reuse the extraction.
    Keyed by the arguments that change the teacher's outputs; written to a
    temporary name and renamed. Cached arrays come back in float32 (npz
    has no bf16), fresh ones as the teacher gave them."""
    cache = getattr(args, "cache_dir", None)
    if not cache:
        return compute()
    # dataset, root and split belong in the key: scene ids collide across
    # datasets
    key = "|".join(str(getattr(args, k, None)) for k in (
        "dataset", "root", "split",
        "clip_model", "clip_checkpoint", "visual_prompt",
        "crop_num_levels", "crop_expansion_ratio", "n_views",
        "max_objects"))
    digest = hashlib.md5(key.encode()).hexdigest()[:10]
    path = os.path.join(cache, f"{scene_id}_{mode}_{digest}.npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return tuple(z[n] for n in names)
    out = tuple((x.float() if x.is_floating_point() else x).cpu().numpy()
                for x in compute())
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}.npz"
    np.savez(tmp, **dict(zip(names, out)))
    os.replace(tmp, path)
    return out


@torch.no_grad()
def eval_scene(raw: Dict, extractor, args) -> Dict[str, float]:
    """One scene: aggregate -> extract -> fuse -> ground queries ->
    metrics, on the extractor's device."""
    dev = extractor.device
    images, depths, segs = raw["images"], raw["depths"], raw["segs"]
    poses, K = raw["poses"], raw["K"]
    obj_info = raw["objects_info"]
    if args.n_views > 0:
        step = max(1, len(images) // args.n_views)
        sel = slice(0, args.n_views * step, step)
        images, depths, segs, poses = (images[sel], depths[sel], segs[sel],
                                       poses[sel])
    h, w = depths.shape[1:]
    n_real = max(int(k) for k in obj_info) + 1
    q_max = args.max_objects
    if n_real > q_max:
        raise ValueError(f"{n_real} objects > --max_objects {q_max}")

    put = lambda x, dt: torch.as_tensor(np.asarray(x, dt)).to(dev)
    on_dev = lambda x: torch.as_tensor(x).to(dev)
    d_depths, d_segs = put(depths, np.float32), put(segs, np.int32)
    d_poses, d_K = put(poses, np.float32), put(K, np.float32)
    xyz, rgb, labels, mask, agg_dropped = aggregate_views(
        d_depths, put(images, np.uint8), d_segs, d_poses, d_K,
        voxel_size=args.voxel_size, capacity=args.cloud_capacity,
        num_labels=q_max)
    if int(agg_dropped):
        print(f"WARNING: {int(agg_dropped)} points truncated during "
              "aggregation (raise cloud_capacity)", flush=True)
    keep = mask & (labels != 0)

    q_real = embed_fusion_queries(extractor, obj_info, args.kernel_queries)
    query_embs = torch.zeros((q_max, q_real.shape[-1]), dtype=torch.float32,
                             device=dev)
    query_embs[:n_real] = q_real
    cfg = FusionConfig(image_hw=(h, w),
                       use_visibility=bool(args.use_visibility),
                       use_similarity=bool(args.use_similarity),
                       sim_kernel=args.use_sim_kernel)

    scene_id = str(raw.get("scene_id", "s"))
    if args.use_obj_prior:
        def _obj_prior():
            extractor.set_mode("cls")
            return extractor.extract_obj_prior(images, segs,
                                               obj_ids=np.arange(q_max),
                                               present_hint=segs)

        obj_feats, present = _teacher_cache(
            args, scene_id, "objprior", ("obj_feats", "present"), _obj_prior)
        fused = fuse_obj_prior(xyz, d_depths, d_segs, d_poses,
                               on_dev(obj_feats), on_dev(present),
                               query_embs, d_K, cfg,
                               obj_valid=torch.arange(q_max, device=dev)
                               < n_real)
        obj_out = fused.obj_features
        nan_rows = obj_out.isnan().any(-1, keepdim=True)
        point_feats = splat_object_features(
            labels, torch.where(nan_rows, query_embs, obj_out))
    else:
        def _patches():
            extractor.set_mode("patch")
            return (extractor.extract(images),)  # (V, ph, pw, C)

        (patch_feats,) = _teacher_cache(
            args, scene_id, "patch", ("patch_feats",), _patches)
        fused = fuse_points(xyz, d_depths, d_segs, d_poses,
                            on_dev(patch_feats), query_embs, d_K, cfg)
        point_feats = torch.nan_to_num(fused.features)

    sel_pts = keep & fused.visible
    labels_np = labels.cpu().numpy()
    sel_np = sel_pts.cpu().numpy()
    generic = lambda: extractor.encode_text(NEGATIVE_PROMPT_GENERIC)

    queries = prepare_queries(
        {k: v for k, v in obj_info.items() if isinstance(v, dict)},
        args.eval_scenario)
    preds, gts = [], []
    for obj_id, texts in queries.items():
        for text in texts:
            if args.sim_negatives == "generic":
                negs = generic()
            elif args.sim_negatives == "scene":
                others = [t for k2, v2 in queries.items() if k2 != obj_id
                          for t in v2]
                negs = extractor.encode_text(others) if others else generic()
            elif args.sim_negatives == "all":
                # every dataset class but this object's own and the table
                # (reference scripts/run_eval.py:262-263)
                cls = str(obj_info[obj_id].get("cls_name", ""))
                others = [c for c in args._cls_list
                          if c not in (cls, "table")]
                negs = extractor.encode_text(others) if others else generic()
            elif args.sim_negatives == "none":
                negs = None
            else:
                raise ValueError(args.sim_negatives)
            pos = l2_normalize(extractor.encode_text([text])[0])
            negs = l2_normalize(negs) if negs is not None else None
            pred, sims = predict_from_embeddings(
                point_feats, pos, negs, mask=sel_pts,
                method=args.sim_method, threshold=args.sim_thr)
            preds.append(pred.cpu().numpy())
            gts.append((labels_np == obj_id) & sel_np)
            if getattr(args, "viz_dir", None):
                _dump_query_viz(args.viz_dir, scene_id, int(obj_id), text,
                                xyz.cpu().numpy(), rgb.cpu().numpy(), sel_np,
                                preds[-1], sims.cpu().numpy(), gts[-1])
    if not preds:
        return {}
    miou, prs = grounding_metrics(torch.as_tensor(np.stack(preds)).float(),
                                  torch.as_tensor(np.stack(gts)))
    return {"mIoU": float(miou), "Pr@25": float(prs[0]),
            "Pr@50": float(prs[1]), "Pr@75": float(prs[2]),
            "n_queries": len(preds)}


def blender_scenes(args) -> List[Dict]:
    """Raw MV-TOD scenes ``[args.start, args.end]`` of ``args.root`` as
    ``eval_scene`` inputs, keyed by their real scene ids (stable
    ``--cache-dir`` entries across windows); sets ``args._cls_list`` to
    the dataset's label map for ``--sim_negatives all``."""
    from ..data.blender import BlenderDataset
    from .preprocess_data import _intrinsic_matrix

    ds = BlenderDataset(args.root, models_root=args.models_root,
                        split=args.split)
    end = args.end if args.end >= 0 else len(ds.scene_ids) - 1
    scenes = []
    for sid in range(args.start, end + 1):
        scene = ds[sid]
        segs, _ = BlenderDataset.obtain_seg_info(scene)
        views = list(scene["views"].values())
        scenes.append({
            "scene_id": str(ds.scene_ids[sid]),
            "images": np.stack([v["rgb"] for v in views]),
            "depths": np.stack([v["depth"] for v in views]),
            "segs": np.stack(segs),
            "poses": np.stack([np.asarray(v["camera"]["world_matrix"],
                                          np.float32) for v in views]),
            "K": _intrinsic_matrix(scene["camera_intrinsic"]),
            "objects_info": scene["objects_info"],
        })
    args._cls_list = sorted({str(n) for n in ds.id_to_name.values()})
    return scenes


def main(argv=None) -> Dict:
    """Run the ablation; returns the summary it prints."""
    p = argparse.ArgumentParser("dropclip_tpu_torch fusion ablation eval")
    p.add_argument("-ds", "--dataset", choices=["Blender", "Synthetic"],
                   default="Synthetic")
    p.add_argument("-r", "--root", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--models-root", default=None)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=-1)
    p.add_argument("--n-scenes", type=int, default=3, help="synthetic only")
    p.add_argument("--n_views", type=int, default=-1, help="-1 = all views")
    p.add_argument("--use_obj_prior", type=int, default=1)
    p.add_argument("--use_visibility", type=int, default=0)
    p.add_argument("--use_similarity", type=int, default=1)
    p.add_argument("--use_sim_kernel", choices=["max", "mean"], default="max")
    p.add_argument("--kernel_queries", default="cls",
                   help="fusion-kernel query scenario (cls|cls+attr|open)")
    p.add_argument("--eval_scenario", default="cls")
    p.add_argument("--sim_method", choices=["paired", "argmax"],
                   default="paired")
    p.add_argument("--sim_negatives",
                   choices=["generic", "scene", "none", "all"],
                   default="generic")
    p.add_argument("--sim_thr", type=float, default=0.75)
    p.add_argument("--voxel_size", type=float, default=0.01)
    p.add_argument("--cloud_capacity", type=int, default=65536)
    p.add_argument("--max_objects", type=int, default=32)
    p.add_argument("--visual-prompt", default="crop-mask")
    p.add_argument("--crop-num-levels", type=int, default=1)
    p.add_argument("--crop-expansion-ratio", type=float, default=0.15)
    p.add_argument("--clip-model", default="ViT-L/14@336px")
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--save-results", default=None)
    p.add_argument("--viz-dir", default=None,
                   help="dump per-query heatmap|gt|pred .pcd panels "
                        "(reference viz_clip_pred_gt)")
    p.add_argument("--cache-dir", default=None, dest="cache_dir",
                   help="per-scene teacher-feature cache shared across "
                        "ablation runs (reference chp_folder)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.dataset == "Blender" and not args.root:
        p.error("-r/--root is required for -ds Blender")

    extractor = build_extractor(args, device=args.device)
    if args.dataset == "Synthetic":
        from ..data.synthetic import make_raw_scene

        rng = np.random.default_rng(0)
        args.cloud_capacity = min(args.cloud_capacity, 4096)
        scenes: List[Dict] = [make_raw_scene(rng, n_objects=3, n_views=4)
                              for _ in range(args.n_scenes)]
        # the dataset-wide class vocabulary for --sim_negatives all: for
        # Synthetic the generated scenes are the dataset
        args._cls_list = sorted({
            str(v["cls_name"]) for s in scenes
            for v in s["objects_info"].values()
            if isinstance(v, dict) and "cls_name" in v})
    else:
        scenes = blender_scenes(args)

    results = []
    for i, raw in enumerate(scenes):
        raw.setdefault("scene_id", f"{i:04d}")
        t0 = time.time()
        res = eval_scene(raw, extractor, args)
        print(f"scene {i}: {res} ({time.time() - t0:.1f}s)", flush=True)
        if res:
            results.append(res)

    agg = {k: float(np.mean([r[k] for r in results]))
           for k in ("mIoU", "Pr@25", "Pr@50", "Pr@75")} if results else {}
    summary = {"config": {k: v for k, v in vars(args).items()
                          if not k.startswith("_")}, "mean": agg,
               "n_scenes": len(results)}
    print(json.dumps({"mean": agg, "n_scenes": len(results)}), flush=True)
    if args.save_results:
        with open(args.save_results, "w") as f:
            json.dump(summary, f, indent=2)
    return summary


if __name__ == "__main__":
    main()
