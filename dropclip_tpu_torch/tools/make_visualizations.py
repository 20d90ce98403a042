"""Visualization point clouds per val scene.

Port of ``dropclip_tpu/tools/make_visualizations.py`` (reference
tools/make_visualizations.py:15-64 and the training-time dump,
engine/distil.py:551-648): for each val scene, .pcd files colored by rgb,
instance labels, PCA of the fused teacher targets and, with a checkpoint
of the port's trainer, PCA of the student's output and the side-by-side
panels. Runs on the card unless ``--device`` says otherwise.

With a checkpoint and ``viz_query`` (a text query, grounded through the
``clip_checkpoint`` text tower): the query's similarity heatmap, the
heatmap | thresholded-prediction panels, and a grasp scene ranked by
``grasp.rank_grasps_by_query`` on the student's features (candidates at
the 32 most similar points, the gripper meshes of the top 10).

Usage:
  python -m dropclip_tpu_torch.tools.make_visualizations \\
      --config configs/DistilBlender.yaml [--device cpu] \\
      --opts root_dir DATA [resume CKPT_DIR] viz_dir ./viz [max_scenes 8] \\
      [viz_query "the red mug" clip_checkpoint CLIP.pt]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..core.checkpoint import LAST_NAME, load_model
from ..core.config import load_cfg, merge_cfg_from_list
from ..core.device import resolve_device
from ..data import build_dataset_for
from ..distill.engine import build_student_for, make_eval_step
from ..distill.train_state import DistilTrainState
from ..pipeline import make_clip_sim
from ..viz import apply_pca, export_feat_scene, label_colors, save_pcd
from .train_distil import to_batch


def query_dumps(out_dir: str, sid: str, xyz: np.ndarray, rgb, labels,
                feats, clip_sim, cfg) -> dict:
    """The ``viz_query`` files of one scene: similarity heatmap,
    heatmap | prediction panels, and the ranked grasp scene (file-output
    counterparts of the reference's interactive similarity and grasp
    viewers, utils/viz.py:426-625). ``feats`` (N, C) student features on
    their device. MV-TOD grasp annotations are unused in the reference
    (blender.py:207), so the candidates are placed above the 32 most
    similar points. Returns the ranking's (order, score) tensors."""
    from ..grasp.grasps import SceneGrasps, rank_grasps_by_query
    from ..similarity import NEGATIVE_PROMPT_GENERIC, predict_from_embeddings
    from ..viz import (export_clip_pred, export_grasp_scene,
                       export_similarity_heatmap)

    thr = float(cfg.sim_norm_thresh or 0.75)
    pos = clip_sim.encode_text([str(cfg.viz_query)])[0]
    negs = clip_sim.encode_text(list(NEGATIVE_PROMPT_GENERIC))
    pred, sims = predict_from_embeddings(
        feats, pos, negs, method=cfg.sim_method or "paired", threshold=thr)
    s = sims.cpu().numpy()
    export_similarity_heatmap(
        os.path.join(out_dir, f"{sid}_query_heatmap.pcd"), xyz, s,
        threshold=thr)
    rngs = s.max() - s.min()
    background = (np.clip(rgb, 0, 1) if rgb is not None
                  else np.full((len(xyz), 3), 0.6))
    export_clip_pred(
        os.path.join(out_dir, f"{sid}_query_pred.pcd"), xyz,
        pred.cpu().numpy().astype(bool),
        (s - s.min()) / (rngs if rngs > 0 else 1.0), background=background,
        trans_factor=float(np.ptp(xyz[:, 0]) * 1.2 + 1e-3))
    top = np.argsort(-s)[:32]
    poses = np.tile(np.eye(4), (len(top), 1, 1))
    poses[:, :3, 3] = xyz[top] + np.array([0, 0, 0.08])
    cand = SceneGrasps(indices=top, poses=poses, scores=s[top],
                       labels=labels[top])
    order, score = rank_grasps_by_query(
        xyz, feats, np.ones(len(xyz), bool), poses[:, :3, 3], cand.scores,
        pos, negs)
    export_grasp_scene(os.path.join(out_dir, f"{sid}_query"), xyz,
                       np.clip(rgb, 0, 1) if rgb is not None else None,
                       cand, order=order.cpu().numpy(), top_k=10)
    return order, score


def main(argv=None) -> str:
    """Write the dumps; returns their directory."""
    p = argparse.ArgumentParser("dropclip_tpu_torch visualization dumps")
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    a = p.parse_args(argv)
    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    device = resolve_device(a.device)
    out_dir = cfg.viz_dir or "./viz"
    max_scenes = int(cfg.max_scenes or 8)
    cfg.evaluate = True
    _, val_ds, collate = build_dataset_for(cfg, device)

    state = eval_step = None
    if cfg.resume:
        model = build_student_for(cfg).to(device)
        restored = load_model(model, cfg.resume, cfg.ckpt_name or LAST_NAME,
                              map_location=device)
        state = DistilTrainState(step=int(restored["step"]), model=model,
                                 tx=None, opt_state=None)
        eval_step = make_eval_step(cfg)
    clip_sim = make_clip_sim(cfg, device) if cfg.viz_query else None

    for i in range(min(max_scenes, len(val_ds))):
        item = val_ds[i]
        m = np.asarray(item["mask"])
        # voxel centres in metric space = coords * voxel_size
        xyz = np.asarray(item["coords"], np.float32)[m] \
            * float(cfg.voxel_size or 0.05)
        rgb = np.asarray(item["in_feats"])[m][:, 3:6] \
            if item["in_feats"].shape[-1] >= 6 else None
        labels = np.asarray(item["labels"])[m]
        targets = np.asarray(item["targets"])[m]
        sid = item["scene_id"]

        if rgb is not None:
            save_pcd(os.path.join(out_dir, f"{sid}_rgb.pcd"), xyz,
                     np.clip(rgb, 0, 1))
        save_pcd(os.path.join(out_dir, f"{sid}_label.pcd"), xyz,
                 label_colors(labels))
        save_pcd(os.path.join(out_dir, f"{sid}_target_pca.pcd"), xyz,
                 apply_pca(targets))
        if eval_step is not None:
            out, _ = eval_step(state, to_batch(collate([item]), device))
            dev_feats = out[0][torch.as_tensor(m, device=device)].float()
            feats = dev_feats.cpu().numpy()
            save_pcd(os.path.join(out_dir, f"{sid}_student_pca.pcd"), xyz,
                     apply_pca(feats))
            # rgb | label | PCA(student) | PCA(targets) in one file (the
            # reference's viz_feat_scene window, utils/viz.py:557-604)
            export_feat_scene(
                os.path.join(out_dir, f"{sid}_panels.pcd"), xyz,
                np.clip(rgb, 0, 1) if rgb is not None
                else np.full((len(xyz), 3), 0.6), labels, feats,
                patch_feat=targets,
                trans_factor=float(np.ptp(xyz[:, 0]) * 1.2 + 1e-3))
            if clip_sim is not None:
                query_dumps(out_dir, sid, xyz, rgb, labels, dev_feats,
                            clip_sim, cfg)
        print(f"dumped {sid} -> {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
