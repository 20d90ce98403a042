"""Visualization point clouds per val scene.

Port of ``dropclip_tpu/tools/make_visualizations.py`` (reference
tools/make_visualizations.py:15-64 and the training-time dump,
engine/distil.py:551-648): for each val scene, .pcd files colored by rgb,
instance labels, PCA of the fused teacher targets and, with a checkpoint
of the port's trainer, PCA of the student's output and the side-by-side
panels. Runs on the card unless ``--device`` says otherwise.

Usage:
  python -m dropclip_tpu_torch.tools.make_visualizations \\
      --config configs/DistilBlender.yaml [--device cpu] \\
      --opts root_dir DATA [resume CKPT_DIR] viz_dir ./viz [max_scenes 8]

``viz_query`` (the JAX tool's language-conditioned dumps, which end in a
ranked grasp scene) raises until the grasp modules are ported.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ..core.checkpoint import LAST_NAME, load_model
from ..core.config import load_cfg, merge_cfg_from_list
from ..core.device import resolve_device
from ..data import build_dataset_for
from ..distill.engine import build_student_for, make_eval_step
from ..distill.train_state import DistilTrainState
from ..viz import apply_pca, export_feat_scene, label_colors, save_pcd
from .train_distil import to_batch


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
    if cfg.viz_query:
        raise NotImplementedError(
            "viz_query's ranked grasp dump is not ported yet: it waits for "
            "its ROADMAP queue 1 item 7.4, REGRAD and grasp")
    device = resolve_device(a.device)
    out_dir = cfg.viz_dir or "./viz"
    max_scenes = int(cfg.max_scenes or 8)
    cfg.evaluate = True
    _, val_ds, collate = build_dataset_for(cfg)

    state = eval_step = None
    if cfg.resume:
        model = build_student_for(cfg).to(device)
        restored = load_model(model, cfg.resume, cfg.ckpt_name or LAST_NAME,
                              map_location=device)
        state = DistilTrainState(step=int(restored["step"]), model=model,
                                 tx=None, opt_state=None)
        eval_step = make_eval_step(cfg)

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
            feats = out[0].float().cpu().numpy()[m]
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
        print(f"dumped {sid} -> {out_dir}", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
