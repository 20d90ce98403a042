"""Standalone grounding evaluation of a trained student, or of the fused
teacher features themselves (the fusion-quality upper bound).

Port of ``dropclip_tpu/tools/validate_blender.py`` (reference
tools/validate_blender.py:80-320 and tools/validate_upper_bound.py:
164-313, whose grounding branch is the same loop with ``out = targets``,
:191-192): load the port trainer's checkpoint into the student, run the
MV-TOD val split, ground every eval query with the configured negatives,
and report mIoU / Pr@{25,50,75} / DistilLoss as one JSON line. Runs on
the card unless ``--device`` says otherwise.

Usage:
  python -m dropclip_tpu_torch.tools.validate_blender \\
      --config configs/DistilBlender.yaml [--device cpu] \\
      --opts resume CKPT_DIR clip_checkpoint CLIP.pt \\
      [ckpt_name best_sim_loss_model] [eval_upper_bound True] \\
      [sim_negatives all] [save_results_path OUT.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..core.checkpoint import LAST_NAME, load_model
from ..core.config import load_cfg, merge_cfg_from_list
from ..core.device import resolve_device
from ..core.logging import setup_logger
from ..data.dataset_blender import MVTODDataset
from ..data.loader import DataLoader
from ..distill.engine import build_student_for, make_eval_step
from ..distill.evaluate import validate_grounding
from ..distill.train_state import DistilTrainState
from ..pipeline import make_clip_sim
from .train_distil import autotune_capacities, to_batch


def main(argv=None) -> dict:
    """Evaluate; returns the printed result."""
    p = argparse.ArgumentParser("dropclip_tpu_torch grounding validation")
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    a = p.parse_args(argv)
    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    device = resolve_device(a.device)
    logger = setup_logger("dropclip.val")

    val_ds = MVTODDataset(cfg, split=cfg.val_split or "test")
    loader = DataLoader(val_ds, int(cfg.batch_size_val or 8),
                        MVTODDataset.collate, shuffle=False,
                        num_workers=int(cfg.workers_val or 2))

    upper_bound = bool(cfg.eval_upper_bound)
    if not upper_bound:
        if not cfg.resume:
            raise ValueError("--opts resume CKPT_DIR required (or "
                             "eval_upper_bound True)")
        # the trainer's capacity autotune, honouring the same switch, so
        # train and eval topologies cannot silently diverge
        autotune_capacities(cfg, val_ds, MVTODDataset.collate, logger)
        model = build_student_for(cfg).to(device)
        restored = load_model(model, cfg.resume, cfg.ckpt_name or LAST_NAME,
                              map_location=device)
        state = DistilTrainState(step=int(restored["step"]), model=model,
                                 tx=None, opt_state=None)
        logger.info("loaded checkpoint %s (step %d)", cfg.resume, state.step)
        eval_step = make_eval_step(cfg)

    clip_sim = make_clip_sim(cfg, device)
    if clip_sim is None:
        raise ValueError("grounding eval needs clip_checkpoint")

    def forward(b):
        if upper_bound:  # score the fused targets themselves (:191-192)
            return torch.as_tensor(np.asarray(b["targets"])).to(device), 0.0
        out, m = eval_step(state, to_batch(b, device))
        dropped = int(m["dropped_voxels"])
        if dropped and not cfg.allow_capacity_overflow:
            # a truncated scene silently deflates every metric
            raise RuntimeError(
                f"{dropped} voxels dropped by brick-capacity/extent "
                "overflow during validation; raise brick_capacities, or "
                "pass allow_capacity_overflow True")
        return out, m["distil_loss"]

    cls_list = None
    if cfg.sim_negatives == "all":
        with open(os.path.join(cfg.root_dir, "cls_list.json")) as f:
            cls_list = list(json.load(f).values())

    res = validate_grounding(loader, forward, clip_sim, cfg,
                             cls_list=cls_list)
    eval_cfg = (f"scenario[{cfg.eval_scenario}]-negatives[{cfg.sim_negatives}]"
                f"-method[{cfg.sim_method}]-thr[{cfg.sim_norm_thresh}]"
                f"{'-UPPERBOUND' if upper_bound else ''}")
    logger.info("%s -> %s", eval_cfg, res)
    result = {"eval_cfg": eval_cfg, **res}
    if cfg.save_results_path:
        os.makedirs(os.path.dirname(cfg.save_results_path) or ".",
                    exist_ok=True)
        with open(cfg.save_results_path, "w") as f:
            json.dump(result, f, indent=2)
        logger.info("results -> %s", cfg.save_results_path)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
