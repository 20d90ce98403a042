"""Distillation training CLI.

Port of ``dropclip_tpu/tools/train_distil.py``'s per-step loop (reference
tools/train_distil.py:39-283): the same config semantics and recipe
(AMSGrad with decoupled weight decay and per-iteration SGDR cosine LR,
grad clip, cosine distil loss, k random views per sample, checkpoints of
the last epoch and of the best validation similarity loss), in one
process on one device: the card unless ``--device`` says otherwise. On
the card every k3 conv of the student runs K1 forward and backward.

Usage:
  python -m dropclip_tpu_torch.tools.train_distil \\
      --config configs/DistilBlender.yaml [--device cpu] [--opts key value ...]

Validation each ``eval_freq`` epochs: with a ``clip_checkpoint`` (a CLIP
checkpoint file, or "random"), segmentation eval (``eval_task`` all or
segmentation, with ``cls_list_path``) and grounding eval (``eval_task``
all or grounding, whose DistilLoss picks the best checkpoint); otherwise
the distil loss alone. ``visualize`` dumps one val scene per eval epoch.

Not ported yet, each raising with its ROADMAP item: ``scan_epochs > 0``,
``profile_dir`` and several processes.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core.checkpoint import restore_checkpoint, save_checkpoint
from ..core.config import load_cfg, merge_cfg_from_list
from ..core.device import resolve_device
from ..core.logging import setup_logger
from ..core.meters import AverageMeter, ProgressMeter
from ..data import build_dataset_for
from ..data.loader import DataLoader
from ..distill.engine import (DistilBatch, brick_shape_of, build_student_for,
                              make_eval_step, make_train_step)
from ..distill.train_state import create_train_state, make_optimizer
from ..pipeline import make_clip_sim
from ..sparse.bricks import autotune_brick_capacities


def get_parser(argv=None):
    """(cfg, device) from ``--config``, ``--device`` and ``--opts``."""
    p = argparse.ArgumentParser("dropclip_tpu_torch distillation trainer")
    p.add_argument("--config", required=True)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    p.add_argument("--opts", nargs=argparse.REMAINDER, default=None)
    a = p.parse_args(argv)
    cfg = load_cfg(a.config)
    if a.opts:
        cfg = merge_cfg_from_list(cfg, a.opts)
    return cfg, resolve_device(a.device)


def _refuse_unported(cfg) -> None:
    todo = [
        (int(cfg.scan_epochs or 0) > 0, "scan_epochs",
         "make_scanned_train as a CUDA graph"),
        (bool(cfg.profile_dir), "profile_dir", "profile_dir on "
         "torch.profiler"),
        (int(os.environ.get("WORLD_SIZE", "1")) > 1 or bool(
            cfg.dist_coordinator), "several processes (training and "
         "eval)", "DDP with all-reduced BN stats"),
    ]
    for on, what, item in todo:
        if on:
            raise NotImplementedError(
                f"{what} is not ported yet: it waits for its ROADMAP queue 1 "
                f"item, {item}")


def to_batch(b: Dict, device: torch.device) -> DistilBatch:
    """A collated host batch as tensors on ``device``."""
    labels = np.asarray(b["labels"], np.int32)
    arrays = dict(
        coords=np.asarray(b["coords"], np.int32), mask=np.asarray(b["mask"]),
        in_feats=np.asarray(b["in_feats"], np.float32),
        targets=np.asarray(b["targets"], np.float32), labels=labels,
        labels_cls=np.asarray(b.get("labels_cls", np.zeros_like(labels)),
                              np.int32))
    return DistilBatch(**{k: torch.as_tensor(v).to(device, non_blocking=True)
                          for k, v in arrays.items()})


def autotune_capacities(cfg, ds, collate, logger) -> None:
    """Static brick capacities from 16 samples of ``ds`` unless set or
    ``autotune_capacities`` is False: every brick conv scales with
    capacity and the M//8 rule over-allocates; slack 1.5 absorbs
    augmentation variance, and a scene past capacity only drops its
    overflow bricks (counted by the steps)."""
    autotune = (cfg.autotune_capacities
                if cfg.autotune_capacities is not None else True)
    if cfg.brick_capacities or not autotune:
        return
    sample = collate([ds[i % len(ds)] for i in range(16)])
    cfg.brick_capacities = list(autotune_brick_capacities(
        np.asarray(sample["coords"]), np.asarray(sample["mask"]),
        num_levels=int(cfg.num_levels or 5), slack=1.5,
        brick_shape=brick_shape_of(cfg)))
    logger.info("autotuned brick capacities: %s (brick shape %s)",
                cfg.brick_capacities, brick_shape_of(cfg))


def dump_visualization(val_ds, collate, eval_forward, epoch: int,
                       save_dir: str, cfg, batch_size: int) -> str:
    """One random val scene per eval epoch (reference engine/distil.py:
    551-648) to ``<save_dir>/vis/epoch-{E}/rank-0/``: ``outputs.npz``
    (raw_pc, raw_rgb, outputs, targets; the JAX package writes the same
    arrays as h5, which the card's machine cannot) and ``outputs.pcd``,
    the 4-panel cloud rgb | label colors | PCA(targets) | PCA(outputs)
    offset along x (:597-604)."""
    from ..viz import apply_pca, label_colors, save_pcd

    rng = np.random.default_rng(int(cfg.manual_seed or 42) + epoch)
    idx = int(rng.integers(len(val_ds)))
    b = collate([val_ds[idx]] * batch_size)  # the loader's batch shape
    out, _ = eval_forward(b)
    mask = np.asarray(b["mask"])[0].astype(bool)
    feats = np.asarray(b["in_feats"])[0][mask]
    xyz = feats[:, :3]
    rgb = (np.clip(feats[:, 3:6], 0, 1) if feats.shape[1] >= 6
           else np.full_like(xyz, 0.5))
    targets = np.asarray(b["targets"])[0][mask]
    labels = np.asarray(b["labels"])[0][mask].astype(int)
    preds = out[0].float().cpu().numpy()[mask]

    tgt_dir = os.path.join(save_dir, "vis", f"epoch-{epoch}", "rank-0")
    os.makedirs(tgt_dir, exist_ok=True)
    np.savez(os.path.join(tgt_dir, "outputs.npz"),
             raw_pc=xyz.astype(np.float32), raw_rgb=rgb.astype(np.float32),
             outputs=preds.astype(np.float32),
             targets=targets.astype(np.float32))
    # the panel offset scales with the scene (the reference's fixed 0.5
    # assumes tabletop extents)
    off = float(np.ptp(xyz[:, 0])) * 1.1 + 1e-3
    panels = [rgb, label_colors(labels), apply_pca(targets),
              apply_pca(preds)]
    pts = np.concatenate([xyz + np.array([off * i, 0.0, 0.0])
                          for i in range(len(panels))])
    save_pcd(os.path.join(tgt_dir, "outputs.pcd"), pts,
             np.concatenate(panels))
    return tgt_dir


def validate(cfg, val_loader, eval_forward, clip_sim, epoch: int, logger,
             fallback: float, wandb_run=None) -> float:
    """One validation pass (reference engine/distil.py:235-532):
    segmentation and grounding eval where ``clip_sim`` and ``eval_task``
    ask for them, else the distil loss; logs the metrics and returns the
    loss that picks the best checkpoint."""
    task = cfg.eval_task
    if clip_sim is not None and task in ("all", "segmentation") \
            and cfg.cls_list_path:
        import json

        from ..distill.evaluate import validate_segmentation

        with open(cfg.cls_list_path) as f:
            cls_names = list(json.load(f).values())
        res = validate_segmentation(val_loader, eval_forward,
                                    clip_sim.encode_text(cls_names), cfg)
        logger.info("Eval Segmentation: Epoch=[%d/%s] %s", epoch,
                    cfg.epochs, res)
    if clip_sim is not None and task in ("all", "grounding"):
        from ..distill.evaluate import validate_grounding

        res = validate_grounding(val_loader, eval_forward, clip_sim, cfg)
        logger.info("Eval Grounding: Epoch=[%d/%s] %s", epoch, cfg.epochs,
                    res)
        if wandb_run is not None:
            wandb_run.log({"val_steps": epoch,
                           **{f"validation/{k}": v for k, v in res.items()}})
        return res["DistilLoss"]
    losses = [float(eval_forward(b)[1]) for b in val_loader]
    val_loss = float(np.mean(losses)) if losses else fallback
    logger.info("Eval: Epoch=[%d/%s] DistilLoss=%.4f", epoch, cfg.epochs,
                val_loss)
    return val_loss


def _wandb(cfg, stamp, logger):
    """A wandb run when ``use_wandb`` is set and wandb is installed."""
    if not cfg.use_wandb:
        return None
    try:
        import wandb
    except ImportError:
        logger.warning("use_wandb=True but wandb is not installed")
        return None
    run = wandb.init(project=cfg.wandb_project or "dropclip_tpu",
                     name=stamp, config=dict(cfg))
    run.define_metric("val_steps")
    run.define_metric("validation/*", step_metric="val_steps")
    return run


def main(argv=None) -> Optional[str]:
    """Train; returns the directory the checkpoints went to."""
    cfg, device = get_parser(argv)
    _refuse_unported(cfg)
    stamp = datetime.datetime.now().strftime("%d-%m-%Y-%H:%M")
    save_dir = os.path.join(cfg.save_path or "./experiments",
                            f"Distill-{cfg.dataset}", stamp)
    logger = setup_logger("dropclip", save_dir=save_dir)
    logger.info("config:\n%s", cfg)
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    wandb_run = _wandb(cfg, stamp, logger)
    seed = int(cfg.manual_seed or 42)
    np.random.seed(seed)

    bsz = int(cfg.batch_size or 8)
    train_ds, val_ds, collate = build_dataset_for(cfg, device)
    if len(train_ds) == 0:
        raise ValueError(f"no training scenes for {cfg.dataset} "
                         f"(root_dir {cfg.root_dir}, processed_dir "
                         f"{cfg.processed_dir})")
    train_loader = DataLoader(train_ds, bsz, collate, shuffle=True,
                              num_workers=int(cfg.workers or 8), seed=seed)
    val_loader = None
    if val_ds is not None:
        val_loader = DataLoader(val_ds, int(cfg.batch_size_val or 8),
                                collate, shuffle=False,
                                num_workers=int(cfg.workers_val or 2))
    iters_per_epoch = max(len(train_loader), 1)

    autotune_capacities(cfg, train_ds, collate, logger)

    model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    state = create_train_state(model, make_optimizer(cfg, iters_per_epoch))

    start_epoch = int(cfg.start_epoch or 0)
    best_val = float("inf")
    if cfg.resume:
        restored = restore_checkpoint(cfg.resume, map_location=device)
        if restored is not None:
            model.load_state_dict(restored["model"])
            state.step = int(restored["step"])
            state.opt_state = restored["opt_state"]
            start_epoch = int(restored["epoch"]) + 1
            best_val = float(restored["best_val"])
            logger.info("resumed from %s @ epoch %d", cfg.resume,
                        start_epoch)
        else:
            logger.warning("no checkpoint found at %s", cfg.resume)

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    clip_sim = make_clip_sim(cfg, device)

    def eval_forward(b):
        out, m = eval_step(state, to_batch(b, device))
        return out, m["distil_loss"]

    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1)

    for epoch in range(start_epoch, int(cfg.epochs or 200)):
        train_loader.set_epoch(epoch)
        bt = AverageMeter("Batch", ":.3f")
        dt = AverageMeter("Data", ":.3f")
        lm = AverageMeter("DistilLoss", ":.4f")
        gm = AverageMeter("GradNorm", ":.2f")
        prog = ProgressMeter(iters_per_epoch, [bt, dt, lm, gm],
                             prefix=f"Epoch [{epoch}] ")
        epoch_dropped = 0  # capacity-overflow voxels (truncation guard)
        end = time.time()
        for i, b in enumerate(train_loader):
            dt.update(time.time() - end)
            state, metrics = train_step(state, to_batch(b, device),
                                        dropout_gen)
            # reading the metrics syncs the card (keeps the meters honest)
            lm.update(float(metrics["distil_loss"]), n=bsz)
            gm.update(float(metrics["grad_norm"]))
            epoch_dropped += int(metrics["dropped_voxels"])
            bt.update(time.time() - end)
            end = time.time()
            if i % int(cfg.print_freq or 25) == 0:
                prog.display(i, print_fn=logger.info)
                if wandb_run is not None:
                    wandb_run.log({"train/distil_loss": lm.val,
                                   "train/grad_norm": gm.val,
                                   "train/step": state.step})
        if epoch_dropped:
            logger.warning(
                "epoch %d: %d voxels/bricks dropped by brick-capacity "
                "overflow or grid extent: scenes are being truncated; raise "
                "brick_capacities or re-run the capacity autotune",
                epoch, epoch_dropped)
            if wandb_run is not None:
                wandb_run.log({"train/dropped_voxels": epoch_dropped})

        val_loss = lm.avg
        if val_loader is not None and epoch % int(cfg.eval_freq or 1) == 0:
            val_loss = validate(cfg, val_loader, eval_forward, clip_sim,
                                epoch, logger, lm.avg, wandb_run)
            if cfg.visualize:
                vdir = dump_visualization(
                    val_ds, collate, eval_forward, epoch, save_dir, cfg,
                    int(cfg.batch_size_val or 8))
                logger.info("visualization -> %s", vdir)

        if epoch % int(cfg.save_freq or 1) == 0:
            is_best = val_loss < best_val
            best_val = min(val_loss, best_val)
            save_checkpoint(save_dir, {
                "step": state.step, "model": model.state_dict(),
                "opt_state": state.opt_state, "epoch": epoch,
                "best_val": best_val}, best=is_best)
            logger.info("saved checkpoint (epoch %d, best=%s)", epoch,
                        is_best)

    logger.info("done; checkpoints in %s", save_dir)
    return save_dir


if __name__ == "__main__":
    main()
