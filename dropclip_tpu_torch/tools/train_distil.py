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

Not ported yet, each raising with its ROADMAP item: ``scan_epochs > 0``,
``clip_checkpoint`` (grounding and segmentation eval), ``visualize``,
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
        (bool(cfg.clip_checkpoint), "clip_checkpoint (grounding and "
         "segmentation eval)", "distill/evaluate.py with make_clip_sim on "
         "a checkpoint"),
        (bool(cfg.visualize), "visualize", "the eval and viz CLIs"),
        (bool(cfg.profile_dir), "profile_dir", "profile_dir on "
         "torch.profiler"),
        (int(os.environ.get("WORLD_SIZE", "1")) > 1 or bool(
            cfg.dist_coordinator), "several processes",
         "DDP with all-reduced BN stats"),
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
    train_ds, val_ds, collate = build_dataset_for(cfg)
    if len(train_ds) == 0:
        raise ValueError(f"no scenes under {cfg.root_dir}/train")
    train_loader = DataLoader(train_ds, bsz, collate, shuffle=True,
                              num_workers=int(cfg.workers or 8), seed=seed)
    val_loader = None
    if val_ds is not None:
        val_loader = DataLoader(val_ds, int(cfg.batch_size_val or 8),
                                collate, shuffle=False,
                                num_workers=int(cfg.workers_val or 2))
    iters_per_epoch = max(len(train_loader), 1)

    # static brick capacities from a data sample: every brick conv scales
    # with capacity and the M//8 rule over-allocates; slack 1.5 absorbs
    # augmentation variance, and a scene past capacity only drops its
    # overflow bricks (counted, and warned about below)
    autotune = (cfg.autotune_capacities
                if cfg.autotune_capacities is not None else True)
    if not cfg.brick_capacities and autotune:
        sample = collate([train_ds[i % len(train_ds)] for i in range(16)])
        cfg.brick_capacities = list(autotune_brick_capacities(
            np.asarray(sample["coords"]), np.asarray(sample["mask"]),
            num_levels=int(cfg.num_levels or 5), slack=1.5,
            brick_shape=brick_shape_of(cfg)))
        logger.info("autotuned brick capacities: %s (brick shape %s)",
                    cfg.brick_capacities, brick_shape_of(cfg))

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
                "brick_capacities/grid_bits or re-run the capacity autotune",
                epoch, epoch_dropped)
            if wandb_run is not None:
                wandb_run.log({"train/dropped_voxels": epoch_dropped})

        val_loss = lm.avg
        if val_loader is not None and epoch % int(cfg.eval_freq or 1) == 0:
            losses = [float(eval_step(state, to_batch(b, device))[1][
                "distil_loss"]) for b in val_loader]
            val_loss = float(np.mean(losses)) if losses else lm.avg
            logger.info("Eval: Epoch=[%d/%s] DistilLoss=%.4f", epoch,
                        cfg.epochs, val_loss)

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
