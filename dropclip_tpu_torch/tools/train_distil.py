"""Distillation training CLI.

Port of ``dropclip_tpu/tools/train_distil.py``'s per-step loop (reference
tools/train_distil.py:39-283): the same config semantics and recipe
(AMSGrad with decoupled weight decay and per-iteration SGDR cosine LR,
grad clip, cosine distil loss, k random views per sample, checkpoints of
the last epoch and of the best validation similarity loss), one device a
process: the card unless ``--device`` says otherwise. On the card every
k3 conv of the brick student runs K1 forward and backward;
``sparse_backend gather`` trains the gather engine.

Usage:
  python -m dropclip_tpu_torch.tools.train_distil \\
      --config configs/DistilBlender.yaml [--device cpu] [--opts key value ...]
  torchrun --nproc_per_node 2 -m dropclip_tpu_torch.tools.train_distil \\
      --config configs/DistilBlender.yaml [--device cpu] [--opts ...]

Several processes (torchrun's environment, or the JAX package's keys
``dist_coordinator host:port``, ``num_processes`` and ``process_id``;
``dist_backend`` overrides NCCL on the card and gloo on the CPU) train
data-parallel as the JAX trainer's process mesh does: each rank loads its
``shard_index`` of every epoch at ``batch_size // world`` rows, the step
is the global batch's (``distill.engine``), brick capacities are tuned on
rank 0 and broadcast, validation runs each rank's val shard and averages
the scalar metrics over the ranks, and rank 0 alone writes checkpoints
and wandb; rank i > 0 logs to ``train.rank-<i>.log`` and dumps its
visualization under ``rank-<i>``.

Validation each ``eval_freq`` epochs: with a ``clip_checkpoint`` (a CLIP
checkpoint file, or "random"), segmentation eval (``eval_task`` all or
segmentation, with ``cls_list_path``) and grounding eval (``eval_task``
all or grounding, whose DistilLoss picks the best checkpoint); otherwise
the distil loss alone. ``visualize`` dumps one val scene per eval epoch.

``scan_epochs N`` trains in chunks of N epochs through
``distill.engine.make_scanned_train`` (one step captured as a CUDA graph
on the card, replayed for every step of a chunk) on the whole padded
dataset staged once on the device, with validation and checkpoints after
each chunk (one process, one device). ``profile_dir`` traces steps 10-14
of the first epoch with ``torch.profiler`` into that directory and logs
the per-op table (``core.xplane``).
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
from ..core.distributed import (broadcast_module, local_device,
                                maybe_initialize_distributed)
from ..core.logging import setup_logger
from ..core.mesh import (all_reduce_mean_host, broadcast_host, distributed,
                         process_count, process_index)
from ..core.meters import AverageMeter, ProgressMeter
from ..data import build_dataset_for
from ..data.loader import DataLoader
from ..distill.engine import (DistilBatch, brick_shape_of, build_student_for,
                              make_eval_step, make_scanned_train,
                              make_train_step)
from ..distill.evaluate import mean_over_ranks
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
    """Static brick capacities from 16 samples of ``ds`` unless set,
    ``autotune_capacities`` is False or the engine is not bricks: every
    brick conv scales with capacity and the M//8 rule over-allocates;
    slack 1.5 absorbs augmentation variance, and a scene past capacity
    only drops its overflow bricks (counted by the steps). Under a process
    group rank 0 tunes and broadcasts, so every rank builds one
    topology."""
    autotune = (cfg.autotune_capacities
                if cfg.autotune_capacities is not None else True)
    if (cfg.brick_capacities or not autotune
            or (cfg.sparse_backend or "bricks") != "bricks"):
        return
    levels = int(cfg.num_levels or 5)
    caps = np.zeros(levels, np.int64)
    if process_index() == 0:
        sample = collate([ds[i % len(ds)] for i in range(16)])
        caps[:] = autotune_brick_capacities(
            np.asarray(sample["coords"]), np.asarray(sample["mask"]),
            num_levels=levels, slack=1.5, brick_shape=brick_shape_of(cfg))
    cfg.brick_capacities = [int(c) for c in broadcast_host(caps)]
    logger.info("autotuned brick capacities: %s (brick shape %s)",
                cfg.brick_capacities, brick_shape_of(cfg))


def dump_visualization(val_ds, collate, eval_forward, epoch: int,
                       save_dir: str, cfg, batch_size: int) -> str:
    """One random val scene per eval epoch (reference engine/distil.py:
    551-648) to ``<save_dir>/vis/epoch-{E}/rank-{R}/``: ``outputs.npz``
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

    tgt_dir = os.path.join(save_dir, "vis", f"epoch-{epoch}",
                           f"rank-{process_index()}")
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
    ask for them, else the distil loss; each rank scores its own val
    shard and the scalar metrics are averaged over the ranks (the JAX
    trainer's mean of per-rank means). Logs the metrics and returns the
    loss that picks the best checkpoint, the same on every rank."""
    task = cfg.eval_task
    if clip_sim is not None and task in ("all", "segmentation") \
            and cfg.cls_list_path:
        import json

        from ..distill.evaluate import validate_segmentation

        with open(cfg.cls_list_path) as f:
            cls_names = list(json.load(f).values())
        res = mean_over_ranks(validate_segmentation(
            val_loader, eval_forward, clip_sim.encode_text(cls_names), cfg))
        logger.info("Eval Segmentation: Epoch=[%d/%s] %s", epoch,
                    cfg.epochs, res)
    if clip_sim is not None and task in ("all", "grounding"):
        from ..distill.evaluate import validate_grounding

        res = mean_over_ranks(validate_grounding(val_loader, eval_forward,
                                                 clip_sim, cfg))
        logger.info("Eval Grounding: Epoch=[%d/%s] %s", epoch, cfg.epochs,
                    res)
        if wandb_run is not None:
            wandb_run.log({"val_steps": epoch,
                           **{f"validation/{k}": v for k, v in res.items()}})
        return res["DistilLoss"]
    losses = [float(eval_forward(b)[1]) for b in val_loader]
    val_loss = float(np.mean(losses)) if losses else fallback
    val_loss = float(np.asarray(all_reduce_mean_host([val_loss]))[0])
    logger.info("Eval: Epoch=[%d/%s] DistilLoss=%.4f", epoch, cfg.epochs,
                val_loss)
    return val_loss


# the scanned trainer stages the whole padded dataset on the device
STAGE_LIMIT = 4 << 30


def stage_dataset(train_ds, collate, device: torch.device, start_epoch: int,
                  logger) -> DistilBatch:
    """Every training scene, padded and collated once (the augmentation
    and view draws of ``start_epoch``) and put on ``device`` as one batch
    with a scene axis; refused above ``STAGE_LIMIT`` bytes."""
    if hasattr(train_ds, "set_epoch"):
        train_ds.set_epoch(start_epoch)
    n = len(train_ds)
    logger.info("scan_epochs: staging %d scenes", n)
    staged = collate([train_ds[i] for i in range(n)])
    nbytes = sum(np.asarray(staged[k]).nbytes for k in (
        "coords", "mask", "in_feats", "targets", "labels"))
    if nbytes > STAGE_LIMIT:
        raise ValueError(f"scan_epochs: the staged dataset is "
                         f"{nbytes / 2**30:.1f} GiB, too large to hold on the "
                         "device; train with the per-step loop")
    return to_batch(staged, device)


def epoch_rows(loader: DataLoader, epoch: int) -> np.ndarray:
    """(steps, batch) dataset indices of ``loader``'s batches at
    ``epoch`` (its shuffle, its dropped last batch)."""
    loader.set_epoch(epoch)
    return np.stack(loader.batch_indices()).astype(np.int64)


def _run_scanned(cfg, state, train_loader, collate, device, logger,
                 save_dir, generator, start_epoch, best_val, run_validation,
                 wandb_run) -> None:
    """``scan_epochs``: the per-step loop's semantics (the loader's
    batches per epoch, the same optimizer steps) in chunks of
    ``scan_epochs`` epochs over the dataset staged once, as the JAX
    package's ``_run_scanned``; validation and the last and best
    checkpoints after each chunk."""
    if process_count() > 1:
        raise RuntimeError("scan_epochs runs one process on one device "
                           "(the staged data is one process's); train "
                           "data-parallel with the per-step loop")
    if cfg.use_augmentation:
        logger.warning("scan_epochs with use_augmentation: augmentation "
                       "draws are FROZEN at epoch %d (pre-staged data); "
                       "use the per-step loop for fresh per-epoch draws",
                       start_epoch)
    if len(train_loader) == 0:
        raise ValueError(f"scan_epochs: batch_size {cfg.batch_size} > "
                         f"dataset {len(train_loader.dataset)}")
    data = stage_dataset(train_loader.dataset, collate, device, start_epoch,
                         logger)
    chunk_fn = make_scanned_train(cfg)
    epochs = int(cfg.epochs or 200)
    scan_n = int(cfg.scan_epochs)
    for c0 in range(start_epoch, epochs, scan_n):
        c1 = min(c0 + scan_n, epochs)
        rows = np.concatenate([epoch_rows(train_loader, e)
                               for e in range(c0, c1)])
        t0 = time.time()
        state, generator, mstack = chunk_fn(state, data, rows, generator)
        loss_tail = float(mstack["distil_loss"][-1])
        dropped = int(mstack["dropped_voxels"].sum())
        logger.info("scan epochs [%d..%d): %d steps, distil_loss %.4f "
                    "(%.1fs)", c0, c1, len(rows), loss_tail,
                    time.time() - t0)
        if dropped:
            logger.warning("chunk [%d..%d): %d voxels/bricks dropped by "
                           "capacity overflow or grid extent: raise "
                           "brick_capacities", c0, c1, dropped)
        if wandb_run is not None:
            wandb_run.log({"train/distil_loss": loss_tail,
                           "train/step": state.step})
        val_loss = run_validation(c1 - 1, loss_tail)
        is_best = val_loss < best_val
        best_val = min(val_loss, best_val)
        save_checkpoint(save_dir, {
            "step": state.step, "model": state.model.state_dict(),
            "opt_state": state.opt_state, "epoch": c1 - 1,
            "best_val": best_val}, best=is_best)
        logger.info("saved checkpoint (epoch %d, best=%s)", c1 - 1, is_best)


class StepProfile:
    """``profile_dir``: ``torch.profiler`` over steps 10-14 of the first
    epoch (or to that epoch's end), its Chrome trace written into
    ``profile_dir`` and its per-op table logged (``core.xplane``)."""

    FIRST, LAST = 10, 14

    def __init__(self, profile_dir: Optional[str], device: torch.device):
        self.dir, self.device, self.prof = profile_dir, device, None

    def before(self, i: int) -> None:
        if self.dir and i == self.FIRST and self.prof is None:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()

    def after(self, i: int, logger, last: bool = False) -> None:
        if self.prof is None or self.dir is None or not (
                i == self.LAST or last):
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        path = os.path.join(self.dir, f"trace.rank-{process_index()}.json")
        self.prof.export_chrome_trace(path)
        from ..core.xplane import format_profile

        logger.info("profiler trace of steps %d-%d -> %s\n%s", self.FIRST,
                    i, path, format_profile(path))
        self.dir = None  # once


def _wandb(cfg, stamp, logger):
    """A wandb run on rank 0 when ``use_wandb`` is set and wandb is
    installed."""
    if not cfg.use_wandb or process_index() != 0:
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
    formed = maybe_initialize_distributed(cfg, device)
    try:
        return _train(cfg, local_device(device))
    finally:
        if formed:
            torch.distributed.destroy_process_group()


def _train(cfg, device: torch.device) -> str:
    rank, world = process_index(), process_count()
    # one stamp, rank 0's, names every rank's run directory
    stamp = datetime.datetime.fromtimestamp(int(broadcast_host(
        np.int64(time.time())))).strftime("%d-%m-%Y-%H:%M")
    save_dir = os.path.join(cfg.save_path or "./experiments",
                            f"Distill-{cfg.dataset}", stamp)
    logger = setup_logger(
        "dropclip", save_dir=save_dir, stderr=rank == 0,
        filename="train.log" if rank == 0 else f"train.rank-{rank}.log")
    logger.info("config:\n%s", cfg)
    logger.info("device: %s", torch.cuda.get_device_name(device)
                if device.type == "cuda" else device)
    if distributed():
        logger.info("process group: rank %d of %d, backend %s", rank, world,
                    torch.distributed.get_backend())
    wandb_run = _wandb(cfg, stamp, logger)
    seed = int(cfg.manual_seed or 42)
    np.random.seed(seed)

    bsz = int(cfg.batch_size or 8)
    bsz_val = int(cfg.batch_size_val or 8)
    if bsz % world or bsz_val % world:
        raise ValueError(f"batch_size {bsz} and batch_size_val {bsz_val} "
                         f"must divide over {world} processes")
    train_ds, val_ds, collate = build_dataset_for(cfg, device)
    if len(train_ds) == 0:
        raise ValueError(f"no training scenes for {cfg.dataset} "
                         f"(root_dir {cfg.root_dir}, processed_dir "
                         f"{cfg.processed_dir})")
    train_loader = DataLoader(train_ds, bsz // world, collate, shuffle=True,
                              num_workers=int(cfg.workers or 8), seed=seed,
                              shard_index=rank, num_shards=world)
    val_loader = None
    if val_ds is not None:
        val_loader = DataLoader(val_ds, bsz_val // world, collate,
                                shuffle=False,
                                num_workers=int(cfg.workers_val or 2),
                                shard_index=rank, num_shards=world)
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
    if distributed():
        broadcast_module(model)

    train_step = make_train_step(cfg)
    eval_step = make_eval_step(cfg)
    clip_sim = make_clip_sim(cfg, device)

    def eval_forward(b):
        out, m = eval_step(state, to_batch(b, device))
        return out, m["distil_loss"]

    dropout_gen = torch.Generator(device=device).manual_seed(seed + 1 + rank)

    def run_validation(epoch: int, fallback: float) -> float:
        """Validation after ``epoch`` (with its visualization), or
        ``fallback`` without a val set."""
        if val_loader is None:
            return fallback
        val_loss = validate(cfg, val_loader, eval_forward, clip_sim, epoch,
                            logger, fallback, wandb_run)
        if cfg.visualize:
            vdir = dump_visualization(val_ds, collate, eval_forward, epoch,
                                      save_dir, cfg, bsz_val // world)
            logger.info("visualization -> %s", vdir)
        return val_loss

    if int(cfg.scan_epochs or 0) > 0:
        _run_scanned(cfg, state, train_loader, collate, device, logger,
                     save_dir, dropout_gen, start_epoch, best_val,
                     run_validation, wandb_run)
        logger.info("done (scanned); checkpoints in %s", save_dir)
        return save_dir

    profiler = StepProfile(cfg.profile_dir, device)
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
            if epoch == start_epoch:
                profiler.before(i)
            state, metrics = train_step(state, to_batch(b, device),
                                        dropout_gen)
            # reading the metrics syncs the card (keeps the meters honest)
            lm.update(float(metrics["distil_loss"]), n=bsz)
            gm.update(float(metrics["grad_norm"]))
            epoch_dropped += int(metrics["dropped_voxels"])
            bt.update(time.time() - end)
            end = time.time()
            profiler.after(i, logger, last=i == iters_per_epoch - 1)
            if i % int(cfg.print_freq or 25) == 0:
                prog.display(i, print_fn=logger.info)
                if wandb_run is not None:
                    wandb_run.log({"train/distil_loss": lm.val,
                                   "train/grad_norm": gm.val,
                                   "train/step": state.step})
        if epoch_dropped:
            logger.warning(
                "epoch %d: %d voxels/bricks dropped by capacity overflow or "
                "grid extent: scenes are being truncated; raise "
                "brick_capacities or re-run the capacity autotune",
                epoch, epoch_dropped)
            if wandb_run is not None:
                wandb_run.log({"train/dropped_voxels": epoch_dropped})

        val_loss = lm.avg
        if epoch % int(cfg.eval_freq or 1) == 0:
            val_loss = run_validation(epoch, lm.avg)

        if epoch % int(cfg.save_freq or 1) == 0:
            # val_loss is the ranks' mean: is_best agrees on every rank
            is_best = val_loss < best_val
            best_val = min(val_loss, best_val)
            if rank == 0:
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
