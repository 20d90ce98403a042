"""Train and eval steps of the distillation trainer.

Port of ``dropclip_tpu/distill/engine.py``. The reference's hot loop
(engine/distil.py:99-230) is: H2D copy, sparse tensor, UNet forward, cosine
loss (+ optional aux hinge / cls-head CE), backward, grad clip,
per-iteration cosine LR step. Here one step builds the brick topology on
the batch's device, runs the student in training mode (K1 in every k3
conv's forward and input gradient on the card), the losses, the backward
and the optimizer chain; its metrics stay tensors on the device until the
caller reads them. ``sparse_backend`` picks the engine: "bricks" (the
default) or "gather" (per-voxel kernel maps, ``sparse.topology``; the
reference-parity baseline).

Under a process group of several ranks (``core.distributed``) a step is
the global batch's step, as the JAX package's sharded program computes
it: the batch norms sum their moments over the ranks, each rank's loss is
its local sum over the global count (so the ranks' losses sum to the
global mean), the non-separable part of the aux hinge (the clip of the
margin against its baseline) is taken on global means and shared equally,
the gradients are summed over the ranks in one flattened all-reduce
before the optimizer (whose global-norm clip then sees the global
gradients), and the metrics are the global batch's. The scanned trainer
comes with a later slice.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..core.distributed import (all_reduce_gradients, all_reduce_sum,
                                all_reduce_sum_diff)
from ..core.mesh import distributed, process_count
from ..sparse.bricks import build_brick_topology, grid_bits_for
from ..sparse.topology import build_unet_topology
from .loss import (aux_hinge_loss, cosine_distil_loss, cross_entropy_cls_loss,
                   l1_distil_loss)
from .train_state import DistilTrainState
from .train_state import global_norm as optax_global_norm  # noqa: F401


def _backend(cfg) -> str:
    backend = cfg.sparse_backend or "bricks"
    if backend not in ("bricks", "gather"):
        raise ValueError(f"sparse_backend {backend!r}: want bricks or "
                         "gather (the pillar engine serves through "
                         "GroundingPipeline)")
    return backend


def build_topology(cfg, coords: torch.Tensor, mask: torch.Tensor):
    """The topology of (B, M, 3) coords on their device for
    ``cfg.sparse_backend``. Gather: ``build_unet_topology`` at the
    default level capacities. Bricks: brick capacities from
    ``cfg.brick_capacities`` (None -> the M//8 rule); the grid is the
    smallest that holds every voxel of the batch, at least the JAX
    package's fixed 5 (+-64 voxels, which drops much of a REGRAD scene at
    1 mm once augmented)."""
    num_levels = int(cfg.num_levels or 5)
    if _backend(cfg) == "gather":
        return build_unet_topology(coords, mask, num_levels=num_levels)
    caps = cfg.brick_capacities
    return build_brick_topology(
        coords, mask, num_levels=num_levels,
        grid_bits=grid_bits_for(coords, mask),
        brick_capacities=tuple(caps) if caps else None,
        brick_shape=brick_shape_of(cfg))


def brick_shape_of(cfg) -> tuple:
    """cfg.brick_shape ([4, 4, 2] or "4,4,2") -> static tuple; default
    isotropic (4, 4, 4)."""
    bs = cfg.brick_shape
    if bs is None:
        return (4, 4, 4)
    if isinstance(bs, str):
        bs = bs.split(",")
    return tuple(int(v) for v in bs)


def student_in_channels(cfg) -> int:
    """Width of the dataset's ``in_feats``: xyz, rgb with ``use_color``,
    and with ``use_view_clip`` the view teacher's patch features (its CLIP
    embedding width: 774 in all for ViT-L/14@336px). The flax student
    reads it off its first input; here the stem is built for it."""
    width = 6 if cfg.use_color else 3
    if cfg.use_view_clip:
        from ..teachers.clip import CLIP_CONFIGS

        width += CLIP_CONFIGS[cfg.view_clip_model
                              or "ViT-L/14@336px"]["embed_dim"]
    return width


def build_student_for(cfg, generator: Optional[torch.Generator] = None):
    """Student factory honouring cfg.sparse_backend, its stem as wide as
    the dataset's input (``student_in_channels``). Both engines register
    the same modules in the same order: one seed, one state dict."""
    if _backend(cfg) == "gather":
        from ..sparse.unet import build_student

        return build_student(cfg, in_channels=student_in_channels(cfg),
                             generator=generator)
    from ..sparse.unet_bricks import build_student_bricks

    return build_student_bricks(cfg, in_channels=student_in_channels(cfg),
                                generator=generator)


def topology_dropped(topo) -> torch.Tensor:
    """Scalar count of units the topology truncated: voxels past the
    brick grid or a brick capacity, or, on the gather engine, voxels past
    the keys' range or a level's capacity (the JAX package reports 0 for
    the gather engine while it drops them); 0 for a topology without
    counters."""
    d = getattr(topo, "dropped", None)
    if d is None:
        return torch.zeros((), dtype=torch.int64)
    return d.sum()


class DistilBatch(NamedTuple):
    """One padded batch on the device.

    coords: (B, M, 3) int32 voxel coords; mask: (B, M) bool occupancy;
    in_feats: (B, M, Cin) xyz(+rgb) inputs; targets: (B, M, F) fused
    teacher features; labels: (B, M) instance ids; labels_cls: (B, M)
    class ids.
    """

    coords: torch.Tensor
    mask: torch.Tensor
    in_feats: torch.Tensor
    targets: torch.Tensor
    labels: torch.Tensor
    labels_cls: torch.Tensor


def _global_count(w: torch.Tensor) -> Optional[torch.Tensor]:
    """The global batch's count of ``w`` (a 0/1 weight) under a process
    group; None (the loss's own local count) without one."""
    if not distributed():
        return None
    return all_reduce_sum(w.float().sum())


def _compute_losses(model_out, batch: DistilBatch, cfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, metrics) of the step; under a process group, this rank's
    share of the global batch's loss (the shares sum to it)."""
    world = process_count()
    use_cls = bool(cfg.use_cls_head)
    out = model_out[0] if use_cls else model_out
    count = _global_count(batch.mask)

    loss_type = cfg.loss_type or "cosine"
    if loss_type == "cosine":
        dloss = cosine_distil_loss(out, batch.targets, batch.mask, count)
    elif loss_type == "l1":
        dloss = l1_distil_loss(out, batch.targets, batch.mask, count)
    else:
        raise NotImplementedError(loss_type)

    loss = dloss
    metrics = {"distil_loss": dloss}
    if cfg.use_aux_loss:
        max_labels = int(cfg.max_objects or 32)
        scenes = batch.mask.shape[0] * world
        pos, mar = aux_hinge_loss(out, batch.labels, batch.mask, max_labels,
                                  n_scenes=scenes)
        # baseline hinge from the targets, no gradient (reference
        # engine/distil.py:176-182: aux = pos + clip(margin - margin_base))
        _, mar_base = aux_hinge_loss(batch.targets.detach(), batch.labels,
                                     batch.mask, max_labels, n_scenes=scenes)
        if distributed():
            mar, mar_base = all_reduce_sum_diff(mar), all_reduce_sum(mar_base)
        hinge = (mar - mar_base.detach()).clamp(min=0.0) / world
        aux = (pos + hinge) * float(cfg.loss_weight_aux or 1.0)
        loss = loss + aux
        metrics["aux_loss"] = aux
    elif use_cls:
        valid = batch.mask & (batch.labels_cls != int(cfg.ignore_label or 255))
        xloss = cross_entropy_cls_loss(
            model_out[1], batch.labels_cls, batch.mask,
            ignore_label=int(cfg.ignore_label or 255),
            count=_global_count(valid))
        xloss = xloss * float(cfg.loss_weight_cls or 1.0)
        loss = loss + xloss
        metrics["aux_loss"] = xloss
    metrics["total_loss"] = loss
    return loss, metrics


def _global_metrics(metrics: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The ranks' shares summed, in one all-reduce (the global batch's
    losses and dropped count)."""
    keys = sorted(metrics)
    summed = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]))
    return {k: v.to(metrics[k].dtype) for k, v in zip(keys, summed)}


def make_train_step(cfg):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``: one optimizer step in place on ``state``; ``generator``
    draws the dropout masks. The metrics are device tensors:
    ``distil_loss``, ``total_loss`` (and ``aux_loss``), ``grad_norm``
    (before clipping) and ``dropped_voxels``, all of the global batch
    under a process group."""
    def train_step(state: DistilTrainState, batch: DistilBatch,
                   generator: Optional[torch.Generator] = None):
        topo = build_topology(cfg, batch.coords, batch.mask)
        model = state.model
        model.train()
        for p in model.parameters():
            p.grad = None
        out = model(topo, batch.in_feats, generator=generator)
        loss, metrics = _compute_losses(out, batch, cfg)
        loss.backward()
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["dropped_voxels"] = topology_dropped(topo)
        if distributed():
            all_reduce_gradients(p for p in model.parameters()
                                 if p.grad is not None)
            metrics = _global_metrics(metrics)
        metrics["grad_norm"] = state.apply_gradients()
        return state, metrics

    return train_step


def make_scanned_train(cfg):
    """The JAX package's ``lax.scan`` trainer (N steps in one program)."""
    raise NotImplementedError(
        "make_scanned_train is not ported: N steps captured as one CUDA "
        "graph waits for its ROADMAP queue 1 item, make_scanned_train as a "
        "CUDA graph")


def make_eval_step(cfg):
    """Returns ``eval_step(state, batch) -> (out_features, metrics)``: eval
    mode (running BN statistics), no gradient, K1 on the card."""
    def eval_step(state: DistilTrainState, batch: DistilBatch):
        topo = build_topology(cfg, batch.coords, batch.mask)
        model = state.model
        model.eval()
        with torch.no_grad():
            out = model(topo, batch.in_feats)
            if cfg.use_cls_head:
                out = out[0]
            dloss = cosine_distil_loss(out, batch.targets, batch.mask)
        return out, {"distil_loss": dloss,
                     "dropped_voxels": topology_dropped(topo)}

    return eval_step

