"""Train and eval steps of the distillation trainer.

Port of ``dropclip_tpu/distill/engine.py``. The reference's hot loop
(engine/distil.py:99-230) is: H2D copy, sparse tensor, UNet forward, cosine
loss (+ optional aux hinge / cls-head CE), backward, grad clip,
per-iteration cosine LR step. Here one step builds the brick topology on
the batch's device, runs the student in training mode (K1 in every k3
conv's forward and input gradient on the card), the losses, the backward
and the optimizer chain; its metrics stay tensors on the device until the
caller reads them. Only the brick engine is ported; the gather backend and
the scanned trainer come with later slices.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..sparse.bricks import BrickTopology, build_brick_topology
from .loss import (aux_hinge_loss, cosine_distil_loss, cross_entropy_cls_loss,
                   l1_distil_loss)
from .train_state import DistilTrainState
from .train_state import global_norm as optax_global_norm  # noqa: F401


def _require_bricks(cfg) -> None:
    backend = cfg.sparse_backend or "bricks"
    if backend != "bricks":
        raise NotImplementedError(
            f"sparse_backend {backend!r} is not ported yet: the gather "
            "engine comes with slice 3 (ROADMAP queue 1 item 7.2)")


def build_topology(cfg, coords: torch.Tensor, mask: torch.Tensor
                   ) -> BrickTopology:
    """Brick topology for (B, M, 3) coords on their device; brick
    capacities from ``cfg.brick_capacities`` (None -> the M//8 rule)."""
    _require_bricks(cfg)
    caps = cfg.brick_capacities
    return build_brick_topology(
        coords, mask, num_levels=int(cfg.num_levels or 5),
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


def build_student_for(cfg, generator: Optional[torch.Generator] = None):
    """Student factory honouring cfg.sparse_backend (bricks only)."""
    _require_bricks(cfg)
    from ..sparse.unet_bricks import build_student_bricks

    return build_student_bricks(cfg, generator=generator)


def topology_dropped(topo) -> torch.Tensor:
    """Scalar count of units the topology truncated (capacity overflow /
    out-of-extent); 0 for a topology without counters."""
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


def _compute_losses(model_out, batch: DistilBatch, cfg
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    use_cls = bool(cfg.use_cls_head)
    out = model_out[0] if use_cls else model_out

    loss_type = cfg.loss_type or "cosine"
    if loss_type == "cosine":
        dloss = cosine_distil_loss(out, batch.targets, batch.mask)
    elif loss_type == "l1":
        dloss = l1_distil_loss(out, batch.targets, batch.mask)
    else:
        raise NotImplementedError(loss_type)

    loss = dloss
    metrics = {"distil_loss": dloss}
    if cfg.use_aux_loss:
        max_labels = int(cfg.max_objects or 32)
        pos, mar = aux_hinge_loss(out, batch.labels, batch.mask, max_labels)
        # baseline hinge from the targets, no gradient (reference
        # engine/distil.py:176-182: aux = pos + clip(margin - margin_base))
        _, mar_base = aux_hinge_loss(batch.targets.detach(), batch.labels,
                                     batch.mask, max_labels)
        aux = pos + (mar - mar_base.detach()).clamp(min=0.0)
        aux = aux * float(cfg.loss_weight_aux or 1.0)
        loss = loss + aux
        metrics["aux_loss"] = aux
    elif use_cls:
        xloss = cross_entropy_cls_loss(
            model_out[1], batch.labels_cls, batch.mask,
            ignore_label=int(cfg.ignore_label or 255))
        xloss = xloss * float(cfg.loss_weight_cls or 1.0)
        loss = loss + xloss
        metrics["aux_loss"] = xloss
    metrics["total_loss"] = loss
    return loss, metrics


def make_train_step(cfg):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``: one optimizer step in place on ``state``; ``generator``
    draws the dropout masks. The metrics are device tensors:
    ``distil_loss``, ``total_loss`` (and ``aux_loss``), ``grad_norm``
    (before clipping) and ``dropped_voxels``."""
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
        metrics["grad_norm"] = state.apply_gradients()
        metrics["dropped_voxels"] = topology_dropped(topo)
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

