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

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from ..core.distributed import (all_reduce_gradients, all_reduce_sum,
                                all_reduce_sum_diff)
from ..core.mesh import distributed, process_count
from ..core.spans import span
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


def build_topology(cfg, coords: torch.Tensor, mask: torch.Tensor,
                   grid_bits: Optional[int] = None):
    """The topology of (B, M, 3) coords on their device for
    ``cfg.sparse_backend``. Gather: ``build_unet_topology`` at the
    default level capacities. Bricks: brick capacities from
    ``cfg.brick_capacities`` (None -> the M//8 rule); the grid is
    ``grid_bits``, or else the smallest that holds every voxel of the
    batch (a read of two numbers), at least the JAX package's fixed 5
    (+-64 voxels, which drops much of a REGRAD scene at 1 mm once
    augmented)."""
    num_levels = int(cfg.num_levels or 5)
    if _backend(cfg) == "gather":
        return build_unet_topology(coords, mask, num_levels=num_levels)
    caps = cfg.brick_capacities
    if grid_bits is None:
        grid_bits = grid_bits_for(coords, mask)
    return build_brick_topology(
        coords, mask, num_levels=num_levels, grid_bits=grid_bits,
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


def _gradients(cfg, model, batch: DistilBatch,
               generator: Optional[torch.Generator],
               grid_bits: Optional[int] = None,
               wgrad_rows: Optional[Tuple[int, ...]] = None
               ) -> Dict[str, torch.Tensor]:
    """The step's forward and backward: the parameters' ``.grad`` set
    anew, and the step's metrics as device tensors. ``wgrad_rows``: the
    brick topology's static weight-gradient row bounds, or None."""
    with span("topology"):
        topo = build_topology(cfg, batch.coords, batch.mask, grid_bits)
    if wgrad_rows is not None:
        topo = topo._replace(wgrad_rows=wgrad_rows)
    model.train()
    for p in model.parameters():
        p.grad = None
    with span("student"):
        out = model(topo, batch.in_feats, generator=generator)
    loss, metrics = _compute_losses(out, batch, cfg)
    with span("train.backward"):
        loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["dropped_voxels"] = topology_dropped(topo)
    return metrics


def make_train_step(cfg, bounds: Optional[Tuple[int, Any]] = None):
    """Returns ``train_step(state, batch, generator=None) -> (state,
    metrics)``: one optimizer step in place on ``state``; ``generator``
    draws the dropout masks. The metrics are device tensors:
    ``distil_loss``, ``total_loss`` (and ``aux_loss``), ``grad_norm``
    (before clipping) and ``dropped_voxels``, all of the global batch
    under a process group. ``bounds``: None (each batch's own grid, the
    weight gradients read their row counts), or ``staged_bounds``' grid
    and row bounds, fixed as the scanned trainer fixes them."""
    grid_bits, wgrad_rows = bounds or (None, None)

    @span("train.step")
    def train_step(state: DistilTrainState, batch: DistilBatch,
                   generator: Optional[torch.Generator] = None):
        model = state.model
        metrics = _gradients(cfg, model, batch, generator, grid_bits,
                             wgrad_rows)
        if distributed():
            all_reduce_gradients(p for p in model.parameters()
                                 if p.grad is not None)
            metrics = _global_metrics(metrics)
        with span("train.optimizer"):
            metrics["grad_norm"] = state.apply_gradients()
        return state, metrics

    return train_step


def staged_bounds(cfg, data: DistilBatch, batch_size: int
                  ) -> Tuple[int, Optional[Tuple[int, ...]]]:
    """What a scanned trainer fixes once from its staged scenes: the brick
    grid that holds every voxel of them (``grid_bits_for``, a read of two
    numbers), and per level a bound on the occupied voxel rows of any
    batch of ``batch_size`` of them, ``batch_size`` times the most that
    one scene occupies there (one read per level; None off the brick
    engine). A scene's topology does not depend on the batch it rides in,
    and a grid larger than a batch's own gives the same topology
    (``grid_bits_for``), so the bounds hold for every batch."""
    grid_bits = grid_bits_for(data.coords, data.mask)
    if _backend(cfg) != "bricks":
        return grid_bits, None
    most = None
    for s0 in range(0, data.coords.shape[0], 16):  # 16 scenes at a time
        topo = build_topology(cfg, data.coords[s0:s0 + 16],
                              data.mask[s0:s0 + 16], grid_bits)
        n = torch.stack([lv.occ.flatten(1).sum(1).amax()
                         for lv in topo.levels])
        most = n if most is None else torch.maximum(most, n)
    return grid_bits, tuple(int(v) * batch_size for v in most)


_METRIC_KEYS = ("distil_loss", "total_loss", "aux_loss", "grad_norm",
                "dropped_voxels")


class _ScannedStep:
    """One step of a scanned chunk on the staged data: the batch gathered
    by row ``index`` of ``rows`` (both on the device), the forward and
    backward, the optimizer's ``update`` with ``count``, and the step's
    metrics written to row ``index`` of ``out`` before ``index`` advances.
    Every
    index and counter lives on the device, so the step reads nothing back
    to the host; on the card ``capture`` records it as a CUDA graph, each
    replay of which runs the next row."""

    def __init__(self, cfg, state: DistilTrainState, data: DistilBatch,
                 steps: int, batch_size: int,
                 generator: Optional[torch.Generator], grid_bits: int,
                 wgrad_rows: Optional[Tuple[int, ...]]):
        dev = data.coords.device
        self.cfg, self.state, self.data = cfg, state, data
        self.generator, self.grid_bits = generator, grid_bits
        self.wgrad_rows = wgrad_rows
        self.keys = [k for k in _METRIC_KEYS
                     if k != "aux_loss" or cfg.use_aux_loss
                     or cfg.use_cls_head]
        self.rows = torch.zeros((steps, batch_size), dtype=torch.int64,
                                device=dev)
        self.index = torch.zeros((), dtype=torch.int64, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.out = torch.zeros((steps, len(self.keys)), dtype=torch.float64,
                               device=dev)
        self.graph = None
        self.addresses = None
        self.k1_launches = 0  # K1 launches that the capture recorded

    def __call__(self) -> None:
        state = self.state
        idx = self.rows.index_select(0, self.index.view(1))[0]
        batch = DistilBatch(*(t.index_select(0, idx) for t in self.data))
        m = _gradients(self.cfg, state.model, batch, self.generator,
                       self.grid_bits, self.wgrad_rows)
        m["grad_norm"] = state.tx.update(state.model, state.opt_state,
                                         self.count)
        vals = torch.stack([m[k].double() for k in self.keys])
        self.out.index_copy_(0, self.index.view(1), vals[None])
        self.index.add_(1)

    def state_tensors(self):
        """The tensors a step changes in place: parameters, buffers (the
        BN statistics) and the optimizer's moments."""
        model, opt = self.state.model, self.state.opt_state
        return ([*model.parameters(), *model.buffers()]
                + [t for st in opt["moments"].values() for t in st.values()])

    def held(self):
        """The addresses a captured graph holds."""
        return [t.data_ptr() for t in (*self.state_tensors(), *self.data)]

    def capture(self) -> None:
        """Warm up on a side stream (K1's build and load, its tap tables,
        the BLAS handles, autograd), put the state back as it was, then
        capture one step. Raises if the capture fails: nothing falls back
        to eager steps on the card."""
        from ..kernels.brick_conv3 import counter

        gen = self.generator
        saved = [t.detach().clone() for t in self.state_tensors()]
        gen_state = gen.get_state() if gen is not None else None
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self.index.zero_()
            self()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self.state_tensors(), saved):
                t.copy_(v)
        del saved
        if gen is not None:
            gen.set_state(gen_state)
        for p in self.state.model.parameters():
            p.grad = None
        self.graph = torch.cuda.CUDAGraph()
        if gen is not None and float(self.cfg.dropout_rate or 0) > 0:
            # each replay draws the next dropout masks from ``gen``
            self.graph.register_generator_state(gen)
        before = counter.launches
        with torch.cuda.graph(self.graph):
            self()
        self.k1_launches = counter.launches - before
        self.addresses = self.held()

    def run(self, schedule: torch.Tensor) -> torch.Tensor:
        """Every row of ``schedule`` (steps, B), as graph replays on the
        card or eager calls on the CPU; (steps, keys) float64 metrics,
        read back once."""
        n = schedule.shape[0]
        self.rows[:n].copy_(schedule)
        self.index.zero_()
        self.count.fill_(int(self.state.opt_state["count"]))
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self()
        return self.out[:n].cpu()


def make_scanned_train(cfg):
    """The JAX package's ``lax.scan`` trainer (``engine.py:151-184``): N
    optimizer steps over data staged on the device, with no host sync
    inside a chunk.

    Returns ``train_chunk(state, data, schedule, generator=None) ->
    (state, generator, metrics)``: ``data`` is one ``DistilBatch`` with a
    leading scene axis on the device, ``schedule`` (steps, B) the scene
    indices of each step, ``generator`` the dropout generator, and
    ``metrics`` every step's scalar metrics stacked on axis 0 (read back
    once per chunk). Each step is ``make_train_step``'s, with three
    things fixed once from the staged data, so that the step reads
    nothing back to the host (``staged_bounds``): the brick grid, the
    k3 convs' weight-gradient row bounds (the topology's ``wgrad_rows``)
    and the optimizer's count as a device tensor (``AmsgradChain.update``
    with ``count``).

    On the card one step is captured as a CUDA graph (the counterpart of
    one jitted ``lax.scan``) and replayed for each row of the schedule: a
    device counter selects the row, advances the optimizer's count and
    places the step's metrics. A capture that fails raises; nothing falls
    back to eager steps on the card. The graph holds the state's tensors:
    a state whose tensors were replaced (a checkpoint loaded in) is
    captured anew. On the CPU the same step runs eagerly, row by row.
    Under a process group it raises: the staged data is one process's
    (the JAX trainer asserts a single device)."""
    cache: Dict[str, Any] = {}

    def train_chunk(state: DistilTrainState, data: DistilBatch,
                    schedule, generator: Optional[torch.Generator] = None):
        if distributed():
            raise RuntimeError("make_scanned_train runs one process on one "
                               "device; the per-step loop trains "
                               "data-parallel")
        schedule = torch.as_tensor(schedule, dtype=torch.int64)
        n, bsz = schedule.shape
        if cache.get("data") is not data or cache.get("bsz") != bsz:
            gb, bounds = staged_bounds(cfg, data, bsz)
            cache.clear()
            cache.update(data=data, bsz=bsz, grid_bits=gb, bounds=bounds)
        step = cache.get("step")
        if (step is None or step.state is not state
                or step.generator is not generator
                or step.rows.shape[0] < n
                or step.addresses not in (None, step.held())):
            cache["step"] = step = None  # its graph's memory goes first
            step = _ScannedStep(cfg, state, data, n, bsz, generator,
                                cache["grid_bits"], cache["bounds"])
            if data.coords.is_cuda:
                step.capture()
            cache["step"] = step
        out = step.run(schedule.to(data.coords.device))
        state.step += n
        state.opt_state["count"] = int(state.opt_state["count"]) + n
        metrics = {k: out[:, j].float() for j, k in enumerate(step.keys)}
        metrics["dropped_voxels"] = metrics["dropped_voxels"].long()
        return state, generator, metrics

    train_chunk.cache = cache  # "step": the _ScannedStep of the last chunk
    return train_chunk


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

