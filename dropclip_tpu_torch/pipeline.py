"""Deployable single-view grounding pipeline on one CUDA card.

Port of ``dropclip_tpu/pipeline.py`` (single device):

    pipe = GroundingPipeline(cfg, params, batch_stats, clip_sim)
    masks, sims = pipe.ground(xyz, rgb, ["the red mug"])

voxelize (host, numpy) -> student -> paired-softmax grounding against
cached text embeddings (CLIP text tower, LayerNorms through K6). Two
engines run the student: "bricks" (the default; brick topology built by
torch ops on the card, every k3 conv through K1) and "pillars" (the
volumetric engine for bin and shelf scenes; host-built pillar topology at
frozen static shapes, every k3 conv through K2, one scene per call).
``GroundingPipeline.from_checkpoint`` loads the port trainer's checkpoint.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``,
which runs the plain versions of the kernels; without a card and without
``device``, construction raises instead of falling back.
"""

from __future__ import annotations

import logging
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import student_state_dict
from .core.device import resolve_device
from .data.voxelize_np import sparse_quantize_np
from .distill.engine import build_student_for, build_topology, \
    topology_dropped
from .similarity import (NEGATIVE_PROMPT_GENERIC, ClipSimilarity,
                         predict_from_embeddings)
from .sparse.pillar_topology import build_pillar_topology
from .sparse.unet_pillars import build_student_pillars


def fit_pillar_shapes(probes) -> Tuple[int, List[int]]:
    """The pillar engine's static shapes from exact-fit topologies: z0 =
    16 * ceil(1.5 * z / 16) and each level's site capacity 16 * ceil(1.3 *
    P / 16), the largest over ``probes``."""
    z0 = max(16 * int(np.ceil(t.levels[0].occ.shape[1] * 1.5 / 16))
             for t in probes)
    caps = [max(16 * int(np.ceil(t.levels[lvl].occ.shape[0] * 1.3 / 16))
                for t in probes) for lvl in range(len(probes[0].levels))]
    return z0, caps


def make_clip_sim(cfg, device=None, seed: int = 0
                  ) -> Optional[ClipSimilarity]:
    """Text encoder for grounding (``tools/train_distil.py::make_clip_sim``
    in the JAX package): the ``cfg.clip_model`` text tower in bf16 with
    ``cfg.sim_method`` and ``cfg.sim_norm_thresh`` as its defaults.
    ``clip_checkpoint`` is a CLIP checkpoint file in either public layout
    (``teachers/convert.load_params``), or "random" to draw the weights
    from ``seed``. None when no checkpoint is configured."""
    if not cfg.clip_checkpoint:
        return None
    from .teachers.convert import build_clip_text_from

    device = resolve_device(device)
    model = build_clip_text_from(cfg.clip_model or "ViT-L/14@336px",
                                 cfg.clip_checkpoint, dtype=torch.bfloat16,
                                 seed=seed)
    return ClipSimilarity(model.to(device), device,
                          method=cfg.sim_method or "paired",
                          threshold=float(cfg.sim_norm_thresh or 0.7))


class GroundingPipeline:
    """xyz/rgb -> per-point features -> text-query 3D masks.

    ``params``/``batch_stats``: the JAX student's flax trees as numpy
    dicts (``convert.student_state_dict`` maps them, for either engine);
    None draws a seeded student. ``forwards`` counts student forwards
    (each runs 16 k3 convs on MinkUNet14D).

    ``engine``: "bricks" (``cfg.sparse_backend``'s default) or "pillars".
    The pillar engine's static shapes (``pillar_site_capacities`` per level
    and ``pillar_z0``) default to a slack-padded fit of the FIRST scene
    (``fit_pillar_shapes``), so later scenes reuse them; pass them when
    the first scene is not representative."""

    def __init__(self, cfg, params: Optional[Mapping[str, Any]] = None,
                 batch_stats: Optional[Mapping[str, Any]] = None,
                 clip_sim: Optional[ClipSimilarity] = None,
                 brick_capacities: Optional[Sequence[int]] = None,
                 engine: Optional[str] = None, device=None, seed: int = 0,
                 pillar_site_capacities: Optional[Sequence[int]] = None,
                 pillar_z0: Optional[int] = None):
        self.engine = engine or cfg.sparse_backend or "bricks"
        if self.engine not in ("bricks", "pillars"):
            raise NotImplementedError(
                f"engine {self.engine!r} is not ported yet: the gather "
                "engine comes with slice 3 (ROADMAP queue 1 item 22)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(cfg.voxel_capacity or 8192)
        self.voxel_size = float(cfg.voxel_size or 0.05)
        self.use_color = bool(cfg.use_color)
        if brick_capacities:
            cfg.brick_capacities = list(brick_capacities)
        self.last_dropped = 0  # voxels / sites truncated by the last forward
        self.forwards = 0
        gen = torch.Generator().manual_seed(seed)
        if self.engine == "pillars":
            self.model = build_student_pillars(cfg, generator=gen)
            self.pillar_caps = (list(pillar_site_capacities)
                                if pillar_site_capacities else None)
            self.pillar_z0 = pillar_z0
        else:
            self.model = build_student_for(cfg, generator=gen)
        if params is not None:
            self.model.load_state_dict(
                student_state_dict(params, batch_stats or {}))
        self.model.to(self.device)
        self.clip_sim = clip_sim

    @classmethod
    def from_checkpoint(cls, config_path: str, ckpt_dir: str,
                        clip_checkpoint: Optional[str] = None,
                        ckpt_name: str = "best_sim_loss_model",
                        overrides: Optional[Sequence[str]] = None,
                        device=None) -> "GroundingPipeline":
        """Build from a training config and a checkpoint directory of the
        port's trainer (``<ckpt_dir>/<ckpt_name>.pt``). ``overrides``: the
        "key value ..." list of the CLIs' ``--opts``; it must repeat the
        shape options the training run used (feat_dim, voxel_capacity,
        arch_3d, ...). The JAX trainer's orbax directories are not read."""
        from .core.checkpoint import load_model
        from .core.config import load_cfg, merge_cfg_from_list

        cfg = load_cfg(config_path)
        if overrides:
            cfg = merge_cfg_from_list(cfg, list(overrides))
        if clip_checkpoint:
            cfg.clip_checkpoint = clip_checkpoint
        device = resolve_device(device)
        clip_sim = make_clip_sim(cfg, device)
        if clip_sim is None:
            raise ValueError("grounding needs a clip_checkpoint")
        pipe = cls(cfg, clip_sim=clip_sim, device=device)
        load_model(pipe.model, ckpt_dir, ckpt_name, map_location=device)
        return pipe

    @torch.no_grad()
    def _forward(self, coords: np.ndarray, mask: np.ndarray,
                 in_feats: np.ndarray) -> torch.Tensor:
        """(B, M, ...) host arrays -> (B, M, C) features on the device."""
        dev = self.device
        coords_t = torch.as_tensor(coords, device=dev)
        mask_t = torch.as_tensor(mask, device=dev)
        topo = build_topology(self.cfg, coords_t, mask_t)
        out = self.model(topo, torch.as_tensor(in_feats, device=dev))
        out = out[0] if isinstance(out, tuple) else out
        self.forwards += 1
        self.last_dropped = int(topology_dropped(topo))
        if self.last_dropped:
            logging.getLogger("dropclip").warning(
                "GroundingPipeline: %d voxels dropped (brick capacity / "
                "grid extent overflow) — grounding masks will miss that "
                "geometry; raise brick_capacities", self.last_dropped)
        return out

    @torch.no_grad()
    def _forward_pillars(self, vox, in_feats: np.ndarray) -> torch.Tensor:
        """One scene through the pillar student: host topology at the
        frozen static shapes, fitted on this scene if none are set. An
        empty scene gives zero features and freezes nothing."""
        if not vox.mask.any():
            self.last_dropped = 0
            return torch.zeros((self.capacity, self.model.final.kernel
                                .shape[-1]), device=self.device)
        if self.pillar_caps is None or self.pillar_z0 is None:
            z0, caps = fit_pillar_shapes([build_pillar_topology(
                vox.coords, vox.mask, device="cpu")])
            if self.pillar_z0 is None:
                self.pillar_z0 = z0
            if self.pillar_caps is None:
                self.pillar_caps = caps
        topo = build_pillar_topology(vox.coords, vox.mask, z0=self.pillar_z0,
                                     site_capacities=self.pillar_caps,
                                     device=self.device)
        out = self.model(topo, torch.as_tensor(in_feats, device=self.device))
        self.forwards += 1
        self.last_dropped = topo.dropped
        if self.last_dropped:
            logging.getLogger("dropclip").warning(
                "GroundingPipeline[pillars]: %d pillar sites dropped (site "
                "capacity overflow) — raise pillar_site_capacities",
                self.last_dropped)
        return out

    def featurize(self, xyz: np.ndarray, rgb: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, np.ndarray, Any]:
        """(N, 3) points (+ optional (N, 3) colors in [0, 1]) -> (per-voxel
        features (cap, C) on the device, voxel validity (cap,), vox record
        with the inverse map back to input points)."""
        vox, in_feats = self._host_voxelize(xyz, rgb)
        if self.engine == "pillars":
            return self._forward_pillars(vox, in_feats), vox.mask, vox
        out = self._forward(vox.coords[None], vox.mask[None], in_feats[None])
        return out[0], vox.mask, vox

    def _host_voxelize(self, xyz: np.ndarray, rgb: Optional[np.ndarray]):
        xyz = np.asarray(xyz, np.float32)
        if not len(xyz):  # an empty cloud: no voxel, zero features
            return (sparse_quantize_np(xyz, self.voxel_size, self.capacity),
                    np.zeros((self.capacity, 6 if self.use_color else 3),
                             np.float32))
        centered = xyz - xyz.mean(axis=0)
        vox = sparse_quantize_np(centered, self.voxel_size, self.capacity)
        pos = centered[vox.unique_idx] * vox.mask[:, None]
        if self.use_color:
            rgb = np.asarray(rgb, np.float32) if rgb is not None else \
                np.zeros_like(xyz)
            col = rgb[vox.unique_idx] * vox.mask[:, None]
            in_feats = np.concatenate([pos, col], axis=-1)
        else:
            in_feats = pos
        return vox, in_feats.astype(np.float32)

    def _settings(self, threshold: Optional[float]):
        thr = threshold if threshold is not None \
            else float(self.cfg.sim_norm_thresh or 0.75)
        return self.cfg.sim_method or "paired", thr

    @staticmethod
    def _to_points(masks: np.ndarray, vox, n_queries: int) -> np.ndarray:
        inv = vox.inverse_map
        valid = inv >= 0
        out = np.zeros((n_queries, len(inv)), bool)
        out[:, valid] = masks[:, inv[valid]]
        return out

    def ground_batch(self, clouds: Sequence[np.ndarray],
                     rgbs: Optional[Sequence[Optional[np.ndarray]]],
                     queries: Sequence[str],
                     negatives: Optional[List[str]] = None,
                     threshold: Optional[float] = None,
                     per_point: bool = True):
        """Throughput serving: B scenes x shared queries, one folded
        student forward. Returns (masks, sims): lists of per-scene (Q, N_i)
        masks and (B, Q, cap) sims when ``per_point``, else (B, Q, cap)
        arrays for both. The brick engine only: the pillar engine serves
        one scene per ``ground`` call."""
        if self.engine == "pillars":
            raise ValueError(
                "ground_batch runs the batched brick program; the pillar "
                "engine serves per scene — call ground() per cloud")
        b = len(clouds)
        rgbs = rgbs if rgbs is not None else [None] * b
        voxes, feats_in = zip(*[self._host_voxelize(x, r)
                                for x, r in zip(clouds, rgbs)])
        vmask = np.stack([v.mask for v in voxes])
        out = self._forward(np.stack([v.coords for v in voxes]), vmask,
                            np.stack(feats_in))
        neg = self.clip_sim.encode_text(
            negatives if negatives else NEGATIVE_PROMPT_GENERIC)
        qpos = [self.clip_sim.encode_text([q])[0] for q in queries]
        method, thr = self._settings(threshold)
        vmask_t = torch.as_tensor(vmask, device=self.device)
        masks, sims = [], []
        for i in range(b):
            per_q = [predict_from_embeddings(out[i], p, neg, mask=vmask_t[i],
                                             method=method, threshold=thr)
                     for p in qpos]
            masks.append(torch.stack([m for m, _ in per_q]))
            sims.append(torch.stack([s for _, s in per_q]))
        masks = torch.stack(masks).cpu().numpy()
        sims = torch.stack(sims).cpu().numpy()
        if not per_point:
            return masks, sims
        return [self._to_points(masks[i], vox, len(queries))
                for i, vox in enumerate(voxes)], sims

    def ground(self, xyz: np.ndarray, rgb: Optional[np.ndarray],
               queries: Sequence[str],
               negatives: Optional[List[str]] = None,
               threshold: Optional[float] = None,
               per_point: bool = True):
        """Ground text queries in the cloud. Returns (masks (Q, N) bool
        over INPUT points if ``per_point`` else (Q, cap) over voxels,
        sims (Q, cap) normalized similarity). Unassigned / overflow input
        points get mask False."""
        feats, vmask, vox = self.featurize(xyz, rgb)
        neg = self.clip_sim.encode_text(
            negatives if negatives else NEGATIVE_PROMPT_GENERIC)
        method, thr = self._settings(threshold)
        vmask_t = torch.as_tensor(vmask, device=self.device)
        per_q = [predict_from_embeddings(
            feats, self.clip_sim.encode_text([q])[0], neg, mask=vmask_t,
            method=method, threshold=thr) for q in queries]
        masks = torch.stack([m for m, _ in per_q]).cpu().numpy()
        sims = torch.stack([s for _, s in per_q]).cpu().numpy()
        if per_point:
            return self._to_points(masks, vox, len(queries)), sims
        return masks, sims
