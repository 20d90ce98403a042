"""Deployable single-view grounding pipeline on one CUDA card.

Port of ``dropclip_tpu/pipeline.py`` (bricks engine, single device):

    pipe = GroundingPipeline(cfg, params, batch_stats, clip_sim)
    masks, sims = pipe.ground(xyz, rgb, ["the red mug"])

voxelize (host, numpy) -> brick topology (torch, on the card) ->
MinkUNet on bricks (every k3 conv through K1) -> paired-softmax
grounding against cached text embeddings (CLIP text tower, LayerNorms
through K6). Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, which runs the plain versions of the kernels; without a
card and without ``device``, construction raises instead of falling back.
"""

from __future__ import annotations

import logging
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .convert import student_state_dict
from .data.voxelize_np import sparse_quantize_np
from .distill.engine import build_student_for, build_topology, \
    topology_dropped
from .similarity import (NEGATIVE_PROMPT_GENERIC, ClipSimilarity,
                         predict_from_embeddings)


def resolve_device(device=None) -> torch.device:
    """``device`` as given, else the card; raises without one."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "dropclip_tpu_torch serves on a CUDA card and none is visible; "
            "pass device='cpu' to run the plain PyTorch versions instead")
    return torch.device("cuda")


def make_clip_sim(cfg, device=None, seed: int = 0
                  ) -> Optional[ClipSimilarity]:
    """Text encoder for grounding (``tools/train_distil.py::make_clip_sim``
    in the JAX package): the ``cfg.clip_model`` text tower in bf16.
    ``clip_checkpoint: random`` draws its weights from ``seed``; real
    checkpoints load through ``convert.clip_text_state_dict``. None when
    no checkpoint is configured."""
    if not cfg.clip_checkpoint:
        return None
    from .teachers.clip import build_clip_text

    if cfg.clip_checkpoint != "random":
        raise NotImplementedError(
            "reading CLIP checkpoint files comes with the ingest slice "
            "(ROADMAP queue 1 item 14); load a state dict from "
            "convert.clip_text_state_dict instead")
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    model = build_clip_text(cfg.clip_model or "ViT-L/14@336px",
                            dtype=torch.bfloat16, generator=gen).to(device)
    return ClipSimilarity(model, device)


class GroundingPipeline:
    """xyz/rgb -> per-point features -> text-query 3D masks.

    ``params``/``batch_stats``: the JAX student's flax trees as numpy
    dicts (``convert.student_state_dict`` maps them); None draws a seeded
    student. ``forwards`` counts student forwards (each runs 16 k3 convs
    on MinkUNet14D)."""

    def __init__(self, cfg, params: Optional[Mapping[str, Any]] = None,
                 batch_stats: Optional[Mapping[str, Any]] = None,
                 clip_sim: Optional[ClipSimilarity] = None,
                 brick_capacities: Optional[Sequence[int]] = None,
                 engine: Optional[str] = None, device=None, seed: int = 0):
        self.engine = engine or cfg.sparse_backend or "bricks"
        if self.engine != "bricks":
            raise NotImplementedError(
                f"engine {self.engine!r} is not ported yet: the gather and "
                "pillar engines come with slice 3 (ROADMAP queue 1 items "
                "22-23)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.capacity = int(cfg.voxel_capacity or 8192)
        self.voxel_size = float(cfg.voxel_size or 0.05)
        self.use_color = bool(cfg.use_color)
        if brick_capacities:
            cfg.brick_capacities = list(brick_capacities)
        self.last_dropped = 0  # voxels truncated by the last forward
        self.forwards = 0
        self.model = build_student_for(
            cfg, generator=torch.Generator().manual_seed(seed))
        if params is not None:
            self.model.load_state_dict(
                student_state_dict(params, batch_stats or {}))
        self.model.to(self.device)
        self.clip_sim = clip_sim

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

    def featurize(self, xyz: np.ndarray, rgb: Optional[np.ndarray] = None
                  ) -> Tuple[torch.Tensor, np.ndarray, Any]:
        """(N, 3) points (+ optional (N, 3) colors in [0, 1]) -> (per-voxel
        features (cap, C) on the device, voxel validity (cap,), vox record
        with the inverse map back to input points)."""
        vox, in_feats = self._host_voxelize(xyz, rgb)
        out = self._forward(vox.coords[None], vox.mask[None], in_feats[None])
        return out[0], vox.mask, vox

    def _host_voxelize(self, xyz: np.ndarray, rgb: Optional[np.ndarray]):
        xyz = np.asarray(xyz, np.float32)
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
        arrays for both."""
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
