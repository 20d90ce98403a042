"""REGRAD-processed distillation dataset.

Port of ``dropclip_tpu/data/dataset_regrad.py`` (numpy, on the host),
itself a port of the reference REGRAD dataset (reference data/dataset.py:12-280):
loads processed ``{scene}.h5py`` or ``{scene}.npz`` scenes
(``scene_io.read_regrad_scene``: pointcloud xyz/rgb/label + multiview
per_obj or patch feats + obj_ids; the card's machine has no h5py), splats per-object features, augments, sparse-
quantizes, and builds class labels (instance -> model class via the
objects json + cls_map, 255 ignore, :186-199) and grounding queries
(model name -> instance ids, :201-216). Splits: train / seen_val /
unseen_val.

Fixed-capacity padded outputs with masks (like dataset_blender),
deterministic per-(seed, epoch, index) RNG (the JAX dataset's draws),
collate to batch arrays including ``labels_cls``.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np

from . import augmentations as aug
from .scene_io import read_regrad_scene
from .voxelize_np import sparse_quantize_np

MAX_POINTS = 10000


class RegradDistilDataset:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.split = split
        self.capacity = int(cfg.voxel_capacity or 8192)
        self.voxel_size = float(cfg.voxel_size or 0.05)
        self.use_color = bool(cfg.use_color)
        self.seed = int(cfg.manual_seed or 42)
        self.epoch = 0

        self.files = sorted(
            f for ext in ("h5py", "npz") for f in glob.glob(
                os.path.join(cfg.processed_dir, split, f"*.{ext}")))
        objects_path = (cfg.objects_train_path if split == "train"
                        else cfg.objects_val_path)
        self.objects_json = json.load(open(objects_path)) \
            if objects_path and os.path.exists(objects_path) else {}
        cls_map_path = cfg.cls_map_path
        self.cls_map = json.load(open(cls_map_path)) \
            if cls_map_path and os.path.exists(cls_map_path) else {}

        self.use_augm = bool(cfg.use_augmentation) and split == "train"
        if self.use_augm:
            elastic = ((cfg.aug_elastic_distortion_granularity_min,
                        cfg.aug_elastic_distortion_granularity_max),
                       (cfg.aug_elastic_distortion_magnitude_min,
                        cfg.aug_elastic_distortion_magnitude_max))
            self.coord_transforms = aug.Compose(
                [aug.ElasticDistortion(elastic), aug.RandomHorizontalFlip("z")])
            self.color_transforms = aug.Compose([
                aug.ChromaticAutoContrast(),
                aug.ChromaticTranslation(cfg.aug_color_trans_ratio or 0.1),
                aug.ChromaticJitter(cfg.aug_color_trans_ratio or 0.1),
                aug.HueSaturationTranslation(cfg.aug_hue_max or 0.5,
                                             cfg.aug_saturation_max or 0.2),
            ]) if cfg.use_color_augmentation else None

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.files)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, index))

    def __getitem__(self, index: int) -> Dict:
        path = self.files[index]
        scene_id = os.path.splitext(os.path.basename(path))[0]
        rng = self._rng(index)
        feat_key = self.cfg.feat_key or "per_obj"
        if feat_key not in ("patch", "per_obj"):
            raise ValueError(f"unknown feat_key {feat_key!r}")
        scene = read_regrad_scene(path, ("xyz", "rgb", "label", "obj_ids",
                                         feat_key))
        xyz, rgb = scene["xyz"], scene["rgb"]
        label = scene["label"].astype(np.int32)
        obj_ids = scene["obj_ids"].astype(np.int32)
        if feat_key == "patch":
            # per-POINT fused patch features (reference
            # data/dataset.py:118-120)
            feat = scene["patch"]
        else:
            obj_feats = scene["per_obj"]
            feat = obj_feats[np.searchsorted(obj_ids, label) % len(obj_ids)]
            feat = np.where(np.isin(label, obj_ids)[:, None], feat, 0.0)
        feat_dim = feat.shape[-1]

        n = xyz.shape[0]
        idx = rng.choice(n, MAX_POINTS, replace=n < MAX_POINTS)
        xyz, rgb, label, feat = xyz[idx], rgb[idx], label[idx], feat[idx]

        xyz = xyz - xyz.mean(0)
        if self.use_augm:
            if self.cfg.aug_random_shift:
                xyz = xyz + rng.uniform(xyz.min(0), xyz.max(0)) / 2
            cat = np.concatenate([rgb, feat], axis=-1)
            xyz, cat, label = self.coord_transforms(xyz, cat, label, rng)
            rgb, feat = cat[:, :3], cat[:, 3:3 + feat_dim]
            if self.color_transforms is not None:
                rgb8 = (255 * rgb).astype(np.uint8).astype(np.float32)
                xyz, rgb8, label = self.color_transforms(xyz, rgb8, label, rng)
                rgb = (rgb8 / 255.0).astype(np.float32)

        vox = sparse_quantize_np(xyz.astype(np.float32), self.voxel_size,
                                 self.capacity, labels=label, ignore_label=0)
        rep = vox.unique_idx
        in_parts = [xyz[rep].astype(np.float32)]
        if self.use_color:
            in_parts.append(rgb[rep].astype(np.float32))
        in_feats = np.concatenate(in_parts, -1) * vox.mask[:, None]
        targets = feat[rep].astype(np.float32) * vox.mask[:, None]

        # class labels: instance -> model class id via objects json
        # (reference dataset.py:186-199); 255 everywhere else
        labels_cls = np.full(self.capacity, 255, np.int32)
        model_names = {x["obj_id"]: x["model_name"]
                       for x in self.objects_json.get(scene_id, [])}
        for obj in obj_ids:
            name = model_names.get(int(obj))
            if name is not None and name in self.cls_map:
                labels_cls[vox.labels == obj] = self.cls_map[name]
        labels_cls = np.where(vox.mask, labels_cls, 255)

        # grounding queries: model name -> instance ids (:201-216)
        obj_queries: Dict[str, List[int]] = {}
        existing = [x["obj_id"] for x in self.objects_json.get(scene_id, [])
                    if x.get("exists", True)]
        for obj in obj_ids:
            name = model_names.get(int(obj))
            if name is None or int(obj) not in existing:
                continue
            obj_queries.setdefault(name, []).append(int(obj))

        return {
            "coords": vox.coords, "mask": vox.mask, "in_feats": in_feats,
            "targets": targets, "labels": vox.labels * vox.mask,
            "labels_cls": labels_cls, "inverse_map": vox.inverse_map,
            "scene_id": scene_id, "queries": obj_queries,
            "obj_ids": obj_ids, "view_id": -1,
        }

    @staticmethod
    def collate(samples: List[Dict]) -> Dict:
        out = {k: np.stack([s[k] for s in samples])
               for k in ("coords", "mask", "in_feats", "targets", "labels",
                         "labels_cls", "inverse_map")}
        for k in ("scene_id", "queries", "obj_ids", "view_id"):
            out[k] = [s[k] for s in samples]
        return out


def build_dataset(cfg):
    """reference data/dataset.py:272-280 (train + seen_val)."""
    train = RegradDistilDataset(cfg, split="train")
    if cfg.evaluate:
        val = RegradDistilDataset(cfg, split=cfg.val_split or "seen_val")
        return train, val, RegradDistilDataset.collate
    return train, None, RegradDistilDataset.collate
