"""MV-TOD (Blender) distillation dataset over processed scenes.

Port of ``dropclip_tpu/data/dataset_blender.py`` (numpy, on the host),
itself a behavioural port of the reference dataset (reference
data/dataset_blender.py:19-486): per-object fused-feature splat,
NaN-object removal, partial-view sampling from stored visibility masks
(union of k random views), random downsample to MAX_POINTS, centre shift
plus shift/rotation/elastic/flip/colour augmentation, sparse
quantization, eval-query construction.

- Scenes are ``*.h5py`` files or ``.npz`` archives of the same schema
  (``scene_io``; the card's machine has no h5py).
- Every sample comes out padded to a fixed voxel capacity with an
  occupancy mask; the collate stacks the trainer's batch arrays.
- Randomness is a per-(seed, epoch, index) ``np.random.Generator``
  (``_rng``), so samples equal the JAX dataset's draw for draw.
- ``use_view_clip`` widens the input with per-point CLIP patch features
  of the sample's view, read from the raw MV-TOD tree under ``raw_root``:
  the patch teacher (``view_clip_model``, ViT-L/14@336px by default, in
  bf16) runs on ``device`` (the card unless the caller asks for the
  CPU), and its patch maps stay there in an LRU cache of
  ``view_clip_cache_views`` views.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from collections import OrderedDict
from typing import Dict, List, Tuple

import numpy as np
import torch

from . import augmentations as aug
from .queries import prepare_queries
from .scene_io import read_scene
from .voxelize_np import sparse_quantize_np

MAX_POINTS = 10000  # reference dataset_blender.py:20


def view_clip_pixels(xyz_world: np.ndarray, pose: np.ndarray, K: np.ndarray,
                     hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> (column, row) pixels of one MV-TOD view (reference
    generate_view_clip, dataset_blender.py:133-171): world->cam through
    the view's cam->world ``pose``, the blender y/z flip, pinhole with
    int truncation (z == 0 -> pixel (0, 0)), clipped to the image (points
    outside it take edge pixels, a reference quirk kept)."""
    pts = np.concatenate([xyz_world, np.ones((len(xyz_world), 1))], axis=1)
    cam = (np.linalg.inv(pose) @ pts.T).T[:, :3]
    cam[:, 1] *= -1.0
    cam[:, 2] *= -1.0
    uvw = (K @ cam.T).T
    z = uvw[:, 2]
    px = np.zeros(len(cam), np.int64)
    py = np.zeros(len(cam), np.int64)
    nz = z != 0
    px[nz] = (uvw[nz, 0] / z[nz]).astype(np.int64)
    py[nz] = (uvw[nz, 1] / z[nz]).astype(np.int64)
    return np.clip(px, 0, hw[1] - 1), np.clip(py, 0, hw[0] - 1)


def _scene_files(root: str, split: str) -> List[str]:
    for pattern in ("*/*.{}", "*.{}"):
        files = sorted(f for ext in ("h5py", "npz") for f in glob.glob(
            os.path.join(root, split, pattern.format(ext))))
        if files:
            return files
    return []


class MVTODDataset:
    """``device``: where the ``use_view_clip`` teacher runs (the card
    unless the caller asks for the CPU); nothing else runs on a device."""

    def __init__(self, cfg, split: str, device=None):
        self.cfg = cfg
        self.split = split
        self.root = cfg.root_dir
        self.capacity = int(cfg.voxel_capacity or 8192)
        self.voxel_size = float(cfg.voxel_size or 0.05)
        self.use_full_pc = bool(cfg.use_full_pc)
        self.use_color = bool(cfg.use_color)
        self.seed = int(cfg.manual_seed or 42)
        self.epoch = 0

        files = _scene_files(self.root, split)
        self.data: List[Tuple[str, int]] = []
        if not self.use_full_pc:
            if cfg.use_k_views and int(cfg.use_k_views) > 1:
                self.data = [(f, -1) for f in files]
            else:
                if cfg.use_view_ids is None:
                    raise ValueError("need use_view_ids when use_k_views "
                                     "<= 1")
                ids = [int(x) for x in str(cfg.use_view_ids).split(",")]
                self.data = [(f, i) for f in files for i in ids]
        else:
            self.data = [(f, -1) for f in files]

        self.use_view_clip = bool(cfg.use_view_clip)
        if self.use_view_clip:
            # the raw tree with the view pngs + cameras json; the reference
            # reads them from the processed root itself (dataset_blender.py
            # :140-144: its processed h5 sits inside the raw scene dirs)
            self.raw_root = cfg.raw_root or self.root
            # reference :67-71 hardcodes the UNSCALED blender intrinsics
            # here (ignoring base_scale, unlike the raw reader): kept as
            # the default, overridable for non-640x480 trees
            fx, fy, cx, cy = (cfg.view_clip_intrinsics
                              or (444.44444444, 444.44444444, 319.5, 239.5))
            self._vc_K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]],
                                  np.float64)
            self._vc_hw = tuple(cfg.view_clip_hw or (480, 640))
            self._vc_cache: "OrderedDict[Tuple[str, int], torch.Tensor]" = \
                OrderedDict()
            self._vc_cache_cap = int(cfg.view_clip_cache_views or 64)
            self._vc_device = device
            self._vc_extractor = None
            self._vc_poses: Dict[str, List[np.ndarray]] = {}
            #: patch-map cache misses (one teacher forward each)
            self.vc_misses = 0
            # data.loader prefetches __getitem__ from a thread pool:
            # serialize the lazy init and the patch-map cache fills
            self._vc_lock = threading.Lock()

        self.use_augm = bool(cfg.use_augmentation) and split == "train"
        if self.use_augm:
            elastic = ((cfg.aug_elastic_distortion_granularity_min,
                        cfg.aug_elastic_distortion_granularity_max),
                       (cfg.aug_elastic_distortion_magnitude_min,
                        cfg.aug_elastic_distortion_magnitude_max))
            tfs = [aug.ElasticDistortion(elastic),
                   aug.RandomHorizontalFlip("z")]
            if cfg.aug_use_blob_removal:
                tfs.append(aug.RandomBlobRemovalPerObj(
                    (cfg.aug_n_blob_min, cfg.aug_n_blob_max),
                    (cfg.aug_blob_size_min, cfg.aug_blob_size_max)))
            self.coord_transforms = aug.Compose(tfs)
            self.color_transforms = None
            if self.use_color and cfg.use_color_augmentation:
                self.color_transforms = aug.Compose([
                    aug.ChromaticAutoContrast(),
                    aug.ChromaticTranslation(cfg.aug_color_trans_ratio or 0.1),
                    aug.ChromaticJitter(cfg.aug_color_trans_ratio or 0.1),
                    aug.HueSaturationTranslation(cfg.aug_hue_max or 0.5,
                                                 cfg.aug_saturation_max or 0.2),
                ])

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.data)

    def _rng(self, index: int) -> np.random.Generator:
        return np.random.default_rng((self.seed, self.epoch, index))

    @staticmethod
    def remove_nan_objects(labels, obj_feats, obj_ids):
        """reference dataset_blender.py:257-268."""
        nan_ids = [int(i) for i in obj_ids if i != 0
                   and np.any(np.isnan(obj_feats[i]))]
        mask = ~np.isin(labels, nan_ids)
        return mask, nan_ids

    def _random_rotation(self, xyz, rng):
        """Random small euler rotation, optionally in a shuffled order
        (reference dataset_blender.py:274-301)."""
        cfg = self.cfg
        if rng.uniform(0, 1) <= float(cfg.aug_random_rot_chance or 0.5):
            return xyz
        rx = rng.uniform(cfg.aug_rotate_min_x or 0, cfg.aug_rotate_max_x or 0)
        ry = rng.uniform(cfg.aug_rotate_min_y or 0, cfg.aug_rotate_max_y or 0)
        rz = rng.uniform(cfg.aug_rotate_min_z or 0, cfg.aug_rotate_max_z or 0)
        cx, sx = np.cos(rx), np.sin(rx)
        cy, sy = np.cos(ry), np.sin(ry)
        cz, sz = np.cos(rz), np.sin(rz)
        mats = [np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]]),
                np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]]),
                np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])]
        if cfg.aug_random_euler_order:
            rng.shuffle(mats)
        R = mats[2] @ mats[1] @ mats[0]
        return xyz @ R.T

    # ---- use_view_clip helpers (reference dataset_blender.py:133-171) ----

    def _vc_scene_dir(self, scene_id: str) -> str:
        for d in (os.path.join(self.raw_root, self.split, scene_id),
                  os.path.join(self.raw_root, scene_id)):
            if os.path.isdir(d):
                return d
        raise FileNotFoundError(
            f"use_view_clip: no raw scene dir for {scene_id!r} under "
            f"{self.raw_root!r} (set cfg.raw_root to the raw MV-TOD tree)")

    def _vc_get_extractor(self):
        """The patch teacher, built on first use (bf16, weights from
        ``clip_checkpoint`` or drawn from seed 0)."""
        if self._vc_extractor is None:
            from ..core.device import resolve_device
            from ..teachers.convert import build_clip_from
            from ..teachers.extractor import ClipExtractor

            model = build_clip_from(
                self.cfg.view_clip_model or "ViT-L/14@336px",
                self.cfg.clip_checkpoint, dtype=torch.bfloat16,
                device=resolve_device(self._vc_device),
                context="use_view_clip")
            self._vc_extractor = ClipExtractor(
                model, mode="patch",
                img_resize=tuple(self.cfg.view_clip_resize or (336, 448)),
                batch_size=int(self.cfg.view_clip_batch or 12))
        return self._vc_extractor

    def _vc_patch_map(self, scene_id: str, view_id: int) -> torch.Tensor:
        """(ph, pw, C) float32 patch features of one view on the teacher's
        device, LRU-cached."""
        key = (scene_id, view_id)
        with self._vc_lock:
            if key in self._vc_cache:
                self._vc_cache.move_to_end(key)
                return self._vc_cache[key]
            from .blender import BlenderDataset

            ex = self._vc_get_extractor()
            d = self._vc_scene_dir(scene_id)
            rgbs = sorted(glob.glob(f"{d}/image.{scene_id}.rgb.*.png"))
            img = BlenderDataset.read_rgb(rgbs[view_id])
            pf = ex.extract(img[None])[0].to(torch.float32)
            self.vc_misses += 1
            self._vc_cache[key] = pf
            while len(self._vc_cache) > self._vc_cache_cap:
                self._vc_cache.popitem(last=False)
            return pf

    def _vc_pose(self, scene_id: str, view_id: int) -> np.ndarray:
        if scene_id not in self._vc_poses:
            d = self._vc_scene_dir(scene_id)
            with open(f"{d}/cameras.{scene_id}.json") as f:
                cams = json.load(f)
            self._vc_poses[scene_id] = [
                np.asarray(cams[k]["world_matrix"], np.float64)
                for k in sorted(cams)]
        return self._vc_poses[scene_id][view_id]

    def _view_clip_features(self, xyz_world: np.ndarray, scene_id: str,
                            view_id: int) -> np.ndarray:
        """Per-point view CLIP features (N, C), reference
        generate_view_clip (:133-171): the view's pixels of the points
        (``view_clip_pixels``), then a bicubic patch-map sample at them
        (``ops.resize.bicubic_sample_at`` on the teacher's device)."""
        from ..ops.resize import bicubic_sample_at

        h, w = self._vc_hw
        px, py = view_clip_pixels(xyz_world, self._vc_pose(scene_id, view_id),
                                  self._vc_K, (h, w))
        pf = self._vc_patch_map(scene_id, view_id)
        as_dev = lambda a: torch.from_numpy(a).to(pf.device)
        return bicubic_sample_at(pf, (h, w), as_dev(px),
                                 as_dev(py)).cpu().numpy()

    def __getitem__(self, index: int) -> Dict:
        path, view_id = self.data[index]
        scene_id = os.path.basename(os.path.dirname(path)) or \
            os.path.splitext(os.path.basename(path))[0]
        rng = self._rng(index)
        scene = read_scene(path)
        xyz, rgb, label = scene.xyz, scene.rgb, scene.label
        obj_feats, obj_ids = scene.obj_feats, scene.obj_ids

        queries = prepare_queries(scene.objects_info,
                                  self.cfg.eval_scenario or "cls")

        keep, _ = self.remove_nan_objects(label, obj_feats, obj_ids)
        xyz, rgb, label = xyz[keep], rgb[keep], label[keep]
        vis = scene.vis_mask[:, keep] if scene.vis_mask is not None else None

        feat = obj_feats[label]  # per-point splat (reference :128-130)
        feat_dim = feat.shape[-1]

        if not self.use_full_pc:
            if vis is None:
                raise ValueError(f"{path}: vis_mask required for partial "
                                 "views")
            if view_id >= 0:
                vmask = vis[view_id]
            else:
                k = int(rng.integers(1, int(self.cfg.use_k_views) + 1))
                view_ids = rng.choice(vis.shape[0], size=k, replace=False)
                vmask = vis[view_ids].sum(0).astype(bool)
            xyz, rgb = xyz[vmask], rgb[vmask]
            label, feat = label[vmask], feat[vmask]

        # random downsample to fixed MAX_POINTS (reference :353-362)
        n = xyz.shape[0]
        idx = rng.choice(n, MAX_POINTS, replace=n < MAX_POINTS)
        xyz, rgb, label, feat = xyz[idx], rgb[idx], label[idx], feat[idx]

        view_feat = None
        if self.use_view_clip:
            # single-view samples only: the feature is what THIS view's
            # CLIP sees at each point (a k-view union has no single view)
            if view_id < 0:
                raise ValueError(
                    "use_view_clip requires explicit single views "
                    "(use_view_ids with use_k_views <= 1)")
            # world-frame coords, before the centre shift
            view_feat = self._view_clip_features(xyz, scene_id, view_id)

        xyz = xyz - xyz.mean(0)
        if self.use_augm:
            if self.cfg.aug_random_shift:
                xyz = xyz + rng.uniform(xyz.min(0), xyz.max(0)) / 2
            if self.cfg.aug_random_rotation:
                xyz = self._random_rotation(xyz, rng)
            parts = [rgb, feat] if view_feat is None else [rgb, feat, view_feat]
            cat = np.concatenate(parts, axis=-1)
            xyz, cat, label = self.coord_transforms(xyz, cat, label, rng)
            rgb, feat = cat[:, :3], cat[:, 3:3 + feat_dim]
            if view_feat is not None:
                view_feat = cat[:, 3 + feat_dim:]
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
        if view_feat is not None:
            # [xyz, rgb, view_feat], the reference's cat_features order
            # (:400-404); the student's stem takes the widened input
            # (``in_channels``)
            in_parts.append(view_feat[rep].astype(np.float32))
        in_feats = np.concatenate(in_parts, axis=-1) * vox.mask[:, None]
        targets = feat[rep].astype(np.float32) * vox.mask[:, None]

        return {
            "coords": vox.coords,
            "mask": vox.mask,
            "in_feats": in_feats,
            "targets": targets,
            "labels": vox.labels * vox.mask,
            "inverse_map": vox.inverse_map,
            "xyz": xyz.astype(np.float32),
            "rgb": rgb.astype(np.float32),
            "raw_label": label.astype(np.int32),
            "scene_id": scene_id,
            "view_id": view_id,
            "queries": queries,
            "obj_ids": obj_ids,
        }

    @staticmethod
    def collate(samples: List[Dict]) -> Dict:
        """Stack padded samples into batch arrays (replaces
        ME.utils.sparse_collate, reference :438-475: the batch index
        column becomes the leading axis)."""
        out = {k: np.stack([s[k] for s in samples])
               for k in ("coords", "mask", "in_feats", "targets", "labels",
                         "inverse_map")}
        for k in ("scene_id", "view_id", "queries", "obj_ids", "xyz", "rgb",
                  "raw_label"):
            out[k] = [s[k] for s in samples]
        return out


def build_dataset(cfg, device=None):
    """(train, val or None, collate) (reference dataset_blender.py:478-486);
    ``device`` runs the ``use_view_clip`` teacher."""
    train = MVTODDataset(cfg, split="train", device=device)
    if cfg.evaluate:
        return (train, MVTODDataset(cfg, split="test", device=device),
                MVTODDataset.collate)
    return train, None, MVTODDataset.collate
