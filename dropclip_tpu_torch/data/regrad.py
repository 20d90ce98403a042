"""Raw REGRAD scene reader (host-side).

Port of ``dropclip_tpu/data/regrad.py`` (numpy; cv2 imported inside the
image readers). Same on-disk format and output structure as the reference reader
(reference data/regrad.py:21-398): per scene, 9 views of RGB jpg + depth
png (mm/1000) + instance seg png (white background -> 0), pickled
grasp+cloud data (`{scene}_view_{v}.p` with view/scene clouds, 6-DoF
grasp frames/scores/labels), camera extrinsics .npy, objects json; the
image<->pointcloud view-index remap (VIEWS_MAPPING, :35-45); optional
world->camera reference-frame conversion.
"""

from __future__ import annotations

import json
import os
import pickle
from typing import Dict, Optional

import numpy as np

from ..geom.knn import find_closest_indices

VIEWS_MAPPING = {1: 9, 2: 1, 3: 2, 4: 3, 5: 4, 6: 5, 7: 6, 8: 7, 9: 8}
IMAGE_SIZE = (1280, 960)


def _quat_to_matrix(q: np.ndarray) -> np.ndarray:
    """xyzw quaternion -> 3x3 rotation (scipy convention)."""
    x, y, z, w = q
    n = x * x + y * y + z * z + w * w
    s = 2.0 / n if n > 0 else 0.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)]])


def _apply_se3(T: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Host-side homogeneous transform of (N, 3) points."""
    p = np.asarray(points, np.float64)
    return (np.c_[p, np.ones(len(p))] @ np.asarray(T, np.float64).T
            )[:, :3].astype(np.float32)


class RegradDataset:
    def __init__(self, cfg, split: str):
        self.cfg = cfg
        self.root = cfg.root_dir
        self.split = split
        self.data_dir = os.path.join(self.root, split)
        self.nviews = int(cfg.num_views or 9)
        self.reference_frame = cfg.reference_frame or "world"

        fname = "objects.json" if split == "train" else "objects_16k.json"
        self.objects_json = json.load(open(os.path.join(self.data_dir, fname)))
        self.camera_info = np.load(
            os.path.join(self.root, cfg.camera_file or "camera_info.npy"),
            allow_pickle=True).item()
        self.scene_ids = sorted(
            d for d in os.listdir(os.path.join(self.data_dir,
                                               cfg.grasp_dir or "grasps"))
            if os.path.isdir(os.path.join(self.data_dir,
                                          cfg.grasp_dir or "grasps", d)))

    def __len__(self) -> int:
        return len(self.scene_ids)

    def _load_img(self, scene_id: str, view: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.data_dir, self.cfg.RGB_dir or "rgb",
                            f"{scene_id}_{view}.jpg")
        return np.ascontiguousarray(cv2.imread(path)[:, :, ::-1])

    def _load_depth(self, scene_id: str, view: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.data_dir, self.cfg.Depth_dir or "depth",
                            f"{scene_id}_{view}.png")
        return cv2.imread(path, cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0

    def _load_seg(self, scene_id: str, view: int) -> np.ndarray:
        import cv2

        path = os.path.join(self.data_dir, self.cfg.Seg_dir or "seg",
                            f"{scene_id}_{view}.png")
        seg = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        seg[seg >= 200] = 0  # white background -> 0 (reference :118)
        return seg

    def _load_grasp_data(self, scene_id: str, view: int) -> Dict:
        path = os.path.join(self.data_dir, self.cfg.grasp_dir or "grasps",
                            scene_id, f"{scene_id}_view_{view}.p")
        with open(path, "rb") as f:
            return pickle.load(f)

    def _load_pc(self, scene_id: str, view: int):
        """reference :140-146 — labels are stored 0-based, +1 here."""
        d = self._load_grasp_data(scene_id, view)
        return (d["view_cloud"], d["view_cloud_color"],
                d["view_cloud_label"] + 1, d["scene_cloud"])

    def _load_grasps(self, scene_id: str, view: int):
        """reference :149-168."""
        d = self._load_grasp_data(scene_id, view)
        return (d["valid_index"], d["select_frame"],
                np.asarray(d["select_score"], np.float32),
                np.asarray(d["select_frame_label"], np.int64) + 1)

    def _load_scene(self, scene_id: str) -> Dict:
        """reference :170-283 (aggregation is numpy concat over views,
        aggregate_views_regrad geometry.py:206-216)."""
        objs = self.objects_json[scene_id]
        state = [{k: v for k, v in o.items()
                  if k not in ("minAreaRect", "bbox")} for o in objs["1"]]
        result: Dict = {}
        all_grasps: Dict = {}
        filtered_cloud = None
        agg_xyz, agg_rgb, agg_lab = [], [], []
        for v in range(1, self.nviews + 1):
            try:
                xyz, rgb, label, full_cloud = self._load_pc(scene_id, v)
                img = self._load_img(scene_id, VIEWS_MAPPING[v])
            except (FileNotFoundError, KeyError, OSError):
                result[v] = {"valid": False}
                continue
            if filtered_cloud is None and self.cfg.include_pc_filtered:
                filtered_cloud = full_cloud
            entry = {"image": img, "pc_xyz": xyz, "pc_rgb": rgb,
                     "pc_label": label, "6D_poses": {}, "RGB_boxes": {},
                     "valid": True}
            if self.cfg.with_depth:
                entry["depth"] = self._load_depth(scene_id, VIEWS_MAPPING[v])
            if self.cfg.with_seg:
                entry["segm2d"] = self._load_seg(scene_id, VIEWS_MAPPING[v])
            if self.cfg.with_grasp:
                idx, poses, scores, labels = self._load_grasps(scene_id, v)
                all_grasps[v] = {"grasp_indices": idx, "grasp_poses": poses,
                                 "grasp_scores": scores,
                                 "grasp_labels": labels.astype(np.uint8)}
            for j, o in enumerate(objs[str(v)]):
                pose = np.asarray(o["6D_pose"], np.float64)
                if self.reference_frame == "camera":
                    T = np.eye(4)
                    T[:3, :3] = _quat_to_matrix(pose[3:])
                    T[:3, 3] = pose[:3]
                    cam = np.asarray(self.camera_info["extrinsic"][v])
                    Tc = np.linalg.inv(cam) @ T
                    pose = np.concatenate([Tc[:3, 3],
                                           _matrix_to_quat(Tc[:3, :3])])
                entry["6D_poses"][o["obj_id"]] = pose
                entry["RGB_boxes"][o["obj_id"]] = \
                    objs[str(VIEWS_MAPPING[v])][j].get("bbox")
            result[v] = entry
            agg_xyz.append(xyz)
            agg_rgb.append(rgb)
            agg_lab.append(label)

        # Whole-scene camera-frame conversion: per-view clouds + grasp
        # poses move to each view's camera frame; the aggregate cloud
        # stays in world frame (reference utils/transforms.py:5-16
        # applied at data/regrad.py:279-281 AFTER aggregation).
        if self.reference_frame == "camera":
            for v, entry in result.items():
                if not entry.get("valid"):
                    continue
                T_inv = np.linalg.inv(
                    np.asarray(self.camera_info["extrinsic"][v], np.float64))
                entry["pc_xyz"] = _apply_se3(T_inv, entry["pc_xyz"])
                if self.cfg.with_grasp and v in all_grasps:
                    all_grasps[v]["grasp_poses"] = (
                        T_inv[None] @ all_grasps[v]["grasp_poses"]
                    ).astype(np.float32)

        pc = {"pc_xyz": np.concatenate(agg_xyz) if agg_xyz else np.zeros((0, 3)),
              "pc_rgb": np.concatenate(agg_rgb) if agg_rgb else np.zeros((0, 3)),
              "pc_label": np.concatenate(agg_lab) if agg_lab else np.zeros((0,))}
        if self.cfg.include_pc_filtered and filtered_cloud is not None:
            sel = find_closest_indices(pc["pc_xyz"], filtered_cloud)
            pc.update({"pc_filt_xyz": pc["pc_xyz"][sel],
                       "pc_filt_rgb": pc["pc_rgb"][sel],
                       "pc_filt_label": pc["pc_label"][sel]})
        out = {"views": result, "aggr": pc, "state": state}
        if self.cfg.with_grasp:
            out["grasps"] = all_grasps
        return out

    def __getitem__(self, index: int) -> Dict:
        return self._load_scene(self.idx_to_scene_id(index))

    def idx_to_scene_id(self, index: int) -> str:
        return self.scene_ids[index]

    def _scene_cloud(self, scene: Dict, view: int, seg: bool):
        """Cloud + colors for view 0 (aggregate) or a single view
        (reference data/regrad.py:309-317)."""
        from .. import viz

        if view == 0:
            src = scene["aggr"]
        else:
            if not 1 <= view <= self.nviews:
                raise ValueError(f"view must be in 1..{self.nviews}")
            src = scene["views"][view]
        colors = (viz.label_colors(src["pc_label"]) if seg
                  else np.clip(src["pc_rgb"], 0, 1))
        return src["pc_xyz"], colors

    def export_scene(self, index: int, path: str, view: int = 0,
                     seg: bool = False, world_frame: bool = False,
                     camera_frames: bool = False) -> str:
        """File-output counterpart of the reference's interactive
        ``visualize_scene`` (data/regrad.py:305-331): writes one .pcd of
        the aggregate (view=0) or per-view cloud, colored by rgb or by
        the label palette; ``world_frame``/``camera_frames`` append
        r/g/b axis-triad sample points where the reference adds o3d
        coord-frame meshes."""
        from .. import viz

        scene = self[index]
        xyz, colors = self._scene_cloud(scene, view, seg)
        extra_xyz, extra_col = [], []
        if world_frame:
            fx, fc = viz.coord_frame_points(scale=0.25)
            extra_xyz.append(fx)
            extra_col.append(fc)
        if camera_frames:
            views = ([view] if view > 0
                     else sorted(self.camera_info["extrinsic"]))
            for v in views:
                fx, fc = viz.coord_frame_points(
                    scale=0.25, transform=self.camera_info["extrinsic"][v])
                extra_xyz.append(fx)
                extra_col.append(fc)
        if extra_xyz:
            xyz = np.concatenate([xyz] + extra_xyz)
            colors = np.concatenate([colors] + extra_col)
        viz.save_pcd(path, xyz, colors)
        return path

    def gather_grasps(self, scene: Dict, view: int = 0):
        """Grasps for one view, or all views concatenated (view=0), as a
        grasp.SceneGrasps in the cloud's frame (reference
        data/regrad.py:337-377). With ``reference_frame == "camera"``
        and view=0, each view's poses are converted back to world with
        that view's own extrinsic — the reference converts every view
        with the last loop view's extrinsic (a leaked loop variable,
        :364-366), which is wrong for all but the final view; we do the
        per-view conversion deliberately."""
        from ..grasp.grasps import SceneGrasps

        if view == 0:
            parts = []
            for v in range(1, self.nviews + 1):
                if v not in scene["grasps"]:
                    continue
                g = scene["grasps"][v]
                poses = g["grasp_poses"]
                if self.reference_frame == "camera":
                    T = np.asarray(self.camera_info["extrinsic"][v],
                                   np.float64)
                    poses = (T[None] @ poses).astype(np.float32)
                parts.append((g["grasp_indices"], poses,
                              g["grasp_scores"], g["grasp_labels"]))
            if not parts:
                return SceneGrasps(np.zeros(0, np.int32),
                                   np.zeros((0, 4, 4), np.float32),
                                   np.zeros(0, np.float32),
                                   np.zeros(0, np.uint8))
            return SceneGrasps(*(np.concatenate([p[i] for p in parts])
                                 for i in range(4)))
        g = scene["grasps"][view]
        return SceneGrasps(g["grasp_indices"], g["grasp_poses"],
                           g["grasp_scores"], g["grasp_labels"])

    def export_grasps(self, index: int, path_prefix: str, view: int = 0,
                      score_thresh: float = 0.75, max_grasps: int = 50,
                      sort: bool = False, object_only=None,
                      seg: bool = False, gripper_type: Optional[str] = None,
                      rng: Optional[np.random.Generator] = None) -> list:
        """File-output counterpart of the reference's interactive
        ``visualize_grasps`` (data/regrad.py:334-398): same grasp
        aggregation/filtering pipeline (score > 3*thresh, optional
        object filter, top-k by score or random sample), then writes the
        cloud .pcd + posed gripper meshes .obj via viz.export_grasp_scene.
        Returns the written paths."""
        from .. import viz

        scene = self[index]
        xyz, colors = self._scene_cloud(scene, view, seg)
        grasps = self.gather_grasps(scene, view)
        grasps = grasps.filter_by_score(score_thresh)
        if object_only is not None:
            grasps = grasps.filter_by_labels(object_only)
        grasps = (grasps.select_topk(max_grasps) if sort
                  else grasps.sample(max_grasps, rng=rng))
        return viz.export_grasp_scene(
            path_prefix, xyz, colors, grasps,
            order=np.arange(len(grasps)), top_k=len(grasps),
            gripper_type=(gripper_type or self.cfg.gripper_type
                          or "franka_panda"))


def _matrix_to_quat(m: np.ndarray) -> np.ndarray:
    """3x3 rotation -> xyzw quaternion."""
    t = np.trace(m)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([(m[2, 1] - m[1, 2]) / s, (m[0, 2] - m[2, 0]) / s,
                         (m[1, 0] - m[0, 1]) / s, 0.25 * s])
    i = int(np.argmax(np.diagonal(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[i] = 0.25 * s
    q[j] = (m[j, i] + m[i, j]) / s
    q[k] = (m[k, i] + m[i, k]) / s
    q[3] = (m[k, j] - m[j, k]) / s
    return q
