"""Raw MV-TOD (Blender) scene reader.

Port of ``dropclip_tpu/data/blender.py`` (host numpy; cv2 and h5py are
imported inside the functions that read images and ``.h5`` grasps). Same
on-disk format and output scene dict as the reference reader
(reference data/blender.py:17-280): per scene directory,
``image.{id}.rgb.{view}.png`` + ``image.{id}.raw_depth.{view}.exr`` +
``image.{id}.iseg.{view}.png``, COCO annotations json (RLE -> binary
masks, decoded by data.rle instead of pycocotools), camera poses json,
object init/final metadata (hex color -> instance id), per-model concept
json; intrinsics fx=fy=444.44*(base_scale/10), cx=319.5, cy=239.5 at
640x480 (reference :180-187).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional

import numpy as np

from .rle import anno_to_mask


def binary_masks_to_seg(masks: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """(K, H, W) binary masks + (K,) ids -> (H, W) instance seg (later masks
    overwrite earlier, reference utils/image.py:11-15)."""
    seg = np.zeros(masks.shape[1:], ids.dtype)
    for m, i in zip(masks, ids):
        seg[m.astype(bool)] = i
    return seg


class BlenderDataset:
    def __init__(self, root: str, models_root: Optional[str] = None,
                 split: str = "train", grasp_root: Optional[str] = None):
        self.root = root
        self.split = split
        self.models_root = models_root
        self.grasp_root = grasp_root
        split_dir = os.path.join(root, split)
        self.scene_ids = sorted(
            d for d in os.listdir(split_dir)
            if os.path.isdir(os.path.join(split_dir, d)))

        meta_path = os.path.join(root, "annos.meta.coco.json")
        self.metadata = (json.load(open(meta_path))
                         if os.path.exists(meta_path) else {"categories": []})
        self.id_to_name = {0: "table",
                           **{x["id"] + 1: x["name"]
                              for x in self.metadata["categories"]}}
        self.name_to_id = {v: k for k, v in self.id_to_name.items()}

    def __len__(self) -> int:
        return len(self.scene_ids)

    @staticmethod
    def load_grasps(filename: str):
        """ACRONYM-style grasp annotations from .h5 or .json (reference
        data/blender.py:100-121): returns (transforms (G, 4, 4), success
        flags (G,), object scale). The reference defines this but its one
        call site is commented out (:207-208); here it is live via
        ``load_object_grasps`` when ``grasp_root`` is set."""
        if filename.endswith(".json"):
            data = json.load(open(filename))
            return (np.asarray(data["transforms"], np.float32),
                    np.asarray(data["quality_flex_object_in_gripper"]),
                    float(data.get("object_scale", 1.0)))
        if filename.endswith(".h5"):
            import h5py

            with h5py.File(filename, "r") as data:
                return (np.asarray(data["grasps/transforms"], np.float32),
                        np.asarray(
                            data["grasps/qualities/flex/object_in_gripper"]),
                        float(data["object/scale"][()]))
        raise RuntimeError(f"Unknown grasp file ending: {filename}")

    def load_object_grasps(self, model_id: str):
        """Grasps for one object model from ``grasp_root`` (the glob the
        reference left commented, data/blender.py:207-208:
        ``{grasp_root}/*_{model_id}_*.h5``). Returns (transforms, success,
        scale) or None when grasp_root is unset / no file matches."""
        if not self.grasp_root:
            return None
        hits = sorted(
            glob.glob(os.path.join(self.grasp_root, f"*_{model_id}_*.h5"))
        ) or sorted(
            glob.glob(os.path.join(self.grasp_root, f"*_{model_id}_*.json")))
        return self.load_grasps(hits[0]) if hits else None

    @staticmethod
    def read_rgb(path: str) -> np.ndarray:
        import cv2

        return np.ascontiguousarray(cv2.imread(path)[:, :, ::-1])

    @staticmethod
    def read_depth(path: str) -> np.ndarray:
        if path.endswith(".npy"):  # fixture/robustness fallback format
            return np.load(path).astype(np.float32)
        os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
        import cv2

        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise IOError(f"cannot read depth {path} (EXR codec missing? "
                          f"set OPENCV_IO_ENABLE_OPENEXR=1 or provide .npy)")
        if img.ndim == 3:
            img = img[:, :, 0]
        return img.astype(np.float32)

    @staticmethod
    def obtain_seg_info(scene: Dict):
        """Per-view (H, W) instance seg + per-view present ids (reference
        data/blender.py:87-97)."""
        col_to_ins = scene["col_to_ins"]
        seg_masks, all_ids = [], []
        for _, stuff in scene["views"].items():
            _, masks, colors = zip(*stuff["annos"])
            gids = [col_to_ins[c] for c in colors]
            seg_masks.append(binary_masks_to_seg(np.stack(masks),
                                                 np.asarray(gids)))
            all_ids.append(gids)
        return seg_masks, all_ids

    def __getitem__(self, index: int) -> Dict:
        data_root = os.path.join(self.root, self.split, f"{index:06d}")
        rgb_files = sorted(glob.glob(
            f"{data_root}/image.{index:06d}.rgb.*.png"))
        depth_files = sorted(glob.glob(
            f"{data_root}/image.{index:06d}.raw_depth.*.exr")) or sorted(
            glob.glob(f"{data_root}/image.{index:06d}.raw_depth.*.npy"))
        seg_files = sorted(glob.glob(
            f"{data_root}/image.{index:06d}.iseg.*.png"))

        annos = json.load(open(f"{data_root}/annos.{index:06d}.coco.json"))
        camera_poses = json.load(open(f"{data_root}/cameras.{index:06d}.json"))
        objects_init = json.load(open(
            f"{data_root}/objects.init.{index:06d}.json"))
        objects_final = json.load(open(f"{data_root}/objects.{index:06d}.json"))

        base_scale = objects_init[-1]["base_scale"]
        camera_intrinsic = {
            "height": 480, "width": 640,
            "fx": 444.44444444 * (base_scale / 10),
            "fy": 444.44444444 * (base_scale / 10),
            "cx": 319.5, "cy": 239.5,
        }

        ins_dict: Dict[str, Dict] = {}
        for obj_init, obj_final in zip(objects_init[:-1], objects_final):
            hex_id = obj_init["color"]["hex"]
            assert hex_id not in ins_dict
            model_path = "/".join(obj_init["path"].split("/")[2:4])
            concepts = ""
            if self.models_root:
                cpath = os.path.join(self.models_root, model_path,
                                     "concept.json")
                if os.path.exists(cpath):
                    concepts = json.load(open(cpath))
            entry = {
                "ins_id": len(ins_dict) + 1,  # 0 reserved for the table
                "cls_name": obj_init["cls_name"],
                "path": model_path,
                "concepts": concepts,
                "size": obj_final["size"],
                "pose": obj_final["pose"],
                "bbox": obj_final["bbox"],
                "rotation": obj_final["rotation"],
                "object_scale": obj_init.get("sim_scale"),
            }
            # per-object ACRONYM grasps (the reference's commented-out
            # intent, data/blender.py:205-221): non-gazebo objects carry
            # grasps/grasp_scores when grasp_root is set
            if self.grasp_root and obj_init.get("source") != "gazebo":
                model_id = obj_init["path"].split("/")[-2]
                loaded = self.load_object_grasps(model_id)
                if loaded is not None:
                    entry["grasps"], entry["grasp_scores"], \
                        entry["grasp_scale"] = loaded
            ins_dict[hex_id] = entry

        img_name_to_id = {x["file_name"]: x["id"] for x in annos["images"]}
        scene: Dict = {"views": {}}
        for rgb_f, depth_f, seg_f in zip(rgb_files, depth_files, seg_files):
            assert (rgb_f.split(".")[-2] == depth_f.split(".")[-2]
                    == seg_f.split(".")[-2])
            view_id = rgb_f.split(".")[-2]
            image_id = img_name_to_id[os.path.basename(rgb_f)]
            rgb = self.read_rgb(rgb_f)
            depth = self.read_depth(depth_f)
            h, w, _ = rgb.shape
            view_annos: List = []
            for x in annos["annotations"]:
                if x["image_id"] == image_id:
                    m = anno_to_mask(x, h, w)
                    hex_id = x["seg_color_hex"]
                    view_annos.append([ins_dict[hex_id]["cls_name"], m, hex_id])
            scene["views"][view_id] = {
                "camera": camera_poses[view_id],
                "annos": view_annos,
                "rgb": rgb,
                "depth": depth,
                "imgpaths": rgb_f,
            }

        scene["objects_info"] = {
            0: "table",
            **{v["ins_id"]: {
                "cls_name": v["cls_name"],
                "concepts": (v["concepts"]["concepts"]
                             if isinstance(v["concepts"], dict) else None),
                "hex_id": k, "path": v["path"], "size": v["size"],
                "pose": v["pose"], "bbox": v["bbox"],
                "rotation": v["rotation"],
                **{gk: v[gk] for gk in
                   ("grasps", "grasp_scores", "grasp_scale") if gk in v},
            } for k, v in ins_dict.items()}}
        scene["queries"] = {0: "table",
                            **{v["ins_id"]: v["cls_name"]
                               for v in ins_dict.values()}}
        scene["col_to_ins"] = {"#000000": 0,
                               **{k: v["ins_id"] for k, v in ins_dict.items()}}
        scene["ins_to_cls"] = {
            0: self.name_to_id.get("table", 0),
            **{v["ins_id"]: self.name_to_id.get(v["cls_name"], 0)
               for v in ins_dict.values()}}
        scene["camera_intrinsic"] = camera_intrinsic
        scene["world_scale"] = base_scale
        return scene
