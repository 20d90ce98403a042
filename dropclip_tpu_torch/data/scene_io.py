"""Processed-scene schemas (read/write): MV-TOD and REGRAD.

Port of ``dropclip_tpu/data/scene_io.py``, byte-compatible with it and with
the reference's preprocessing output (tools/preprocess_data.py:285-297):

  multiview/per_obj       (K, C)  f32   fused per-object CLIP features
  multiview/obj_ids       (K,)    u8    object ids (== row index)
  multiview/objects_info  str           python-literal object metadata
  pointcloud/xyz          (N, 3)  f32
  pointcloud/rgb          (N, 3)  f32   0..1
  pointcloud/label        (N,)    u8    instance ids (0 = table)
  pointcloud/vis_mask     (V, N)  f32   per-view point visibility

A path ending in ``.npz`` holds the same schema as one numpy archive
(``xyz``, ``rgb``, ``label``, ``vis_mask``, ``obj_feats``, ``obj_ids``
and ``objects_info`` as its python literal): the card's machine has no
h5py, and ``process_scene(write=...)`` writes ``.npz`` there. ``h5py`` is
imported inside the h5 branches only.

REGRAD ingest (``process_regrad_scene``) writes another schema, the one
``data/dataset_regrad.py`` reads (reference save_multiview_dataset_h5py,
tools/preprocess_data.py:40-58):

  pointcloud/xyz          (N, 3)  f32
  pointcloud/rgb          (N, 3)  f32
  pointcloud/label        (N,)    u8    instance ids
  multiview/patch         (N, C)  f32   per-point fused patch features
  multiview/per_obj       (K, C)  f32   per-object obj-prior features
  multiview/obj_ids       (K,)    u8

as ``.npz`` with the keys ``xyz``, ``rgb``, ``label``, ``patch``,
``per_obj`` and ``obj_ids``.
"""

from __future__ import annotations

import os
from ast import literal_eval
from typing import Dict, NamedTuple

import numpy as np


class ProcessedScene(NamedTuple):
    xyz: np.ndarray
    rgb: np.ndarray
    label: np.ndarray
    vis_mask: np.ndarray       # (V, N) bool
    obj_feats: np.ndarray      # (K, C)
    obj_ids: np.ndarray        # (K,)
    objects_info: Dict


def write_scene(path: str, xyz: np.ndarray, rgb: np.ndarray,
                label: np.ndarray, vis_mask: np.ndarray,
                obj_feats: np.ndarray, objects_info: Dict) -> None:
    """Write atomically (a tmp name renamed into place): the ingest CLI
    resumes by skipping existing files, so a crash mid-write must not
    leave a truncated file behind. ``.npz`` paths get a numpy archive."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    if path.endswith(".npz"):
        with open(tmp, "wb") as f:
            np.savez(f, xyz=np.asarray(xyz, np.float32),
                     rgb=np.asarray(rgb, np.float32),
                     label=np.asarray(label).astype(np.uint8),
                     vis_mask=np.asarray(vis_mask, np.float32),
                     obj_feats=np.asarray(obj_feats, np.float32),
                     obj_ids=np.arange(len(obj_feats), dtype=np.uint8),
                     objects_info=np.array(str(objects_info)))
        os.replace(tmp, path)
        return
    import h5py

    with h5py.File(tmp, "w") as f:
        mv = f.create_group("multiview")
        mv.create_dataset("per_obj", data=np.asarray(obj_feats, np.float32))
        mv.create_dataset("obj_ids", data=np.arange(len(obj_feats)),
                          dtype="uint8")
        mv.create_dataset("objects_info", data=str(objects_info))
        pc = f.create_group("pointcloud")
        pc.create_dataset("xyz", data=np.asarray(xyz, np.float32))
        pc.create_dataset("rgb", data=np.asarray(rgb, np.float32))
        pc.create_dataset("label", data=np.asarray(label), dtype="uint8")
        pc.create_dataset("vis_mask", data=np.asarray(vis_mask, np.float32))
    os.replace(tmp, path)


def read_scene(path: str) -> ProcessedScene:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return ProcessedScene(
                xyz=z["xyz"], rgb=z["rgb"],
                label=z["label"].astype(np.int32),
                vis_mask=z["vis_mask"].astype(np.uint8).astype(bool)
                if "vis_mask" in z else None,
                obj_feats=z["obj_feats"],
                obj_ids=z["obj_ids"].astype(np.int32),
                objects_info=literal_eval(str(z["objects_info"])))
    import h5py

    with h5py.File(path, "r") as f:
        obj_info = f["multiview"]["objects_info"][()]
        if isinstance(obj_info, bytes):
            obj_info = obj_info.decode("utf-8")
        return ProcessedScene(
            xyz=f["pointcloud"]["xyz"][:],
            rgb=f["pointcloud"]["rgb"][:],
            label=f["pointcloud"]["label"][:].astype(np.int32),
            vis_mask=f["pointcloud"]["vis_mask"][:].astype(np.uint8).astype(
                bool) if "vis_mask" in f["pointcloud"] else None,
            obj_feats=f["multiview"]["per_obj"][:],
            obj_ids=f["multiview"]["obj_ids"][:].astype(np.int32),
            objects_info=literal_eval(obj_info),
        )


REGRAD_KEYS = {"xyz": "pointcloud", "rgb": "pointcloud",
               "label": "pointcloud", "patch": "multiview",
               "per_obj": "multiview", "obj_ids": "multiview"}


def write_regrad_scene(path: str, xyz: np.ndarray, rgb: np.ndarray,
                       label: np.ndarray, patch: np.ndarray,
                       per_obj: np.ndarray, obj_ids: np.ndarray) -> None:
    """Write one processed REGRAD scene atomically (h5, or ``.npz`` for a
    path ending in it). Labels and object ids are stored as uint8: an id
    of 256 or more would wrap and scramble the label-to-feature pairing,
    so it raises."""
    for name, ids in (("label", label), ("obj_ids", obj_ids)):
        if len(ids) and int(np.max(ids)) >= 256:
            raise ValueError(f"{name} id {int(np.max(ids))} does not fit "
                             "uint8")
    arrays = dict(xyz=np.asarray(xyz, np.float32),
                  rgb=np.asarray(rgb, np.float32),
                  label=np.asarray(label).astype(np.uint8),
                  patch=np.asarray(patch, np.float32),
                  per_obj=np.asarray(per_obj, np.float32),
                  obj_ids=np.asarray(obj_ids).astype(np.uint8))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    if path.endswith(".npz"):
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
    else:
        import h5py

        with h5py.File(tmp, "w") as f:
            for group in ("pointcloud", "multiview"):
                g = f.create_group(group)
                for k, grp in REGRAD_KEYS.items():
                    if grp == group:
                        g.create_dataset(k, data=arrays[k])
    os.replace(tmp, path)


def read_regrad_scene(path: str, keys=tuple(REGRAD_KEYS)) -> Dict:
    """The arrays ``keys`` of one processed REGRAD scene (h5 or .npz)."""
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in keys}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[REGRAD_KEYS[k]][k][:] for k in keys}
