"""Gripper meshes (pure numpy, no trimesh dependency).

Copy of ``dropclip_tpu/grasp/gripper.py``, reading the port's own copy of
the vendor meshes (``grasp/assets/``, see PROVENANCE.md there). Port of the
reference's parallel-yaw marker — four cylinders: base stick,
cross bar, two fingers (reference gripper_models/__init__.py:9-67 and
data/blender.py:124-162) — built from explicit cylinder vertices/faces.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _cylinder(p0: np.ndarray, p1: np.ndarray, radius: float = 0.002,
              sections: int = 6) -> Tuple[np.ndarray, np.ndarray]:
    """Capless cylinder between two 3D points -> (verts (2S, 3), faces)."""
    p0, p1 = np.asarray(p0, float), np.asarray(p1, float)
    axis = p1 - p0
    length = np.linalg.norm(axis)
    z = axis / max(length, 1e-12)
    a = np.array([1.0, 0, 0]) if abs(z[0]) < 0.9 else np.array([0, 1.0, 0])
    x = np.cross(z, a)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    ang = np.linspace(0, 2 * np.pi, sections, endpoint=False)
    ring = (np.outer(np.cos(ang), x) + np.outer(np.sin(ang), y)) * radius
    verts = np.concatenate([p0 + ring, p1 + ring])
    faces = []
    for i in range(sections):
        j = (i + 1) % sections
        faces.append([i, j, sections + i])
        faces.append([j, sections + j, sections + i])
    return verts, np.asarray(faces, np.int32)


# reference gripper_models/__init__.py:9-67 segment endpoints
_SEGMENTS = [
    ([4.10000000e-02, 0, 6.59999996e-02], [4.10000000e-02, 0, 1.12169998e-01]),
    ([-4.1e-02, 0, 6.59999996e-02], [-4.1e-02, 0, 1.12169998e-01]),
    ([0, 0, 0], [0, 0, 6.59999996e-02]),
    ([-4.1e-02, 0, 6.59999996e-02], [4.1e-02, 0, 6.59999996e-02]),
]


def create_gripper_marker(radius: float = 0.002, sections: int = 6
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Parallel-yaw gripper marker -> (verts (V, 3), faces (F, 3))."""
    all_v, all_f = [], []
    off = 0
    for p0, p1 in _SEGMENTS:
        v, f = _cylinder(np.array(p0), np.array(p1), radius, sections)
        all_v.append(v)
        all_f.append(f + off)
        off += len(v)
    return np.concatenate(all_v), np.concatenate(all_f)


# reference gripper_models/__init__.py:59-65: pose the marker so its
# fingers straddle the grasp frame's approach axis
MARKER_IMPLICIT_TRANSFORM = np.array([
    [0.0, 0.0, 1.0, -0.06],
    [1.0, 0.0, 0.0, -0.01],
    [0.0, 1.0, 0.0, -0.01],
    [0.0, 0.0, 0.0, 1.0],
])


def _box(center, size) -> Tuple[np.ndarray, np.ndarray]:
    """Axis-aligned box mesh -> (verts (8, 3), faces (12, 3))."""
    c = np.asarray(center, float)
    h = np.asarray(size, float) / 2.0
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], float)
    verts = c + corners * h
    faces = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],  # x faces
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],  # y faces
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],  # z faces
    ], np.int32)
    return verts, faces


def _concat(parts) -> Tuple[np.ndarray, np.ndarray]:
    vs, fs, off = [], [], 0
    for v, f in parts:
        vs.append(v)
        fs.append(f + off)
        off += len(v)
    return np.concatenate(vs), np.concatenate(fs)


def _transform(verts: np.ndarray, T: np.ndarray) -> np.ndarray:
    return np.c_[verts, np.ones(len(verts))] @ T.T[:, :3]


def _franka_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Procedural Franka-Panda-hand approximation (palm + two fingers,
    Panda hand dimensions) — fallback when the vendored CAD assets
    (grasp/assets/, see PROVENANCE.md) are unavailable."""
    palm = _box([0, 0, 0.029], [0.063, 0.21, 0.058])
    finger_l = _box([0, 0.045, 0.083], [0.022, 0.018, 0.05])
    finger_r = _box([0, -0.045, 0.083], [0.022, 0.018, 0.05])
    return _concat([palm, finger_l, finger_r])


def _robotiq_mesh() -> Tuple[np.ndarray, np.ndarray]:
    """Procedural Robotiq 2F-140 approximation (wider jaw span) —
    fallback when the vendored CAD asset is unavailable."""
    palm = _box([0, 0, 0.03], [0.09, 0.13, 0.06])
    finger_l = _box([0, 0.07, 0.12], [0.025, 0.02, 0.12])
    finger_r = _box([0, -0.07, 0.12], [0.025, 0.02, 0.12])
    return _concat([palm, finger_l, finger_r])


_ASSETS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "assets")


def load_obj(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Minimal Wavefront OBJ reader: ``v x y z`` vertices and ``f``
    faces (slash groups allowed, polygons fan-triangulated). Covers the
    assimp/trimesh exports in grasp/assets/."""
    verts, faces = [], []
    with open(path) as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                idx = [int(p.split("/")[0]) for p in parts[1:]]
                idx = [i - 1 if i > 0 else len(verts) + i for i in idx]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return (np.asarray(verts, float),
            np.asarray(faces, np.int32).reshape(-1, 3))


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _franka_mesh_assets() -> Tuple[np.ndarray, np.ndarray]:
    """Vendor CAD Franka hand: the reference's make_franka_mesh posing
    (gripper_models/franka_panda/make.py:7-35) — fingers offset
    (0, +/-0.015, 0.0584), right finger rotated pi about z, combined
    hand translated z-0.105 (the rotated tf there is dead code; only
    the translation is applied)."""
    hand = load_obj(os.path.join(_ASSETS, "franka_hand.obj"))
    lf_v, lf_f = load_obj(os.path.join(_ASSETS, "franka_finger.obj"))
    rf_v = lf_v @ _rot_z(np.pi).T + np.array([0, -0.015, 0.0584])
    lf_v = lf_v + np.array([0, 0.015, 0.0584])
    v, f = _concat([hand, (lf_v, lf_f), (rf_v, lf_f)])
    return v + np.array([0, 0, -0.105]), f


def _robotiq_mesh_assets() -> Tuple[np.ndarray, np.ndarray]:
    return load_obj(os.path.join(_ASSETS, "robotiq_2f_140.obj"))


def _have_assets(*names: str) -> bool:
    """Per-gripper check: a stripped robotiq asset must not silently
    downgrade the unrelated Franka gripper to its procedural fallback."""
    return all(os.path.exists(os.path.join(_ASSETS, n)) for n in names)


def make(gripper_type: str) -> Tuple[np.ndarray, np.ndarray]:
    """Gripper mesh factory (reference gripper_models/__init__.py:70-103):
    same names, same posing transforms, (verts, faces) instead of an o3d
    TriangleMesh."""
    if gripper_type == "franka_panda":
        v, f = (_franka_mesh_assets()
                if _have_assets("franka_hand.obj", "franka_finger.obj")
                else _franka_mesh())
        theta = np.pi / 2  # reference :76-83
        R = np.array([
            [np.cos(theta), 0, np.sin(theta), 0.025],
            [0, 1, 0, -0.01],
            [-np.sin(theta), 0, np.cos(theta), 0],
            [0, 0, 0, 1],
        ])
        v = _transform(v, R)
        v = (v - v.mean(0)) * 1.25 + v.mean(0)  # reference :85 scale
        return v, f
    if gripper_type == "robotiq_2f_140":
        v, f = (_robotiq_mesh_assets()
                if _have_assets("robotiq_2f_140.obj")
                else _robotiq_mesh())
        theta = np.pi / 2  # reference :92-98
        R = np.array([
            [np.cos(theta), 0, np.sin(theta), 0.0],
            [0, 1, 0, 0.0],
            [-np.sin(theta), 0, np.cos(theta), 0],
            [0, 0, 0, 1],
        ])
        return _transform(v, R), f
    if gripper_type == "marker":
        v, f = create_gripper_marker()
        return _transform(v, MARKER_IMPLICIT_TRANSFORM), f
    raise ValueError(f"Unknown gripper type {gripper_type}. "
                     "Check dropclip_tpu_torch/grasp/gripper.py.")


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Minimal OBJ export for visualization."""
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")
