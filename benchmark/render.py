"""Dense multi-view tabletop scenes for the ingest cell, from a traffic
file's parameters and a seed.

A scene is a table top (segment 0) and boxes and spheres standing on it
(segments 1..n), seen by cameras on a hemisphere around the table's
centre (MV-TOD's layout: 73 views a scene at 480x640). Every pixel is
ray-cast on the device: it takes the depth (the camera-frame z, as a
depth map stores it), the segment and the shaded colour of the first
surface its ray hits; a ray that hits nothing reads the background
depth (100 m, past the ingest's 25 m truncation) and segment 0. Depth
is rounded to float16, the ingest's wire type, so that both sides read
the same depths.

Every seed gets the same object sizes, kinds and camera rings, in
another order and arrangement, so that seeds differ in where things lie
and not in how much work a scene is. The layout is drawn on the host
(numpy); the pixels are computed in a few batched calls on the device
and copied to host memory once."""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from . import gen

BG_SEGMENT = 0


def look_at(eye: np.ndarray, target: np.ndarray) -> np.ndarray:
    """The camera-to-world matrix of a camera at ``eye`` looking at
    ``target`` with world z up, in the Blender convention (the camera
    looks along its -z, its y up)."""
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    pose = np.eye(4)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, up, -fwd, eye
    return pose


def camera_poses(cams: Dict, table_z: float, rng: np.random.Generator
                 ) -> np.ndarray:
    """(V, 4, 4) float32 poses: ``per_ring`` cameras on each elevation
    ring, evenly spread in azimuth from an offset drawn per ring, and one
    near the top; each aimed at the table's centre moved by up to
    ``aim_jitter_m``."""
    d = float(cams["distance_m"])
    jit = float(cams["aim_jitter_m"])
    elev = list(cams["elevations_deg"])
    per = int(cams["per_ring"])
    views = []
    for e in elev:
        off = rng.uniform(0.0, 2 * math.pi)
        views += [(math.radians(e), off + 2 * math.pi * i / per)
                  for i in range(per)]
    views.append((math.radians(float(cams["top_elevation_deg"])),
                  rng.uniform(0.0, 2 * math.pi)))
    poses = []
    for e, a in views:
        target = np.array([*rng.uniform(-jit, jit, 2), table_z])
        eye = np.array([d * math.cos(e) * math.cos(a),
                        d * math.cos(e) * math.sin(a),
                        table_z + d * math.sin(e)])
        poses.append(look_at(eye, target))
    return np.stack(poses).astype(np.float32)


def objects(spec: Dict, table_z: float, rng: np.random.Generator
            ) -> List[Dict]:
    """``n`` objects of sizes evenly spaced over ``size_m``, half boxes
    and half spheres, in an order drawn from ``rng``, placed on the table
    without overlap (footprint circles ``gap_m`` apart)."""
    n = int(spec["n"])
    lo, hi = spec["size_m"]
    sizes = rng.permutation(np.linspace(lo, hi, n))
    kinds = rng.permutation(["box"] * (n // 2) + ["sphere"] * (n - n // 2))
    ax, ay = spec["area_half_extent_m"]
    aspect = np.asarray(spec["box_aspect"], np.float64)
    colors = list(spec["colors"])
    while True:
        placed: List[Dict] = []
        for size, kind in zip(sizes, kinds):
            if kind == "box":
                half = size * aspect / 2
                radius = float(np.linalg.norm(half[:2]))
            else:
                half = np.full(3, size / 2)
                radius = size / 2
            for _ in range(2000):
                xy = rng.uniform([-ax, -ay], [ax, ay])
                if all(np.linalg.norm(xy - p["xy"]) >= radius + p["radius"]
                       + spec["gap_m"] for p in placed):
                    break
            else:
                break
            cls = spec["classes"][kind]
            color = colors[int(rng.integers(len(colors)))]
            placed.append(dict(
                kind=str(kind), xy=xy, radius=radius, half=half,
                yaw=float(rng.uniform(0.0, math.pi)),
                centre=np.array([xy[0], xy[1], table_z + half[2]]),
                cls=cls[int(rng.integers(len(cls)))], color=color,
                rgb=np.asarray(spec["colors"][color], np.float64)))
        if len(placed) == n:
            return placed


def objects_info(objs: List[Dict]) -> Dict:
    """MV-TOD's per-scene object metadata: the table, then each object's
    class and a description with its colour."""
    info = {0: {"cls_name": "table", "concepts": None}}
    for k, o in enumerate(objs, start=1):
        info[k] = {"cls_name": o["cls"],
                   "concepts": {"More descriptions":
                                [f"a {o['color']} {o['cls']}"]}}
    return info


def layout(traffic: Dict, rng: np.random.Generator) -> Dict:
    """One scene's table, objects and cameras, drawn from ``rng``."""
    table_z = float(traffic["table"]["top_z_m"])
    objs = objects(traffic["objects"], table_z, rng)
    poses = camera_poses(traffic["cameras"], table_z, rng)
    ci = traffic["intrinsics"]
    K = np.array([[ci["fx"], 0, ci["cx"]], [0, ci["fy"], ci["cy"]],
                  [0, 0, 1]], np.float32)
    return dict(objects=objs, poses=poses, K=K, table_z=table_z,
                obj_info=objects_info(objs))


def rays(pose: torch.Tensor, K: torch.Tensor, hw) -> tuple:
    """(origins (V, 3), directions (V, H*W, 3)) of every pixel (u, v) of
    each view, each direction scaled to camera-frame z 1, so that a hit
    at ``origin + t * direction`` has depth ``t``."""
    h, w = hw
    dev, dt = pose.device, pose.dtype
    u = torch.arange(w, device=dev, dtype=dt)
    v = torch.arange(h, device=dev, dtype=dt)
    x = ((u[None, :] - K[0, 2]) / K[0, 0]).expand(h, w)
    y = ((v[:, None] - K[1, 2]) / K[1, 1]).expand(h, w)
    # OpenCV (x, y, 1) is Blender (x, -y, -1) in the camera frame
    cam = torch.stack([x, -y, -torch.ones_like(x)], -1).reshape(-1, 3)
    dirs = torch.einsum("vij,nj->vni", pose[:, :3, :3], cam)
    return pose[:, :3, 3], dirs


def _hit_table(o, d, table: Dict, table_z: float):
    t = (table_z - o[:, None, 2]) / d[..., 2]
    p = o[:, None, :] + t[..., None] * d
    hx, hy = table["half_extent_m"]
    ok = (t > 0) & (p[..., 0].abs() <= hx) & (p[..., 1].abs() <= hy)
    n = torch.zeros_like(d)
    n[..., 2] = 1.0
    return torch.where(ok, t, math.inf), n


def _hit_sphere(o, d, obj: Dict):
    c = torch.as_tensor(obj["centre"], dtype=d.dtype, device=d.device)
    r = float(obj["half"][0])
    oc = o[:, None, :] - c
    a = (d * d).sum(-1)
    b = 2 * (oc * d).sum(-1)
    cc = (oc * oc).sum(-1) - r * r
    disc = b * b - 4 * a * cc
    t = (-b - disc.clamp_min(0).sqrt()) / (2 * a)
    ok = (disc >= 0) & (t > 0)
    n = (o[:, None, :] + t[..., None] * d - c) / r
    return torch.where(ok, t, math.inf), n


def _hit_box(o, d, obj: Dict):
    dev, dt = d.device, d.dtype
    c = torch.as_tensor(obj["centre"], dtype=dt, device=dev)
    half = torch.as_tensor(obj["half"], dtype=dt, device=dev)
    cs, sn = math.cos(obj["yaw"]), math.sin(obj["yaw"])
    rot = torch.tensor([[cs, -sn, 0.0], [sn, cs, 0.0], [0.0, 0.0, 1.0]],
                       dtype=dt, device=dev)  # local -> world
    ol = (o[:, None, :] - c) @ rot   # world -> local: rot^T (o - c)
    dl = d @ rot
    t1 = (-half - ol) / dl
    t2 = (half - ol) / dl
    tmin, axis = torch.minimum(t1, t2).max(-1)
    tmax = torch.maximum(t1, t2).min(-1).values
    ok = (tmax >= tmin) & (tmin > 0)
    sign = -torch.sign(dl.gather(-1, axis[..., None]))[..., 0]
    nl = torch.nn.functional.one_hot(axis, 3).to(dt) * sign[..., None]
    return torch.where(ok, tmin, math.inf), nl @ rot.T


def _checker(p: torch.Tensor, size: float) -> torch.Tensor:
    cell = torch.floor(p[..., 0] / size) + torch.floor(p[..., 1] / size)
    return 1.0 + 0.15 * (1 - 2 * torch.remainder(cell, 2))


def render(lay: Dict, traffic: Dict, device, views_per_call: int = 8
           ) -> Dict:
    """The scene's images (V, H, W, 3) uint8, depths (V, H, W) float16,
    segs (V, H, W) uint8, poses (V, 4, 4) float32 and K (3, 3) float32,
    in host memory, and its ``obj_info``."""
    h, w = traffic["hw"]
    dt = torch.float32
    pose = torch.as_tensor(lay["poses"], device=device)
    K = torch.as_tensor(lay["K"], device=device)
    light = torch.as_tensor(traffic["light"], dtype=dt, device=device)
    light = light / light.norm()
    amb = float(traffic["ambient"])
    bg_depth = float(traffic["background_depth_m"])
    bg_rgb = torch.as_tensor(traffic["background_rgb"], dtype=dt,
                             device=device)
    table = traffic["table"]
    colours = torch.as_tensor(np.stack(
        [table["rgb"]] + [o["rgb"] for o in lay["objects"]]), dtype=dt,
        device=device)
    images, depths, segs = [], [], []
    for s in range(0, pose.shape[0], views_per_call):
        o, d = rays(pose[s:s + views_per_call], K, (h, w))
        hits = [_hit_table(o, d, table, lay["table_z"])]
        for obj in lay["objects"]:
            hits.append(_hit_sphere(o, d, obj) if obj["kind"] == "sphere"
                        else _hit_box(o, d, obj))
        ts = torch.stack([t for t, _ in hits])        # (S, v, n)
        t, seg = ts.min(0)
        normals = torch.stack([n for _, n in hits])   # (S, v, n, 3)
        n = normals.gather(0, seg[None, ..., None].expand(
            1, *seg.shape, 3))[0]
        shade = amb + (1 - amb) * (n @ light).abs()
        rgb = colours[seg] * shade[..., None]
        p = o[:, None, :] + t[..., None] * d
        rgb = torch.where((seg == 0)[..., None],
                          rgb * _checker(p, table["checker_m"])[..., None],
                          rgb)
        hit = torch.isfinite(t)
        rgb = torch.where(hit[..., None], rgb, bg_rgb)
        depth = torch.where(hit, t, bg_depth)
        seg = torch.where(hit, seg, BG_SEGMENT)
        nv = seg.shape[0]
        images.append(rgb.clamp(0, 255).round().to(torch.uint8)
                      .reshape(nv, h, w, 3))
        depths.append(depth.to(torch.float16).reshape(nv, h, w))
        segs.append(seg.to(torch.uint8).reshape(nv, h, w))
    host = lambda xs: torch.cat(xs).cpu().numpy()  # noqa: E731
    return dict(images=host(images), depths=host(depths), segs=host(segs),
                poses=lay["poses"], K=lay["K"], obj_info=lay["obj_info"])


def make_ring(traffic: Dict, seed: int, device) -> List[Dict]:
    """The cell's ring of scenes, each laid out from the seed and
    rendered on ``device``."""
    rng = gen.rng_for(seed, 4)
    return [render(layout(traffic, rng), traffic, device)
            for _ in range(int(traffic["ring"]))]
