"""Offline ingest: raw multi-view scenes -> fused per-object features -> h5.

Port of ``dropclip_tpu/tools/preprocess_data.py`` (reference
tools/preprocess_data.py:152-332): aggregate the RGB-D views into a
labeled voxel cloud, run the CLIP teacher on every present (view, object)
pair with crop-mask prompts, embed the per-object text queries, fuse the
object features across views, replace never-fused objects' NaN rows with
their text embedding, and write the processed scene. Every stage runs on
the card (the ViT-L teacher through K3, K6 and K7) unless the caller
passes ``device="cpu"``.

The raw readers: ``-ds Blender`` reads MV-TOD renders
(``data/blender.py``) into the same pipeline; ``-ds REGRAD``
(``process_regrad_scene``) cleans each view's cloud against its 2D
segmentation, samples the teacher's patch features at every point's
pixel, averages per-object class-token features over the views where the
object is present, voxel-pools the cloud and writes the REGRAD schema
(``scene_io.write_regrad_scene``).

Usage (``--clip-checkpoint`` a CLIP checkpoint file, OpenAI, OpenCLIP or
HuggingFace layout; without it the teacher's weights are drawn from a
seed; ``--clip-model ViT-H-14`` takes OpenCLIP's ViT-H/14 at its 224 x 294
crop canvas; ``--format npz`` writes numpy archives of the same schema):

  python -m dropclip_tpu_torch.tools.preprocess_data -ds Blender \\
      -r RAW_ROOT -c OUT_DIR [--split train --start 0 --end 100]
  python -m dropclip_tpu_torch.tools.preprocess_data -ds REGRAD \\
      -r RAW_ROOT -c OUT_DIR [--reader-config configs/REGRAD.yaml]
  python -m dropclip_tpu_torch.tools.preprocess_data -ds Synthetic \\
      -c OUT_DIR --n-scenes 4 [--clip-checkpoint CLIP.pt] [--device cpu]

``--n-devices N`` (Blender and Synthetic) ingests on N local cards at
once, one worker thread and one teacher replica per card, scenes dealt
round-robin (``_run_multidevice``); with ``--device cpu`` it runs N CPU
workers.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..data import scene_io
from ..data.queries import prepare_fusion_queries
from ..fusion.core import FusedObjects, FusionConfig, fuse_obj_prior
from ..geom.aggregate import aggregate_views
from ..teachers.extractor import ClipExtractor


def _fusion_query_texts(obj_info: Dict, scenario: str) -> Dict:
    """{0: table, objects...} per-object query texts (reference
    preprocess_data.py:252-256)."""
    return {0: ["table"],
            **prepare_fusion_queries(
                {k: v for k, v in obj_info.items() if k > 0}, scenario)}


def embed_fusion_queries(extractor: ClipExtractor, obj_info: Dict,
                         scenario: str = "open") -> torch.Tensor:
    """{0: table, objects...} -> (Q, C) normalised mean-pooled embeddings
    of the real object rows (segments padded to a power-of-two bucket,
    min 8, as the JAX package does for its compile cache)."""
    queries = _fusion_query_texts(obj_info, scenario)
    n = max(queries) + 1
    n_pad = max(8, 1 << (n - 1).bit_length())
    return extractor.encode_queries(queries, n_segments=n_pad)[:n]


class SceneWriter:
    """One-slot asynchronous scene finalizer.

    The previous scene's fetch and write overlap the current scene's
    device work, but at most one write is pending: a slow disk holds
    ingest back instead of queueing scene payloads in memory, and a
    failed write re-raises on the next ``submit`` or ``close``."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(1)
        self._fut = None
        self._tag = None
        #: (tag, return value) per completed submit
        self.results = []

    def _join(self):
        if self._fut is None:
            return
        fut, tag = self._fut, self._tag
        self._fut = self._tag = None
        try:
            self.results.append((tag, fut.result()))
        except Exception as e:
            raise RuntimeError(
                f"async scene finalize failed for {tag!r}") from e

    def submit(self, fn, *args, tag=None, **kwargs):
        self._join()
        self._tag = tag
        self._fut = self._pool.submit(fn, *args, **kwargs)

    def close(self):
        try:
            self._join()
        finally:
            self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def stage_scene(images: np.ndarray, depths: np.ndarray, segs: np.ndarray,
                poses: np.ndarray, K: np.ndarray, device=None) -> Dict:
    """Copy one scene's arrays to the device in the JAX package's wire
    dtypes: images and segs as uint8, depths as float16 (widened on the
    device, so voxel positions round exactly as there)."""
    assert int(np.max(segs)) < 256, "seg ids must fit uint8"
    device = resolve_device(device)
    put = lambda x, dt: torch.from_numpy(np.ascontiguousarray(
        x, dt)).to(device)
    return dict(images=put(images, np.uint8), depths=put(depths, np.float16),
                segs=put(segs, np.uint8), poses=put(poses, np.float32),
                K=put(K, np.float32))


def finalize_scene(xyz, rgb, labels, mask, fused: FusedObjects,
                   query_embs: torch.Tensor, n_real: int,
                   obj_info: Dict) -> Tuple[Dict, Dict]:
    """Fetch and compact one fused scene: -> (the keyword arguments of
    ``scene_io.write_scene`` but the path, stats). Padded and table rows
    leave the cloud with the points seen in no view, and objects never
    fused (NaN rows) take their text embedding (reference :277-282)."""
    obj_out = fused.obj_features[:n_real].cpu().numpy().copy()
    nan_rows = np.isnan(obj_out).any(axis=-1)
    obj_out[nan_rows] = query_embs[:n_real].cpu().numpy()[nan_rows]
    sel = mask & (labels != 0) & fused.visible
    scene = dict(xyz=xyz[sel].cpu().numpy(), rgb=rgb[sel].cpu().numpy(),
                 label=labels[sel].cpu().numpy(),
                 vis_mask=fused.visibility[:, sel].cpu().numpy(),
                 obj_feats=obj_out, objects_info=obj_info)
    stats = {"points": int(sel.sum()), "objects": n_real,
             "nan_objects": int(nan_rows.sum())}
    return scene, stats


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def process_scene(images: np.ndarray, depths: np.ndarray, segs: np.ndarray,
                  poses: np.ndarray, K: np.ndarray, obj_info: Dict,
                  extractor: ClipExtractor, out_path: str,
                  voxel_size: float, cloud_capacity: int = 65536,
                  max_objects: int = 32, eval_scenario: str = "open",
                  sim_kernel: str = "max", use_visibility: bool = False,
                  use_similarity: bool = True, vis_threshold: float = 0.05,
                  staged: Dict = None, writer: SceneWriter = None,
                  sync_timings: bool = False,
                  write: Callable = scene_io.write_scene) -> Dict:
    """One scene end to end on the extractor's device; returns timing and
    stat dicts. The cloud stays padded to ``cloud_capacity`` and objects
    and queries to ``max_objects`` (masked by ``obj_valid``).
    ``write(out_path, **scene)`` stores the result (``scene_io``'s h5
    writer by default). ``sync_timings`` synchronises the card at each
    phase boundary so the phase times are device times; otherwise they
    time the host's enqueue. With a ``writer`` the fetch and write run on
    its thread and the stats land in ``writer.results``. The stats add
    ``dropped``, the points the aggregation lost to capacity or extent."""
    device = extractor.device
    t0 = time.time()
    n_real = max(int(k) for k in obj_info) + 1  # incl. table id 0
    assert n_real <= max_objects, (n_real, max_objects)
    h, w = depths.shape[1:]
    if staged is None:
        staged = stage_scene(images, depths, segs, poses, K, device=device)
    dev_depths = staged["depths"].to(torch.float32)
    dev_segs = staged["segs"].to(torch.int32)
    dev_images, dev_poses, dev_K = (staged["images"], staged["poses"],
                                    staged["K"])

    # 1) aggregate views -> labeled voxel cloud; label-vote width in
    # buckets of 16 / max_objects (the payload is (7 + labels) per point)
    num_labels = 16 if n_real <= 16 else max_objects
    xyz, rgb, labels, mask, agg_dropped = aggregate_views(
        dev_depths, dev_images, dev_segs, dev_poses, dev_K,
        voxel_size=voxel_size, capacity=cloud_capacity,
        num_labels=num_labels)
    if sync_timings:
        _sync(device)
    t_agg = time.time() - t0

    # 2) per-(view, object) teacher features with visual prompts
    t0 = time.time()
    obj_feats, present = extractor.extract_obj_prior(
        dev_images, dev_segs, obj_ids=np.arange(max_objects),
        present_hint=segs)
    if sync_timings:
        _sync(device)
    t_clip = time.time() - t0

    # 3) text queries + object-level fusion
    t0 = time.time()
    query_embs = extractor.encode_queries(
        _fusion_query_texts(obj_info, eval_scenario), n_segments=max_objects)
    obj_valid = torch.arange(max_objects, device=device) < n_real
    cfg = FusionConfig(image_hw=(h, w), visibility_threshold=vis_threshold,
                       use_visibility=use_visibility,
                       use_similarity=use_similarity, sim_kernel=sim_kernel)
    fused = fuse_obj_prior(xyz, dev_depths, dev_segs, dev_poses, obj_feats,
                           present, query_embs, dev_K, cfg,
                           obj_valid=obj_valid)
    if sync_timings:
        _sync(device)
    t_fuse = time.time() - t0

    def _finalize() -> Dict:
        dropped = int(agg_dropped)
        if dropped:
            print(f"WARNING: {dropped} points truncated during aggregation "
                  f"(cloud_capacity={cloud_capacity} or grid extent too "
                  f"small) -> {out_path}", flush=True)
        scene, stats = finalize_scene(xyz, rgb, labels, mask, fused,
                                      query_embs, n_real, obj_info)
        write(out_path, **scene)
        if stats["points"] == 0:
            print(f"WARNING: 0 points survived compaction -> {out_path} "
                  "(all points table/pad or invisible in every view)",
                  flush=True)
        return {**stats, "dropped": dropped}

    timings = {"t_aggregate": t_agg, "t_teacher": t_clip, "t_fuse": t_fuse}
    if writer is not None and not sync_timings:
        def _finalize_logged() -> Dict:
            stats = _finalize()
            print(f"{out_path}: {stats}", flush=True)
            return stats

        writer.submit(_finalize_logged, tag=out_path)
        return timings
    t0 = time.time()
    stats = _finalize()
    timings["t_finalize"] = time.time() - t0
    return {**stats, **timings}


def build_extractor(args, device=None, seed: int = 0) -> ClipExtractor:
    """The ingest teacher: ``args.clip_model`` in bf16 with the obj-prior
    prompt settings of ``args``; weights from ``args.clip_checkpoint`` (a
    CLIP checkpoint file in any public layout: OpenAI, OpenCLIP, HF), or
    drawn from ``seed`` when it is None or "random"; crops at the
    teacher's canvas (its configuration's ``img_resize``)."""
    from ..teachers.convert import build_clip_from

    model = build_clip_from(args.clip_model, args.clip_checkpoint,
                            dtype=torch.bfloat16, device=device, seed=seed,
                            context="--clip-checkpoint")
    return ClipExtractor(model, mode="cls",
                         visual_prompt=args.visual_prompt.split(","),
                         crop_num_levels=args.crop_num_levels,
                         crop_expansion_ratio=args.crop_expansion_ratio,
                         img_resize=model.img_resize,
                         batch_size=args.batch_size)


def _intrinsic_matrix(ci: Dict) -> np.ndarray:
    return np.array([[ci["fx"], 0, ci["cx"]], [0, ci["fy"], ci["cy"]],
                     [0, 0, 1]], np.float32)


def run_blender(args, write: Callable = scene_io.write_scene) -> list:
    """MV-TOD ingest of scenes ``[args.start, args.end)`` (``--end`` is
    EXCLUSIVE, -1 = all) of ``args.root``'s split: a loader thread reads
    and stages scene i+1 while scene i runs on the card, and the writer
    thread (``SceneWriter``) fetches and writes scene i-1 through
    ``write``. Existing outputs are skipped. ``args.n_devices`` above 1
    deals the scenes over that many cards (``_run_multidevice``).
    Returns the writer's (path, stats) per scene."""
    from ..data.blender import BlenderDataset

    dataset = BlenderDataset(args.root, models_root=args.models_root,
                             split=args.split)
    extractor = build_extractor(args, device=args.device)
    os.makedirs(args.out, exist_ok=True)
    end = args.end if args.end >= 0 else len(dataset.scene_ids)

    def load_one(sid: int, device=extractor.device):
        scene_id = f"{sid:06d}"
        out_path = os.path.join(args.out, args.split, scene_id,
                                f"{scene_id}.{args.format}")
        if os.path.isfile(out_path):
            print(f"skip {scene_id}: exists", flush=True)
            return None
        if scene_id not in dataset.scene_ids:
            return None
        scene = dataset[sid]
        segs, _ = BlenderDataset.obtain_seg_info(scene)
        views = list(scene["views"].values())
        kw = dict(
            images=np.stack([v["rgb"] for v in views]),
            depths=np.stack([v["depth"] for v in views]),
            segs=np.stack(segs),
            poses=np.stack([np.asarray(v["camera"]["world_matrix"],
                                       np.float32) for v in views]),
            K=_intrinsic_matrix(scene["camera_intrinsic"]),
            obj_info=scene["objects_info"], out_path=out_path,
            voxel_size=args.voxel_size * scene["world_scale"])
        kw["staged"] = stage_scene(kw["images"], kw["depths"], kw["segs"],
                                   kw["poses"], kw["K"], device=device)
        return scene_id, kw

    if getattr(args, "n_devices", 1) > 1:
        return _run_multidevice(extractor, load_one, range(args.start, end),
                                args.n_devices, write)
    with ThreadPoolExecutor(1) as loader, SceneWriter() as writer:
        pending = None  # (scene_id, kwargs) read and staged, ready to run
        for sid in range(args.start, end + 1):
            nxt = loader.submit(load_one, sid) if sid < end else None
            if pending is not None:
                scene_id, kw = pending
                stats = process_scene(extractor=extractor, writer=writer,
                                      write=write, **kw)
                print(f"{scene_id}: {stats}", flush=True)
            pending = nxt.result() if nxt is not None else None
    return writer.results


def _pixels(xyz: np.ndarray, pose: np.ndarray, K: np.ndarray,
            hw: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """World points -> (row, column) pixels of one REGRAD view: world->cam
    in float32, the REGRAD camera flip (reference projections.py:89-92),
    pinhole with int truncation, clipped to the image."""
    from ..geom.transforms import transform_pointcloud_to_camera_frame

    cam = transform_pointcloud_to_camera_frame(
        torch.as_tensor(xyz, dtype=torch.float32),
        torch.as_tensor(pose, dtype=torch.float32)).numpy()
    cam[:, 1:3] *= -1
    uvw = cam @ K.T
    z = np.where(np.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
    uv = uvw[:, :2] / z[:, None]
    return (np.clip(uv[:, 1].astype(int), 0, hw[0] - 1),
            np.clip(uv[:, 0].astype(int), 0, hw[1] - 1))


@torch.no_grad()
def process_regrad_scene(scene: Dict, camera_poses: Dict, K: np.ndarray,
                         extractor: ClipExtractor, out_path: str,
                         voxel_size: float, max_objects: int = 32,
                         write: Callable = scene_io.write_regrad_scene
                         ) -> Dict:
    """One REGRAD scene: per-view 2D/3D consistency cleanup, patch-CLIP
    pixel fusion, per-object obj-prior fusion, the processed write
    (reference tools/preprocess_data.py:431-607 + projections.py:151-241;
    schema of save_multiview_dataset_h5py :40-58, ``write(out_path,
    **arrays)``, ``scene_io.write_regrad_scene`` by default).

    Cleanup (reference :476-546): drop 3D points whose projection lands
    outside their object's 2D mask. Patch fusion: per-view ViT patch
    features (the extractor's device) sampled at each point's pixel,
    voxel-mean over views. Object fusion: per-object mean of the per-view
    obj-prior features over the views where the object is present (the
    JAX package's choice; the reference means over all views)."""
    from ..geom.cleanup import voxel_pool

    t0 = time.time()
    h = w = None
    imgs, segs, pcs, rgbs, labs, pixs = [], [], [], [], [], []
    for v, e in sorted(scene["views"].items()):
        if not e.get("valid"):
            continue
        img, seg = e["image"], e["segm2d"]
        xyz, rgb, lab = e["pc_xyz"], e["pc_rgb"], e["pc_label"]
        h, w = img.shape[:2]
        ys, xs = _pixels(xyz, camera_poses[v], K, (h, w))
        keep = np.zeros(len(xyz), bool)
        for obj in np.unique(seg)[1:] if seg.min() == 0 else np.unique(seg):
            m3 = lab == obj
            keep[m3] = seg[ys[m3], xs[m3]] == obj
        if not keep.any():
            continue
        imgs.append(img)
        segs.append(seg)
        pcs.append(xyz[keep])
        rgbs.append(rgb[keep])
        labs.append(lab[keep])
        pixs.append((ys[keep], xs[keep]))
    if not pcs:
        return {"points": 0, "skipped": True}
    t_clean = time.time() - t0

    # per-view dense patch features, sampled at each kept point's pixel
    t0 = time.time()
    extractor.set_mode("patch")
    patch = extractor.extract(np.stack(imgs))  # (V, ph, pw, C)
    ph, pw = patch.shape[1:3]
    feats = []
    for i, (ys, xs) in enumerate(pixs):
        at = lambda a: torch.from_numpy(a).to(patch.device)
        f = patch[i, at(ys * ph // h), at(xs * pw // w)].float()
        feats.append((f / f.norm(dim=-1, keepdim=True).clamp_min(1e-6)
                      ).cpu().numpy())

    # per-(view, object) obj-prior features
    obj_ids = np.unique(np.concatenate(labs)).astype(np.int32)
    if len(obj_ids) > max_objects:
        raise ValueError(f"{len(obj_ids)} objects > max_objects "
                         f"{max_objects}")
    seg_stack = np.stack(segs).astype(np.int32)
    extractor.set_mode("cls")
    obj_feats, present = extractor.extract_obj_prior(
        np.stack(imgs), seg_stack, obj_ids=obj_ids, present_hint=seg_stack)
    obj_feats = obj_feats.float().cpu().numpy()  # (V, K, C)
    present = present.cpu().numpy()
    denom = np.maximum(present.sum(axis=0), 1)[:, None]
    per_obj = (obj_feats * present[..., None]).sum(axis=0) / denom
    t_teacher = time.time() - t0

    # aggregate + voxel pool (the host voxelizer)
    t0 = time.time()
    xyz_v, pooled, lab_v = voxel_pool(
        np.concatenate(pcs),
        {"rgb": np.concatenate(rgbs), "mv": np.concatenate(feats)},
        np.concatenate(labs), voxel_size)
    t_fuse = time.time() - t0

    write(out_path, xyz=xyz_v, rgb=pooled["rgb"], label=lab_v,
          patch=pooled["mv"], per_obj=per_obj, obj_ids=obj_ids)
    return {"points": len(xyz_v), "objects": len(obj_ids),
            "views": len(pcs), "t_clean": t_clean, "t_teacher": t_teacher,
            "t_fuse": t_fuse}


def regrad_intrinsics(camera_info: Dict) -> np.ndarray:
    """The camera file's intrinsics (a dict of fx, fy, cx, cy or a 3x3
    matrix), else REGRAD's default, which centres 840x840 images."""
    ci = camera_info.get("intrinsic")
    if ci is None:
        return np.array([[1120.0, 0, 420], [0, 1120.0, 420], [0, 0, 1]],
                        np.float32)
    if isinstance(ci, dict):
        return _intrinsic_matrix(ci)
    return _intrinsic_matrix({"fx": ci[0][0], "fy": ci[1][1],
                              "cx": ci[0][2], "cy": ci[1][2]})


def run_regrad(args, write: Callable = scene_io.write_regrad_scene
               ) -> list:
    """REGRAD offline ingest (reference preprocess_regrad_aggr_multiview,
    tools/preprocess_data.py:431-607) of scenes ``[args.start,
    args.end)``: raw scenes -> processed scenes, existing outputs and
    unreadable scenes skipped. Returns (scene id, stats) per scene run."""
    from ..core.config import load_cfg, merge_cfg_from_list
    from ..data.regrad import RegradDataset

    cfg = load_cfg(args.reader_config)
    if args.root:
        cfg = merge_cfg_from_list(cfg, ["root_dir", args.root])
    cfg.reference_frame = "world"  # reference :436
    ds = RegradDataset(cfg, args.split)
    K = regrad_intrinsics(ds.camera_info)
    poses = {v: np.asarray(ds.camera_info["extrinsic"][v])
             for v in range(1, ds.nviews + 1)}
    extractor = build_extractor(args, device=args.device)

    results = []
    end = len(ds) if args.end < 0 else min(args.end, len(ds))
    for i in range(args.start, end):
        sid = ds.idx_to_scene_id(i)
        out_path = os.path.join(args.out, args.split, f"{sid}.{args.format}")
        if os.path.exists(out_path):  # idempotent resume (reference :192)
            print(f"{sid}: exists, skipping", flush=True)
            continue
        try:
            scene = ds[i]
        except Exception as exc:  # noqa: BLE001 (reference :201-205 skips
            # scenes it cannot read)
            print(f"{sid}: SKIP ({exc!r})", flush=True)
            continue
        stats = process_regrad_scene(scene, poses, K, extractor, out_path,
                                     voxel_size=args.voxel_size, write=write)
        print(f"{sid}: {stats}", flush=True)
        results.append((sid, stats))
    return results


def _local_devices(device: torch.device, n_devices: int) -> list:
    """The devices of ``n_devices`` workers on ``device``'s kind: the
    local cards, at most as many as there are (with the JAX package's
    warning when fewer), or ``n_devices`` CPU workers (the counterpart of
    the JAX tests' forced host devices)."""
    if device.type != "cuda":
        return [device] * n_devices
    count = torch.cuda.device_count()
    nd = min(n_devices, count)
    if nd < n_devices:
        print(f"WARNING: --n-devices {n_devices} > {count} local devices; "
              f"using {nd}", flush=True)
    return [torch.device("cuda", i) for i in range(nd)]


def _run_multidevice(extractor: ClipExtractor, load_one: Callable, sids,
                     n_devices: int,
                     write: Callable = scene_io.write_scene) -> list:
    """Single-host multi-card ingest: scenes dealt round-robin over the
    local cards, one worker thread per card (the JAX package's
    ``_run_multidevice``; the reference runs a spawn Pool of CUDA
    processes, tools/preprocess_data.py:728-730). Each worker makes its
    card current in its own thread (the CUDA runtime's current device is
    per thread), runs its own teacher replica (``ClipExtractor.
    on_device``), and has its own one-slot loader, which reads and stages
    ``load_one(sid, device)`` for its next scene while the current one
    runs, and its own ``SceneWriter``. Scenes are independent: no
    collectives. Returns the (path, stats) of every written scene, by
    path."""
    devices = _local_devices(extractor.device, n_devices)
    nd = len(devices)
    replicas = [extractor.on_device(d) for d in devices]
    sids = list(sids)

    def worker(wi: int) -> list:
        dev = devices[wi]
        mine = sids[wi::nd]
        current = (torch.cuda.device(dev) if dev.type == "cuda"
                   else contextlib.nullcontext())
        with current, SceneWriter() as writer, \
                ThreadPoolExecutor(1) as loader:
            nxt = loader.submit(load_one, mine[0], dev) if mine else None
            for j in range(len(mine)):
                loaded = nxt.result()
                nxt = (loader.submit(load_one, mine[j + 1], dev)
                       if j + 1 < len(mine) else None)
                if loaded is None:
                    continue
                scene_id, kw = loaded
                stats = process_scene(extractor=replicas[wi], writer=writer,
                                      write=write, **kw)
                print(f"{scene_id} [dev{wi}]: {stats}", flush=True)
        return writer.results

    with ThreadPoolExecutor(nd) as pool:
        futs = [pool.submit(worker, wi) for wi in range(nd)]
        results = [r for f in futs for r in f.result()]  # re-raises
    return sorted(results, key=lambda r: r[0])


def run_synthetic(args, write: Callable = scene_io.write_scene) -> list:
    """Full-pipeline smoke run on procedurally generated raw scenes;
    ``args.n_devices`` above 1 deals them over that many cards. Returns
    the (path, stats) of every scene."""
    from ..data.synthetic import make_raw_scene

    extractor = build_extractor(args, device=args.device)

    def load_one(sid: int, device=None):
        scene_id = f"{sid:06d}"
        out_path = os.path.join(args.out, args.split, scene_id,
                                f"{scene_id}.{args.format}")
        # per-scene rng: the same scenes as the JAX package's run, in any
        # order of the workers
        raw = make_raw_scene(np.random.default_rng(sid), n_objects=3,
                             n_views=args.n_views)
        kw = dict(images=raw["images"], depths=raw["depths"],
                  segs=raw["segs"], poses=raw["poses"], K=raw["K"],
                  obj_info=raw["objects_info"], out_path=out_path,
                  voxel_size=args.voxel_size, cloud_capacity=4096)
        if device is not None:
            kw["staged"] = stage_scene(kw["images"], kw["depths"],
                                       kw["segs"], kw["poses"], kw["K"],
                                       device=device)
        return scene_id, kw

    if getattr(args, "n_devices", 1) > 1:
        return _run_multidevice(extractor, load_one, range(args.n_scenes),
                                args.n_devices, write)
    results = []
    for sid in range(args.n_scenes):
        scene_id, kw = load_one(sid)
        stats = process_scene(extractor=extractor, write=write, **kw)
        print(f"{scene_id}: {stats}")
        results.append((kw["out_path"], stats))
    return results


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dropclip_tpu_torch offline ingest")
    p.add_argument("-ds", "--dataset",
                   choices=["Blender", "REGRAD", "Synthetic"], required=True)
    p.add_argument("--reader-config", default="configs/REGRAD.yaml",
                   help="raw-reader config for -ds REGRAD")
    p.add_argument("-r", "--root", default=None, help="raw dataset root")
    p.add_argument("-c", "--out", required=True, help="processed output dir")
    p.add_argument("--models-root", default=None)
    p.add_argument("--split", default="train")
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--end", type=int, default=-1,
                   help="end scene index, EXCLUSIVE (-1 = all)")
    p.add_argument("--format", choices=["h5py", "npz"], default="h5py",
                   help="processed file format (npz where h5py is absent)")
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--clip-model", default="ViT-L/14@336px",
                   help="a name of teachers.clip.CLIP_CONFIGS, e.g. "
                        "ViT-H-14 (OpenCLIP)")
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--visual-prompt", default="crop-mask")
    p.add_argument("--crop-num-levels", type=int, default=1)
    p.add_argument("--crop-expansion-ratio", type=float, default=0.15)
    p.add_argument("--n-scenes", type=int, default=4, help="synthetic only")
    p.add_argument("--n-views", type=int, default=4, help="synthetic only")
    p.add_argument("--n-devices", type=int, default=1,
                   help="local cards to ingest on concurrently, one worker "
                        "thread each (Blender and Synthetic; with --device "
                        "cpu, CPU workers)")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.dataset == "Blender":
        if not args.root:
            p.error("-r/--root is required for -ds Blender")
        run_blender(args)
    elif args.dataset == "REGRAD":
        run_regrad(args)
    else:
        run_synthetic(args)


if __name__ == "__main__":
    main()
