"""Offline ingest: raw multi-view scenes -> fused per-object features -> h5.

Port of ``dropclip_tpu/tools/preprocess_data.py`` (reference
tools/preprocess_data.py:152-332): aggregate the RGB-D views into a
labeled voxel cloud, run the CLIP teacher on every present (view, object)
pair with crop-mask prompts, embed the per-object text queries, fuse the
object features across views, replace never-fused objects' NaN rows with
their text embedding, and write the processed scene. Every stage runs on
the card (the ViT-L teacher through K3, K6 and K7) unless the caller
passes ``device="cpu"``.

Usage (``--clip-checkpoint`` a CLIP checkpoint file, OpenAI or
HuggingFace layout; without it the teacher's weights are drawn from a
seed):

  python -m dropclip_tpu_torch.tools.preprocess_data -ds Synthetic \\
      -c OUT_DIR --n-scenes 4 [--clip-checkpoint CLIP.pt] [--device cpu]

Waiting for a later slice: ``-ds Blender`` and ``-ds REGRAD`` (their raw
readers) and ``--n-devices`` (one scene per card).
"""

from __future__ import annotations

import argparse
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
    CLIP checkpoint file in either public layout), or drawn from ``seed``
    when it is None or "random"."""
    from ..teachers.convert import build_clip_from

    model = build_clip_from(args.clip_model, args.clip_checkpoint,
                            dtype=torch.bfloat16, device=device, seed=seed,
                            context="--clip-checkpoint")
    return ClipExtractor(model, mode="cls",
                         visual_prompt=args.visual_prompt.split(","),
                         crop_num_levels=args.crop_num_levels,
                         crop_expansion_ratio=args.crop_expansion_ratio,
                         img_resize=(336, 448), batch_size=args.batch_size)


def run_synthetic(args) -> None:
    """Full-pipeline smoke run on procedurally generated raw scenes."""
    from ..data.synthetic import make_raw_scene

    extractor = build_extractor(args, device=args.device)
    for sid in range(args.n_scenes):
        scene_id = f"{sid:06d}"
        out_path = os.path.join(args.out, args.split, scene_id,
                                f"{scene_id}.h5py")
        # per-scene rng: the same scenes as the JAX package's run
        raw = make_raw_scene(np.random.default_rng(sid), n_objects=3,
                             n_views=args.n_views)
        stats = process_scene(
            images=raw["images"], depths=raw["depths"], segs=raw["segs"],
            poses=raw["poses"], K=raw["K"], obj_info=raw["objects_info"],
            extractor=extractor, out_path=out_path,
            voxel_size=args.voxel_size, cloud_capacity=4096)
        print(f"{scene_id}: {stats}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dropclip_tpu_torch offline ingest")
    p.add_argument("-ds", "--dataset",
                   choices=["Blender", "REGRAD", "Synthetic"], required=True)
    p.add_argument("-c", "--out", required=True, help="processed output dir")
    p.add_argument("--split", default="train")
    p.add_argument("--voxel-size", type=float, default=0.02)
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--clip-model", default="ViT-L/14@336px")
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--visual-prompt", default="crop-mask")
    p.add_argument("--crop-num-levels", type=int, default=1)
    p.add_argument("--crop-expansion-ratio", type=float, default=0.15)
    p.add_argument("--n-scenes", type=int, default=4, help="synthetic only")
    p.add_argument("--n-views", type=int, default=4, help="synthetic only")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    args = p.parse_args(argv)
    if args.dataset != "Synthetic":
        p.error(f"-ds {args.dataset} is not ported yet (its raw reader "
                "comes with a later slice); use -ds Synthetic")
    run_synthetic(args)


if __name__ == "__main__":
    main()
