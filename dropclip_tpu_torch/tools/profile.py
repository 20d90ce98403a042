"""Op-level profiler over the port's hot surfaces.

Port of ``dropclip_tpu/tools/profile.py``. One surface runs under
``torch.profiler`` on synthetic inputs at production shapes, and the
per-op table prints from its Chrome trace (``core/xplane.py``): on the
card the CUDA kernels' device time, on the CPU the ops' host self time
(a relative ranking only).

Surfaces:

- ``train``   one distillation train step (the brick engine at the
              recipe's shapes: batch 8 x 8192 voxels, MinkUNet14D, bf16
              activations): K1 in every k3 conv's forward and dgrad
- ``infer``   the student forward on a batch of 8 and paired-softmax
              grounding of 8 queries x 8 negatives per scene (K1)
- ``teacher`` the ingest's CLIP visual forward, a 96-crop ViT-L/14@336px
              chunk in bf16 (K3, K6, K7)
- ``fusion``  multi-view point-level feature fusion (8 views at 480x640)

``--tiny`` shrinks every surface for a seconds-long smoke run on any
device. ``--device`` picks the device (the card by default).

Usage::

    python -m dropclip_tpu_torch.tools.profile --surface teacher --top 30
    python -m dropclip_tpu_torch.tools.profile --surface train \\
        --logdir prof_train   # keep the trace for later parsing
    python -m dropclip_tpu_torch.tools.profile --surface infer --tiny \\
        --device cpu
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def _student_inputs(tiny: bool, device):
    """(cfg, coords, mask, bf16 feats) of the train and infer surfaces:
    tabletop scenes (6000 voxels in 8192 slots at full size), capacities
    autotuned with slack 1.5, (4, 4, 2) bricks."""
    from ..core.config import CfgNode
    from ..data.synthetic import make_tabletop_coords
    from ..sparse.bricks import autotune_brick_capacities

    b, m = (2, 256) if tiny else (8, 8192)
    cfg = CfgNode(dict(arch_3d="tiny" if tiny else "MinkUNet14D",
                       feat_dim=16 if tiny else 768, loss_type="cosine",
                       use_color=True, base_lr=3e-4, min_lr=1e-4,
                       epochs=200, weight_decay=1e-5, max_norm=5.0,
                       brick_shape=[4, 4, 2], remat=False))
    rng = np.random.RandomState(0)
    coords, mask = make_tabletop_coords(
        rng, b, m, n_occ=128 if tiny else 6000, ext=8 if tiny else 40)
    cfg.brick_capacities = list(autotune_brick_capacities(
        coords, mask, slack=1.5, brick_shape=(4, 4, 2)))
    feats = rng.randn(b, m, 6).astype(np.float32) * mask[..., None]
    put = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
    return cfg, put(coords), put(mask), put(feats).bfloat16(), rng


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _surface_train(tiny: bool, device):
    from ..distill.engine import (DistilBatch, build_student_for,
                                  make_train_step)
    from ..distill.train_state import create_train_state, make_optimizer

    cfg, coords, mask, feats, rng = _student_inputs(tiny, device)
    b, m = mask.shape
    targets = torch.as_tensor(rng.randn(b, m, int(cfg.feat_dim)).astype(
        np.float32), device=device) * mask[..., None]
    labels = torch.zeros((b, m), dtype=torch.int32, device=device)
    batch = DistilBatch(coords, mask, feats, targets, labels, labels)
    model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    state = create_train_state(model, make_optimizer(cfg, 100))
    step = make_train_step(cfg)

    def run():
        _, metrics = step(state, batch)
        return float(metrics["distil_loss"])

    return run


def _surface_infer(tiny: bool, device):
    from ..distill.engine import build_student_for, build_topology
    from ..similarity import predict_queries

    cfg, coords, mask, feats, rng = _student_inputs(tiny, device)
    model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(0)).to(device)
    c_out, nq, nneg = int(cfg.feat_dim), 8, 8

    def unit(shape):
        e = torch.as_tensor(rng.randn(*shape).astype(np.float32),
                            device=device)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    qpos, qneg = unit((nq, c_out)), unit((nq, nneg, c_out))

    @torch.no_grad()
    def run():
        topo = build_topology(cfg, coords, mask)
        out = model(topo, feats)
        total = 0.0
        for s in range(out.shape[0]):
            pred, sims = predict_queries(out[s], qpos, qneg, mask=mask[s],
                                         method="paired", threshold=0.75)
            total = total + pred.float().sum() + sims.sum()
        return float(total)

    return run


def _surface_teacher(tiny: bool, device, model_name: str, crops: int):
    from ..teachers.clip import build_clip

    model = build_clip("tiny-test" if tiny else model_name,
                       dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       device=device)
    res = model.visual.image_resolution
    b = 4 if tiny else crops
    rng = np.random.RandomState(0)
    pixels = torch.as_tensor(rng.randn(b, res, res, 3).astype(np.float32),
                             device=device).bfloat16()

    @torch.no_grad()
    def run():
        return float(model.encode_image(pixels).float().sum())

    return run


def _surface_fusion(tiny: bool, device):
    from ..data.synthetic import make_raw_scene
    from ..fusion.core import FusionConfig, fuse_points

    rng = np.random.default_rng(0)
    n_views, hw = (2, (24, 32)) if tiny else (8, (480, 640))
    c = 16 if tiny else 768
    raw = make_raw_scene(rng, n_objects=3, n_points_per_obj=120,
                         n_views=n_views, hw=hw)
    ph, pw = hw[0] // 8, hw[1] // 8
    put = lambda a, dt=np.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a).astype(dt), device=device)
    pfeat = put(rng.normal(size=(n_views, ph, pw, c)))
    cfg = FusionConfig(image_hw=hw, use_similarity=False)
    points, depths = put(raw["points"]), put(raw["depths"])
    segs, poses, K = put(raw["segs"], np.int32), put(raw["poses"]), \
        put(raw["K"])

    @torch.no_grad()
    def run():
        fused = fuse_points(points, depths, segs, poses, pfeat, None, K, cfg)
        return float(torch.nansum(fused.features))

    return run


def trace(run, logdir: str, reps: int, device) -> str:
    """``reps`` calls of ``run`` (each ends in a host read, so the trace
    holds the device's work) under ``torch.profiler``; the Chrome trace's
    path under ``logdir``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        for _ in range(reps):
            run()
        _sync(device)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    return path


def main(argv=None) -> int:
    from ..core.device import resolve_device
    from ..core.xplane import print_profile

    ap = argparse.ArgumentParser(
        description="profile one hot surface and print the per-op table")
    ap.add_argument("--surface", required=True,
                    choices=["train", "infer", "teacher", "fusion"])
    ap.add_argument("--logdir", default=None,
                    help="trace output dir (default: a fresh tempdir)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--reps", type=int, default=3,
                    help="traced repetitions (after one warm-up call)")
    ap.add_argument("--tiny", action="store_true",
                    help="seconds-long smoke shapes (any device)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--clip-model", default="ViT-L/14@336px",
                    help="teacher surface tower")
    ap.add_argument("--crops", type=int, default=96,
                    help="teacher surface batch (ingest chunk = 96)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    logdir = args.logdir or tempfile.mkdtemp(prefix="dropclip_prof_")
    builders = {"train": lambda: _surface_train(args.tiny, device),
                "infer": lambda: _surface_infer(args.tiny, device),
                "teacher": lambda: _surface_teacher(
                    args.tiny, device, args.clip_model, args.crops),
                "fusion": lambda: _surface_fusion(args.tiny, device)}
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# building surface '{args.surface}' (device {name}, "
          f"tiny={args.tiny})", flush=True)
    run = builders[args.surface]()
    print("# warm-up...", flush=True)
    run()
    print(f"# tracing {args.reps} reps -> {logdir}", flush=True)
    trace(run, logdir, args.reps, device)
    print_profile(logdir, top=args.top)
    print(f"# trace kept at {logdir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
