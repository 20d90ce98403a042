#!/usr/bin/env python3
"""Smoke run of dropclip_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

1. records the card (nvidia-smi name and power limit) and builds the
   kernels from this checkout: K1 (``csrc/brick_conv3.cu`` with nvcc into
   ``build/kernels/``) and K6 (Triton, compiled at its first launch);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes the serve path gives it (K1: the 16 k3 convs of MinkUNet14D at
   batch 8 in float32 with TF32 off and in bf16; K6: the text tower's
   (Q*77, 768) rows in bf16 and float32), and times kernel, plain version,
   a library yardstick the port never calls, and the card's bound;
3. serves full-width requests (configs/DistilBlender.yaml: MinkUNet14D,
   768-d out, 8192 voxels, (4, 4, 2) bricks; ViT-L/14@336px text tower in
   bf16; weights drawn from a seed) through ``GroundingPipeline.ground``
   and ``ground_batch`` and checks from the launch counters that K1 ran 16
   times per student forward and K6 25 times per text encode;
4. compares one request on the card with the same request on the CPU
   (plain versions, same weights);
5. profiles one ``ground`` request and one ``ground_batch`` (device busy
   share of the wall time, top kernels by device time);
6. prints the ``kernels`` JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises and exits non-zero. Without a CUDA card the
script exits non-zero before printing any result. A JSON report with every
number goes to ``chiprun_out/chip_smoke_report.json``.
"""

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 outside
# the tensor cores, bf16 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
QUERY_SETS = [["the red mug", "a green bowl"], ["a blue bottle", "the box"],
              ["a yellow can", "the white plate"], ["a spoon", "the fork"],
              ["a black mug", "the red bowl"]]
BATCH_QUERIES = ["the green bottle", "a white box"]


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Mean device time of ``fn`` in ms (CUDA events around ``reps``
    back-to-back calls, after ``warmup``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def build_kernels():
    """Compile K1 (nvcc) and K6 (Triton, by a first launch) side by
    side; returns (K1 build seconds, K6 build seconds, ptxas report)."""
    from dropclip_tpu_torch.kernels import brick_conv3 as k1
    from dropclip_tpu_torch.ops.layernorm import layer_norm

    def nvcc():
        t = time.time()
        k1.build()
        return time.time() - t

    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(nvcc)
        t = time.time()
        x = torch.randn(4, 768, device="cuda", dtype=torch.bfloat16)
        layer_norm(x, torch.ones(768, device="cuda"),
                   torch.zeros(768, device="cuda"))
        torch.cuda.synchronize()
        t_k6 = time.time() - t
        t_k1 = fut.result()
    return t_k1, t_k6, k1.build_log


def make_clouds(n_scenes):
    """Tabletop clouds: 6000 synthetic voxel coords at 5 cm, one jittered
    point per voxel plus a second for half of them. Re-centred and
    re-voxelized by the pipeline they occupy about 7100 voxels (jitter
    splits some), within the 8192-voxel capacity."""
    from dropclip_tpu_torch.data.synthetic import make_tabletop_coords

    rng = np.random.RandomState(SEED)
    coords, mask = make_tabletop_coords(rng, n_scenes, 8192, n_occ=6000,
                                        ext=40)
    clouds, rgbs = [], []
    for b in range(n_scenes):
        c = coords[b][mask[b]].astype(np.float32)
        pts = np.concatenate([c, c[: len(c) // 2]])
        xyz = (pts + rng.rand(*pts.shape).astype(np.float32)) * 0.05
        clouds.append(xyz.astype(np.float32))
        rgbs.append(rng.rand(len(xyz), 3).astype(np.float32))
    return clouds, rgbs


def main_path_shapes(model):
    """(level, C, Cout) of every k3 conv in forward order."""
    shapes = []
    for s in range(4):
        blk = getattr(model, f"block{s + 1}_0")
        shapes += [(s + 1, blk.conv1.kernel.shape[1], blk.conv1.kernel.shape[2]),
                   (s + 1, blk.conv2.kernel.shape[1], blk.conv2.kernel.shape[2])]
    for d in range(4):
        blk = getattr(model, f"block{5 + d}_0")
        shapes += [(3 - d, blk.conv1.kernel.shape[1], blk.conv1.kernel.shape[2]),
                   (3 - d, blk.conv2.kernel.shape[1], blk.conv2.kernel.shape[2])]
    return shapes


def k1_phase(pipe, clouds, rgbs, report):
    """K1 against its plain version at the 16 main-path shapes, batch 8."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.distill.engine import build_topology
    from dropclip_tpu_torch.kernels.brick_conv3 import (brick_conv3,
                                                        brick_conv3_plain)
    from dropclip_tpu_torch.sparse.bricks import fold_topology, halo_exchange

    voxes = [pipe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    coords = torch.as_tensor(np.stack([v.coords for v in voxes]),
                             device="cuda")
    mask = torch.as_tensor(np.stack([v.mask for v in voxes]), device="cuda")
    topo = fold_topology(build_topology(pipe.cfg, coords, mask))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows, tot = [], {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                     "library_ms": 0.0}
    max_err = 0.0
    for i, (lvl, c, cout) in enumerate(main_path_shapes(pipe.model)):
        lv = topo.levels[lvl]
        bm, bx, by, bz = lv.occ.shape
        occf = lv.occ[..., None].float()
        # data-needed work: occupied (output voxel, input voxel) tap pairs
        halo = halo_exchange(occf, lv.nbr, 1)
        taps = (halo.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)
                .sum((-1, -2, -3))[..., 0])
        pairs = float((taps * occf[..., 0]).sum())
        for dtype in (torch.float32, torch.bfloat16):
            x = (torch.randn((bm, bx, by, bz, c), generator=gen,
                             device="cuda") * occf).to(dtype)
            w = (torch.randn((27, c, cout), generator=gen, device="cuda")
                 * (2.0 / (27 * cout)) ** 0.5).to(dtype)
            got = brick_conv3(x, lv.nbr, w, lv.occ).float()
            ref = brick_conv3_plain(x, lv.nbr, w, lv.occ).float()
            torch.cuda.synchronize()
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            if dtype == torch.float32:
                ok = torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
            else:
                ok = err <= 1e-2 * scale
            check(ok and scale > 0, f"K1 {dtype} shape {i} (L{lvl} {c}->"
                  f"{cout}, Bm {bm}): max err {err} vs max|ref| {scale}")
            if dtype != torch.float32:
                rows[-1]["bf16_max_abs_err"] = err
                rows[-1]["bf16_rel_err"] = err / scale
                continue
            max_err = max(max_err, err)
            es = x.element_size()
            nbytes = (x.numel() * es + w.numel() * es + lv.nbr.numel() * 4
                      + lv.occ.numel() + bm * bx * by * bz * cout * es)
            flops = 2.0 * pairs * c * cout
            bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
            k_ms = cuda_ms(lambda: brick_conv3(x, lv.nbr, w, lv.occ), 5)
            p_ms = cuda_ms(lambda: brick_conv3_plain(x, lv.nbr, w, lv.occ),
                           2, warmup=1)
            w5 = w.permute(2, 1, 0).reshape(cout, c, 3, 3, 3).contiguous()

            def library():
                h = halo_exchange(x, lv.nbr, 1).permute(0, 4, 1, 2, 3)
                return F.conv3d(h, w5).permute(0, 2, 3, 4, 1) * \
                    lv.occ[..., None]

            lib_err = float((library() - ref).abs().max())
            l_ms = cuda_ms(library, 3, warmup=1)
            row = dict(shape=i, level=lvl, bm=bm, c=c, cout=cout,
                       max_abs_err=err, rel_err=err / scale,
                       library_max_abs_err=lib_err, ms=k_ms, plain_ms=p_ms,
                       library_ms=l_ms, bound_ms=bound,
                       bound_by="operations" if flops / PEAK_FLOPS[dtype]
                       > nbytes / PEAK_BYTES else "bytes",
                       flops_needed=flops,
                       flops_padded=2.0 * bm * bx * by * bz * 27 * c * cout,
                       bytes=nbytes)
            rows.append(row)
            for k in tot:
                tot[k] += row[k]
        r = rows[-1]
        print(f"K1 L{lvl} {c:4d}->{cout:4d} Bm={bm:5d}: f32 err "
              f"{r['max_abs_err']:.3e} (rel {r['rel_err']:.3e}) bf16 rel "
              f"{r['bf16_rel_err']:.3e} | kernel {r['ms']:.4f} ms plain "
              f"{r['plain_ms']:.4f} ms cudnn {r['library_ms']:.4f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
    report["k1_shapes"] = rows
    print(f"K1 per forward (16 convs, batch {BATCH}, f32): kernel "
          f"{tot['ms']} ms, plain {tot['plain_ms']} ms, cudnn "
          f"{tot['library_ms']} ms, bound {tot['bound_ms']} ms", flush=True)
    return dict(max_abs_err=max_err, bound_by="operations", **tot)


def k6_phase(report):
    """K6 against its plain version at the text tower's LayerNorm rows."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    rows, main = [], None
    for q in (4, 1):
        for dtype in (torch.bfloat16, torch.float32):
            x = (torch.randn((q * 77, 768), generator=gen, device="cuda") * 3
                 ).to(dtype)
            s = 1 + 0.1 * torch.randn(768, generator=gen, device="cuda")
            b = 0.1 * torch.randn(768, generator=gen, device="cuda")
            got = layer_norm(x, s, b).float()
            ref = layer_norm_plain(x, s, b).float()
            torch.cuda.synchronize()
            err = float((got - ref).abs().max())
            if dtype == torch.bfloat16:
                ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(
                    1e-30))) - 7)
                ok = bool(((got - ref).abs() <= ulp).all())
            else:
                ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
            check(ok, f"K6 {dtype} ({q * 77}, 768): max err {err}")
            es = x.element_size()
            nbytes = 2 * x.numel() * es + 2 * 768 * 4
            flops = 9.0 * x.numel()
            bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
            row = dict(rows=q * 77, dtype=str(dtype), max_abs_err=err,
                       ms=cuda_ms(lambda: layer_norm(x, s, b), 200),
                       plain_ms=cuda_ms(lambda: layer_norm_plain(x, s, b),
                                        200),
                       library_ms=cuda_ms(lambda: F.layer_norm(
                           x, (768,), s.to(dtype), b.to(dtype), 1e-5), 200),
                       bound_ms=bound, bound_by="bytes")
            rows.append(row)
            print(f"K6 ({q * 77}, 768) {dtype}: err {err:.3e} | kernel "
                  f"{row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
                  f"F.layer_norm {row['library_ms']:.5f} ms bound "
                  f"{bound:.6f} ms", flush=True)
            if q == 4 and dtype == torch.bfloat16:
                main = row
    report["k6_shapes"] = rows
    return {k: main[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "library_ms", "bound_ms", "bound_by")}


def serve_phase(pipe, clouds, rgbs, report):
    """Full-width requests through the entry points, kernels counted."""
    from dropclip_tpu_torch.kernels.brick_conv3 import brick_conv3
    from dropclip_tpu_torch.ops.layernorm import layer_norm

    sim = pipe.clip_sim
    t = time.time()
    pipe.ground(clouds[0], rgbs[0], QUERY_SETS[0])  # warm-up request
    print(f"warm-up request: {(time.time() - t) * 1e3} ms", flush=True)

    brick_conv3.launches = 0
    layer_norm.launches = 0
    fwd0, enc0 = pipe.forwards, sim.encodes
    req_ms = []
    for i in range(1, 5):
        torch.cuda.synchronize()
        t = time.time()
        masks, sims = pipe.ground(clouds[i], rgbs[i], QUERY_SETS[i])
        req_ms.append((time.time() - t) * 1e3)
        check(masks.shape == (2, len(clouds[i])) and masks.dtype == bool,
              f"ground masks shape {masks.shape}")
        # min-max normalised over the valid voxels; padding rows fall
        # outside [0, 1] in the JAX pipeline too
        valid = pipe._host_voxelize(clouds[i], rgbs[i])[0].mask
        check(sims.shape == (2, pipe.capacity) and np.isfinite(sims).all()
              and sims[:, valid].min() >= 0
              and sims[:, valid].max() <= 1 + 1e-6,
              "ground sims not finite in [0, 1] on the valid voxels")
        check(0 < masks.mean() < 1, "degenerate grounding mask")
        print(f"ground request {i}: {req_ms[-1]} ms, last_dropped "
              f"{pipe.last_dropped}, mask fraction {masks.mean(1)}",
              flush=True)
    torch.cuda.synchronize()
    t = time.time()
    bmasks, bsims = pipe.ground_batch(clouds[:BATCH], rgbs[:BATCH],
                                      BATCH_QUERIES)
    batch_ms = (time.time() - t) * 1e3
    print(f"ground_batch of {BATCH} scenes: {batch_ms} ms "
          f"({batch_ms / BATCH} ms/scene), last_dropped "
          f"{pipe.last_dropped}", flush=True)
    one_masks, one_sims = pipe.ground(clouds[3], rgbs[3], BATCH_QUERIES)
    fwds, encs = pipe.forwards - fwd0, sim.encodes - enc0
    k1_n, k6_n = brick_conv3.launches, layer_norm.launches

    check(len(bmasks) == BATCH and bsims.shape == (BATCH, 2, pipe.capacity),
          "ground_batch shapes")
    sim_diff = float(np.abs(bsims[3] - one_sims).max())
    agree = float((bmasks[3] == one_masks).mean())
    print(f"ground_batch scene 3 vs ground(): max |dsims| {sim_diff}, "
          f"mask agreement {agree}", flush=True)
    check(sim_diff <= 1e-4 and agree >= 0.999,
          "ground_batch disagrees with per-scene ground")
    print(f"launches: K1 {k1_n} over {fwds} student forwards, K6 {k6_n} "
          f"over {encs} text encodes", flush=True)
    check(fwds == 6 and k1_n == 16 * fwds,
          f"K1 ran {k1_n} times over {fwds} forwards (want 16 each)")
    check(encs >= 1 and k6_n == 25 * encs,
          f"K6 ran {k6_n} times over {encs} encodes (want 25 each)")
    report["serve"] = dict(request_ms=req_ms, batch_ms=batch_ms,
                           forwards=fwds, encodes=encs, k1_launches=k1_n,
                           k6_launches=k6_n,
                           last_dropped=pipe.last_dropped,
                           batch_vs_single_max_dsims=sim_diff)
    return k1_n, k6_n


def cpu_phase(cfg, pipe, clouds, rgbs, report):
    """One request on the card and on the CPU (plain versions), same
    seeded weights."""
    from dropclip_tpu_torch.pipeline import GroundingPipeline, make_clip_sim

    cpu = GroundingPipeline(cfg, clip_sim=make_clip_sim(cfg, "cpu", SEED),
                            device="cpu", seed=SEED)
    x, r, q = clouds[5], rgbs[5], QUERY_SETS[0]
    f_gpu = pipe.featurize(x, r)[0].cpu()
    t = time.time()
    f_cpu = cpu.featurize(x, r)[0]
    cpu_ms = (time.time() - t) * 1e3
    feat_rel = float((f_gpu - f_cpu).abs().max() / f_cpu.abs().max())
    e_gpu = pipe.clip_sim.encode_text(q).cpu()
    e_cpu = cpu.clip_sim.encode_text(q)
    cos = float(torch.nn.functional.cosine_similarity(e_gpu, e_cpu).min())
    m_gpu, s_gpu = pipe.ground(x, r, q)
    m_cpu, s_cpu = cpu.ground(x, r, q)
    dsims = float(np.abs(s_gpu - s_cpu).max())
    agree = float((m_gpu == m_cpu).mean())
    print(f"card vs CPU: student features max rel diff {feat_rel} (CPU "
          f"forward {cpu_ms} ms), bf16 text embedding min cosine {cos}, "
          f"sims max |d| {dsims}, mask agreement {agree}", flush=True)
    report["card_vs_cpu"] = dict(feat_max_rel=feat_rel, text_min_cos=cos,
                                 sims_max_abs=dsims, mask_agreement=agree)
    # f32 student: summation order only; bf16 text tower: rounding in two
    # matmul libraries, which the temperature-0.1 softmax amplifies
    check(feat_rel <= 1e-4, f"student features differ by {feat_rel}")
    check(cos >= 0.999, f"text embeddings differ (cosine {cos})")
    check(dsims <= 0.05 and agree >= 0.99,
          f"grounding differs: |dsims| {dsims}, agreement {agree}")


def profile_phase(pipe, clouds, rgbs, report):
    """One ground request and one ground_batch under torch.profiler: the
    device's busy share of the wall time and the kernels that fill it.
    The ground request's trace goes to chiprun_out/trace_ground.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    queries = ["a red box", "the cup"]
    cases = (("ground", lambda: pipe.ground(clouds[6], rgbs[6], queries)),
             ("ground_batch",
              lambda: pipe.ground_batch(clouds, rgbs, queries)))
    for name, fn in cases:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.time()
            fn()
            torch.cuda.synchronize()
            wall = (time.time() - t) * 1e3
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in kernels) / 1e3
        check(busy > 0, f"profiler saw no device time in {name}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        report.setdefault("profile", {})[name] = dict(
            wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
            top=[dict(kernel=e.key, calls=e.count,
                      ms=e.self_device_time_total / 1e3) for e in top])
        print(f"profile {name}: wall {wall} ms, device busy {busy} ms, "
              f"idle share {1 - busy / wall}", flush=True)
        for e in top:
            print(f"  {e.self_device_time_total / 1e3:10.4f} ms "
                  f"{e.count:5d} calls  {e.key[:90]}", flush=True)
        # the port's own kernels: device time per launch, free of the
        # host's launch overhead that CUDA events around a loop include
        for tag, key in (("K1", "brick_conv3_kernel"), ("K6", "_ln_rows")):
            mine = [e for e in kernels if key in e.key]
            n = sum(e.count for e in mine)
            dev = sum(e.self_device_time_total for e in mine) / 1e3
            report["profile"][name][tag] = dict(launches=n, device_ms=dev)
            print(f"  {tag}: {n} launches, {dev} ms on the device, "
                  f"{dev / max(n, 1)} ms each", flush=True)
        if name == "ground":
            prof.export_chrome_trace(os.path.join(
                ROOT, "chiprun_out", "trace_ground.json"))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "card and has no CPU mode", file=sys.stderr)
        return 2
    # fails here, before any output, when run outside a checkout
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.distill.engine import brick_shape_of
    from dropclip_tpu_torch.pipeline import GroundingPipeline, make_clip_sim
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    card = card_line()
    import triton

    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda} triton {triton.__version__}", flush=True)
    t_k1, t_k6, ptxas = build_kernels()
    print(f"built K1 (nvcc, sm_90a) in {t_k1:.2f} s, K6 (triton) in "
          f"{t_k6:.2f} s", flush=True)
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    cfg.clip_checkpoint = "random"
    clouds, rgbs = make_clouds(BATCH)
    report = {"card": card, "torch": torch.__version__}
    clip_sim = make_clip_sim(cfg, "cuda", SEED)
    probe = GroundingPipeline(cfg, clip_sim=clip_sim, device="cuda",
                              seed=SEED)
    vox = [probe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    caps = autotune_brick_capacities(np.stack([v.coords for v in vox]),
                                     np.stack([v.mask for v in vox]),
                                     brick_shape=brick_shape_of(cfg))
    print(f"scenes: {[int(v.mask.sum()) for v in vox]} voxels; brick "
          f"capacities {caps}", flush=True)
    pipe = GroundingPipeline(cfg, clip_sim=clip_sim, brick_capacities=caps,
                             device="cuda", seed=SEED)
    del probe

    k1 = k1_phase(pipe, clouds, rgbs, report)
    k6 = k6_phase(report)
    k1_n, k6_n = serve_phase(pipe, clouds, rgbs, report)
    cpu_phase(cfg, pipe, clouds, rgbs, report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    profile_phase(pipe, clouds, rgbs, report)

    kernels = [
        dict(name="K1 brick_conv3", route="cuda",
             source="dropclip_tpu_torch/csrc/brick_conv3.cu",
             replaces="dropclip_tpu/sparse/pallas_conv.py:125",
             launches=k1_n, **k1),
        dict(name="K6 layer_norm", route="triton",
             source="dropclip_tpu_torch/ops/layernorm.py",
             replaces="dropclip_tpu/ops/layernorm.py:153",
             launches=k6_n, **k6),
    ]
    report["kernels"] = kernels
    report["seconds"] = time.time() - t0
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    print(f"total {report['seconds']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
