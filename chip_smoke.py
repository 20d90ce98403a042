#!/usr/bin/env python3
"""Smoke run of dropclip_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

1. records the card (nvidia-smi name and power limit) and builds every
   kernel from this checkout side by side: the CUDA sources with nvcc into
   ``build/kernels/`` (K1 ``csrc/brick_conv3.cu``; K2
   ``csrc/pillar_conv3.cu``; K3, K4 and K5 ``csrc/attention.cu``) and the
   Triton kernels K6 and K7 by a first launch; prints ptxas' registers
   and spills per entry function (attention v3 must not spill);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes its paths give it (K1: the 16 k3 convs of MinkUNet14D at batch 8
   in float32 with TF32 off and in bf16, both timed against halo gather +
   cuDNN ``conv3d`` in the same dtype and a tensor-core bound, 3xTF32 for
   float32; K6: the text tower's (Q*77, 768)
   rows and the ViT-L teacher's (96*769, 1024) and (96, 1024) rows; K3 and
   K4: the teacher's (96, 769, 16, 64) bf16; K5: the hi-res patch
   extract's (8, 3073, 16, 64) bf16, with DINO v1 hi-res, causal T=77 and
   the float32 instance as extra rows; K7: the teacher's (96*769, 1024)
   bf16 rows), and times kernel, plain version, a library yardstick the
   port never calls, and the card's bound; the attention limit is checked
   against a planted fault (the last key dropped), and the wgmma
   descriptors of attention v3 against a float32 product (self-test);
3. serve path: full-width requests (configs/DistilBlender.yaml:
   MinkUNet14D, 768-d out, 8192 voxels, (4, 4, 2) bricks; ViT-L/14@336px
   text tower in bf16; weights drawn from a seed) through
   ``GroundingPipeline.ground`` and ``ground_batch``, checking from the
   launch counters that K1 ran 16 times per student forward and K6 25
   times per text encode; one request on the card against the CPU; a
   profile of one ``ground`` and one ``ground_batch``;
4. pillar serve path (the volumetric engine): 8 bin-like scenes
   (``make_volumetric_coords``, 6000 voxels at 5 cm through a 32-voxel z
   range) at the same full width; site capacities and pillar_z0 fitted
   over all 8 with the pipeline's own rule; K2 against its plain version
   at the 16 k3 conv shapes of a real pillar forward (float32 and bf16,
   random scale, bias and relu, each level's shared row schedule, a
   random-occupancy case, and a planted fault: the dz = -1 and +1 taps
   swapped), both dtypes timed with the column gather + cuDNN ``conv1d``
   yardstick and a tensor-core bound, 3xTF32 for float32, the row
   schedules included; ``ground`` over the 8 scenes (K2 16
   times per forward, K6 25 per encode, nothing dropped); one request on
   the card against the CPU; the pillar engine against the brick engine
   on one scene with the same weights; a profile of one request;
5. ingest path: ``tools.preprocess_data.process_scene`` at bench.py's
   fusion shape (73 views at 480x640, 10 objects, ViT-L/14@336px teacher
   in bf16 at full width and depth, voxel 0.005, cloud capacity 131072),
   one warm scene and one timed, checking that K3 ran 24 times, K7 47 and
   K6 3 per 96-crop chunk (plus 25 for the text queries); one chunk
   forward with ``DROPCLIP_PACKED_ATTN=0`` (K4) and the teacher at a
   doubled input (K5); three reduced scenes on the card against the CPU,
   with planted faults that the limits must see; a profile of one scene,
   whose attention launches must all be v3's;
6. prints the ``kernels`` JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises and exits non-zero. Without a CUDA card the
script exits non-zero before printing any result. A JSON report with every
number goes to ``chiprun_out/chip_smoke_report.json``.
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 0
BATCH = 8
# Published H100 SXM peaks (NVIDIA data sheet, dense): float32 outside
# the tensor cores, bf16 and TF32 tensor cores, HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32 = 495e12  # TF32 tensor cores: K1's float32 runs 3xTF32 on them
PEAK_BYTES = 3.35e12
QUERY_SETS = [["the red mug", "a green bowl"], ["a blue bottle", "the box"],
              ["a yellow can", "the white plate"], ["a spoon", "the fork"],
              ["a black mug", "the red bowl"]]
BATCH_QUERIES = ["the green bottle", "a white box"]
# full-width ingest scene (bench.py's fusion shape): views at 480x640
INGEST_VIEWS = 73
INGEST_CAPACITY = 131072


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
    """Compile every kernel side by side: the CUDA sources (one nvcc each,
    started together) and the Triton kernels K6 and K7 (by a first
    launch). Returns ({name: build seconds}, {source: ptxas report})."""
    from dropclip_tpu_torch.kernels import (attention, brick_conv3,  # noqa
                                            pillar_conv3)
    from dropclip_tpu_torch.kernels.nvcc import LIBRARIES
    from dropclip_tpu_torch.ops.layernorm import add_layer_norm, layer_norm

    def nvcc(lib):
        t = time.time()
        lib.build()
        return time.time() - t

    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        futs = {name: pool.submit(nvcc, lib)
                for name, lib in LIBRARIES.items()}
        t = time.time()
        x = torch.randn(4, 768, device="cuda", dtype=torch.bfloat16)
        s, b = torch.ones(768, device="cuda"), torch.zeros(768, device="cuda")
        layer_norm(x, s, b)
        torch.cuda.synchronize()
        times = {"K6 (triton)": time.time() - t}
        t = time.time()
        add_layer_norm(x, x, s, b)
        torch.cuda.synchronize()
        times["K7 (triton)"] = time.time() - t
        for name, fut in futs.items():
            times[f"{name}.cu (nvcc)"] = fut.result()
    layer_norm.launches = add_layer_norm.launches = 0
    return times, {name: lib.build_log for name, lib in LIBRARIES.items()}


def ptxas_entries(log):
    """{entry function (mangled): [ptxas register and spill lines]} from
    an ``nvcc -Xptxas -v`` log."""
    entries, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = entries.setdefault(m.group(1), [])
        elif cur is not None and ("registers" in line or "spill" in line):
            cur.append(line.strip())
    return entries


def bf16_ulps(err, ref_max):
    """An error in bf16 ulps at the magnitude ``ref_max``."""
    return err / 2.0 ** (np.floor(np.log2(max(ref_max, 1e-30))) - 7)


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


def brick_pipeline(cfg, clouds, rgbs, clip_sim):
    """The brick-engine pipeline on the card with weights from SEED and
    brick capacities autotuned on the scenes, as a user would fit them."""
    from dropclip_tpu_torch.distill.engine import brick_shape_of
    from dropclip_tpu_torch.pipeline import GroundingPipeline
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    probe = GroundingPipeline(cfg, device="cuda", seed=SEED)
    vox = [probe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    del probe
    caps = autotune_brick_capacities(np.stack([v.coords for v in vox]),
                                     np.stack([v.mask for v in vox]),
                                     brick_shape=brick_shape_of(cfg))
    print(f"scenes: {[int(v.mask.sum()) for v in vox]} voxels; brick "
          f"capacities {caps}", flush=True)
    return GroundingPipeline(cfg, clip_sim=clip_sim, brick_capacities=caps,
                             device="cuda", seed=SEED)


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


def k1_cases(pipe, clouds, rgbs):
    """The 16 main-path k3 convs on the folded batch-8 topology of the
    tabletop scenes: [(i, level, C, Cout, BrickLevel, occupied pairs,
    schedule)], where the pairs are the (occupied output voxel, occupied
    input voxel) pairs one tap apart, the work this data needs, and the
    schedule is the level's ``row_order`` as the student shares it (None
    for a checkout without one)."""
    from dropclip_tpu_torch.distill.engine import build_topology
    from dropclip_tpu_torch.kernels import brick_conv3 as k1
    from dropclip_tpu_torch.sparse.bricks import fold_topology, halo_exchange

    voxes = [pipe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    coords = torch.as_tensor(np.stack([v.coords for v in voxes]),
                             device="cuda")
    mask = torch.as_tensor(np.stack([v.mask for v in voxes]), device="cuda")
    topo = fold_topology(build_topology(pipe.cfg, coords, mask))
    row_order = getattr(k1, "row_order", None)
    scheds = {}
    cases = []
    for i, (lvl, c, cout) in enumerate(main_path_shapes(pipe.model)):
        lv = topo.levels[lvl]
        occf = lv.occ[..., None].float()
        halo = halo_exchange(occf, lv.nbr, 1)
        taps = (halo.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)
                .sum((-1, -2, -3))[..., 0])
        if lvl not in scheds:
            scheds[lvl] = row_order and row_order(lv.occ, lv.nbr)
        cases.append((i, lvl, c, cout, lv,
                      float((taps * occf[..., 0]).sum()), scheds[lvl]))
    return cases


def k1_schedule_ms(cases):
    """Device time of one forward's K1 row schedules: ``row_order`` once
    per distinct level, as the student computes them."""
    from dropclip_tpu_torch.kernels import brick_conv3 as k1

    if not hasattr(k1, "row_order"):
        return 0.0
    levels = {lvl: lv for _, lvl, _, _, lv, _, _ in cases}
    return sum(cuda_ms(lambda: k1.row_order(lv.occ, lv.nbr), 10)
               for lv in levels.values())


def k1_call(conv, x, lv, w, sched):
    """One K1 call with the level's shared schedule, where there is one."""
    if sched is None:
        return conv(x, lv.nbr, w, lv.occ)
    return conv(x, lv.nbr, w, lv.occ, sched)


def k1_inputs(lv, c, cout, dtype, gen):
    """Seeded features (zero on empty voxels, as the student gives them)
    and He-scaled weights for one K1 call."""
    occf = lv.occ[..., None].float()
    x = (torch.randn(tuple(lv.occ.shape) + (c,), generator=gen,
                     device="cuda") * occf).to(dtype)
    w = (torch.randn((27, c, cout), generator=gen, device="cuda")
         * (2.0 / (27 * cout)) ** 0.5).to(dtype)
    return x, w


def k1_close(got, ref, dtype):
    """K1's limits: float32 rtol 1e-4 plus atol 1e-4 * max|ref| (the
    summation order of 27*C terms; TF32 off in the plain version), bf16
    1e-2 * max|ref| (one bf16 rounding of the output). Returns (ok, max
    abs err, max|ref|)."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        ok = torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        ok = err <= 1e-2 * scale
    return ok and scale > 0, err, scale


def k1_bound(flops, nbytes, dtype):
    """The least time (ms) of one K1 call and what bounds it: float32 at
    three TF32 tensor-core products per product (3xTF32), bf16 at the bf16
    tensor-core rate; the bytes each input read once, the output written
    once."""
    t_ops = (3 * flops / PEAK_TF32 if dtype == torch.float32
             else flops / PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def k1_phase(pipe, clouds, rgbs, report):
    """K1 against its plain version at the 16 main-path shapes, batch 8,
    in float32 (the serve dtype) and bf16 (bench.py's infer and train
    dtype), each timed beside the plain version and halo gather + cuDNN
    ``conv3d`` in the same dtype."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.kernels.brick_conv3 import (brick_conv3,
                                                        brick_conv3_plain)
    from dropclip_tpu_torch.sparse.bricks import halo_exchange

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = {dt: dict.fromkeys(keys, 0.0) for dt in ("f32", "bf16")}
    max_err = {"f32": 0.0, "bf16": 0.0}
    cases = k1_cases(pipe, clouds, rgbs)
    for i, lvl, c, cout, lv, pairs, sched in cases:
        bm, bx, by, bz = lv.occ.shape
        row = dict(shape=i, level=lvl, bm=bm, c=c, cout=cout,
                   flops_needed=2.0 * pairs * c * cout,
                   flops_padded=2.0 * bm * bx * by * bz * 27 * c * cout)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x, w = k1_inputs(lv, c, cout, dtype, gen)
            got = k1_call(brick_conv3, x, lv, w, sched)
            ref = brick_conv3_plain(x, lv.nbr, w, lv.occ)
            torch.cuda.synchronize()
            ok, err, scale = k1_close(got, ref, dtype)
            check(ok, f"K1 {dtype} shape {i} (L{lvl} {c}->{cout}, Bm "
                  f"{bm}): max err {err} vs max|ref| {scale}")
            max_err[tag] = max(max_err[tag], err)
            es = x.element_size()
            nbytes = (x.numel() * es + w.numel() * es + lv.nbr.numel() * 4
                      + lv.occ.numel() + bm * bx * by * bz * cout * es)
            bound, by_what = k1_bound(row["flops_needed"], nbytes, dtype)
            w5 = w.permute(2, 1, 0).reshape(cout, c, 3, 3, 3).contiguous()

            def library():
                h = halo_exchange(x, lv.nbr, 1).permute(0, 4, 1, 2, 3)
                return F.conv3d(h, w5).permute(0, 2, 3, 4, 1) * \
                    lv.occ[..., None]

            lib_ok, lib_err, _ = k1_close(library(), ref, dtype)
            row[tag] = dict(
                max_abs_err=err, rel_err=err / scale, library_ok=lib_ok,
                library_max_abs_err=lib_err,
                ms=cuda_ms(lambda: k1_call(brick_conv3, x, lv, w, sched),
                           5),
                plain_ms=cuda_ms(lambda: brick_conv3_plain(
                    x, lv.nbr, w, lv.occ), 2, warmup=1),
                library_ms=cuda_ms(library, 3, warmup=1), bound_ms=bound,
                bound_by=by_what, bytes=nbytes)
            if dtype == torch.float32:
                # the CUDA cores' float32 rate, for reference
                row[tag]["bound_f32_cores_ms"] = max(
                    row["flops_needed"] / PEAK_FLOPS[dtype],
                    nbytes / PEAK_BYTES) * 1e3
            for k in keys:
                tot[tag][k] += row[tag][k]
            del x, w, got, ref
        rows.append(row)
        f, b = row["f32"], row["bf16"]
        print(f"K1 L{lvl} {c:4d}->{cout:4d} Bm={bm:5d}: f32 err "
              f"{f['max_abs_err']:.3e} (rel {f['rel_err']:.3e}) kernel "
              f"{f['ms']:.4f} plain {f['plain_ms']:.4f} cudnn "
              f"{f['library_ms']:.4f} bound {f['bound_ms']:.4f} ms "
              f"({f['bound_by']}) | bf16 rel {b['rel_err']:.3e} kernel "
              f"{b['ms']:.4f} plain {b['plain_ms']:.4f} cudnn "
              f"{b['library_ms']:.4f} bound {b['bound_ms']:.4f} ms",
              flush=True)
    # the row schedules (once per level) are part of every forward's K1
    sched_ms = k1_schedule_ms(cases)
    for tag in ("f32", "bf16"):
        tot[tag]["kernel_only_ms"] = tot[tag]["ms"]
        tot[tag]["ms"] += sched_ms
    report["k1_shapes"] = rows
    report["k1_per_forward"] = dict(tot, schedule_ms=sched_ms)
    for tag in ("f32", "bf16"):
        t = tot[tag]
        print(f"K1 per forward (16 convs, batch {BATCH}, {tag}): "
              f"{t['ms']} ms ({t['kernel_only_ms']} in the 16 calls, "
              f"{sched_ms} in 5 row schedules), plain {t['plain_ms']} ms, "
              f"cudnn {t['library_ms']} ms, bound {t['bound_ms']} ms",
              flush=True)
    # what bounds the forward: the limit that bounds the most bound time
    by = {}
    for row in rows:
        f = row["f32"]
        by[f["bound_by"]] = by.get(f["bound_by"], 0.0) + f["bound_ms"]
    f32 = dict(max_abs_err=max_err["f32"], bound_by=max(by, key=by.get),
               **tot["f32"])
    f32.update({f"bf16_{k}": v for k, v in tot["bf16"].items()})
    f32["bf16_max_abs_err"] = max_err["bf16"]
    return f32


def k6_phase(report):
    """K6 against its plain version at every shape its paths give it: the
    text tower's (Q*77, 768) rows (serve and ingest queries) and the ViT-L
    teacher's (96*769, 1024) rows (ln_pre, block 0's ln_1) and (96, 1024)
    class tokens (ln_post). bf16: within one bf16 ulp of the plain result;
    at the teacher's 75M values the ulp is floored at 2^-10, as for K7,
    where float32 reduction order can flip a value that cancels below
    2^-13. float32: rtol 1e-5, atol 1e-5."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops.layernorm import layer_norm, layer_norm_plain

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    cases = [(4 * 77, 768, torch.bfloat16, 1e-30),
             (4 * 77, 768, torch.float32, None),
             (77, 768, torch.bfloat16, 1e-30), (77, 768, torch.float32, None),
             (96 * 769, 1024, torch.bfloat16, 2.0 ** -10),
             (96, 1024, torch.bfloat16, 1e-30)]
    rows, main = [], None
    for n, c, dtype, floor in cases:
        x = (torch.randn((n, c), generator=gen, device="cuda") * 3
             ).to(dtype)
        s = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        got = layer_norm(x, s, b).float()
        ref = layer_norm_plain(x, s, b).float()
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if dtype == torch.bfloat16:
            ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(
                floor))) - 7)
            ok = bool(((got - ref).abs() <= ulp).all())
        else:
            ok = torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
        check(ok, f"K6 {dtype} ({n}, {c}): max err {err}")
        del got, ref
        es = x.element_size()
        nbytes = 2 * x.numel() * es + 2 * c * 4
        flops = 9.0 * x.numel()
        bound = max(flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES) * 1e3
        reps = 20 if n > 10000 else 200
        row = dict(rows=n, c=c, dtype=str(dtype), max_abs_err=err,
                   ms=cuda_ms(lambda: layer_norm(x, s, b), reps),
                   plain_ms=cuda_ms(lambda: layer_norm_plain(x, s, b), reps),
                   library_ms=cuda_ms(lambda: F.layer_norm(
                       x, (c,), s.to(dtype), b.to(dtype), 1e-5), reps),
                   bound_ms=bound, bound_by="bytes")
        rows.append(row)
        print(f"K6 ({n}, {c}) {dtype}: err {err:.3e} | kernel "
              f"{row['ms']:.5f} ms plain {row['plain_ms']:.5f} ms "
              f"F.layer_norm {row['library_ms']:.5f} ms bound "
              f"{bound:.6f} ms", flush=True)
        if n == 4 * 77 and dtype == torch.bfloat16:
            main = row
        del x
    report["k6_shapes"] = rows
    layer_norm.launches = 0
    out = {k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                "bound_by")}
    # the largest error over every bf16 shape of the serve and ingest paths
    out["max_abs_err"] = max(r["max_abs_err"] for r in rows
                             if r["dtype"] == str(torch.bfloat16))
    return out


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


def profile_phase(cases, tags, report, trace=None):
    """Each ``(name, fn)`` of ``cases`` under torch.profiler: the device's
    busy share of the wall time and the kernels that fill it, and for each
    ``(tag, kernel name)`` of ``tags`` the launches and device time. The
    trace of case ``trace`` goes to chiprun_out/trace_<trace>.json."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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
        for tag, key in tags:
            mine = [e for e in kernels if key in e.key]
            n = sum(e.count for e in mine)
            dev = sum(e.self_device_time_total for e in mine) / 1e3
            report["profile"][name][tag] = dict(launches=n, device_ms=dev)
            print(f"  {tag}: {n} launches, {dev} ms on the device, "
                  f"{dev / max(n, 1)} ms each", flush=True)
        if name == trace:
            prof.export_chrome_trace(os.path.join(
                ROOT, "chiprun_out", f"trace_{name}.json"))


def make_volumetric_clouds(n_scenes, n_occ=6000):
    """Bin and shelf clouds: ``n_occ`` voxels of solid boxes through a
    32-voxel z range at 5 cm (``make_volumetric_coords(rng, n_scenes,
    8192, n_occ, ext=20, zext=32)``), one jittered point per voxel plus a
    second for half of them; the pipeline's voxelization keeps about 86%
    of the voxels."""
    from dropclip_tpu_torch.data.synthetic import make_volumetric_coords

    rng = np.random.RandomState(SEED + 5)
    coords, mask = make_volumetric_coords(rng, n_scenes, 8192, n_occ=n_occ,
                                          ext=20, zext=32)
    clouds, rgbs = [], []
    for b in range(n_scenes):
        c = coords[b][mask[b]].astype(np.float32)
        pts = np.concatenate([c, c[: len(c) // 2]])
        xyz = (pts + rng.rand(*pts.shape).astype(np.float32)) * 0.05
        clouds.append(xyz.astype(np.float32))
        rgbs.append(rng.rand(len(xyz), 3).astype(np.float32))
    return clouds, rgbs


def pillar_pipeline(cfg, clouds, rgbs, clip_sim):
    """The pillar-engine pipeline on the card (the config with
    sparse_backend pillars) with weights from SEED, pillar_z0 and site
    capacities fitted over all the scenes with the pipeline's own rule."""
    from dropclip_tpu_torch.pipeline import (GroundingPipeline,
                                             fit_pillar_shapes)
    from dropclip_tpu_torch.sparse.pillar_topology import \
        build_pillar_topology

    pcfg = type(cfg)(dict(cfg, sparse_backend="pillars"))
    ppipe = GroundingPipeline(pcfg, clip_sim=clip_sim, device="cuda",
                              seed=SEED)
    vox = [ppipe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    ppipe.pillar_z0, ppipe.pillar_caps = fit_pillar_shapes([
        build_pillar_topology(v.coords, v.mask, device="cpu") for v in vox])
    print(f"volumetric scenes: {[int(v.mask.sum()) for v in vox]} voxels; "
          f"pillar_z0 {ppipe.pillar_z0}, site capacities "
          f"{ppipe.pillar_caps} (fitted over all {len(vox)})", flush=True)
    return pcfg, ppipe


def k2_cases(ppipe, clouds, rgbs):
    """The 16 k3 convs of a pillar forward on volumetric scene 0:
    [(i, level, C, Cout, PillarLevel, occupied pairs, schedule)], where the
    pairs are the (occupied output slot, occupied source slot) pairs one tap
    apart, the work this data needs, and the schedule is the level's
    ``row_order`` as the student shares it (None for a checkout without
    one)."""
    from dropclip_tpu_torch.kernels import pillar_conv3 as k2
    from dropclip_tpu_torch.sparse.pillar_ops import gather_rows, z_shift
    from dropclip_tpu_torch.sparse.pillar_topology import \
        build_pillar_topology

    vox = ppipe._host_voxelize(clouds[0], rgbs[0])[0]
    topo = build_pillar_topology(vox.coords, vox.mask, z0=ppipe.pillar_z0,
                                 site_capacities=ppipe.pillar_caps,
                                 device="cuda")
    row_order = getattr(k2, "row_order", None)
    scheds, cases = {}, []
    for i, (lvl, c, cout) in enumerate(main_path_shapes(ppipe.model)):
        lv = topo.levels[lvl]
        occf = lv.occ.float()
        src = gather_rows(occf, lv.nbr9)  # (P, 9, Z)
        taps = sum(z_shift(src, dz, axis=-1) for dz in (-1, 0, 1)).sum(1)
        if lvl not in scheds:
            scheds[lvl] = row_order and row_order(lv.occ)
        cases.append((i, lvl, c, cout, lv, float((taps * occf).sum()),
                      scheds[lvl]))
    return cases


def k2_schedule_ms(cases):
    """Device time of one forward's K2 row schedules: ``row_order`` once
    per distinct level, as the student computes them."""
    from dropclip_tpu_torch.kernels import pillar_conv3 as k2

    if not hasattr(k2, "row_order"):
        return 0.0
    levels = {lvl: lv for _, lvl, _, _, lv, _, _ in cases}
    return sum(cuda_ms(lambda: k2.row_order(lv.occ), 10)
               for lv in levels.values())


def k2_inputs(lv, c, cout, dtype, gen):
    """Seeded features (zero on empty slots, as the student gives them),
    He-scaled weights, and a random scale and bias for one K2 call:
    (feats, nbr, weights, occ, scale, bias)."""
    p, z = lv.occ.shape
    x = (torch.randn((p, z, c), generator=gen, device="cuda")
         * lv.occ[..., None]).to(dtype)
    w = (torch.randn((9, 3, c, cout), generator=gen, device="cuda")
         * (2.0 / (27 * cout)) ** 0.5).to(dtype)
    sc = 0.5 + torch.rand(cout, generator=gen, device="cuda")
    bi = 0.1 * torch.randn(cout, generator=gen, device="cuda")
    return (x, lv.nbr9, w, lv.occ, sc, bi)


def k2_call(conv, args, relu, sched):
    """One K2 call with the level's shared schedule, where there is one."""
    if sched is None:
        return conv(*args, relu=relu)
    return conv(*args, relu=relu, schedule=sched)


def k2_limits(got, ref, dtype):
    """(within the limit, max |err|, max |ref|): float32 (TF32 off) rtol
    1e-4 plus atol 1e-4 * max|ref| (the summation order of 27*C terms);
    bf16 with float32 accumulation 1e-2 of max|ref| (one bf16 rounding of
    the output), as for K1."""
    got, ref = got.float(), ref.float()
    scale = float(ref.abs().max())
    err = float((got - ref).abs().max())
    if dtype == torch.float32:
        ok = torch.allclose(got, ref, rtol=1e-4, atol=1e-4 * scale)
    else:
        ok = err <= 1e-2 * scale
    return bool(ok) and scale > 0, err, scale


def k2_phase(ppipe, clouds, rgbs, report):
    """K2 against its plain version at the 16 k3 conv shapes of a pillar
    forward on volumetric scene 0, float32 and bf16, with random scale,
    bias and relu and the level's shared schedule; per shape also a random
    occupancy (float32, no schedule) and the planted fault (dz = -1 and +1
    taps swapped), which must fail the limit the kernel passes. Times, in
    both dtypes: kernel, plain version, and the yardstick the port never
    calls: the column gather (P, 9*C, Z) and one cuDNN ``conv1d`` (kernel
    3, padding 1, TF32 off) with the same epilogue; the bound by
    ``k1_bound``'s rule (float32 at 3xTF32). The per-forward sums include
    the 5 row schedules."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.kernels.pillar_conv3 import (pillar_conv3,
                                                         pillar_conv3_plain)
    from dropclip_tpu_torch.sparse.pillar_ops import gather_rows

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    keys = ("ms", "plain_ms", "bound_ms", "library_ms")
    tot = {dt: dict.fromkeys(keys, 0.0) for dt in ("f32", "bf16")}
    max_err = {"f32": 0.0, "bf16": 0.0}
    rows, worst_fault = [], float("inf")
    cases = k2_cases(ppipe, clouds, rgbs)
    for i, lvl, c, cout, lv, pairs, sched in cases:
        p, z = lv.occ.shape
        relu = i % 2 == 0
        row = dict(shape=i, level=lvl, p=p, z=z, c=c, cout=cout, relu=relu,
                   occupied=int(lv.occ.sum()), pairs=pairs,
                   flops_needed=2.0 * pairs * c * cout,
                   flops_rows=2.0 * int(lv.occ.sum()) * 27 * c * cout,
                   flops_padded=2.0 * p * z * 27 * c * cout)
        for dtype, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            args = k2_inputs(lv, c, cout, dtype, gen)
            x, _, w, _, sc, bi = args
            ref = pillar_conv3_plain(*args, relu=relu)
            ok, err, scale = k2_limits(k2_call(pillar_conv3, args, relu,
                                               sched), ref, dtype)
            check(ok, f"K2 {dtype} shape {i} (L{lvl} {c}->{cout}, P {p}, Z "
                  f"{z}): max err {err} vs max|ref| {scale}")
            swapped = (x, lv.nbr9, w.flip(1).contiguous(), lv.occ, sc, bi)
            f_ok, f_err, _ = k2_limits(k2_call(pillar_conv3, swapped, relu,
                                               sched), ref, dtype)
            check(not f_ok, f"K2 {dtype} shape {i}: the limit does not see "
                  f"swapped z taps (err {f_err})")
            worst_fault = min(worst_fault, f_err / scale)
            max_err[tag] = max(max_err[tag], err)
            es = x.element_size()
            nbytes = ((x.numel() + w.numel() + p * z * cout) * es
                      + lv.nbr9.numel() * 4 + lv.occ.numel() + 2 * cout * 4)
            bound, by_what = k1_bound(row["flops_needed"], nbytes, dtype)
            w1 = w.permute(3, 0, 2, 1).reshape(cout, 9 * c, 3).contiguous()

            def library():
                cols = gather_rows(x, lv.nbr9).permute(0, 1, 3, 2)
                y = F.conv1d(cols.reshape(p, 9 * c, z), w1, padding=1)
                y = y.transpose(1, 2) * sc + bi
                return ((torch.relu(y) if relu else y)
                        * lv.occ[..., None]).to(dtype)

            lib_ok, lib_err, _ = k2_limits(library(), ref, dtype)
            check(lib_ok, f"K2 yardstick {dtype} shape {i} disagrees "
                  f"({lib_err})")
            row[tag] = dict(
                max_abs_err=err, rel_err=err / scale,
                fault_rel_err=f_err / scale,
                ms=cuda_ms(lambda: k2_call(pillar_conv3, args, relu, sched),
                           5),
                plain_ms=cuda_ms(lambda: pillar_conv3_plain(*args,
                                                            relu=relu),
                                 2, warmup=1),
                library_ms=cuda_ms(library, 3, warmup=1), bound_ms=bound,
                bound_by=by_what, bytes=nbytes)
            if dtype == torch.float32:
                rocc = torch.rand((p, z), generator=gen, device="cuda") < 0.5
                r_args = (x, lv.nbr9, w, rocc, sc, bi)
                r_ok, r_err, r_scale = k2_limits(
                    pillar_conv3(*r_args, relu=relu),
                    pillar_conv3_plain(*r_args, relu=relu), dtype)
                check(r_ok, f"K2 f32 shape {i} with random occupancy: max "
                      f"err {r_err} vs max|ref| {r_scale}")
                row[tag]["random_occ_max_abs_err"] = r_err
            for k in keys:
                tot[tag][k] += row[tag][k]
            del args, x, w, ref
        rows.append(row)
        f, b = row["f32"], row["bf16"]
        print(f"K2 L{lvl} P={p:4d} Z={z:3d} {c:4d}->{cout:4d} relu={relu:d}: "
              f"f32 err {f['max_abs_err']:.3e} (rel {f['rel_err']:.3e}) "
              f"kernel {f['ms']:.4f} plain {f['plain_ms']:.4f} gather+conv1d "
              f"{f['library_ms']:.4f} bound {f['bound_ms']:.4f} ms "
              f"({f['bound_by']}) | bf16 rel {b['rel_err']:.3e} kernel "
              f"{b['ms']:.4f} plain {b['plain_ms']:.4f} gather+conv1d "
              f"{b['library_ms']:.4f} bound {b['bound_ms']:.4f} ms; "
              f"swapped-dz fault rel {f['fault_rel_err']:.3e} / "
              f"{b['fault_rel_err']:.3e}", flush=True)
    # the row schedules (once per level) are part of every forward's K2
    sched_ms = k2_schedule_ms(cases)
    for tag in ("f32", "bf16"):
        tot[tag]["kernel_only_ms"] = tot[tag]["ms"]
        tot[tag]["ms"] += sched_ms
        t = tot[tag]
        print(f"K2 per pillar forward (16 convs, {tag}): {t['ms']} ms "
              f"({t['kernel_only_ms']} in the 16 calls, {sched_ms} in 5 row "
              f"schedules), plain {t['plain_ms']} ms, gather+conv1d "
              f"{t['library_ms']} ms, bound {t['bound_ms']} ms", flush=True)
    print(f"K2 smallest planted-fault error {worst_fault} of max|ref|",
          flush=True)
    report["k2_shapes"] = rows
    report["k2_per_forward"] = dict(tot, schedule_ms=sched_ms)
    by = {}
    for row in rows:
        f = row["f32"]
        by[f["bound_by"]] = by.get(f["bound_by"], 0.0) + f["bound_ms"]
    f32 = dict(max_abs_err=max_err["f32"], bound_by=max(by, key=by.get),
               **tot["f32"])
    f32.update({f"bf16_{k}": v for k, v in tot["bf16"].items()})
    f32["bf16_max_abs_err"] = max_err["bf16"]
    del cases
    torch.cuda.empty_cache()
    return f32


PILLAR_QUERIES = [["the metal bin", "a cardboard box"],
                  ["the top shelf", "a plastic tote"], ["a red crate", "the box"],
                  ["a bottle of soap", "the white bag"],
                  ["a blue bin", "the green crate"], ["a can", "the tote"],
                  ["a black box", "the red bottle"], ["a pouch", "the jar"]]


def pillar_serve_phase(ppipe, clouds, rgbs, report):
    """``ground`` on the pillar engine over the 8 volumetric scenes after a
    warm-up request, kernels counted; nothing may be dropped."""
    from dropclip_tpu_torch.kernels.pillar_conv3 import pillar_conv3
    from dropclip_tpu_torch.ops.layernorm import layer_norm
    from dropclip_tpu_torch.sparse.pillar_topology import \
        build_pillar_topology

    sim = ppipe.clip_sim
    t = time.time()
    ppipe.ground(clouds[0], rgbs[0], ["a warm-up query", "the bin"])
    print(f"pillar warm-up request: {(time.time() - t) * 1e3} ms",
          flush=True)
    # the host layer: topology build (numpy) and its copy to the card
    topo_ms = []
    for x, r in zip(clouds, rgbs):
        vox = ppipe._host_voxelize(x, r)[0]
        torch.cuda.synchronize()
        t = time.time()
        build_pillar_topology(vox.coords, vox.mask, z0=ppipe.pillar_z0,
                              site_capacities=ppipe.pillar_caps,
                              device="cuda")
        torch.cuda.synchronize()
        topo_ms.append((time.time() - t) * 1e3)
    print(f"pillar topology build + copy to the card: {topo_ms} ms",
          flush=True)
    pillar_conv3.launches = 0
    layer_norm.launches = 0
    fwd0, enc0 = ppipe.forwards, sim.encodes
    req_ms, dropped = [], []
    for i, (x, r) in enumerate(zip(clouds, rgbs)):
        torch.cuda.synchronize()
        t = time.time()
        masks, sims = ppipe.ground(x, r, PILLAR_QUERIES[i])
        req_ms.append((time.time() - t) * 1e3)
        dropped.append(ppipe.last_dropped)
        valid = ppipe._host_voxelize(x, r)[0].mask
        check(masks.shape == (2, len(x)) and masks.dtype == bool,
              f"pillar ground masks shape {masks.shape}")
        check(sims.shape == (2, ppipe.capacity) and np.isfinite(sims).all()
              and sims[:, valid].min() >= 0
              and sims[:, valid].max() <= 1 + 1e-6,
              "pillar ground sims not finite in [0, 1] on the valid voxels")
        check(0 < masks.mean() < 1, "degenerate pillar grounding mask")
        print(f"pillar ground request {i}: {req_ms[-1]} ms, {valid.sum()} "
              f"voxels, last_dropped {ppipe.last_dropped}, mask fraction "
              f"{masks.mean(1)}", flush=True)
    fwds, encs = ppipe.forwards - fwd0, sim.encodes - enc0
    k2_n, k6_n = pillar_conv3.launches, layer_norm.launches
    print(f"pillar launches: K2 {k2_n} over {fwds} student forwards, K6 "
          f"{k6_n} over {encs} text encodes; per request "
          f"{np.mean(req_ms)} ms mean, {np.median(req_ms)} ms median",
          flush=True)
    check(all(d == 0 for d in dropped), f"pillar sites dropped: {dropped}")
    check(fwds == len(clouds) and k2_n == 16 * fwds,
          f"K2 ran {k2_n} times over {fwds} forwards (want 16 each)")
    check(encs >= 1 and k6_n == 25 * encs,
          f"K6 ran {k6_n} times over {encs} encodes (want 25 each)")
    report["pillar_serve"] = dict(
        request_ms=req_ms, topology_ms=topo_ms, forwards=fwds,
        encodes=encs, k2_launches=k2_n,
        k6_launches=k6_n, last_dropped=dropped,
        z0=ppipe.pillar_z0, site_capacities=ppipe.pillar_caps)
    return k2_n, k6_n


def pillar_cpu_phase(pcfg, ppipe, clouds, rgbs, report):
    """One pillar request on the card and on the CPU (plain versions),
    same seeded weights and static shapes, with the brick check's
    limits."""
    from dropclip_tpu_torch.pipeline import GroundingPipeline, make_clip_sim

    cpu = GroundingPipeline(pcfg, clip_sim=make_clip_sim(pcfg, "cpu", SEED),
                            device="cpu", seed=SEED,
                            pillar_site_capacities=ppipe.pillar_caps,
                            pillar_z0=ppipe.pillar_z0)
    x, r, q = clouds[5], rgbs[5], PILLAR_QUERIES[0]
    f_gpu = ppipe.featurize(x, r)[0].cpu()
    t = time.time()
    f_cpu = cpu.featurize(x, r)[0]
    cpu_ms = (time.time() - t) * 1e3
    feat_rel = float((f_gpu - f_cpu).abs().max() / f_cpu.abs().max())
    m_gpu, s_gpu = ppipe.ground(x, r, q)
    m_cpu, s_cpu = cpu.ground(x, r, q)
    dsims = float(np.abs(s_gpu - s_cpu).max())
    agree = float((m_gpu == m_cpu).mean())
    print(f"pillar card vs CPU: student features max rel diff {feat_rel} "
          f"(CPU forward {cpu_ms} ms), sims max |d| {dsims}, mask "
          f"agreement {agree}", flush=True)
    report["pillar_card_vs_cpu"] = dict(feat_max_rel=feat_rel,
                                        sims_max_abs=dsims,
                                        mask_agreement=agree, cpu_ms=cpu_ms)
    check(feat_rel <= 1e-4, f"pillar student features differ by {feat_rel}")
    check(dsims <= 0.05 and agree >= 0.99,
          f"pillar grounding differs: |dsims| {dsims}, agreement {agree}")


def pillar_vs_brick_phase(cfg, ppipe, clouds, rgbs, report):
    """The pillar engine against the port's brick engine on volumetric
    scene 2, same seeded weights, on the card; brick capacities autotuned
    on that scene so neither engine drops a voxel."""
    from dropclip_tpu_torch.distill.engine import brick_shape_of
    from dropclip_tpu_torch.pipeline import GroundingPipeline
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    x, r, q = clouds[2], rgbs[2], PILLAR_QUERIES[2]
    bcfg = type(cfg)(dict(cfg))
    vox = ppipe._host_voxelize(x, r)[0]
    caps = autotune_brick_capacities(vox.coords[None], vox.mask[None],
                                     brick_shape=brick_shape_of(bcfg))
    bpipe = GroundingPipeline(bcfg, clip_sim=ppipe.clip_sim,
                              brick_capacities=caps, device="cuda",
                              seed=SEED)
    sb, sp = bpipe.model.state_dict(), ppipe.model.state_dict()
    check(all(torch.equal(sb[k], sp[k]) for k in sb),
          "the engines drew different weights from one seed")
    f_b = bpipe.featurize(x, r)[0]
    check(bpipe.last_dropped == 0, f"brick engine dropped "
          f"{bpipe.last_dropped} voxels")
    f_p = ppipe.featurize(x, r)[0]
    check(ppipe.last_dropped == 0, "pillar engine dropped sites")
    feat_rel = float((f_p - f_b).abs().max() / f_b.abs().max())
    m_b, s_b = bpipe.ground(x, r, q)
    m_p, s_p = ppipe.ground(x, r, q)
    dsims = float(np.abs(s_p - s_b).max())
    agree = float((m_p == m_b).mean())
    print(f"pillar vs brick engine (scene 2, {int(vox.mask.sum())} voxels, "
          f"brick capacities {caps}): features max rel diff {feat_rel}, "
          f"sims max |d| {dsims}, mask agreement {agree}", flush=True)
    report["pillar_vs_brick"] = dict(feat_max_rel=feat_rel,
                                     sims_max_abs=dsims,
                                     mask_agreement=agree,
                                     brick_capacities=list(caps))
    check(feat_rel <= 1e-4 and dsims <= 0.05 and agree >= 0.99,
          f"pillar and brick engines disagree: features {feat_rel}, "
          f"|dsims| {dsims}, agreement {agree}")


ATTN_ULPS = 1  # bf16 limit, in ulps of max|ref|
# the designs of the attention kernel's instances (csrc/attention.cu)
ATTN_DESIGNS = {"v3": "v3 wgmma, stage C(i) and the softmax cut: S = Q.K^T "
                      "(SS) and O += P.V (RS) on wgmma.m64n64k16, n16 last "
                      "key tile, one fma into ex2.approx.ftz per "
                      "probability, cp.async double buffer",
                "f32": "float32 instance on the CUDA cores"}


def dropped_key_control(q, k, v, causal):
    """A planted fault for the limits: masked softmax attention (the plain
    K5 order) with the last key left out, as an off-by-one in the key mask
    would do. Rows are (B, T, H, D)."""
    t, d = q.shape[1], q.shape[-1]
    qf, kf, vf = (x.permute(0, 2, 1, 3).float()
                  for x in (q, k[:, :-1], v[:, :-1]))
    s = qf @ kf.transpose(-1, -2) * d ** -0.5
    if causal:
        keep = torch.ones(t, t - 1, dtype=torch.bool, device=q.device).tril()
        s.masked_fill_(~keep, torch.finfo(torch.float32).min)
    p = torch.softmax(s, dim=-1).to(q.dtype).float()
    return (p @ vf).to(q.dtype).permute(0, 2, 1, 3)


def attention_phase(report):
    """K3, K4 and K5 against their plain versions at the shapes the ingest
    path gives them: K3 and K4 at the ViT-L teacher's (96, 769, 16, 64),
    K5 at the hi-res patch extract's (8, 3073, 16, 64), all bf16; extra
    rows: K5 at DINO v1 hi-res (T=3026, 6 heads) and causal at T=77, and
    the float32 instance at (8, 769, 16, 64). Each bf16 case runs on three
    seeds and must stay within ATTN_ULPS bf16 ulp of max|ref|: the two
    float32 results may round to neighbouring bf16 values, because online
    softmax rounds the unnormalised probabilities against a running
    maximum. The same case with the last key left out (``dropped_key_
    control``) must lie above that limit, so that the limit sees an
    off-by-one in the key mask. float32: rtol 1e-4, atol 1e-5 * max|ref|.
    ``F.scaled_dot_product_attention`` is timed as the library yardstick
    only."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.kernels.attention import instance, wgmma_selftest
    from dropclip_tpu_torch.ops import attention as att

    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    a, b = (torch.randn((64, 64), generator=gen, device="cuda").bfloat16()
            for _ in range(2))
    ref = a.float() @ b.float().T
    for mode, bm in ((0, b), (1, b.T.contiguous())):
        err = float((wgmma_selftest(a, bm, mode) - ref).abs().max())
        print(f"wgmma descriptor self-test, mode {mode}: max err {err} "
              f"(max|ref| {float(ref.abs().max())})", flush=True)
        check(err <= 1e-5 * float(ref.abs().max()),
              f"wgmma descriptor self-test, mode {mode}: {err}")

    cases = [("K3", 96, 769, 16, False, torch.bfloat16),
             ("K4", 96, 769, 16, False, torch.bfloat16),
             ("K5", 8, 3073, 16, False, torch.bfloat16),
             ("K5 DINO", 1, 3026, 6, False, torch.bfloat16),
             ("K5 causal", 32, 77, 12, True, torch.bfloat16),
             ("K3 f32", 8, 769, 16, False, torch.float32)]
    out = {}
    for tag, b, t, h, causal, dtype in cases:
        errs = []
        for seed in range(3 if dtype == torch.bfloat16 else 1):
            gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + seed)
            q, k, v = (torch.randn((b, t, h, 64), generator=gen,
                                   device="cuda").to(dtype) for _ in range(3))
            if tag.startswith("K3"):
                args = [x.reshape(b, t, h * 64) for x in (q, k, v)]
                kern = lambda: att.oneshot_attention_packed(*args, h)
                plain = lambda: att.oneshot_attention_packed_plain(*args, h)
            elif tag == "K4":
                kern = lambda: att.oneshot_attention(q, k, v)
                plain = lambda: att.oneshot_attention_plain(q, k, v)
            else:
                kern = lambda: att.flash_attention_padded(q, k, v, causal)
                plain = lambda: att.flash_attention_plain(q, k, v, causal)
            got, ref = kern().float(), plain().float()
            torch.cuda.synchronize()
            ref_max = float(ref.abs().max())
            err = float((got - ref).abs().max())
            check(bool(torch.isfinite(got).all()), f"{tag}: not finite")
            if dtype == torch.float32:
                ok = torch.allclose(got, ref.reshape(got.shape), rtol=1e-4,
                                    atol=1e-5 * ref_max)
                check(ok, f"{tag} (B={b}, T={t}, H={h}): max err {err} vs "
                      f"max|ref| {ref_max}")
            errs.append(dict(seed=SEED + 2 + seed, max_abs_err=err,
                             ref_max=ref_max,
                             ulps=bf16_ulps(err, ref_max)))
            if seed == 0 and dtype == torch.bfloat16:
                ctrl = dropped_key_control(q, k, v, causal).float()
                ctrl_ulps = bf16_ulps(float((ctrl - ref.reshape(
                    ctrl.shape)).abs().max()), ref_max)
                del ctrl
            del got, ref
        worst = max(e["ulps"] for e in errs)
        if dtype == torch.bfloat16:
            print(f"{tag}: max err over seeds {[e['ulps'] for e in errs]} "
                  f"bf16 ulps; control (last key dropped) {ctrl_ulps:.2f} "
                  f"ulps", flush=True)
            check(worst <= ATTN_ULPS < ctrl_ulps,
                  f"{tag} (B={b}, T={t}, H={h}): {worst} bf16 ulps (limit "
                  f"{ATTN_ULPS}, control {ctrl_ulps})")
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                          is_causal=causal)
        # work the data needs: causal keeps t(t+1)/2 of the t^2 pairs
        pairs = t * (t + 1) / 2 if causal else t * t
        flops = 4.0 * b * h * pairs * 64
        nbytes = 4.0 * b * t * h * 64 * q.element_size()
        peak = PEAK_FLOPS[dtype]
        row = dict(b=b, t=t, h=h, d=64, causal=causal, dtype=str(dtype),
                   max_abs_err=max(e["max_abs_err"] for e in errs),
                   max_err_bf16_ulps=worst, seeds=errs,
                   ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 3),
                   library_ms=cuda_ms(library, 10),
                   bound_ms=max(flops / peak, nbytes / PEAK_BYTES) * 1e3,
                   bound_by="operations" if flops / peak > nbytes / PEAK_BYTES
                   else "bytes", gflop=flops / 1e9,
                   design=ATTN_DESIGNS[instance(dtype, 64)])
        if dtype == torch.bfloat16:
            row["control_bf16_ulps"] = ctrl_ulps
        row["tflops"] = flops / row["ms"] / 1e9
        out[tag] = row
        print(f"{tag} (B={b}, T={t}, H={h}, D=64{', causal' if causal else ''}"
              f", {dtype}): err {row['max_abs_err']:.3e} ({worst:.2f} bf16 "
              f"ulps) | kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
              f"TFLOP/s) plain {row['plain_ms']:.4f} ms sdpa "
              f"{row['library_ms']:.4f} ms bound {row['bound_ms']:.4f} ms "
              f"({row['bound_by']})", flush=True)
        del q, k, v, qh, kh, vh
        torch.cuda.empty_cache()
    report["attention"] = out
    att.oneshot_attention_packed.launches = 0
    att.oneshot_attention.launches = 0
    att.flash_attention_padded.launches = 0
    keys = ("max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "design", "tflops")
    return {tag: {k: out[tag][k] for k in keys} for tag in ("K3", "K4", "K5")}


def k7_phase(report):
    """K7 against its plain version at the teacher's (96*769, 1024) bf16
    rows: the sum bit-equal, y within one bf16 ulp (floored at 2^-10,
    where float32 reduction order can flip a cancelled value). The library
    yardstick is an add plus ``F.layer_norm``."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops.layernorm import (add_layer_norm,
                                                  add_layer_norm_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rows, c = 96 * 769, 1024
    r = (torch.randn((rows, c), generator=gen, device="cuda") * 3).bfloat16()
    d = torch.randn((rows, c), generator=gen, device="cuda").bfloat16()
    s = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
    b = 0.1 * torch.randn(c, generator=gen, device="cuda")
    got_s, got_y = add_layer_norm(r, d, s, b)
    ref_s, ref_y = add_layer_norm_plain(r, d, s, b)
    torch.cuda.synchronize()
    ref = ref_y.float()
    err = float((got_y.float() - ref).abs().max())
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -10)))
                  - 7)
    check(torch.equal(got_s, ref_s)
          and bool(((got_y.float() - ref).abs() <= ulp).all()),
          f"K7 ({rows}, {c}) bf16: max err {err}")
    sb, bb = s.bfloat16(), b.bfloat16()

    def library():
        x = r + d
        return x, F.layer_norm(x, (c,), sb, bb, 1e-5)

    nbytes = 4.0 * rows * c * 2 + 2 * c * 4
    flops = 10.0 * rows * c
    row = dict(rows=rows, c=c, max_abs_err=err,
               ms=cuda_ms(lambda: add_layer_norm(r, d, s, b), 20),
               plain_ms=cuda_ms(lambda: add_layer_norm_plain(r, d, s, b), 5),
               library_ms=cuda_ms(library, 20),
               bound_ms=max(flops / PEAK_FLOPS[torch.bfloat16],
                            nbytes / PEAK_BYTES) * 1e3, bound_by="bytes")
    row["gb_per_s"] = nbytes / row["ms"] / 1e6
    report["k7"] = row
    print(f"K7 ({rows}, {c}) bf16: err {err:.3e} | kernel {row['ms']:.4f} ms "
          f"({row['gb_per_s']:.0f} GB/s) plain {row['plain_ms']:.4f} ms "
          f"add+F.layer_norm {row['library_ms']:.4f} ms bound "
          f"{row['bound_ms']:.4f} ms", flush=True)
    add_layer_norm.launches = 0
    return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                "library_ms", "bound_ms", "bound_by")}


class NpzWriter:
    """``process_scene``'s ``write``: the scene dict as .npz under
    chiprun_out/ (the card's machine has no h5py); keeps the last one."""

    def __init__(self):
        self.last = None

    def __call__(self, out_path, objects_info, **arrays):
        os.makedirs(os.path.dirname(out_path), exist_ok=True)
        np.savez(out_path, **arrays)
        self.last = arrays


def present_pairs(segs, max_objects=32):
    """Present (view, object) pairs as the extractor counts them."""
    ids = np.arange(max_objects)
    return int(sum(np.isin(ids, np.setdiff1d(np.unique(s), [0])).sum()
                   for s in segs))


def make_ingest_scene(seed, n_views, hw, n_objects, n_points):
    """make_raw_scene at bench.py's fusion shape; MV-TOD intrinsics scaled
    to ``hw`` (reference data/blender.py:180-187 at 480x640)."""
    from dropclip_tpu_torch.data.synthetic import make_raw_scene

    raw = make_raw_scene(np.random.default_rng(seed), n_objects=n_objects,
                         n_points_per_obj=n_points, n_views=n_views, hw=hw)
    f = 444.44 * hw[1] / 640
    raw["K"] = np.array([[f, 0, hw[1] / 2 - 0.5], [0, f, hw[0] / 2 - 0.5],
                         [0, 0, 1]], np.float32)
    return raw


def ingest_scene(extractor, raw, tag, writer, capacity=INGEST_CAPACITY,
                 sync=True):
    from dropclip_tpu_torch.tools.preprocess_data import process_scene

    return process_scene(
        images=raw["images"], depths=raw["depths"], segs=raw["segs"],
        poses=raw["poses"], K=raw["K"], obj_info=raw["objects_info"],
        extractor=extractor,
        out_path=os.path.join(ROOT, "chiprun_out", "ingest", f"{tag}.npz"),
        voxel_size=0.005, cloud_capacity=capacity, max_objects=32,
        sync_timings=sync, write=writer)


def check_scene(stats, scene, what):
    feats = scene["obj_feats"]
    check(stats["points"] > 0, f"{what}: no point survived compaction")
    check(np.isfinite(feats).all() and (np.linalg.norm(feats, axis=-1)
                                        > 0).all(),
          f"{what}: fused rows not finite and non-zero after the NaN "
          "replacement")
    check(np.isfinite(scene["xyz"]).all() and scene["xyz"].shape[0]
          == stats["points"], f"{what}: compacted cloud malformed")


def ingest_phase(extractor, report):
    """Full-width ingest (bench.py's fusion shape): one warm scene, then
    one timed scene with the launch counters set to 0 before it. Returns
    the scenes' launch counts."""
    from dropclip_tpu_torch.ops import attention as att
    from dropclip_tpu_torch.ops.layernorm import add_layer_norm, layer_norm

    writer = NpzWriter()
    scenes = [make_ingest_scene(s, INGEST_VIEWS, (480, 640), 10, 400)
              for s in (1, 2)]
    t = time.time()
    warm = ingest_scene(extractor, scenes[0], "warm", writer)
    print(f"warm ingest scene: {time.time() - t:.2f} s {warm}", flush=True)
    counters = (att.oneshot_attention_packed, att.oneshot_attention,
                att.flash_attention_padded, layer_norm, add_layer_norm)
    for c in counters:
        c.launches = 0
    chunks0 = extractor.chunks
    torch.cuda.synchronize()
    t = time.time()
    stats = ingest_scene(extractor, scenes[1], "scene", writer)
    wall = time.time() - t
    n = {name: c.launches for name, c in zip(("K3", "K4", "K5", "K6", "K7"),
                                             counters)}
    chunks = extractor.chunks - chunks0
    pairs = present_pairs(scenes[1]["segs"])
    check_scene(stats, writer.last, "full-width ingest")
    print(f"ingest scene ({INGEST_VIEWS} views 480x640, 10 objects, "
          f"ViT-L/14@336px bf16): {wall:.3f} s wall; aggregate "
          f"{stats['t_aggregate']:.3f} s, teacher {stats['t_teacher']:.3f} s,"
          f" queries+fuse {stats['t_fuse']:.3f} s, finalize "
          f"{stats['t_finalize']:.3f} s; {pairs} present pairs in {chunks} "
          f"chunks; launches {n}; dropped {stats['dropped']}, points "
          f"{stats['points']}, objects {stats['objects']}, nan_objects "
          f"{stats['nan_objects']}", flush=True)
    check(chunks == -(-pairs // extractor.chunk), "chunk count")
    check(n["K3"] == 24 * chunks and n["K7"] == 47 * chunks
          and n["K6"] == 3 * chunks + 25 and n["K4"] == n["K5"] == 0,
          f"launches {n} over {chunks} chunks (want K3 24, K7 47, K6 3 "
          "per chunk + 25 for the text queries)")
    report["ingest"] = dict(views=INGEST_VIEWS, wall_s=wall, stats=stats,
                            pairs=pairs, chunks=chunks, launches=n)
    return n, scenes[1]


def ingest_fallback_phase(extractor, report):
    """The teacher's other attention routes on the ingest path, counters
    set to 0 before each: the per-head kernel (DROPCLIP_PACKED_ATTN=0, K4)
    over one 96-crop chunk forward of ``encode_image``, which must give
    the packed route's (K3) bits; the long-sequence kernel (K5) on CLIP at
    a doubled input (672x896, 3073 tokens, past ``supports``) through
    ``ClipExtractor.extract``."""
    from dropclip_tpu_torch.ops import attention as att
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    model = extractor.model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    px = torch.randn((extractor.chunk,) + extractor.img_resize + (3,),
                     generator=gen, device="cuda")
    with torch.no_grad():
        packed = model.encode_image(px)
        os.environ["DROPCLIP_PACKED_ATTN"] = "0"
        try:
            att.oneshot_attention.launches = 0
            att.oneshot_attention_packed.launches = 0
            torch.cuda.synchronize()
            t = time.time()
            per_head = model.encode_image(px)
            torch.cuda.synchronize()
            wall = time.time() - t
            k4 = att.oneshot_attention.launches
            k3 = att.oneshot_attention_packed.launches
        finally:
            del os.environ["DROPCLIP_PACKED_ATTN"]
    check(k4 == 24 and k3 == 0, f"K4 ran {k4} times and K3 {k3} in one "
          "chunk forward (want 24 and 0)")
    check(torch.equal(per_head, packed), "the K4 and K3 routes differ")
    print(f"chunk forward ({extractor.chunk} crops), DROPCLIP_PACKED_ATTN=0:"
          f" {wall:.3f} s, K4 {k4} launches, equal to the K3 route",
          flush=True)

    hires = ClipExtractor(model, mode="patch", img_resize=(672, 896),
                          batch_size=8)
    images = make_ingest_scene(1, 8, (480, 640), 10, 400)["images"]
    att.flash_attention_padded.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    feats = hires.extract(images)
    torch.cuda.synchronize()
    wall_hr = time.time() - t
    k5 = att.flash_attention_padded.launches
    check(tuple(feats.shape) == (8, 48, 64, 768)
          and bool(torch.isfinite(feats.float()).all()),
          f"hi-res patch features {tuple(feats.shape)}")
    check(k5 == 23, f"K5 ran {k5} times (want 23: the patch path runs all "
          "blocks but the last through attention)")
    print(f"hi-res patch extract (8 views at 672x896, T=3073): {wall_hr:.3f}"
          f" s, K5 {k5} launches", flush=True)
    report["ingest_fallbacks"] = dict(per_head_chunk_s=wall, k4_launches=k4,
                                      hires_wall_s=wall_hr, k5_launches=k5)
    return k4, k5


# ingest card vs CPU limits; the readings of sound runs and of planted
# faults that set them are in PERF.md (Findings, PR 2)
INGEST_COS = 0.9995  # fused object rows, min cosine
INGEST_XYZ = 1e-6  # xyz and rgb, max |d|


def compare_scenes(g, c):
    """Card scene ``g`` against CPU scene ``c``, matched by voxel."""
    key = lambda xyz: [tuple(r) for r in np.floor(xyz / 0.005).astype(int)]
    gi = {k: i for i, k in enumerate(key(g["xyz"]))}
    pairs = [(gi[k], j) for j, k in enumerate(key(c["xyz"])) if k in gi]
    gsel = np.array([p[0] for p in pairs], int)
    csel = np.array([p[1] for p in pairs], int)
    fg, fc = g["obj_feats"], c["obj_feats"]
    return dict(
        matched=len(pairs) / max(len(gi), len(c["xyz"]), 1),
        xyz=float(np.abs(g["xyz"][gsel] - c["xyz"][csel]).max()),
        rgb=float(np.abs(g["rgb"][gsel] - c["rgb"][csel]).max()),
        labels_equal=bool((g["label"][gsel] == c["label"][csel]).all()),
        vis_agreement=float((g["vis_mask"][:, gsel]
                             == c["vis_mask"][:, csel]).mean()),
        obj_feats_min_cos=float((np.sum(fg * fc, -1) / (
            np.linalg.norm(fg, axis=-1) * np.linalg.norm(fc, axis=-1))).min()))


def ingest_cpu_phase(report):
    """Three reduced scenes (seeds 3-5; 4 views 120x160, 3 objects,
    ViT-L/14@336px cut to 2 vision layers at full width, the same seeded
    weights) on the card and on the CPU (plain versions). Matched by voxel:
    xyz and rgb within INGEST_XYZ (float atomics sum in another order),
    labels equal, vis_mask agreeing on 99.9% of entries, at least 99.9% of
    each cloud's voxels matched, fused object rows at cosine >=
    INGEST_COS (bf16 towers in two matmul libraries). Two planted faults
    in K3 on the card, against the CPU scene of seed 3: the softmax scale
    without log2(e), which the cosine limit must catch, and the last key
    dropped, which is recorded only (it moves a class token by about one
    part in 769, below bf16 noise end to end; the attention phase's ulp
    limit catches it)."""
    from dropclip_tpu_torch.ops import attention as att
    from dropclip_tpu_torch.teachers.clip import build_clip
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    from dropclip_tpu_torch.kernels.attention import attention

    entry = att.oneshot_attention_packed

    def no_log2e(q, k, v, heads):
        return attention(q * (1.0 / att.LOG2E), k, v, heads)

    def dropped_key(q, k, v, heads):
        b, t, c = q.shape
        split = [x.reshape(b, t, heads, c // heads) for x in (q, k, v)]
        return dropped_key_control(*split, False).reshape(b, t, c)

    raws = {s: make_ingest_scene(s, 4, (120, 160), 3, 400) for s in (3, 4, 5)}
    scenes, secs = {}, {}
    for dev in ("cuda", "cpu"):
        model = build_clip("ViT-L/14@336px", dtype=torch.bfloat16,
                           generator=torch.Generator().manual_seed(SEED),
                           device=dev, vision_layers=2)
        ex = ClipExtractor(model, chunk=16)
        runs = [(s, None) for s in raws]
        if dev == "cuda":
            runs += [(3, "no_log2e"), (3, "dropped_key")]
        for seed, fault in runs:
            writer = NpzWriter()
            tag = f"reduced_{dev}_{seed}" + (f"_{fault}" if fault else "")
            if fault:
                att.oneshot_attention_packed = {
                    "no_log2e": no_log2e, "dropped_key": dropped_key}[fault]
            t = time.time()
            try:
                stats = ingest_scene(ex, raws[seed], tag, writer,
                                     capacity=16384, sync=True)
            finally:
                att.oneshot_attention_packed = entry
            secs[tag] = time.time() - t
            scenes[(dev, seed, fault)] = (stats, writer.last)
        del model, ex
    rows = {}
    for seed in raws:
        (sg, g), (sc, c) = scenes[("cuda", seed, None)], \
            scenes[("cpu", seed, None)]
        check_scene(sg, g, f"reduced ingest {seed} on the card")
        check_scene(sc, c, f"reduced ingest {seed} on the CPU")
        r = compare_scenes(g, c)
        r.update(points=[sg["points"], sc["points"]],
                 nan_objects=[sg["nan_objects"], sc["nan_objects"]],
                 cpu_s=secs[f"reduced_cpu_{seed}"],
                 card_s=secs[f"reduced_cuda_{seed}"])
        rows[seed] = r
        print(f"ingest card vs CPU, seed {seed} (4 views 120x160, 3 objects,"
              f" 2-layer ViT-L bf16): points {r['points']}, matched "
              f"{r['matched']:.4f}, xyz max |d| {r['xyz']:.3e}, rgb max |d| "
              f"{r['rgb']:.3e}, labels equal {r['labels_equal']}, vis_mask "
              f"agreement {r['vis_agreement']:.5f}, obj_feats min cosine "
              f"{r['obj_feats_min_cos']:.6f}, nan_objects "
              f"{r['nan_objects']}; CPU {r['cpu_s']:.1f} s, card "
              f"{r['card_s']:.1f} s", flush=True)
    cpu3 = scenes[("cpu", 3, None)][1]
    faults = {f: compare_scenes(scenes[("cuda", 3, f)][1], cpu3)[
        "obj_feats_min_cos"] for f in ("no_log2e", "dropped_key")}
    print(f"planted faults in K3, seed 3, obj_feats min cosine vs the CPU: "
          f"{faults}", flush=True)
    report["ingest_card_vs_cpu"] = dict(seeds=rows, planted_faults=faults,
                                        cos_limit=INGEST_COS,
                                        xyz_limit=INGEST_XYZ)
    for seed, r in rows.items():
        check(r["matched"] >= 0.999 and r["xyz"] <= INGEST_XYZ
              and r["rgb"] <= INGEST_XYZ and r["labels_equal"]
              and r["vis_agreement"] >= 0.999
              and r["obj_feats_min_cos"] >= INGEST_COS
              and r["nan_objects"][0] == r["nan_objects"][1],
              f"ingest card vs CPU, seed {seed}, outside its tolerances")
    check(faults["no_log2e"] < INGEST_COS, "the cosine limit does not see "
          "a softmax scale without log2(e)")


def ingest_profile_phase(extractor, scene, report):
    """One full-width ingest scene under torch.profiler: device busy and
    idle share, top kernels; the trace goes to chiprun_out/."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.time()
        ingest_scene(extractor, scene, "profiled", NpzWriter(), sync=False)
        torch.cuda.synchronize()
        wall = (time.time() - t) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    check(busy > 0, "profiler saw no device time in ingest")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]
    mine = {}
    for tag, key in (("K3/K4/K5", "attention_kernel"), ("K6", "_ln_rows"),
                     ("K7", "_add_ln_rows")):
        ev = [e for e in kernels if key in e.key and
              not (tag == "K6" and "_add_ln_rows" in e.key)]
        mine[tag] = dict(launches=sum(e.count for e in ev),
                         device_ms=sum(e.self_device_time_total
                                       for e in ev) / 1e3)
    # the teacher's bf16 attention at D = 64 runs v3 and nothing else
    v3 = sum(e.count for e in kernels if "attention_kernel_v3" in e.key)
    mine["K3/K4/K5"]["v3_launches"] = v3
    want = report["ingest"]["launches"]["K3"]  # the same scene's count
    check(v3 == mine["K3/K4/K5"]["launches"] == want,
          f"ingest attention launches: {mine['K3/K4/K5']['launches']}, of "
          f"them v3 {v3} (want {want}, all v3)")
    report.setdefault("profile", {})["ingest"] = dict(
        wall_ms=wall, device_busy_ms=busy, idle_share=1 - busy / wall,
        top=[dict(kernel=e.key, calls=e.count,
                  ms=e.self_device_time_total / 1e3) for e in top],
        **mine)
    print(f"profile ingest: wall {wall} ms, device busy {busy} ms, idle "
          f"share {1 - busy / wall}", flush=True)
    for e in top:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms {e.count:6d} "
              f"calls  {e.key[:90]}", flush=True)
    for tag, m in mine.items():
        print(f"  {tag}: {m['launches']} launches, {m['device_ms']} ms on "
              f"the device", flush=True)
    prof.export_chrome_trace(os.path.join(ROOT, "chiprun_out",
                                          "trace_ingest.json"))


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script measures the "
              "card and has no CPU mode", file=sys.stderr)
        return 2
    # fails here, before any output, when run outside a checkout
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.pipeline import make_clip_sim
    from dropclip_tpu_torch.tools.preprocess_data import build_extractor

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.time()
    card = card_line()
    import triton

    print(f"card: {card}; torch {torch.__version__} cuda "
          f"{torch.version.cuda} triton {triton.__version__}", flush=True)
    times, ptxas = build_kernels()
    print("built " + ", ".join(f"{k} in {v:.2f} s" for k, v in
                               times.items()), flush=True)
    for name, log in ptxas.items():
        for fn, lines in ptxas_entries(log).items():
            short = re.sub(r"^_ZN.*_cu_[0-9a-f]{8}\d*", "", fn)[:48]
            print(f"  ptxas {name} {short}: {'; '.join(lines)}", flush=True)
        for line in log.splitlines():  # ptxas' notes on wgmma, if any
            if "GMMA" in line or "wgmma" in line:
                print(f"  ptxas {name}: {line.strip()[:160]}", flush=True)
    v3 = [lines for fn, lines in ptxas_entries(ptxas["attention"]).items()
          if "attention_kernel_v3" in fn]
    check(len(v3) == 1 and any("0 bytes spill stores, 0 bytes spill loads"
                               in line for line in v3[0]),
          f"attention v3 spills registers or was not built: {v3}")

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    cfg.clip_checkpoint = "random"
    clouds, rgbs = make_clouds(BATCH)
    report = {"card": card, "torch": torch.__version__}
    clip_sim = make_clip_sim(cfg, "cuda", SEED)
    pipe = brick_pipeline(cfg, clouds, rgbs, clip_sim)

    k1 = k1_phase(pipe, clouds, rgbs, report)
    k6 = k6_phase(report)
    k1_n, k6_n = serve_phase(pipe, clouds, rgbs, report)
    cpu_phase(cfg, pipe, clouds, rgbs, report)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    queries = ["a red box", "the cup"]
    profile_phase(
        (("ground", lambda: pipe.ground(clouds[6], rgbs[6], queries)),
         ("ground_batch", lambda: pipe.ground_batch(clouds, rgbs, queries))),
        (("K1", "brick_conv3_mma"), ("K6", "_ln_rows")), report,
        trace="ground")
    del pipe
    torch.cuda.empty_cache()

    # the pillar engine: the same config with sparse_backend pillars
    vclouds, vrgbs = make_volumetric_clouds(BATCH)
    pcfg, ppipe = pillar_pipeline(cfg, vclouds, vrgbs, clip_sim)
    k2 = k2_phase(ppipe, vclouds, vrgbs, report)
    k2_n, k6_np = pillar_serve_phase(ppipe, vclouds, vrgbs, report)
    pillar_cpu_phase(pcfg, ppipe, vclouds, vrgbs, report)
    pillar_vs_brick_phase(cfg, ppipe, vclouds, vrgbs, report)
    profile_phase(
        (("pillar_ground", lambda: ppipe.ground(vclouds[7], vrgbs[7],
                                                queries)),),
        (("K2", "pillar_conv3_mma"), ("K6", "_ln_rows")), report,
        trace="pillar_ground")
    del ppipe
    torch.cuda.empty_cache()

    att = attention_phase(report)
    k7 = k7_phase(report)
    args = SimpleNamespace(clip_model="ViT-L/14@336px", clip_checkpoint=None,
                           visual_prompt="crop-mask", crop_num_levels=1,
                           crop_expansion_ratio=0.15, batch_size=32)
    t = time.time()
    extractor = build_extractor(args, device="cuda", seed=SEED)
    print(f"built the ViT-L/14@336px teacher (bf16, seed {SEED}) in "
          f"{time.time() - t:.1f} s", flush=True)
    n_ing, scene = ingest_phase(extractor, report)
    k4_n, k5_n = ingest_fallback_phase(extractor, report)
    ingest_profile_phase(extractor, scene, report)
    del extractor
    torch.cuda.empty_cache()
    ingest_cpu_phase(report)

    kernels = [
        dict(name="K1 brick_conv3", route="cuda",
             source="dropclip_tpu_torch/csrc/brick_conv3.cu",
             replaces="dropclip_tpu/sparse/pallas_conv.py:125",
             launches=k1_n, **k1),
        dict(name="K2 pillar_conv3", route="cuda",
             source="dropclip_tpu_torch/csrc/pillar_conv3.cu",
             replaces="dropclip_tpu/sparse/pallas_pillar.py:134",
             launches=k2_n, **k2),
        dict(name="K3 oneshot_attention_packed", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:180",
             launches=n_ing["K3"], **att["K3"]),
        dict(name="K4 oneshot_attention", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:93",
             launches=k4_n, **att["K4"]),
        dict(name="K5 flash_attention_padded", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:214",
             launches=k5_n, **att["K5"]),
        dict(name="K6 layer_norm", route="triton",
             source="dropclip_tpu_torch/ops/layernorm.py",
             replaces="dropclip_tpu/ops/layernorm.py:153",
             launches=k6_n + k6_np + n_ing["K6"], **k6),
        dict(name="K7 add_layer_norm", route="triton",
             source="dropclip_tpu_torch/ops/layernorm.py",
             replaces="dropclip_tpu/ops/layernorm.py:125",
             launches=n_ing["K7"], **k7),
    ]
    check(all(k["launches"] > 0 for k in kernels),
          "a kernel of the main paths never launched")
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
