#!/usr/bin/env python3
"""Smoke run of dropclip_tpu_torch on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py

1. records the card (nvidia-smi name and power limit) and builds every
   kernel from this checkout side by side: the CUDA sources with nvcc into
   ``build/kernels/`` (K1 ``csrc/brick_conv3.cu``; K2
   ``csrc/pillar_conv3.cu``; K3, K4 and K5 ``csrc/attention.cu``) and the
   Triton kernels K6 and K7 by a first launch; prints ptxas' registers
   and spills per entry function (attention v3 and the float32 wgmma
   kernel must not spill);
2. holds each kernel against its plain PyTorch version on the card at the
   shapes its paths give it (K1: the 16 k3 convs of MinkUNet14D at batch 8
   in float32 with TF32 off and in bf16, both timed against halo gather +
   cuDNN ``conv3d`` in the same dtype and a tensor-core bound, 3xTF32 for
   float32; K6: the text tower's (Q*77, 768)
   rows and the ViT-L teacher's (96*769, 1024) and (96, 1024) rows; K3 and
   K4: the teacher's (96, 769, 16, 64) bf16; K5: the hi-res patch
   extract's (8, 3073, 16, 64) bf16, with DINO v1 hi-res, causal T=77 and
   the float32 instance (3xTF32, bound at the TF32 rate) as extra rows;
   K7: the teacher's (96*769, 1024)
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
6. train path: the distillation trainer (``distill/engine.py``) at
   configs/DistilBlender.yaml's recipe and full width (MinkUNet14D,
   768-d, (4, 4, 2) bricks, 8192 voxels, float32, remat False, random
   unit 768-d targets under the cosine loss) on batch 8 of tabletop
   scenes: step 1's gradients through K1 (forward and dgrad) against the
   plain path (native autograd of the plain conv) with TF32 off, every
   parameter given a gradient, and a planted fault (dgrad taps not
   mirrored) that must read far past the limit; five optimizer steps on
   both paths (losses, nothing dropped, 32 K1 launches per step counted
   from 0, step time, peak memory, one step split by CUDA events into
   forward, dgrad, wgrad and the rest, one step under the profiler); the
   eval step after training against the plain eval; one bf16 step (K1's
   wgmma instance in forward and dgrad) against the plain arithmetic; the
   trainer CLI as a module for one epoch of 3 steps on a fake .npz
   dataset with grounding eval (``clip_checkpoint random``), then resumed
   from its checkpoint at the next epoch;
7. eval path: ``tools.run_eval.eval_scene`` on the full-width ingest
   scene in both fusion modes (object prior: K3 24, K7 47, K6 3 per
   chunk; patch: K3 23, K7 45, K6 4 per image batch; K6 25 per text
   encode) and a reduced scene on the card against the CPU (fused rows
   at cosine >= 0.9995; planted fault: ``bicubic_sample_at`` with px and
   py swapped); an OpenAI-layout ViT-L/14@336px checkpoint file drawn
   from a seed, read through ``make_clip_sim`` on the card and the CPU
   (planted fault: q and k swapped); on the train CLI's checkpoint and
   the dataset's test split, ``tools.validate_blender`` as a module,
   ``validate_grounding`` in process (K1 16 per student forward, K6 25
   per text-encode miss, nothing dropped), one val batch and the upper
   bound on the card against the CPU (sims within 0.05, masks 99%), the
   batched scorer on a perfect student against the CPU (planted fault:
   ground truths shifted by one query), ``validate_upper_bound`` on both,
   ``GroundingPipeline.from_checkpoint`` against a pipeline built in
   process (1e-6), ``tools.make_visualizations``;
8. teachers: K5 at the new shapes (float32 (1, 3026, 6, 64) and
   (1, 16130, 6, 64) of DINO v1, bf16 (8, 3073, 16, 64) of DINOv2) and K4
   at DINOv2's (8, 1370, 16, 64), each against its plain version with the
   dropped-key control and timed; DINOv2-L/14 in bf16 from a
   HuggingFace-layout file drawn from a seed on 8 frames at 336x448,
   518x518 and 672x896 (K3, K4, K5 by the JAX predicates, K6 2 and K7 47
   per forward, from the counters), card against CPU at 2 layers (planted
   fault: LayerScale ls1 dropped), ``dino_extract.main`` in cls and patch
   modes; DINO v1 ViT-S/8 at stride 4 in float32 at 224x224 and 512x512
   (descriptors, binned, saliency: K5 12 or 11 per forward), card
   against CPU at 224x224 (planted fault: the +0.1 pos-embed trick left
   out), ``dino_extract.main --family dino_v1`` on two frames (cv2's
   resize replaced by nearest-pixel sampling where cv2 is absent); K6
   and K7 at the teachers' rows and eps (float32 (3026, 384) and (16130,
   384), DINOv2's 8 x 3073 rows of 1024 in both types) against their
   plain versions with a planted fault each, timed, and split into device
   time (profiler) and host time per call beside ``F.layer_norm``'s; the
   float32 K5 rows also read kernel and plain version against float64;
   RN50 from an OpenAI-layout file
   (pooled, patch and text features against the CPU, a planted fault
   each); ``clip_extract.main``
   with ViT-L/14@336px (cls, patch, tiled) and RN50 (patch; cls and
   tiled raise); one ingest chunk on the per-view prompt path against
   the packed route; profiles of one forward of each teacher;
9. raw datasets (after the eval path's run_eval, before the teachers):
   a raw MV-TOD scene at the published shape (73 views 480x640, 10
   objects, RLE masks, .npy depth) written by ``write_fake_raw_blender``
   and read through ``BlenderDataset`` (read and RLE decode timed, the
   RLE route printed), ``run_blender`` in process with the .npz writer
   and the ingest teacher (K3 24, K7 47, K6 3 per chunk + 25), its scene
   against ``process_scene`` on the generator's arrays (planted fault:
   two hex colours swapped); ``run_eval -ds Blender`` in both fusion
   modes; raw REGRAD scenes (9 views at 840x840, 10 objects, 20000
   points a view) through ``run_regrad`` (patch batch K3 23, K7 45, K6
   4; obj-prior chunks as ingest); the MV-TOD trainer for 3 steps with
   ``use_view_clip`` (774-wide stem; K1 32 per step, the patch teacher
   per cache miss); a reduced REGRAD scene and one view's features card
   (bf16) against CPU (float32) at cosine >= 0.999 (planted faults: the
   camera flip, the y flip left out); K1's forward and dgrad at the
   REGRAD trainer's (2, 2, 2) bricks on its batch's topology against the
   plain version (planted fault: dgrad taps not mirrored), the batch's
   grid dropping nothing; ``train_distil`` under
   configs/DistilREGRAD.yaml at its recipe but for the bricks (batch 16,
   3 steps, grounding eval on REGRAD queries; K1 32 per step, 16 per val
   batch; nothing dropped); then
   ``make_visualizations`` with ``viz_query`` on its checkpoint (K1 16 per
   forward, K6 25 per text encode) and every grasp ranking card against
   CPU (planted fault: the radius compared unsquared);
10. prints the ``kernels`` JSON line, the card line and, last,
   ``{"ok": true, "device": {...}}``.

Any failed check raises and exits non-zero. Without a CUDA card the
script exits non-zero before printing any result. A JSON report with every
number goes to ``chiprun_out/chip_smoke_report.json``.
"""

import contextlib
import json
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace
from unittest import mock

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


def device_ms(fn, per=1, reps=51, warm=50):
    """Median device time (ms) of a call of ``fn`` (``per`` kernels a
    call) over ``reps`` calls, from torch.profiler's kernel durations. A
    session in a process that has profiled before can miss the kernels of
    its first calls, so ``warm`` calls run inside the session first and
    the last ``reps * per`` kernels, in launch order, are the calls read."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session that saw too few kernels is taken again
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(warm + reps):
                fn()
            torch.cuda.synchronize()
        kernels = sorted((e for e in prof.events()
                          if e.device_type == DeviceType.CUDA),
                         key=lambda e: e.time_range.start)
        if len(kernels) >= reps * per:
            break
    check(len(kernels) >= reps * per,
          f"profiler saw {len(kernels)} kernels in {warm + reps} calls")
    kernels = kernels[len(kernels) - reps * per:]
    return float(np.median([
        sum(e.time_range.elapsed_us() for e in kernels[i:i + per]) / 1e3
        for i in range(0, len(kernels), per)]))


def host_ms(fns, reps=101):
    """Median host time (ms) of a call of each of ``fns``: the host clock
    around every call, the functions called in turns (a, b, a, b, ...) so
    that each sees the same state of a shared host, back to back (far
    fewer calls than fill the launch queue, so the card never holds the
    host back)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            t = time.perf_counter()
            fn()
            ts.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return [float(np.median(ts)) for ts in times]


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


class Launches:
    """Launches of K3-K7 over a ``with`` block: each counter is set to 0
    on entry and read on exit (after a sync) into ``n``."""

    def __enter__(self):
        from dropclip_tpu_torch.ops import attention as att
        from dropclip_tpu_torch.ops.layernorm import add_layer_norm, \
            layer_norm

        self.counters = dict(K3=att.oneshot_attention_packed,
                             K4=att.oneshot_attention,
                             K5=att.flash_attention_padded, K6=layer_norm,
                             K7=add_layer_norm)
        torch.cuda.synchronize()  # work queued before the block is not its
        for c in self.counters.values():
            c.launches = 0
        self.t = time.time()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.wall = time.time() - self.t
        self.n = {k: c.launches for k, c in self.counters.items()}


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


def tc_bound(flops, nbytes, dtype):
    """The least time (ms) of one call of a tensor-core kernel (K1, K2,
    K3-K5) and what bounds it: float32 at three TF32 tensor-core products
    per product (3xTF32), bf16 at the bf16 tensor-core rate; the bytes
    each input read once, the output written once."""
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
            bound, by_what = tc_bound(row["flops_needed"], nbytes, dtype)
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


def ln_close(got, ref, dtype, floor=2.0 ** -10):
    """K6/K7's rule: float32 rtol and atol 1e-5; bf16 within one bf16
    ulp of the plain result, the ulp floored at ``floor`` (2^-10 at large
    row counts, where float32 reduction order can flip a value that
    cancels below 2^-13)."""
    got, ref = got.float(), ref.float()
    if dtype == torch.float32:
        return torch.allclose(got, ref, rtol=1e-5, atol=1e-5)
    ulp = 2.0 ** (torch.floor(torch.log2(ref.abs().clamp_min(floor))) - 7)
    return bool(((got - ref).abs() <= ulp).all())


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
        check(ln_close(got, ref, dtype, floor),
              f"K6 {dtype} ({n}, {c}): max err {err}")
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
    from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count
    from dropclip_tpu_torch.ops.layernorm import layer_norm

    sim = pipe.clip_sim
    t = time.time()
    pipe.ground(clouds[0], rgbs[0], QUERY_SETS[0])  # warm-up request
    print(f"warm-up request: {(time.time() - t) * 1e3} ms", flush=True)

    k1_count.launches = 0
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
    k1_n, k6_n = k1_count.launches, layer_norm.launches

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
            # a kernel goes to the longest tag key it contains (K6's
            # "_ln_rows" is part of K7's "_add_ln_rows")
            mine = [e for e in kernels if key in e.key and not any(
                key in k2 and k2 != key and k2 in e.key for _, k2 in tags)]
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
    ``tc_bound``'s rule (float32 at 3xTF32). The per-forward sums include
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
            bound, by_what = tc_bound(row["flops_needed"], nbytes, dtype)
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
                "f32x3": "f32x3 3xTF32, at D = 64 on wgmma.m64n64k8.tf32: "
                         "Q and P split in registers (RS), K and V^T split "
                         "once per block into hi and lo 128B-swizzled tiles "
                         "(V^T's keys in the order of P's relabelled A "
                         "fragment, no shuffles), each tile's P.V from zero "
                         "then O alpha + part in FFMA, exp2f; D = 16, 32 on "
                         "mma.sync.m16n8k8"}


def attention_f32_close(got, ref):
    """The float32 instance's limit: rtol 1e-4, atol 1e-5 * max|ref|.
    Returns (within, the limit in words, the largest share of its limit
    that an element's error takes)."""
    atol = 1e-5 * float(ref.abs().max())
    share = float(((got - ref).abs() / (atol + 1e-4 * ref.abs())).max())
    return (torch.allclose(got, ref, rtol=1e-4, atol=atol),
            f"rtol 1e-4, atol {atol:.3e}", share)


def attention_f64(q, k, v, causal):
    """Softmax attention in float64, one head at a time: the reference
    that the float32 instance and its plain version are both read against
    (for information; the limit holds the kernel to the plain version).
    Rows are (B, T, H, D)."""
    t, d = q.shape[1], q.shape[-1]
    out = torch.empty(q.shape, dtype=torch.float64, device=q.device)
    for h in range(q.shape[2]):
        qh, kh, vh = (x[:, :, h].double() for x in (q, k, v))
        s = qh @ kh.transpose(-1, -2) * d ** -0.5
        if causal:
            keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
            s.masked_fill_(~keep, float("-inf"))
        out[:, :, h] = torch.softmax(s, dim=-1) @ vh
        del s
    return out


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


def attention_row(tag, b, t, h, causal, dtype, f32_control=False):
    """One attention shape (B, T, H, 64) against its plain version on
    three seeds (bf16; one in float32), timed with the plain version, SDPA
    and the bound (``tc_bound``: float32 at 3xTF32). bf16 must stay within
    ATTN_ULPS of max|ref| and the dropped-key control above it; float32
    within ``attention_f32_close``, and with ``f32_control`` the control
    outside it, the kernel and the plain version then both read against
    float64 (``attention_f64``, printed only)."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.kernels.attention import instance
    from dropclip_tpu_torch.ops import attention as att

    errs = []
    for seed in range(3 if dtype == torch.bfloat16 else 1):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2 + seed)
        q, k, v = (torch.randn((b, t, h, 64), generator=gen,
                               device="cuda").to(dtype) for _ in range(3))
        if tag.startswith("K3"):
            args = [x.reshape(b, t, h * 64) for x in (q, k, v)]
            kern = lambda: att.oneshot_attention_packed(*args, h)
            plain = lambda: att.oneshot_attention_packed_plain(*args, h)
        elif tag.startswith("K4"):
            kern = lambda: att.oneshot_attention(q, k, v)
            plain = lambda: att.oneshot_attention_plain(q, k, v)
        else:
            kern = lambda: att.flash_attention_padded(q, k, v, causal)
            plain = lambda: att.flash_attention_plain(q, k, v, causal)
        got, ref = kern().float(), plain().float().reshape(q.shape)
        got = got.reshape(q.shape)
        torch.cuda.synchronize()
        ref_max = float(ref.abs().max())
        err = float((got - ref).abs().max())
        check(bool(torch.isfinite(got).all()), f"{tag}: not finite")
        errs.append(dict(seed=SEED + 2 + seed, max_abs_err=err,
                         ref_max=ref_max, ulps=bf16_ulps(err, ref_max)))
        if dtype == torch.float32:
            ok, lim, share = attention_f32_close(got, ref)
            errs[-1]["limit_share"] = share
            check(ok, f"{tag} (B={b}, T={t}, H={h}): max err {err} vs "
                  f"max|ref| {ref_max} ({lim})")
        if seed == 0 and (dtype == torch.bfloat16 or f32_control):
            ctrl = dropped_key_control(q, k, v, causal).float()
            ctrl_err = float((ctrl - ref).abs().max())
            ctrl_ulps = bf16_ulps(ctrl_err, ref_max)
            if dtype == torch.float32:
                ctrl_ok, _, ctrl_share = attention_f32_close(ctrl, ref)
                print(f"{tag}: kernel at {share:.3f} of the limit, control "
                      f"(last key dropped) max err {ctrl_err:.3e}, "
                      f"{ctrl_share:.1f} of the limit", flush=True)
                check(not ctrl_ok, f"{tag}: the float32 limit does not see "
                      f"the last key dropped (max err {ctrl_err})")
                # for information: both against float64
                ref64 = attention_f64(q, k, v, causal)
                errs[-1]["f64_max_abs_err"] = float(
                    (got.double() - ref64).abs().max())
                errs[-1]["plain_f64_max_abs_err"] = float(
                    (ref.double() - ref64).abs().max())
                print(f"{tag}: against float64, kernel max err "
                      f"{errs[-1]['f64_max_abs_err']:.3e}, plain "
                      f"{errs[-1]['plain_f64_max_abs_err']:.3e}", flush=True)
                del ref64
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
    bound, by_what = tc_bound(flops, nbytes, dtype)
    row = dict(b=b, t=t, h=h, d=64, causal=causal, dtype=str(dtype),
               max_abs_err=max(e["max_abs_err"] for e in errs),
               max_err_bf16_ulps=worst, seeds=errs,
               ms=cuda_ms(kern, 10), plain_ms=cuda_ms(plain, 3),
               library_ms=cuda_ms(library, 10), bound_ms=bound,
               bound_by=by_what, gflop=flops / 1e9,
               design=ATTN_DESIGNS[instance(dtype, 64)])
    if dtype == torch.float32:
        # the CUDA cores' float32 rate, for reference
        row["bound_f32_cores_ms"] = max(flops / PEAK_FLOPS[dtype],
                                        nbytes / PEAK_BYTES) * 1e3
        row["limit_share"] = max(e["limit_share"] for e in errs)
    if dtype == torch.bfloat16 or f32_control:
        row["control_max_abs_err" if dtype == torch.float32
            else "control_bf16_ulps"] = (ctrl_err if dtype == torch.float32
                                         else ctrl_ulps)
    row["tflops"] = flops / row["ms"] / 1e9
    row["bound_share"] = bound / row["ms"]
    print(f"{tag} (B={b}, T={t}, H={h}, D=64{', causal' if causal else ''}"
          f", {dtype}): err {row['max_abs_err']:.3e} ({worst:.2f} bf16 "
          f"ulps) | kernel {row['ms']:.4f} ms ({row['tflops']:.1f} "
          f"TFLOP/s, {row['bound_share']:.3f} of the bound) plain "
          f"{row['plain_ms']:.4f} ms sdpa {row['library_ms']:.4f} ms bound "
          f"{row['bound_ms']:.4f} ms ({row['bound_by']})", flush=True)
    del q, k, v, qh, kh, vh
    torch.cuda.empty_cache()
    return row


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
    from dropclip_tpu_torch.kernels.attention import wgmma_selftest
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
    out = {case[0]: attention_row(*case) for case in cases}
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
    err = float((got_y.float() - ref_y.float()).abs().max())
    check(torch.equal(got_s, ref_s)
          and ln_close(got_y, ref_y, torch.bfloat16),
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
    writer = NpzWriter()
    scenes = [make_ingest_scene(s, INGEST_VIEWS, (480, 640), 10, 400)
              for s in (1, 2)]
    t = time.time()
    warm = ingest_scene(extractor, scenes[0], "warm", writer)
    print(f"warm ingest scene: {time.time() - t:.2f} s {warm}", flush=True)
    chunks0 = extractor.chunks
    with Launches() as counted:
        stats = ingest_scene(extractor, scenes[1], "scene", writer)
    wall, n = counted.wall, counted.n
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



# --------------------------------------------------------------- train path

TRAIN_STEPS = 5
TRAIN_GRAD_RTOL = 1e-4  # per tensor, of max|ref|, plus 1e-7
TRAIN_LOSS_RTOL = 1e-3  # per step, over five steps
# bf16 step gradients against the plain arithmetic, of max|ref| per
# tensor, set between the sound readings and the planted fault's on the
# H100 (train_grad_readings.py, two seeds; PERF.md): K1's dgrad (sound
# 0.018-0.024, fault 1.98-2.06) and the whole K1 path on the k3 conv
# kernels (sound 0.41-0.50, fault 1.73-1.74)
TRAIN_BF16_DGRAD = 0.1
TRAIN_BF16_PATH = 1.0


class PlainConv3:
    """``BrickConv3Fn``'s stand-in for the plain path: the plain k3 conv
    under native autograd (halo gather, unfolded 27-tap matmul), no K1 in
    the forward or the backward."""

    @staticmethod
    def apply(x, w, nbr, occ, schedule=None):
        from dropclip_tpu_torch.kernels.brick_conv3 import brick_conv3_plain

        return brick_conv3_plain(x, nbr, w, occ)


class K1Route:
    """Within the block, ``BrickConv3Fn``'s calls of ``brick_conv3`` go to
    K1 or to the plain version, separately for the forward and for the
    backward (dgrad); ``phase`` says which one runs."""

    def __init__(self, forward="k1", backward="k1"):
        self.route = {"forward": forward, "backward": backward}
        self.phase = "forward"

    def __enter__(self):
        from dropclip_tpu_torch.kernels import brick_conv3 as k1

        self.k1, self.saved = k1, k1.brick_conv3

        def routed(x, nbr, w, occ, schedule=None):
            if self.route[self.phase] == "k1":
                return self.saved(x, nbr, w, occ, schedule)
            return k1.brick_conv3_plain(x, nbr, w, occ)

        k1.brick_conv3 = routed
        return self

    def __exit__(self, *exc):
        self.k1.brick_conv3 = self.saved


class unmirrored:
    """The planted fault of the dgrad identity: taps transposed but not
    mirrored."""

    def __enter__(self):
        from dropclip_tpu_torch.kernels import brick_conv3 as k1

        self.k1, self.saved = k1, k1.mirror_taps
        k1.mirror_taps = lambda t: t.transpose(1, 2).contiguous()

    def __exit__(self, *exc):
        self.k1.mirror_taps = self.saved


class CheckedConv3(torch.autograd.Function):
    """``BrickConv3Fn`` (same outputs, same K1 launches) with each call held
    to the plain conv on that call's own inputs, as the step gives them:
    the forward to ``brick_conv3_plain``, dgrad and wgrad to native
    autograd of it (dgrad on the occupied voxels, where ``BrickConv3Fn``
    defines it), all computed in float32 from the call's (float32 or bf16)
    tensors and held to ``k1_close``'s limit for the call's dtype. Each
    reading goes to ``calls``: (part, shape, max err, max|ref|, ok)."""

    calls = []

    @staticmethod
    def record(part, got, ref, dtype):
        ok, err, scale = k1_close(got, ref, dtype)
        CheckedConv3.calls.append((part, tuple(ref.shape), err, scale, ok))

    @staticmethod
    def forward(ctx, x, w, nbr, occ, schedule=None):
        from dropclip_tpu_torch.kernels.brick_conv3 import (BrickConv3Fn,
                                                            brick_conv3_plain)

        out = BrickConv3Fn.forward(ctx, x, w, nbr, occ, schedule)
        CheckedConv3.record("forward", out, brick_conv3_plain(
            x.float(), nbr, w.float(), occ), x.dtype)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        from dropclip_tpu_torch.kernels.brick_conv3 import (BrickConv3Fn,
                                                            brick_conv3_plain)

        grads = BrickConv3Fn.backward(ctx, grad_out)
        x, w, nbr, occ = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().float().requires_grad_()
            wr = w.detach().float().requires_grad_()
            rdx, rdw = torch.autograd.grad(
                brick_conv3_plain(xr, nbr, wr, occ), (xr, wr),
                grad_out.float())
        CheckedConv3.record("dgrad", grads[0], rdx * occ[..., None], x.dtype)
        CheckedConv3.record("wgrad", grads[1], rdw, x.dtype)
        return grads


class swap_conv3:
    """Within the block, the brick student's k3 convs run ``fn`` for
    ``BrickConv3Fn``: ``PlainConv3`` (the plain path) or ``CheckedConv3``."""

    def __init__(self, fn):
        self.fn = fn

    def __enter__(self):
        from dropclip_tpu_torch.sparse import unet_bricks

        self.saved = unet_bricks.BrickConv3Fn
        unet_bricks.BrickConv3Fn = self.fn

    def __exit__(self, *exc):
        from dropclip_tpu_torch.sparse import unet_bricks

        unet_bricks.BrickConv3Fn = self.saved


def train_setup(seed=SEED):
    """configs/DistilBlender.yaml's recipe at full width (MinkUNet14D,
    768-d, (4, 4, 2) bricks, 8192-voxel capacity, remat False): batch 8
    of tabletop scenes (6000 voxels each, bench.py's train shapes),
    capacities autotuned with slack 1.5, xyz+rgb inputs, random unit
    768-d targets; the data and the student's weights (on the host) from
    ``seed``."""
    from dropclip_tpu_torch.core.config import load_cfg
    from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
    from dropclip_tpu_torch.distill.engine import (DistilBatch,
                                                   build_student_for)
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    rng = np.random.RandomState(seed + 7)
    cap = int(cfg.voxel_capacity)
    coords, mask = make_tabletop_coords(rng, BATCH, cap, n_occ=6000, ext=40)
    cfg.brick_capacities = list(autotune_brick_capacities(
        coords, mask, slack=1.5, brick_shape=(4, 4, 2)))
    feats = rng.randn(BATCH, cap, 6).astype(np.float32) * mask[..., None]
    tgt = rng.randn(BATCH, cap, int(cfg.feat_dim)).astype(np.float32)
    tgt = tgt / np.linalg.norm(tgt, axis=-1, keepdims=True) * mask[..., None]
    z = np.zeros((BATCH, cap), np.int32)
    batch = DistilBatch(*(torch.as_tensor(a).cuda() for a in (
        coords, mask, feats, tgt.astype(np.float32), z, z)))
    host_model = build_student_for(
        cfg, generator=torch.Generator().manual_seed(seed))
    n_par = sum(p.numel() for p in host_model.parameters())
    print(f"train: {BATCH} scenes of {int(mask.sum(1).min())}-"
          f"{int(mask.sum(1).max())} voxels, brick capacities "
          f"{cfg.brick_capacities}, {n_par} parameters, remat {cfg.remat}",
          flush=True)
    return cfg, batch, host_model


def step_grads(cfg, host_model, batch, route=None, conv=None):
    """One training forward and backward of a copy of ``host_model`` on
    the card (the train step without the optimizer): ({name: grad},
    grad_norm, loss). ``route``: a ``K1Route`` for the k3 convs; ``conv``:
    a stand-in for ``BrickConv3Fn`` (``swap_conv3``)."""
    import contextlib
    import copy

    from dropclip_tpu_torch.distill.engine import (_compute_losses,
                                                   build_topology)
    from dropclip_tpu_torch.distill.train_state import global_norm

    model = copy.deepcopy(host_model).cuda().train()
    with contextlib.ExitStack() as stack:
        if conv is not None:
            stack.enter_context(swap_conv3(conv))
        if route is not None:
            stack.enter_context(route)
        topo = build_topology(cfg, batch.coords, batch.mask)
        loss, _ = _compute_losses(model(topo, batch.in_feats), batch, cfg)
        if route is not None:
            route.phase = "backward"
        loss.backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    norm = global_norm([g for g in grads.values() if g is not None])
    return grads, float(norm), float(loss.detach())


def excess(got, ref):
    """{tensor: max|d| / (TRAIN_GRAD_RTOL * max|ref| + 1e-7)} (<= 1 is
    within the limit)."""
    return {n: float((got[n] - r).abs().max())
            / (TRAIN_GRAD_RTOL * float(r.abs().max()) + 1e-7)
            for n, r in ref.items()}


def rel_max(got, ref):
    """{tensor: max|d| / max|ref|}."""
    return {n: float((got[n] - r).abs().max()) / float(r.abs().max())
            for n, r in ref.items()}


def rel_fro(got, ref):
    """{tensor: ||d|| / ||ref||}, Frobenius norms."""
    return {n: float((got[n] - r).norm()) / float(r.norm())
            for n, r in ref.items()}


def worst(readings, names=None):
    """The largest reading, over ``names`` or all, and its tensor."""
    return max((v, n) for n, v in readings.items()
               if names is None or n in names)


def k3_kernels(model):
    """The names of the k3 conv kernels: the weights K1 runs."""
    return {n for n, p in model.named_parameters()
            if p.dim() == 3 and p.shape[0] == 27}


# three orders of the batch's scenes: the same loss and gradients, summed
# in other orders
PERMS = ((3, 1, 7, 0, 5, 2, 6, 4), (7, 6, 5, 4, 3, 2, 1, 0),
         (1, 0, 3, 2, 5, 4, 7, 6))


def permuted(batch, perm):
    perm = torch.tensor(perm, device=batch.mask.device)
    return batch._replace(**{f: getattr(batch, f)[perm]
                             for f in batch._fields})


def checked_calls(dtype):
    """``CheckedConv3``'s readings since it was last emptied: the worst
    err / max|ref| of each part and the calls outside ``k1_close``."""
    calls, CheckedConv3.calls = CheckedConv3.calls, []
    parts = {}
    for part, _, err, scale, _ in calls:
        parts[part] = max(parts.get(part, 0.0), err / scale)
    bad = [c for c in calls if not c[-1]]
    check(len(calls) == 48, f"{dtype} checked step: {len(calls)} conv "
          "readings, want 16 forward, 16 dgrad, 16 wgrad")
    return parts, bad


def train_grads_phase(cfg, batch, host_model, report):
    """Step 1's gradients, same weights and batch, on the card, TF32 off.

    Checks: (1) every K1 call of the step, forward and dgrad, and every
    wgrad, on its own inputs against the plain conv within K1's float32
    limit (``CheckedConv3``); (2) K1's dgrad, per tensor within
    TRAIN_GRAD_RTOL * max|ref| + 1e-7, under either forward: with the
    plain forward against the plain path (native autograd of the plain
    conv), and with K1's forward against K1's forward with the plain
    dgrad; the planted fault (taps not mirrored) must read past 10x the
    limit; (3) every parameter has a finite, nonzero gradient; (4)
    grad_norm within 1e-4 relative.

    Printed, not held: the whole K1 path against the plain path per
    tensor, beside each tensor's float32 floor, the plain path against
    itself with the scenes in PERMS' orders (the worst of three), in max
    and Frobenius norms. The step's gradients are ill-conditioned: each
    train-mode batch norm's backward subtracts batch means of the
    gradient it receives, sums over about 48,000 voxels that cancel, so
    another summation order moves them by about 5e-3 in Frobenius norm.
    K1's forward, within its limit at every call (check 1), moves them as
    far: K1's forward alone gives the whole path's readings (PERF.md).

    The plain path holds every level's unfolded float32 patches for its
    backward; it fits the card at batch 8 with remat False (its peak is
    read in the steps phase)."""
    kernels = k3_kernels(host_model)
    ref, n_ref, l_ref = step_grads(cfg, host_model, batch, conv=PlainConv3)
    floor, fro_floor = {}, {}
    for perm in PERMS:
        got, _, _ = step_grads(cfg, host_model, permuted(batch, perm),
                               conv=PlainConv3)
        for n, v in excess(got, ref).items():
            floor[n] = max(floor.get(n, 0.0), v)
        for n, v in rel_fro(got, ref).items():
            fro_floor[n] = max(fro_floor.get(n, 0.0), v)
        del got
    g_k1, n_k1, l_k1 = step_grads(cfg, host_model, batch, conv=CheckedConv3)
    parts, bad = checked_calls("float32")
    missing = [n for n, g in g_k1.items() if g is None
               or not torch.isfinite(g).all() or float(g.abs().max()) == 0]
    check(not missing, f"K1 path: no (finite, nonzero) gradient for "
          f"{missing[:5]} ({len(missing)} parameters)")
    fwd, _, _ = step_grads(cfg, host_model, batch, K1Route(backward="plain"))
    readings = {"k1_path": excess(g_k1, ref), "k1_forward": excess(fwd, ref),
                "k1_dgrad_under_k1_forward": excess(g_k1, fwd)}
    fro = {"k1_path": rel_fro(g_k1, ref)}
    del g_k1, fwd
    dgrad, _, _ = step_grads(cfg, host_model, batch, K1Route(forward="plain"))
    readings["k1_dgrad"] = excess(dgrad, ref)
    del dgrad
    with unmirrored():
        bad_taps, _, _ = step_grads(cfg, host_model, batch,
                                    K1Route(forward="plain"))
    readings["planted_fault"] = excess(bad_taps, ref)
    del bad_taps
    torch.cuda.empty_cache()
    dnorm = abs(n_k1 - n_ref) / n_ref
    over = {n: v / max(1.0, floor[n])
            for n, v in readings["k1_path"].items()}
    print(f"train step 1: loss K1 {l_k1} plain {l_ref}; grad_norm K1 {n_k1} "
          f"plain {n_ref} (rel {dnorm}); each K1 call on its own inputs, "
          f"worst err of max|ref|: {parts}, outside the limit "
          f"{len(bad)}", flush=True)
    print("train step 1, worst gradient in units of the limit: " + "; ".join(
        f"{k} {worst(v)}" for k, v in readings.items()) + f"; plain vs plain "
          f"with the scenes permuted {worst(floor)}; K1 path over each "
          f"tensor's max(1, floor) {worst(over)}", flush=True)
    print(f"train step 1, Frobenius: K1 path {worst(fro['k1_path'])}, "
          f"k3 kernels {worst(fro['k1_path'], kernels)}; permuted floor "
          f"{worst(fro_floor)}", flush=True)
    top = sorted(readings["k1_path"].items(), key=lambda kv: -kv[1])[:6]
    print("  K1 path, most moved tensors (reading, floor, K1 forward alone): "
          + "; ".join(f"{n} {v:.3f} {floor[n]:.3f} "
                      f"{readings['k1_forward'][n]:.3f}" for n, v in top),
          flush=True)
    check(not bad, f"K1 calls of the step outside K1's float32 limit: "
          f"{bad[:4]}")
    for k in ("k1_dgrad", "k1_dgrad_under_k1_forward"):
        check(worst(readings[k])[0] <= 1.0,
              f"{k} gradients differ: {worst(readings[k])}")
    fault = worst(readings["planted_fault"])
    check(fault[0] > 10, f"the planted dgrad fault reads only {fault}")
    check(dnorm <= 1e-4, f"grad_norm differs by {dnorm}")
    report["train_step1"] = dict(
        loss_k1=l_k1, loss_plain=l_ref, grad_norm_k1=n_k1,
        grad_norm_plain=n_ref, grad_norm_rel=dnorm, k1_calls_worst=parts,
        plain_permuted_floor=list(worst(floor)),
        k1_path_over_floor=list(worst(over)),
        k3_kernels_k1_path=list(worst(readings["k1_path"], kernels)),
        **{k: list(worst(v)) for k, v in readings.items()})
    return ref


def timed_steps(cfg, model, batch, n):
    """``n`` optimizer steps: (losses, dropped, ms per step, synchronised
    host clock), from the model's weights and a fresh optimizer state."""
    from dropclip_tpu_torch.distill.engine import make_train_step
    from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                        make_optimizer)

    state = create_train_state(model, make_optimizer(cfg, 100))
    step = make_train_step(cfg)
    losses, dropped, ms = [], [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.time()
        state, m = step(state, batch)
        losses.append(float(m["distil_loss"]))
        torch.cuda.synchronize()
        ms.append((time.time() - t) * 1e3)
        dropped.append(int(m["dropped_voxels"]))
    return losses, dropped, ms, state


class StepSplit:
    """Device time of one step's parts by CUDA events on the current
    stream: every K1 call in the forward and in the backward (dgrad),
    every wgrad, the whole forward (with the loss), backward and
    optimizer."""

    def __enter__(self):
        from dropclip_tpu_torch.kernels import brick_conv3 as k1

        self.k1, self.calls = k1, []
        self.saved = (k1.brick_conv3, k1.brick_conv3_wgrad)
        self.phase = "forward"

        def timed(name, fn):
            def run(*a, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **kw)
                e.record()
                self.calls.append((name if name == "wgrad" else
                                   f"k1_{self.phase}", s, e))
                return out
            return run

        k1.brick_conv3 = timed("k1", self.saved[0])
        k1.brick_conv3_wgrad = timed("wgrad", self.saved[1])
        return self

    def __exit__(self, *exc):
        self.k1.brick_conv3, self.k1.brick_conv3_wgrad = self.saved

    def sums(self):
        torch.cuda.synchronize()
        out = {}
        for name, s, e in self.calls:
            out[name] = out.get(name, 0.0) + s.elapsed_time(e)
        return out


def split_step(cfg, state, batch):
    """One instrumented train step: {forward_ms, backward_ms, optimizer_ms,
    k1_forward_ms, k1_dgrad_ms, wgrad_ms, rest_ms, wall_ms}."""
    from dropclip_tpu_torch.distill.engine import (_compute_losses,
                                                   build_topology)

    model = state.model
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    t = time.time()
    with StepSplit() as sp:
        ev[0].record()
        topo = build_topology(cfg, batch.coords, batch.mask)
        model.train()
        for p in model.parameters():
            p.grad = None
        loss, _ = _compute_losses(model(topo, batch.in_feats), batch, cfg)
        ev[1].record()
        sp.phase = "dgrad"
        loss.backward()
        ev[2].record()
        state.apply_gradients()
        ev[3].record()
        torch.cuda.synchronize()
    wall = (time.time() - t) * 1e3
    parts = sp.sums()
    out = dict(forward_ms=ev[0].elapsed_time(ev[1]),
               backward_ms=ev[1].elapsed_time(ev[2]),
               optimizer_ms=ev[2].elapsed_time(ev[3]),
               k1_forward_ms=parts.get("k1_forward", 0.0),
               k1_dgrad_ms=parts.get("k1_dgrad", 0.0),
               wgrad_ms=parts.get("wgrad", 0.0), wall_ms=wall,
               k1_calls=sum(1 for c in sp.calls if c[0] != "wgrad"))
    out["rest_ms"] = (ev[0].elapsed_time(ev[3]) - out["k1_forward_ms"]
                      - out["k1_dgrad_ms"] - out["wgrad_ms"])
    return out


def train_steps_phase(cfg, batch, host_model, report):
    """Five optimizer steps on both paths from the same weights: per-step
    losses within TRAIN_LOSS_RTOL, nothing dropped; the K1 path's step
    time, peak memory and launches (the counter set to 0 just before the
    steps, read just after) and one step split into its parts. Returns
    (K1 launches, trained K1-path state)."""
    import copy

    from dropclip_tpu_torch.distill.engine import make_train_step
    from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count

    torch.cuda.reset_peak_memory_stats()
    k1_count.launches = 0
    losses, dropped, ms, state = timed_steps(
        cfg, copy.deepcopy(host_model).cuda(), batch, TRAIN_STEPS)
    k1_n = k1_count.launches
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with swap_conv3(PlainConv3):
        p_losses, p_dropped, p_ms, _ = timed_steps(
            cfg, copy.deepcopy(host_model).cuda(), batch, TRAIN_STEPS)
    p_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, p_losses)]
    med, p_med = float(np.median(ms[1:])), float(np.median(p_ms[1:]))
    print(f"train {TRAIN_STEPS} steps: losses K1 {losses} plain {p_losses} "
          f"(max rel {max(rel)}); dropped {dropped}; K1 launches {k1_n} "
          f"({k1_n / TRAIN_STEPS} per step); median step {med} ms (plain "
          f"{p_med} ms; all {ms}); peak memory {peak / 2**30:.3f} GiB "
          f"(plain {p_peak / 2**30:.3f} GiB)", flush=True)
    check(max(rel) <= TRAIN_LOSS_RTOL, f"train losses differ by {max(rel)}")
    check(sum(dropped) == 0 and sum(p_dropped) == 0, "voxels dropped")
    check(k1_n == 32 * TRAIN_STEPS,
          f"K1 ran {k1_n} times over {TRAIN_STEPS} steps (want 32 each)")
    # the plain steps left the allocator cold: one step first
    make_train_step(cfg)(state, batch)
    split = split_step(cfg, state, batch)
    check(split["k1_calls"] == 32, f"split step: {split['k1_calls']} K1 "
          "calls")
    print("train step split (CUDA events): " + ", ".join(
        f"{k} {v}" for k, v in split.items()), flush=True)
    report["train_steps"] = dict(
        losses=losses, plain_losses=p_losses, max_rel=max(rel),
        dropped=dropped, step_ms=ms, median_ms=med, plain_step_ms=p_ms,
        plain_median_ms=p_med, peak_bytes=peak, plain_peak_bytes=p_peak,
        k1_launches=k1_n,
        k1_per_step=k1_n / TRAIN_STEPS, split=split)
    return k1_n, state


def train_profile_phase(cfg, state, batch, report):
    """One K1-path step under torch.profiler: device busy and idle share,
    K1's launches and device time, the top kernels."""
    from dropclip_tpu_torch.distill.engine import make_train_step

    step = make_train_step(cfg)
    profile_phase((("train_step", lambda: step(state, batch)),),
                  (("K1", "brick_conv3_mma"),), report, trace="train_step")
    prof = report["profile"]["train_step"]
    check(prof["K1"]["launches"] == 32,
          f"profiled step: {prof['K1']['launches']} K1 launches")


def train_bf16_phase(cfg, batch, host_model, ref32, report):
    """One bf16 step (bf16 activations, float32 parameters, as bench.py's
    train mode): K1's bf16 (wgmma) instance in the forward and in dgrad.

    Checks: (1) every K1 call of the step, forward and dgrad, and every
    wgrad, on its own inputs within K1's bf16 limit, 1e-2 of max|ref|,
    of the conv computed in float32 from the same bf16 tensors
    (``CheckedConv3``: one bf16 rounding of the output); (2) against the
    plain version in the same arithmetic (``BrickConv3Fn`` with the plain
    version, which rounds where K1 rounds), per tensor max|d| / max|ref|:
    K1's dgrad, under the plain forward and under K1's forward, on every
    tensor within TRAIN_BF16_DGRAD, which the planted fault (K1's dgrad
    with taps not mirrored) must pass tenfold; the whole K1 path on the
    k3 conv kernels within TRAIN_BF16_PATH, which the same fault in the
    whole K1 path must pass.

    The whole path reads far above its dgrad: where K1's forward and the
    plain version round a near-tie apart, the step's gradients move by up
    to half their largest entry, as bf16 moves them from the float32 ones
    in either arithmetic. Printed, not held: the plain arithmetic against
    itself with the scenes permuted, and both arithmetics against the
    float32 gradients ``ref32``."""
    from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count
    from dropclip_tpu_torch.kernels.brick_conv3 import instance

    shapes = main_path_shapes(host_model)
    kinds = {instance(torch.bfloat16, c, co) for _, c, co in shapes} | {
        instance(torch.bfloat16, co, c) for _, c, co in shapes}
    # both bf16 instances run wgmma (the ragged one fills shared memory
    # element by element); MinkUNet14D's widths all take "bf16"
    check(kinds <= {"bf16", "bf16_ragged"}, f"bf16 convs reach {kinds}")
    kernels = k3_kernels(host_model)
    bb = batch._replace(in_feats=batch.in_feats.bfloat16())
    before = k1_count.launches
    g_k1, n_k1, _ = step_grads(cfg, host_model, bb, conv=CheckedConv3)
    check(k1_count.launches - before == 32, "bf16 step: K1 launches")
    parts, bad = checked_calls("bf16")

    def grads(route, b=bb):
        return step_grads(cfg, host_model, b, route)[0]

    plain = grads(K1Route("plain", "plain"))
    rel = {"k1_path": rel_max(g_k1, plain),
           "k1_dgrad": rel_max(grads(K1Route(forward="plain")), plain),
           "k1_dgrad_under_k1_forward": rel_max(
               g_k1, grads(K1Route(backward="plain"))),
           "plain_permuted": rel_max(grads(K1Route("plain", "plain"),
                                           permuted(bb, PERMS[0])), plain),
           "k1_vs_f32": rel_max(g_k1, ref32),
           "plain_vs_f32": rel_max(plain, ref32)}
    with unmirrored():
        rel["planted_fault"] = rel_max(grads(K1Route(forward="plain")),
                                       plain)
        rel["planted_fault_k1_path"] = rel_max(grads(K1Route()), plain)
    del g_k1, plain
    torch.cuda.empty_cache()
    readings = {k: dict(all=list(worst(v)), k3_kernels=list(worst(v, kernels)))
                for k, v in rel.items()}
    print(f"train bf16 step ({sorted(kinds)}): grad_norm K1 {n_k1}; each K1 "
          f"call on its own inputs, worst err of max|ref|: {parts}, outside "
          f"the limit {len(bad)}", flush=True)
    print("train bf16 step, worst gradient of max|ref| (all tensors | k3 "
          "conv kernels): " + "; ".join(
              f"{k} {r['all']} | {r['k3_kernels']}"
              for k, r in readings.items()), flush=True)
    check(not bad, f"bf16 K1 calls of the step outside 1e-2 of max|ref|: "
          f"{bad[:4]}")
    for k in ("k1_dgrad", "k1_dgrad_under_k1_forward"):
        check(readings[k]["all"][0] <= TRAIN_BF16_DGRAD,
              f"bf16 {k} gradients differ: {readings[k]['all']}")
    path = readings["k1_path"]["k3_kernels"]
    check(path[0] <= TRAIN_BF16_PATH,
          f"bf16 K1 path kernel gradients differ: {path}")
    fault = readings["planted_fault"]["all"]
    check(fault[0] > 10 * TRAIN_BF16_DGRAD,
          f"the planted bf16 dgrad fault reads only {fault}")
    fault = readings["planted_fault_k1_path"]["k3_kernels"]
    check(fault[0] > TRAIN_BF16_PATH,
          f"the planted bf16 fault reads only {fault} on the K1 path")
    report["train_bf16"] = dict(
        grad_norm_k1=n_k1, instances=sorted(kinds), k1_calls_worst=parts,
        limits=dict(dgrad=TRAIN_BF16_DGRAD, path=TRAIN_BF16_PATH), **readings)


def train_eval_phase(cfg, state, batch, report):
    """The eval step after training, through K1, held to the plain eval
    on the same weights within K1's float32 limit."""
    from dropclip_tpu_torch.distill.engine import make_eval_step
    from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count

    ev = make_eval_step(cfg)
    before = k1_count.launches
    out, m = ev(state, batch)
    check(k1_count.launches - before == 16, "eval step: K1 launches")
    with swap_conv3(PlainConv3):
        ref, pm = ev(state, batch)
    scale = float(ref.abs().max())
    err = float((out - ref).abs().max())
    ok = torch.allclose(out, ref, rtol=1e-4, atol=1e-4 * scale)
    print(f"eval step after training: distil loss K1 {float(m['distil_loss'])}"
          f" plain {float(pm['distil_loss'])}; features max err {err} of "
          f"max|ref| {scale}", flush=True)
    check(ok and torch.isfinite(out).all() and scale > 0,
          f"eval features differ: {err} vs {scale}")
    report["train_eval"] = dict(max_abs_err=err, ref_max=scale,
                                loss=float(m["distil_loss"]),
                                plain_loss=float(pm["distil_loss"]))


def train_cli_phase(report):
    """``tools/train_distil`` as a module on the card: MinkUNet14D on a
    fake .npz processed dataset under chiprun_out/, one epoch of 3 steps
    with grounding eval (``clip_checkpoint random``, the ViT-L text tower
    in bf16) and a checkpoint, then a second run that resumes it at epoch
    1. The checkpoints (0.7 GB each: weights and AMSGrad moments) go to
    build/; the eval phase reads the first run's and deletes them. Returns
    (dataset dir, first run's checkpoint dir, checkpoints root)."""
    from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
    from dropclip_tpu_torch.data.synthetic import write_fake_processed_dataset

    logs = os.path.join(ROOT, "chiprun_out", "train_cli")
    data = os.path.join(logs, "data")
    saves = os.path.join(ROOT, "build", "train_cli")
    shutil.rmtree(data, ignore_errors=True)
    # train and test splits, 6 scenes each (the test split is the eval
    # phase's val set)
    write_fake_processed_dataset(data, n_scenes=6, n_objects=3,
                                 feat_dim=768, fmt="npz")

    def run(tag, epochs, *extra):
        t = time.time()
        proc = subprocess.run(
            [sys.executable, "-m", "dropclip_tpu_torch.tools.train_distil",
             "--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
             "--opts", "root_dir", data, "batch_size", "2",
             "batch_size_val", "2", "workers", "2", "workers_val", "1",
             "epochs", str(epochs), "print_freq", "1",
             "save_path", os.path.join(saves, tag), *extra],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        with open(os.path.join(logs, f"{tag}.log"), "w") as f:
            f.write(proc.stdout + proc.stderr)
        check(proc.returncode == 0, f"train CLI {tag} failed: "
              f"{proc.stderr[-2000:]}")
        print(f"train CLI {tag}: {time.time() - t:.1f} s", flush=True)
        return proc.stderr, proc.stderr.split("checkpoints in ")[-1].strip()

    try:
        log1, first = run("first", 1, "clip_checkpoint", "random",
                          "eval_task", "grounding")
        ck = restore_checkpoint(first)
        check(ck is not None and ck["epoch"] == 0 and ck["step"] == 3,
              "train CLI: no epoch-0 checkpoint of 3 steps")
        evals = re.findall(r"Eval Grounding: Epoch=\[0/1\] (\{[^}]*\})",
                           log1)
        check(len(evals) == 1, "train CLI: no Eval Grounding line")
        metrics = json.loads(evals[0].replace("'", '"'))
        check(set(metrics) == {"mIoU", "Pr@25", "Pr@50", "Pr@75",
                               "DistilLoss"}
              and all(np.isfinite(v) for v in metrics.values()),
              f"train CLI: grounding eval metrics {metrics}")
        log2, second = run("resumed", 2, "resume", first)
        ck2 = restore_checkpoint(second)
        check(f"resumed from {first} @ epoch 1" in log2 and "Epoch [0]"
              not in log2 and ck2["epoch"] == 1 and ck2["step"] == 6,
              "train CLI: the second run did not resume at epoch 1")
    except BaseException:
        shutil.rmtree(saves, ignore_errors=True)
        raise
    losses = re.findall(r"DistilLoss ([0-9.]+) ", log1 + log2)
    print(f"train CLI: losses {losses}; Eval Grounding (random ViT-L text "
          f"tower) {metrics}", flush=True)
    report["train_cli"] = dict(losses=losses, eval_grounding=metrics)
    return data, first, saves


def train_phase(report):
    """The distillation trainer at full width on the card (step-1
    gradients, five steps, bf16, eval, profile, CLI). Returns (K1
    launches of the five steps, the K1 part of the kernels line, what
    ``train_cli_phase`` returns)."""
    cfg, batch, host_model = train_setup()
    ref32 = train_grads_phase(cfg, batch, host_model, report)
    k1_n, state = train_steps_phase(cfg, batch, host_model, report)
    train_eval_phase(cfg, state, batch, report)
    train_profile_phase(cfg, state, batch, report)
    del state
    torch.cuda.empty_cache()
    train_bf16_phase(cfg, batch, host_model, ref32, report)
    del ref32
    cli = train_cli_phase(report)
    split = report["train_steps"]["split"]
    return k1_n, dict(train_step_ms=report["train_steps"]["median_ms"],
                      train_k1_forward_ms=split["k1_forward_ms"],
                      train_k1_dgrad_ms=split["k1_dgrad_ms"],
                      train_wgrad_ms=split["wgrad_ms"]), cli


# ---- eval path: run_eval at the ingest shape; validation, serving from
# the trainer's checkpoint, viz and a CLIP checkpoint file ----

EVAL_SIMS = 0.05  # normalized sims, card vs CPU (the serve phase's limit)
EVAL_AGREE = 0.99  # mask agreement, card vs CPU (the serve phase's limit)
EVAL_METRICS = 1.0  # grounding metrics in points of %, card vs CPU scorer
TEXT_COS = 0.999  # bf16 text embeddings, card vs CPU (the serve limit)
SERVE_REL = 1e-6  # from_checkpoint vs a pipeline built in process
CLIP_PROMPTS = ["the red mug", "a green bowl", "a blue bottle", "the box"]
# launches per teacher chunk (96 obj-prior crops, or ``batch_size`` whole
# images in patch mode, whose last block runs the value path only: no
# attention, one plain LayerNorm, one fused add + LayerNorm fewer pair)
TEACHER_LAUNCHES = {1: dict(K3=24, K7=47, K6=3), 0: dict(K3=23, K7=45, K6=4)}


def run_eval_args(use_obj_prior, capacity):
    """``tools/run_eval``'s defaults at the ingest phase's voxel size."""
    return SimpleNamespace(
        n_views=-1, max_objects=32, voxel_size=0.005, cloud_capacity=capacity,
        kernel_queries="cls", use_visibility=0, use_similarity=1,
        use_sim_kernel="max", use_obj_prior=use_obj_prior,
        eval_scenario="cls", sim_negatives="generic", sim_method="paired",
        sim_thr=0.75, cache_dir=None, viz_dir=None, _cls_list=[])


def eval_scene_fused(extractor, raw, args, counted=None):
    """``tools.run_eval.eval_scene``, also returning the fusion's input
    points and result; ``counted`` (a one-item list) counts text-tower
    runs."""
    from dropclip_tpu_torch.tools import run_eval

    name = "fuse_obj_prior" if args.use_obj_prior else "fuse_points"
    fn, kept = getattr(run_eval, name), {}

    def keep(*a, **k):
        kept["points"], kept["fused"] = a[0], fn(*a, **k)
        return kept["fused"]

    enc = extractor.model.encode_text

    def encode(tokens):
        counted[0] += 1
        return enc(tokens)

    setattr(run_eval, name, keep)
    if counted is not None:
        extractor.model.encode_text = encode
    try:
        res = run_eval.eval_scene(raw, extractor, args)
    finally:
        setattr(run_eval, name, fn)
        extractor.model.__dict__.pop("encode_text", None)
    return res, kept["points"], kept["fused"]


def run_eval_phase(extractor, scene, report):
    """``tools.run_eval.eval_scene`` on the full-width ingest scene (73
    views at 480x640, 10 objects, the ViT-L/14@336px teacher in bf16) in
    both fusion modes, one warm call and one timed with the launch
    counters set to 0: object-prior (class tokens of crop-mask prompts,
    object-level fusion) and dense patches (MaskCLIP patch features,
    point-level fusion through ``bicubic_sample_at``). Returns the timed
    calls' launches per kernel, summed over the modes."""
    from dropclip_tpu_torch.ops import attention as att
    from dropclip_tpu_torch.ops.layernorm import add_layer_norm, layer_norm

    counters = dict(K3=att.oneshot_attention_packed, K6=layer_norm,
                    K7=add_layer_norm)
    total, rows = dict(K3=0, K6=0, K7=0), {}
    for mode, tag in ((1, "obj_prior"), (0, "patch")):
        args = run_eval_args(mode, INGEST_CAPACITY)
        eval_scene_fused(extractor, scene, args)
        for c in counters.values():
            c.launches = 0
        chunks0, texts = extractor.chunks, [0]
        torch.cuda.synchronize()
        t = time.time()
        res, points, fused = eval_scene_fused(extractor, scene, args, texts)
        wall = time.time() - t
        n = {k: c.launches for k, c in counters.items()}
        chunks = (extractor.chunks - chunks0 if mode else
                  -(-len(scene["images"]) // extractor.batch_size))
        want = {k: v * chunks for k, v in TEACHER_LAUNCHES[mode].items()}
        want["K6"] += 25 * texts[0]
        rows[tag] = dict(wall_s=wall, metrics=res, chunks=chunks,
                         text_encodes=texts[0], launches=n,
                         visible=int(fused.visible.sum()))
        print(f"run_eval {tag} (73 views 480x640, 10 objects, ViT-L/14@336px "
              f"bf16): {wall:.3f} s wall; {res}; {chunks} teacher chunks, "
              f"{texts[0]} text encodes, launches {n}; "
              f"{rows[tag]['visible']} visible points", flush=True)
        check(n == want, f"run_eval {tag}: launches {n}, want {want}")
        check(texts[0] == 1 + 2 * res["n_queries"] and res["n_queries"] > 0
              and all(np.isfinite(v) for v in res.values()),
              f"run_eval {tag}: {res}, {texts[0]} text encodes")
        fused_rows = (fused.obj_features[torch.isfinite(
            fused.obj_features).all(-1)] if mode
            else fused.features[fused.visible])
        check(len(fused_rows) > 0 and bool(torch.isfinite(fused_rows).all()),
              f"run_eval {tag}: no fused row, or one not finite")
        for k in total:
            total[k] += n[k]
        profile_phase(((f"run_eval_{tag}", lambda: eval_scene_fused(
            extractor, scene, args)),), (("K3", "attention_kernel"),
                                         ("K6", "_ln_rows"),
                                         ("K7", "_add_ln_rows")), report)
    report["run_eval"] = rows
    return total


def fused_rows_cos(g, c, points, depths, poses, K, hw):
    """Card result ``g`` against CPU result ``c`` of one fusion, rows
    matched by index: (min cosine over the rows fused on both, away from
    borderline projections; visibility agreement)."""
    from dropclip_tpu_torch.fusion.core import FusionConfig, borderline_points

    vis_agree = float((g.visibility.cpu() == c.visibility).float().mean())
    if hasattr(g, "obj_features"):  # never-fused objects: NaN on both
        fg, fc = g.obj_features.cpu(), c.obj_features
        keep = torch.isfinite(fg).all(-1)
        if not torch.equal(keep, torch.isfinite(fc).all(-1)):
            return -1.0, vis_agree, 0
    else:
        border = borderline_points(points, depths, poses, K,
                                   FusionConfig(image_hw=hw))
        fg, fc = g.features.cpu(), c.features
        keep = g.visible.cpu() & c.visible & ~border.any(0)
    cos = torch.nn.functional.cosine_similarity(fg[keep].double(),
                                                fc[keep].double())
    return float(cos.min()), vis_agree, int(keep.sum())


def run_eval_cpu_phase(report):
    """A reduced scene (seed 3; 4 views 120x160, 3 objects; ViT-L/14@336px
    cut to 2 vision layers at full width, one seeded weight draw) through
    ``run_eval.eval_scene`` on the card and on the CPU in both modes:
    fused rows at cosine >= INGEST_COS (point rows away from borderline
    projections, which a float32 ulp decides), visibility agreeing on
    99.9%; metrics printed. Planted fault: ``bicubic_sample_at`` with px
    and py swapped on the card, which the cosine limit must see."""
    from dropclip_tpu_torch.fusion import core as fusion_core
    from dropclip_tpu_torch.teachers.clip import build_clip
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    raw = make_ingest_scene(3, 4, (120, 160), 3, 400)
    d = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    geo = (d(raw["depths"]), d(raw["poses"]), d(raw["K"]), (120, 160))
    sample = fusion_core.bicubic_sample_at

    def swapped(src, out_hw, px, py):
        return sample(src, out_hw, py, px)

    out, rows = {}, {}
    for dev in ("cuda", "cpu"):
        ex = ClipExtractor(build_clip(
            "ViT-L/14@336px", dtype=torch.bfloat16, device=dev,
            generator=torch.Generator().manual_seed(SEED), vision_layers=2),
            chunk=16)
        runs = [(1, None), (0, None)] + ([(0, "swapped")] if dev == "cuda"
                                         else [])
        for mode, fault in runs:
            if fault:
                fusion_core.bicubic_sample_at = swapped
            try:
                out[(dev, mode, fault)] = eval_scene_fused(
                    ex, raw, run_eval_args(mode, 16384))
            finally:
                fusion_core.bicubic_sample_at = sample
        del ex
    for mode, tag in ((1, "obj_prior"), (0, "patch")):
        (rg, pg, fg), (rc, pc, fc) = out[("cuda", mode, None)], \
            out[("cpu", mode, None)]
        check(float((pg.cpu() - pc).abs().max()) <= INGEST_XYZ,
              f"run_eval {tag}: card and CPU clouds differ")
        cos, agree, n = fused_rows_cos(fg, fc, pc, *geo)
        rows[tag] = dict(min_cos=cos, vis_agreement=agree, rows=n,
                         card=rg, cpu=rc)
        print(f"run_eval {tag} card vs CPU (4 views 120x160, 3 objects, "
              f"2-layer ViT-L bf16): fused rows min cosine {cos:.6f} over "
              f"{n}, visibility agreement {agree:.5f}; metrics card {rg} "
              f"CPU {rc}", flush=True)
        check(cos >= INGEST_COS and agree >= 0.999 and n > 0,
              f"run_eval {tag}: card vs CPU outside its tolerances")
    fault_cos = fused_rows_cos(out[("cuda", 0, "swapped")][2],
                               out[("cpu", 0, None)][2],
                               out[("cpu", 0, None)][1], *geo)[0]
    print(f"planted fault, bicubic_sample_at with px and py swapped: fused "
          f"rows min cosine {fault_cos:.6f} vs the CPU", flush=True)
    check(fault_cos < INGEST_COS, "the cosine limit does not see "
          "bicubic_sample_at with px and py swapped")
    report["run_eval_card_vs_cpu"] = dict(modes=rows, cos_limit=INGEST_COS,
                                          planted_swap_cos=fault_cos)


def clip_file_phase(cfg, report):
    """An OpenAI-layout ViT-L/14@336px state dict drawn by numpy from
    SEED, saved in fp16 under build/, read through ``make_clip_sim`` on
    the card and on the CPU: 4 prompts' bf16 embeddings at cosine >=
    TEXT_COS (25 K6 launches for the card's encode). Planted fault: the
    card's first text block with q and k swapped. Returns the file's
    path (the caller deletes it)."""
    from dropclip_tpu_torch.ops.layernorm import layer_norm
    from dropclip_tpu_torch.pipeline import make_clip_sim
    from dropclip_tpu_torch.teachers.convert import \
        synthetic_openai_state_dict

    path = os.path.join(ROOT, "build", "clip_vitl14_336_seed0.pt")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t = time.time()
    torch.save(synthetic_openai_state_dict("ViT-L/14@336px", seed=SEED,
                                           dtype=torch.float16), path)
    made = time.time() - t
    cfg = cfg.__class__(dict(cfg, clip_checkpoint=path))
    t = time.time()
    sims = {dev: make_clip_sim(cfg, dev) for dev in ("cuda", "cpu")}
    load = time.time() - t
    layer_norm.launches = 0
    emb = {dev: s.encode_text(CLIP_PROMPTS).cpu() for dev, s in sims.items()}
    k6 = layer_norm.launches
    cos = float(torch.nn.functional.cosine_similarity(
        emb["cuda"], emb["cpu"]).min())
    blk = sims["cuda"].model.blocks[0].attn
    with torch.no_grad():
        for a in ("weight", "bias"):
            q, k = getattr(blk.q_proj, a), getattr(blk.k_proj, a)
            tmp = q.clone()
            q.copy_(k)
            k.copy_(tmp)
    sims["cuda"]._cache.clear()
    fault = float(torch.nn.functional.cosine_similarity(
        sims["cuda"].encode_text(CLIP_PROMPTS).cpu(), emb["cpu"]).min())
    print(f"CLIP checkpoint file (OpenAI layout, ViT-L/14@336px fp16, "
          f"{os.path.getsize(path) / 2**20:.0f} MiB): made in {made:.1f} s, "
          f"read twice in {load:.1f} s; bf16 text embeddings card vs CPU min "
          f"cosine {cos:.6f} ({k6} K6 launches); planted fault, q and k "
          f"swapped in the first block: {fault:.6f}", flush=True)
    report["clip_file"] = dict(min_cos=cos, limit=TEXT_COS, k6=k6,
                               planted_qk_swap_cos=fault)
    check(k6 == 25, f"CLIP file: {k6} K6 launches for one encode")
    check(cos >= TEXT_COS, f"CLIP file: card vs CPU cosine {cos}")
    check(fault < TEXT_COS, "the cosine limit does not see q and k swapped")
    return path


def eval_cfg(data, clip_path, **extra):
    """configs/DistilBlender.yaml on the fake dataset's test split."""
    from dropclip_tpu_torch.core.config import load_cfg

    cfg = load_cfg(os.path.join(ROOT, "configs", "DistilBlender.yaml"))
    cfg.update(root_dir=data, batch_size_val=2, workers_val=1,
               clip_checkpoint=clip_path, **extra)
    return cfg


def eval_model(cfg, ckpt, device):
    """The trainer's last checkpoint as an eval state on ``device``."""
    from dropclip_tpu_torch.core.checkpoint import load_model
    from dropclip_tpu_torch.distill.engine import build_student_for
    from dropclip_tpu_torch.distill.train_state import DistilTrainState

    model = build_student_for(cfg).to(device)
    load_model(model, ckpt, map_location=device)
    return DistilTrainState(step=0, model=model, tx=None, opt_state=None)


def grounding_sims(clip_sim, out, batch, cfg):
    """The normalized sims and masks the scorer thresholds, every real
    query of every scene of ``batch``, valid points only (host)."""
    from dropclip_tpu_torch.distill import evaluate as ev
    from dropclip_tpu_torch.similarity import predict_queries

    sims, preds = [], []
    thr = float(cfg.sim_norm_thresh)
    for s in range(out.shape[0]):
        plan = ev.scene_query_plan(batch["queries"][s], cfg.sim_negatives)
        pos, negs, nmask, use_negs, _, qmask, _ = ev._pad_queries(
            clip_sim, plan, np.asarray(batch["labels"][s]), 32, 64,
            out.shape[-1], out.device)
        mask = torch.as_tensor(batch["mask"][s]).to(out.device)
        p_n, s_n = predict_queries(out[s], pos, negs, mask, cfg.sim_method,
                                   thr, neg_mask=nmask)
        p_0, s_0 = predict_queries(out[s], pos, None, mask, cfg.sim_method,
                                   thr)
        u = use_negs[:, None]
        sims.append(torch.where(u, s_n, s_0)[qmask][:, mask].cpu())
        preds.append(torch.where(u, p_n, p_0)[qmask][:, mask].cpu())
    return torch.cat([x.reshape(-1) for x in sims]), \
        torch.cat([x.reshape(-1) for x in preds])


def sims_vs_cpu(what, g, c):
    d = float((g[0] - c[0]).abs().max())
    agree = float((g[1] == c[1]).float().mean())
    print(f"{what} card vs CPU: normalized sims max |d| {d}, mask agreement "
          f"{agree} over {len(g[0])} (query, point) pairs", flush=True)
    check(d <= EVAL_SIMS and agree >= EVAL_AGREE,
          f"{what}: card vs CPU sims {d}, agreement {agree}")
    return dict(sims_max_abs=d, mask_agreement=agree)


def validation_phase(data, ckpt, clip_path, report):
    """Grounding validation of the trainer's checkpoint on the test split
    (6 scenes, batches of 2): ``tools.validate_blender`` as a module on
    the card (exit 0, its JSON line); ``validate_grounding`` in process
    with the launch counters set to 0 (K1 16 per student forward, K6 25
    per text-encode miss, nothing dropped); one batch of 2 scenes on the
    card against the CPU (sims within EVAL_SIMS, masks EVAL_AGREE), the
    scorer on a perfect student against the CPU within EVAL_METRICS with
    a planted fault (ground truths shifted by one query), and
    ``validate_upper_bound`` on both. Returns (K1, K6) launches."""
    import logging

    from dropclip_tpu_torch.data.dataset_blender import MVTODDataset
    from dropclip_tpu_torch.data.loader import DataLoader
    from dropclip_tpu_torch.distill import evaluate as ev
    from dropclip_tpu_torch.distill.engine import make_eval_step
    from dropclip_tpu_torch.kernels.brick_conv3 import counter as k1_count
    from dropclip_tpu_torch.ops.layernorm import layer_norm
    from dropclip_tpu_torch.pipeline import make_clip_sim
    from dropclip_tpu_torch.tools import validate_upper_bound
    from dropclip_tpu_torch.tools.train_distil import (autotune_capacities,
                                                       to_batch)

    opts = ["root_dir", data, "batch_size_val", "2", "workers_val", "1",
            "clip_checkpoint", clip_path]
    t = time.time()
    proc = subprocess.run(
        [sys.executable, "-m", "dropclip_tpu_torch.tools.validate_blender",
         "--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
         "--opts", *opts, "resume", ckpt], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    with open(os.path.join(ROOT, "chiprun_out", "validate_blender.log"),
              "w") as f:
        f.write(proc.stdout + proc.stderr)
    check(proc.returncode == 0, f"validate_blender failed: "
          f"{proc.stderr[-2000:]}")
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"validate_blender module on the card: {time.time() - t:.1f} s; "
          f"{line}", flush=True)
    check(all(np.isfinite(v) for k, v in line.items() if k != "eval_cfg"),
          f"validate_blender: {line}")

    cfg = eval_cfg(data, clip_path)
    val = MVTODDataset(cfg, "test")
    loader = DataLoader(val, 2, MVTODDataset.collate, shuffle=False,
                        num_workers=1)
    autotune_capacities(cfg, val, MVTODDataset.collate,
                        logging.getLogger("chip_smoke"))
    step = make_eval_step(cfg)
    state = {dev: eval_model(cfg, ckpt, dev) for dev in ("cuda", "cpu")}
    sim = {dev: make_clip_sim(cfg, dev) for dev in ("cuda", "cpu")}
    seen = dict(forwards=0, dropped=0)

    def forward(dev):
        def run(b):
            out, m = step(state[dev], to_batch(b, dev))
            seen["forwards"] += dev == "cuda"
            seen["dropped"] += int(m["dropped_voxels"])
            return out, m["distil_loss"]
        return run

    k1_count.launches = layer_norm.launches = 0
    enc0 = sim["cuda"].encodes
    torch.cuda.synchronize()
    t = time.time()
    res = ev.validate_grounding(loader, forward("cuda"), sim["cuda"], cfg)
    wall = time.time() - t
    k1, k6 = k1_count.launches, layer_norm.launches
    misses = sim["cuda"].encodes - enc0
    print(f"validate_grounding in process on the card: {wall:.3f} s for "
          f"{seen['forwards']} batches of 2; {res}; K1 {k1}, K6 {k6} "
          f"launches, {misses} text-encode misses, {seen['dropped']} "
          f"dropped", flush=True)
    check(k1 == 16 * seen["forwards"] and k6 == 25 * misses and misses > 0,
          f"validate_grounding launches: K1 {k1} over {seen['forwards']} "
          f"forwards, K6 {k6} over {misses} misses")
    check(seen["dropped"] == 0, "validate_grounding dropped voxels")
    check(all(np.isfinite(v) for v in res.values()), f"metrics {res}")
    sim["cuda"]._cache.clear()  # the profiled pass encodes its texts anew
    profile_phase((("validate_grounding", lambda: ev.validate_grounding(
        loader, forward("cuda"), sim["cuda"], cfg)),),
        (("K1", "brick_conv3_mma"), ("K6", "_ln_rows")), report)

    batch = next(iter(loader))
    outs = {dev: forward(dev)(batch)[0] for dev in ("cuda", "cpu")}
    rows = dict(student=sims_vs_cpu("val batch (student)", *(
        grounding_sims(sim[d], outs[d], batch, cfg) for d in ("cuda",
                                                              "cpu"))))
    metrics = {dev: ev.validate_grounding([batch], forward(dev), sim[dev],
                                          cfg) for dev in ("cuda", "cpu")}
    print(f"val batch metrics, card {metrics['cuda']}, CPU "
          f"{metrics['cpu']}", flush=True)
    targets = {d: torch.as_tensor(batch["targets"]).to(d)
               for d in ("cuda", "cpu")}
    rows["upper_bound"] = sims_vs_cpu("val batch (upper bound)", *(
        grounding_sims(sim[d], targets[d], batch, cfg) for d in ("cuda",
                                                                 "cpu")))
    ub = {dev: validate_upper_bound.main(
        ["--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
         "--device", dev, "--opts", *opts]) for dev in ("cuda", "cpu")}
    print(f"validate_upper_bound, card {ub['cuda']}, CPU {ub['cpu']}",
          flush=True)
    rows["scorer"] = scorer_phase(sim, batch, cfg)
    report["validation"] = dict(
        validate_blender=line, in_process=res, wall_s=wall,
        forwards=seen["forwards"], launches=dict(K1=k1, K6=k6),
        text_misses=misses, batch_metrics=metrics, upper_bound=ub,
        card_vs_cpu=rows, limits=dict(sims=EVAL_SIMS, agree=EVAL_AGREE,
                                      metrics=EVAL_METRICS))
    return k1, k6


def scorer_phase(sim, batch, cfg):
    """The batched scorer at full width (768-d, 8192 points, 32 queries x
    64 negatives) on a perfect student: one query per object of the
    batch's first scene (CLIP_PROMPTS), whose text embedding is the
    student's feature at the object's points. Card against CPU within
    EVAL_METRICS points of %, and the planted fault (ground truths
    shifted by one query on the card) past it."""
    from dropclip_tpu_torch.distill import evaluate as ev

    labels = np.asarray(batch["labels"][0])
    ids = [int(i) for i in np.unique(labels) if i > 0]
    plan = ev.scene_query_plan({i: [CLIP_PROMPTS[n % len(CLIP_PROMPTS)]]
                                for n, i in enumerate(ids)}, "generic")
    c, got = batch["targets"].shape[-1], {}
    for dev in ("cuda", "cpu"):
        q = ev._pad_queries(sim[dev], plan, labels, 32, 64, c, dev)[:-1]
        out = 0.01 * torch.randn((len(labels), c), generator=torch.
                                 Generator().manual_seed(SEED)).to(dev)
        for i, (_, gt_ids, _) in enumerate(plan):
            sel = torch.as_tensor(np.isin(labels, gt_ids)).to(dev)
            out[sel] += 10 * q[0][i]
        mask = torch.as_tensor(batch["mask"][0]).to(dev)
        score = ev.make_grounding_scorer("paired", 0.75)
        got[dev] = torch.cat([x.reshape(-1).cpu() for x in score(
            out, mask, *q)])
        if dev == "cuda":
            gts = q[4].clone()
            gts[: len(plan)] = torch.roll(gts[: len(plan)], 1, 0)
            fault = torch.cat([x.reshape(-1).cpu() for x in score(
                out, mask, *q[:4], gts, q[5])])
    d = float((got["cuda"] - got["cpu"]).abs().max())
    dfault = float((fault - got["cpu"]).abs().max())
    print(f"scorer on a perfect student ({len(plan)} queries): card "
          f"{got['cuda'].tolist()} CPU {got['cpu'].tolist()}, max |d| {d}; "
          f"planted fault, ground truths shifted by one query: "
          f"{fault.tolist()}, |d| {dfault}", flush=True)
    check(d <= EVAL_METRICS, f"scorer card vs CPU differs by {d}")
    check(dfault > EVAL_METRICS, "the metrics limit does not see ground "
          "truths shifted by one query")
    return dict(card=got["cuda"].tolist(), cpu=got["cpu"].tolist(),
                max_abs=d, planted_shift_abs=dfault)


def serve_ckpt_phase(data, ckpt, clip_path, report):
    """``GroundingPipeline.from_checkpoint`` on the trainer's checkpoint
    (best_sim_loss_model) against a pipeline built in process from the
    same state dict and text tower, 2 tabletop scenes on the card: sims
    within SERVE_REL of max|ref|, masks equal."""
    from dropclip_tpu_torch.core.checkpoint import load_model
    from dropclip_tpu_torch.distill.engine import brick_shape_of
    from dropclip_tpu_torch.pipeline import GroundingPipeline
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

    clouds, rgbs = make_clouds(2)
    cfg = eval_cfg(data, clip_path)
    probe = GroundingPipeline(cfg, device="cpu")
    vox = [probe._host_voxelize(x, r)[0] for x, r in zip(clouds, rgbs)]
    caps = list(autotune_brick_capacities(
        np.stack([v.coords for v in vox]), np.stack([v.mask for v in vox]),
        brick_shape=brick_shape_of(cfg)))
    t = time.time()
    pipe = GroundingPipeline.from_checkpoint(
        os.path.join(ROOT, "configs", "DistilBlender.yaml"), ckpt,
        clip_checkpoint=clip_path,
        overrides=["brick_capacities", str(caps)], device="cuda")
    load = time.time() - t
    cfg.brick_capacities = caps
    ref = GroundingPipeline(cfg, clip_sim=pipe.clip_sim, device="cuda")
    load_model(ref.model, ckpt, "best_sim_loss_model", map_location="cuda")
    worst = 0.0
    for x, r in zip(clouds, rgbs):
        m_p, s_p = pipe.ground(x, r, QUERY_SETS[0])
        m_r, s_r = ref.ground(x, r, QUERY_SETS[0])
        check(np.array_equal(m_p, m_r) and pipe.last_dropped == 0,
              "from_checkpoint: masks differ or voxels dropped")
        worst = max(worst, float(np.abs(s_p - s_r).max()
                                 / max(np.abs(s_r).max(), 1e-30)))
    print(f"from_checkpoint on the card ({load:.1f} s to load): sims within "
          f"{worst} of max|ref| of the in-process pipeline over 2 scenes, "
          f"masks equal", flush=True)
    check(worst <= SERVE_REL, f"from_checkpoint sims differ by {worst}")
    report["serve_from_checkpoint"] = dict(max_rel=worst, load_s=load)


def viz_phase(data, ckpt, report):
    """``tools.make_visualizations`` on the trainer's checkpoint (2 val
    scenes): its files written, one .pcd read back through load_pcd."""
    from dropclip_tpu_torch.tools import make_visualizations
    from dropclip_tpu_torch.viz import load_pcd

    out = os.path.join(ROOT, "chiprun_out", "viz")
    shutil.rmtree(out, ignore_errors=True)
    t = time.time()
    make_visualizations.main(
        ["--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
         "--opts", "root_dir", data, "resume", ckpt, "viz_dir", out,
         "max_scenes", "2"])
    names = sorted(os.listdir(out))
    xyz, col = load_pcd(os.path.join(out, "test_0000_student_pca.pcd"))
    print(f"make_visualizations: {len(names)} files in {time.time() - t:.1f}"
          f" s; test_0000_student_pca.pcd reads back {xyz.shape[0]} points",
          flush=True)
    check(len(names) == 10 and xyz.shape[0] > 0 and np.isfinite(xyz).all()
          and col is not None, f"make_visualizations wrote {names}")
    report["viz"] = dict(files=names, points=int(xyz.shape[0]))


def eval_phase(cfg, cli, report):
    """The eval path on the trainer CLI's checkpoint: the CLIP checkpoint
    file, validation, serving from the checkpoint, viz. Deletes the
    checkpoints and the file afterwards. Returns (K1, K6) launches of the
    in-process validation."""
    data, ckpt, saves = cli
    clip_path = None
    try:
        clip_path = clip_file_phase(cfg, report)
        launches = validation_phase(data, ckpt, clip_path, report)
        serve_ckpt_phase(data, ckpt, clip_path, report)
        viz_phase(data, ckpt, report)
    finally:
        shutil.rmtree(saves, ignore_errors=True)
        if clip_path:
            os.remove(clip_path)
    return launches


# ---- the raw datasets: the MV-TOD and REGRAD readers, their ingest,
# use_view_clip and REGRAD training, language-ranked grasps ----

RAW_DIR = os.path.join(ROOT, "build", "raw")
RAW_SEED = 11
# the raw MV-TOD scene at the published shape (the ingest phase's scene)
RAW_VIEWS, RAW_HW, RAW_OBJECTS, RAW_POINTS = 73, (480, 640), 10, 400
# a raw REGRAD scene: 9 views at the ingest's default intrinsics (cx = cy
# = 420), 10 objects of 2000 points, so 20000 points per view cloud
REGRAD_HW, REGRAD_OBJECTS, REGRAD_POINTS = (840, 840), 10, 2000
REGRAD_VOXEL = 0.001  # the ingest's voxel pooling, m: the recipe's voxel
REGRAD_COS = 0.999  # card bf16 vs CPU float32: patch and per_obj rows
VIEW_CLIP_COS = 0.999  # card bf16 vs CPU float32: per-point view features
VIEW_CLIP_VIEWS = 24  # single views of the MV-TOD trainer: 3 steps of 8
RANK_TOL = 1e-5  # grasp scores, card vs CPU, of max|score|
RANK_RADIUS = 0.05


class Recorder:
    """A ``write=`` seam: calls ``write`` (None: nothing on disk) and
    keeps each scene's arrays by path."""

    def __init__(self, write=None):
        self.write, self.scenes = write, {}

    def __call__(self, path, **arrays):
        if self.write is not None:
            self.write(path, **arrays)
        self.scenes[path] = arrays


def raw_args(**kw):
    """``tools/preprocess_data``'s arguments (its defaults, .npz files)."""
    return SimpleNamespace(**{
        **dict(clip_model="ViT-L/14@336px", clip_checkpoint=None,
               visual_prompt="crop-mask", crop_num_levels=1,
               crop_expansion_ratio=0.15, batch_size=32, models_root=None,
               split="train", start=0, end=-1, format="npz", device="cuda",
               reader_config=os.path.join(ROOT, "configs", "REGRAD.yaml")),
        **kw})


def teacher_want(chunks, batches, texts=0):
    """Launches of ``chunks`` obj-prior chunks, ``batches`` patch batches
    and ``texts`` text encodes."""
    per = {k: TEACHER_LAUNCHES[1][k] * chunks + TEACHER_LAUNCHES[0][k]
           * batches for k in ("K3", "K6", "K7")}
    per["K6"] += 25 * texts
    return {**per, "K4": 0, "K5": 0}


def row_cos(a, b):
    """Min cosine of matched rows (float64)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(-1) / np.maximum(
        np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1), 1e-30)
    return float(cos.min()) if len(cos) else 1.0


def mvtod_raw_phase(extractor, report):
    """A raw MV-TOD scene at the published shape (73 views 480x640, 10
    objects, RLE masks, .npy depth) written by ``write_fake_raw_blender``,
    read through ``BlenderDataset`` (read and RLE decode timed), then
    ``run_blender`` in process with the .npz writer and the ingest
    phase's teacher (K3 24, K7 47, K6 3 per chunk + 25 for the queries);
    its scene against ``process_scene`` on the generator's arrays
    without the reader (xyz within INGEST_XYZ, labels equal, fused rows at
    cosine >= INGEST_COS); planted fault: two objects' hex colours
    swapped in ``col_to_ins``, which the label check must see. Returns
    (launches, raw root, processed root)."""
    from dropclip_tpu_torch import native
    from dropclip_tpu_torch.data import blender, scene_io
    from dropclip_tpu_torch.data.synthetic import (make_raw_scene,
                                                   write_fake_raw_blender)
    from dropclip_tpu_torch.tools import preprocess_data as pre

    root = os.path.join(RAW_DIR, "mvtod")
    proc = os.path.join(RAW_DIR, "mvtod_proc")
    for d in (root, proc):
        shutil.rmtree(d, ignore_errors=True)
    t = time.time()
    write_fake_raw_blender(root, n_scenes=1, n_objects=RAW_OBJECTS,
                           n_views=RAW_VIEWS, hw=RAW_HW, seed=RAW_SEED,
                           n_points_per_obj=RAW_POINTS)
    t_write = time.time() - t
    decode = [0.0, 0]
    inner = blender.anno_to_mask

    def timed_decode(*a):
        t0 = time.perf_counter()
        out = inner(*a)
        decode[0] += time.perf_counter() - t0
        decode[1] += 1
        return out

    ds = blender.BlenderDataset(root)
    with mock.patch.object(blender, "anno_to_mask", timed_decode):
        t = time.time()
        scene = ds[0]
        t_read = time.time() - t
    print(f"raw MV-TOD scene ({RAW_VIEWS} views {RAW_HW[0]}x{RAW_HW[1]}, "
          f"{RAW_OBJECTS} objects): written in {t_write:.2f} s, read in "
          f"{t_read:.3f} s, of which RLE decode {decode[0]:.3f} s for "
          f"{decode[1]} masks; RLE codec {native.route()}", flush=True)
    raw = make_raw_scene(np.random.default_rng(RAW_SEED),
                         n_objects=RAW_OBJECTS, n_points_per_obj=RAW_POINTS,
                         n_views=RAW_VIEWS, hw=RAW_HW)
    views = list(scene["views"].values())
    segs = np.stack(blender.BlenderDataset.obtain_seg_info(scene)[0])
    check(np.array_equal(np.stack([v["rgb"] for v in views]), raw["images"])
          and np.array_equal(np.stack([v["depth"] for v in views]),
                             raw["depths"])
          and np.array_equal(segs, raw["segs"]),
          "the reader's arrays differ from the written scene's")

    rec = Recorder(scene_io.write_scene)
    # the ingest phase's 5 mm: run_blender scales by the scene's
    # base_scale (10 in the writer's objects.init)
    args = raw_args(root=root, out=proc, voxel_size=0.005 / 10.0)
    chunks0 = extractor.chunks
    with mock.patch.object(pre, "build_extractor",
                           lambda a, device=None: extractor), \
            Launches() as counted:
        results = pre.run_blender(args, write=rec)
    chunks = extractor.chunks - chunks0
    check(len(results) == 1, f"run_blender results {results}")
    path, stats = results[0]
    got = rec.scenes[path]
    want = teacher_want(chunks, 0, texts=1)
    print(f"run_blender (in process, .npz): {counted.wall:.3f} s wall; "
          f"{stats}; {chunks} chunks, launches {counted.n}", flush=True)
    check(counted.n == want, f"run_blender launches {counted.n}, want "
          f"{want}")
    check(stats["points"] > 0 and stats["dropped"] == 0,
          f"run_blender stats {stats}")

    def direct(seg_stack):
        r = Recorder()
        pre.process_scene(images=raw["images"], depths=raw["depths"],
                      segs=seg_stack, poses=raw["poses"],
                      K=pre._intrinsic_matrix(scene["camera_intrinsic"]),
                      obj_info=scene["objects_info"], extractor=extractor,
                      out_path="direct", voxel_size=0.005, write=r)
        return r.scenes["direct"]

    ref = direct(raw["segs"])
    same = (got["xyz"].shape == ref["xyz"].shape
            and np.array_equal(got["label"], ref["label"]))
    xyz_d = (float(np.abs(got["xyz"] - ref["xyz"]).max()) if same
             else float("inf"))
    cos = row_cos(got["obj_feats"], ref["obj_feats"])
    # planted fault: objects 1 and 2 swap colours in the reader's table
    bad = dict(scene, col_to_ins=dict(scene["col_to_ins"]))
    h1, h2 = (scene["objects_info"][k]["hex_id"] for k in (1, 2))
    bad["col_to_ins"][h1], bad["col_to_ins"][h2] = (
        bad["col_to_ins"][h2], bad["col_to_ins"][h1])
    fault = direct(np.stack(blender.BlenderDataset.obtain_seg_info(bad)[0]))
    fault_same = (fault["label"].shape == ref["label"].shape
                  and np.array_equal(fault["label"], ref["label"]))
    print(f"run_blender vs process_scene on the generator's arrays: points "
          f"{len(got['xyz'])} / {len(ref['xyz'])}, labels equal {same}, "
          f"xyz max |d| {xyz_d:.3e}, fused rows min cosine {cos:.6f}; "
          f"planted fault (two hex colours swapped): labels equal "
          f"{fault_same}", flush=True)
    check(same and xyz_d <= INGEST_XYZ and cos >= INGEST_COS,
          "run_blender's scene differs from process_scene's")
    check(not fault_same, "the label check does not see two objects' "
          "colours swapped")
    report["raw_mvtod"] = dict(
        write_s=t_write, read_s=t_read, rle_decode_s=decode[0],
        masks=decode[1], rle_route=native.route(), wall_s=counted.wall,
        stats=stats, chunks=chunks, launches=counted.n, xyz_max=xyz_d,
        min_cos=cos, fault_labels_equal=fault_same)
    return counted.n, root, proc


def raw_run_eval_phase(extractor, root, report):
    """``tools.run_eval -ds Blender`` on the raw tree in both fusion modes
    (in process, the ingest phase's teacher): per mode, launches from the
    counters against the chunks, patch batches and text encodes."""
    from dropclip_tpu_torch.tools import run_eval

    total, rows = dict(K3=0, K6=0, K7=0), {}
    for mode, tag in ((1, "obj_prior"), (0, "patch")):
        argv = ["-ds", "Blender", "-r", root, "--voxel_size", "0.005",
                "--cloud_capacity", str(INGEST_CAPACITY),
                "--use_obj_prior", str(mode)]
        chunks0 = extractor.chunks
        with mock.patch.object(run_eval, "build_extractor",
                               lambda a, device=None: extractor), \
                mock.patch.object(extractor.model, "encode_text",
                                  wraps=extractor.model.encode_text) as enc, \
                Launches() as counted:
            summary = run_eval.main(argv)
        texts = enc.call_count
        chunks = extractor.chunks - chunks0
        batches = 0 if mode else -(-RAW_VIEWS // extractor.batch_size)
        want = teacher_want(chunks, batches, texts)
        print(f"run_eval -ds Blender {tag}: {counted.wall:.3f} s wall; "
              f"{summary['mean']}; {chunks} chunks, {batches} patch "
              f"batches, {texts} text encodes, launches {counted.n}",
              flush=True)
        check(counted.n == want, f"run_eval -ds Blender {tag}: launches "
              f"{counted.n}, want {want}")
        check(summary["n_scenes"] == 1 and texts > 1 and all(
            np.isfinite(v) for v in summary["mean"].values()),
            f"run_eval -ds Blender {tag}: {summary}")
        rows[tag] = dict(wall_s=counted.wall, mean=summary["mean"],
                         launches=counted.n, text_encodes=texts)
        for k in total:
            total[k] += counted.n[k]
    report["raw_run_eval"] = rows
    return total


def regrad_reader_cfg(root):
    from dropclip_tpu_torch.core.config import load_cfg, merge_cfg_from_list

    cfg = load_cfg(os.path.join(ROOT, "configs", "REGRAD.yaml"))
    cfg = merge_cfg_from_list(cfg, ["root_dir", root])
    cfg.reference_frame = "world"
    return cfg


def regrad_ingest_phase(extractor, report):
    """Raw REGRAD scenes (9 views at 840x840, 10 objects, 20000 points a
    view cloud; 3 train, 1 seen_val) through ``run_regrad`` in process
    with the .npz writer and the ingest phase's teacher (patches: one
    batch of 9, K3 23, K7 45, K6 4; class tokens of the present pairs: K3
    24, K7 47, K6 3 a chunk). Returns (launches, raw root, processed
    root, {split: scene ids})."""
    from dropclip_tpu_torch.data import scene_io
    from dropclip_tpu_torch.data.synthetic import write_fake_raw_regrad
    from dropclip_tpu_torch.tools import preprocess_data as pre

    root = os.path.join(RAW_DIR, "regrad")
    proc = os.path.join(RAW_DIR, "regrad_proc")
    for d in (root, proc):
        shutil.rmtree(d, ignore_errors=True)
    t = time.time()
    sids = {split: write_fake_raw_regrad(
        root, n_scenes=n, n_objects=REGRAD_OBJECTS, n_views=9,
        points_per_obj=REGRAD_POINTS, hw=REGRAD_HW, split=split, seed=seed)
        for split, n, seed in (("train", 3, 0), ("seen_val", 1, 1))}
    print(f"raw REGRAD scenes written in {time.time() - t:.2f} s", flush=True)
    total, rows = dict(K3=0, K6=0, K7=0), {}
    for split in sids:
        rec = Recorder(scene_io.write_regrad_scene)
        chunks0 = extractor.chunks
        with mock.patch.object(pre, "build_extractor",
                               lambda a, device=None: extractor), \
                Launches() as counted:
            results = pre.run_regrad(raw_args(root=root, out=proc,
                                              split=split,
                                              voxel_size=REGRAD_VOXEL),
                                     write=rec)
        chunks = extractor.chunks - chunks0
        want = teacher_want(chunks, len(results))
        for sid, st in results:
            print(f"run_regrad {split} {sid}: {st}", flush=True)
            check(st["views"] == 9 and st["objects"] == REGRAD_OBJECTS
                  and st["points"] > REGRAD_OBJECTS * REGRAD_POINTS // 4,
                  f"run_regrad {sid}: {st}")
        for arrays in rec.scenes.values():
            check(np.isfinite(arrays["patch"]).all()
                  and np.isfinite(arrays["per_obj"]).all(),
                  "run_regrad wrote non-finite features")
        print(f"run_regrad {split}: {len(results)} scenes in "
              f"{counted.wall:.3f} s; {chunks} chunks; launches "
              f"{counted.n}", flush=True)
        check(len(results) == len(sids[split]) and counted.n == want,
              f"run_regrad {split}: launches {counted.n}, want {want}")
        rows[split] = dict(wall_s=counted.wall, chunks=chunks,
                           launches=counted.n,
                           scenes={s: st for s, st in results})
        for k in total:
            total[k] += counted.n[k]
    report["raw_regrad_ingest"] = rows
    return total, root, proc, sids


def view_clip_train_phase(extractor, mvtod_root, mvtod_proc, report):
    """The MV-TOD trainer (configs/DistilBlender.yaml: MinkUNet14D,
    batch 8) for 3 steps with ``use_view_clip`` on single views of the
    ingested scene, ``raw_root`` the raw tree: the student's stem 774
    wide, the patch teacher the ingest phase's (the same seeded ViT-L/14@
    336px the dataset would build). K1 32 per step; K3 23, K7 45, K6 4 per
    patch-map miss. Returns (K1 launches, K3-K7 launches)."""
    from dropclip_tpu_torch.data import build_dataset_for
    from dropclip_tpu_torch.kernels.brick_conv3 import counter
    from dropclip_tpu_torch.teachers import convert
    from dropclip_tpu_torch.tools import train_distil

    saves = os.path.join(RAW_DIR, "view_clip_ckpt")
    made = []

    def capture(cfg, device=None):
        out = build_dataset_for(cfg, device)
        made.append(out[0])
        return out

    argv = ["--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
            "--opts", "root_dir", mvtod_proc, "raw_root", mvtod_root,
            "use_view_clip", "True", "use_k_views", "0", "use_view_ids",
            # quoted: --opts would read "0,1,..." as a tuple literal
            repr(",".join(str(v) for v in range(VIEW_CLIP_VIEWS))),
            "voxel_size", "0.005", "evaluate", "False", "epochs", "1",
            "print_freq", "1", "save_path", saves]
    torch.cuda.reset_peak_memory_stats()
    try:
        with mock.patch.object(train_distil, "build_dataset_for", capture), \
                mock.patch.object(convert, "build_clip_from",
                                  lambda *a, **k: extractor.model), \
                Launches() as counted:
            counter.launches = 0
            ckpt = train_distil.main(argv)
            k1 = counter.launches
        with open(os.path.join(ckpt, "train.log")) as f:
            log = f.read()
    finally:
        shutil.rmtree(saves, ignore_errors=True)
    ds = made[0]
    misses = ds.vc_misses
    steps = [float(x) for x in re.findall(r"Batch ([0-9.]+) \(", log)]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    want = teacher_want(0, misses)
    print(f"use_view_clip training (3 steps of 8 single views, MinkUNet14D "
          f"stem {ds[0]['in_feats'].shape[-1]} wide): {counted.wall:.1f} s "
          f"wall, steps {steps} s, peak {peak:.2f} GiB; K1 {k1}; "
          f"{misses} patch-map misses, launches {counted.n}", flush=True)
    check(k1 == 32 * 3, f"use_view_clip training: K1 {k1}, want 96")
    check(counted.n == want and misses == VIEW_CLIP_VIEWS,
          f"use_view_clip training: launches {counted.n} over {misses} "
          f"misses, want {want}")
    check(len(steps) == 3 and "dropped by brick" not in log,
          f"use_view_clip training: steps {steps}, or voxels dropped")
    report["view_clip_train"] = dict(wall_s=counted.wall, steps_s=steps,
                                     peak_gib=peak, k1=k1, misses=misses,
                                     launches=counted.n)
    return k1, counted.n


def raw_phase(extractor, report):
    """The raw datasets' paths that run the ingest teacher. Returns the
    state the later raw phases take."""
    t = time.time()
    n1, mvtod_root, mvtod_proc = mvtod_raw_phase(extractor, report)
    n2 = raw_run_eval_phase(extractor, mvtod_root, report)
    n3, regrad_root, regrad_proc, sids = regrad_ingest_phase(extractor,
                                                             report)
    k1, n4 = view_clip_train_phase(extractor, mvtod_root, mvtod_proc,
                                   report)
    secs = time.time() - t
    print(f"raw datasets, teacher part: {secs:.1f} s", flush=True)
    return dict(seconds=secs, k1=k1,
                n={k: n1[k] + n2[k] + n3[k] + n4[k]
                   for k in ("K3", "K6", "K7")},
                mvtod_root=mvtod_root, regrad_root=regrad_root,
                regrad_proc=regrad_proc, sids=sids)


def no_flip_pixels(xyz, pose, K, hw):
    """``preprocess_data._pixels`` without the REGRAD camera flip (the
    planted fault)."""
    from dropclip_tpu_torch.geom.transforms import \
        transform_pointcloud_to_camera_frame

    cam = transform_pointcloud_to_camera_frame(
        torch.as_tensor(xyz, dtype=torch.float32),
        torch.as_tensor(pose, dtype=torch.float32)).numpy()
    uvw = cam @ K.T
    z = np.where(np.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
    uv = uvw[:, :2] / z[:, None]
    return (np.clip(uv[:, 1].astype(int), 0, hw[0] - 1),
            np.clip(uv[:, 0].astype(int), 0, hw[1] - 1))


def two_layer_teachers():
    """ViT-L/14@336px cut to 2 vision layers at full width, the same
    seeded weights: bf16 on the card, float32 on the CPU."""
    from dropclip_tpu_torch.teachers.clip import build_clip
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    return {dev: ClipExtractor(build_clip(
        "ViT-L/14@336px", dtype=dt, generator=torch.Generator().manual_seed(
            SEED), device=dev, vision_layers=2), chunk=16)
        for dev, dt in (("cuda", torch.bfloat16), ("cpu", torch.float32))}


def regrad_cpu_phase(teachers, report):
    """A reduced REGRAD scene (3 views at 168x168, 4 objects of 300
    points) through ``process_regrad_scene`` on the card (bf16) and the
    CPU (float32), 2-layer ViT-L: xyz, labels and object ids equal, patch
    and per_obj rows at cosine >= REGRAD_COS; planted fault: the camera's
    y/z flip left out, which must empty or change the kept set."""
    from dropclip_tpu_torch.data.regrad import RegradDataset
    from dropclip_tpu_torch.data.synthetic import write_fake_raw_regrad
    from dropclip_tpu_torch.tools import preprocess_data as pre

    root = os.path.join(RAW_DIR, "regrad_reduced")
    shutil.rmtree(root, ignore_errors=True)
    K = np.array([[224.0, 0, 84], [0, 224.0, 84], [0, 0, 1]], np.float32)
    write_fake_raw_regrad(root, n_scenes=1, n_objects=4, n_views=3,
                          points_per_obj=300, hw=(168, 168), K=K, seed=2)
    ds = RegradDataset(regrad_reader_cfg(root), "train")
    scene = ds[0]
    poses = {v: np.asarray(ds.camera_info["extrinsic"][v])
             for v in range(1, 10)}
    K = pre.regrad_intrinsics(ds.camera_info)
    out = {}
    for dev, ex in teachers.items():
        rec = Recorder()
        stats = pre.process_regrad_scene(scene, poses, K, ex, dev,
                                         REGRAD_VOXEL, write=rec)
        out[dev] = (stats, rec.scenes[dev])
    (sg, g), (sc, c) = out["cuda"], out["cpu"]
    equal = all(g[k].shape == c[k].shape and np.array_equal(g[k], c[k])
                for k in ("xyz", "label", "obj_ids"))
    cos = {k: row_cos(g[k], c[k]) if equal else -1.0
           for k in ("patch", "per_obj")}
    with mock.patch.object(pre, "_pixels", no_flip_pixels):
        rec = Recorder()
        fs = pre.process_regrad_scene(scene, poses, K, teachers["cpu"],
                                      "fault", REGRAD_VOXEL, write=rec)
    fault = rec.scenes.get("fault")
    fault_same = fault is not None and fault["xyz"].shape == \
        c["xyz"].shape and np.array_equal(fault["xyz"], c["xyz"])
    print(f"REGRAD card vs CPU (3 views 168x168, 4 objects, 2-layer ViT-L, "
          f"bf16 vs float32): points {sg['points']} / {sc['points']}, xyz, "
          f"labels and ids equal {equal}, min cosine {cos}; planted fault "
          f"(no y/z flip): {fs}, kept set equal {fault_same}", flush=True)
    check(equal and min(cos.values()) >= REGRAD_COS,
          "REGRAD ingest card vs CPU outside its tolerances")
    check(not fault_same, "the kept-set check does not see the camera "
          "flip left out")
    report["raw_regrad_card_vs_cpu"] = dict(points=[sg["points"],
                                                    sc["points"]],
                                            equal=equal, min_cos=cos,
                                            fault=fs, limit=REGRAD_COS)


def view_clip_cpu_phase(teachers, mvtod_root, report):
    """Per-point view features of one MV-TOD view (``_view_clip_features``
    of the dataset) on the card (bf16) and the CPU (float32), 2-layer
    ViT-L, at cosine >= VIEW_CLIP_COS; planted fault: the y flip left out
    of the projection, which the limit must see."""
    from dropclip_tpu_torch.core.config import CfgNode
    from dropclip_tpu_torch.data import dataset_blender
    from dropclip_tpu_torch.data.scene_io import read_scene

    proc = os.path.join(RAW_DIR, "mvtod_proc")
    pts = read_scene(os.path.join(proc, "train", "000000",
                                  "000000.npz")).xyz
    cfg = CfgNode(dict(root_dir=proc, raw_root=mvtod_root, use_view_clip=True,
                       use_k_views=0, use_view_ids="5", use_full_pc=False))
    feats = {}
    for dev, ex in teachers.items():
        ex.set_mode("patch")
        ds = dataset_blender.MVTODDataset(cfg, "train", device=dev)
        ds._vc_extractor = ex
        feats[dev] = ds._view_clip_features(pts, "000000", 5)
    cos = row_cos(feats["cuda"], feats["cpu"])
    inner = dataset_blender.view_clip_pixels

    def no_y_flip(xyz, pose, K, hw):
        # a pose with its y axis negated: its inverse negates the camera's
        # y, which the flip then undoes
        return inner(xyz, pose @ np.diag([1.0, -1.0, 1.0, 1.0]), K, hw)

    with mock.patch.object(dataset_blender, "view_clip_pixels", no_y_flip):
        fault = row_cos(ds._view_clip_features(pts, "000000", 5),
                        feats["cpu"])
    print(f"view features card vs CPU ({len(pts)} points, view 5, 2-layer "
          f"ViT-L, bf16 vs float32): min cosine {cos:.6f}; planted fault "
          f"(no y flip): {fault:.6f}", flush=True)
    check(cos >= VIEW_CLIP_COS, "view features card vs CPU below the limit")
    check(fault < VIEW_CLIP_COS, "the limit does not see the y flip left out")
    report["view_clip_card_vs_cpu"] = dict(min_cos=cos, fault_cos=fault,
                                           limit=VIEW_CLIP_COS)


def regrad_train_data(proc, raw_root, sids):
    """The trainer's REGRAD tree: each ingested scene linked 16 times into
    train (48 scenes: 3 steps of 16) and 4 times into seen_val (2 val
    batches of 2), with the object lists of the copies. Returns (tree,
    objects json of train, of seen_val)."""
    data = os.path.join(RAW_DIR, "regrad_train")
    shutil.rmtree(data, ignore_errors=True)
    paths = {}
    for split, copies, src in (("train", 16, "objects_single.json"),
                               ("seen_val", 4, "objects_refer_test.json")):
        os.makedirs(os.path.join(data, split))
        with open(os.path.join(raw_root, src)) as f:
            objs = json.load(f)
        out = {}
        for sid in sids[split]:
            for j in range(copies):
                name = f"{sid}c{j:02d}"
                os.symlink(os.path.join(proc, split, f"{sid}.npz"),
                           os.path.join(data, split, f"{name}.npz"))
                out[name] = objs[sid]
        paths[split] = os.path.join(data, f"objects_{split}.json")
        with open(paths[split], "w") as f:
            json.dump(out, f)
    return data, paths["train"], paths["seen_val"]


def regrad_opts(state):
    """The trainer's and viz's --opts on the REGRAD tree. Bricks of
    (2, 2, 2): at the recipe's 1 mm voxels a 10000-point sample of
    surfaces fills about 2 of the 32 cells of a (4, 4, 2) brick, and
    that layout needs more than the card's 80 GB at batch 16, remat or
    not (PERF.md, the raw datasets)."""
    data, train_objs, val_objs = state["regrad_train"]
    return ["processed_dir", data, "objects_train_path", train_objs,
            "objects_val_path", val_objs, "cls_map_path",
            os.path.join(state["regrad_root"], "cls_map.json"),
            "clip_checkpoint", "random", "brick_shape", "[2, 2, 2]"]


def plain_by_scenes(x, dy, lv, w, scenes, budget=2 ** 33):
    """K1's plain version and autograd of it (dgrad on the occupied
    voxels) on a folded level of ``scenes`` scenes, computed a few scenes
    at a time: no neighbour row leaves its scene's block of rows, so each
    group is a level of its own (misses renumbered to its zero row), and
    the plain version's unfolded patches of a group stay within
    ``budget`` bytes. Returns (forward, dgrad) for the whole level."""
    from dropclip_tpu_torch.kernels.brick_conv3 import brick_conv3_plain

    bm = lv.occ.shape[0]
    cap, voxels = bm // scenes, lv.occ[0].numel()
    per = max(1, budget // (cap * voxels * 27 * max(x.shape[-1],
                                                    dy.shape[-1]) * 4))
    ref, gref = torch.empty_like(dy), torch.empty_like(x)
    for s0 in range(0, scenes, per):
        r0, r1 = s0 * cap, min(scenes, s0 + per) * cap
        nbr = lv.nbr[r0:r1].long()
        nbr = torch.where(nbr >= bm, r1 - r0, nbr - r0)
        xs = x[r0:r1].clone().requires_grad_()
        out = brick_conv3_plain(xs, nbr, w, lv.occ[r0:r1])
        (g,) = torch.autograd.grad(out, xs, dy[r0:r1])
        ref[r0:r1] = out.detach()
        gref[r0:r1] = g * lv.occ[r0:r1, ..., None]
        del xs, out, g
    return ref, gref


def regrad_k1_phase(state, report):
    """K1 at the REGRAD trainer's layout, (2, 2, 2) bricks, which no other
    phase holds: the topology of the trainer's batch (its first 16 train
    scenes, augmented, at 1 mm, capacities autotuned as the trainer does,
    on the grid ``build_topology`` picks, which must drop nothing),
    folded; at each of MinkUNet14D's 16 k3 convs, seeded features on the
    level's occupancy and He-scaled weights in float32 (the trainer's
    dtype), K1's forward and its dgrad (K1 on ``dY * occ`` with
    ``mirror_taps``, the level's row schedule, as ``BrickConv3Fn`` runs
    them) against ``brick_conv3_plain`` and autograd of it on the occupied
    voxels (``plain_by_scenes``), within ``k1_close``; planted fault: the
    dgrad's taps transposed but not mirrored, which must fall outside
    it."""
    import logging

    from dropclip_tpu_torch.data import build_dataset_for
    from dropclip_tpu_torch.distill.engine import (brick_shape_of,
                                                   build_student_for,
                                                   build_topology)
    from dropclip_tpu_torch.kernels import brick_conv3 as k1
    from dropclip_tpu_torch.sparse.bricks import (build_brick_topology,
                                                  fold_topology,
                                                  grid_bits_for)
    from dropclip_tpu_torch.tools import train_distil

    t = time.time()
    cfg, device = train_distil.get_parser(
        ["--config", os.path.join(ROOT, "configs", "DistilREGRAD.yaml"),
         "--opts", *regrad_opts(state)])
    ds, _, collate = build_dataset_for(cfg, device)
    train_distil.autotune_capacities(cfg, ds, collate,
                                     logging.getLogger("chip_smoke"))
    b = collate([ds[i] for i in range(int(cfg.batch_size))])
    coords = torch.as_tensor(b["coords"], device="cuda")
    mask = torch.as_tensor(b["mask"], device="cuda")
    bits = grid_bits_for(coords, mask)
    topo = build_topology(cfg, coords, mask)
    dropped = int(topo.dropped.sum())
    fixed = int(build_brick_topology(
        coords, mask, grid_bits=5, brick_capacities=cfg.brick_capacities,
        brick_shape=brick_shape_of(cfg)).dropped.sum())
    print(f"REGRAD batch ({len(mask)} scenes, {int(mask.sum())} voxels, "
          f"bricks {cfg.brick_shape}): grid_bits {bits} (+-"
          f"{2 ** (bits + 1)} voxels), capacities {cfg.brick_capacities}, "
          f"{dropped} voxels/bricks dropped ({fixed} at the JAX package's "
          f"fixed grid_bits 5)", flush=True)
    topo = fold_topology(topo)
    shapes = main_path_shapes(build_student_for(cfg))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    scheds, rows = {}, []
    torch.cuda.reset_peak_memory_stats()
    for i, (lvl, c, cout) in enumerate(shapes):
        lv = topo.levels[lvl]
        if lvl not in scheds:
            scheds[lvl] = k1.row_order(lv.occ, lv.nbr)
        sched = scheds[lvl]
        occf = lv.occ[..., None].float()
        x, w = k1_inputs(lv, c, cout, torch.float32, gen)
        dy = torch.randn(tuple(lv.occ.shape) + (cout,), generator=gen,
                         device="cuda") * occf
        ref, gref = plain_by_scenes(x, dy, lv, w, len(mask))
        fwd = k1_close(k1_call(k1.brick_conv3, x, lv, w, sched), ref,
                       torch.float32)
        dgrad = k1_close(k1_call(k1.brick_conv3, dy, lv, k1.mirror_taps(w),
                                 sched), gref, torch.float32)
        fault = k1_close(k1_call(k1.brick_conv3, dy, lv,
                                 w.transpose(1, 2).contiguous(), sched),
                         gref, torch.float32)
        torch.cuda.synchronize()
        row = dict(shape=i, level=lvl, bm=lv.occ.shape[0], c=c, cout=cout,
                   forward_rel=fwd[1] / fwd[2], dgrad_rel=dgrad[1] / dgrad[2],
                   fault_rel=fault[1] / fault[2])
        rows.append(row)
        print(f"K1 REGRAD (2, 2, 2) L{lvl} {c:4d}->{cout:4d} Bm="
              f"{row['bm']:6d}: forward rel {row['forward_rel']:.3e}, dgrad "
              f"rel {row['dgrad_rel']:.3e}; planted fault (taps not "
              f"mirrored) rel {row['fault_rel']:.3e}", flush=True)
        check(fwd[0] and dgrad[0], f"K1 at the REGRAD layout, shape {i} "
              f"(L{lvl} {c}->{cout}): forward {fwd}, dgrad {dgrad}")
        check(not fault[0], f"K1 at the REGRAD layout, shape {i}: the "
              f"unmirrored dgrad taps read within the limit ({fault})")
        del x, w, dy, ref, gref
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del topo, coords, mask
    torch.cuda.empty_cache()
    check(dropped == 0, f"the REGRAD batch lost {dropped} voxels/bricks")
    summary = dict(grid_bits=bits, dropped=dropped, dropped_at_bits5=fixed,
                   capacities=list(cfg.brick_capacities),
                   forward_rel=max(r["forward_rel"] for r in rows),
                   dgrad_rel=max(r["dgrad_rel"] for r in rows),
                   fault_rel_min=min(r["fault_rel"] for r in rows),
                   peak_gib=peak, seconds=time.time() - t)
    print(f"K1 at the REGRAD layout: {summary}", flush=True)
    report["regrad_k1"] = dict(summary, rows=rows)
    return summary


def regrad_train_phase(state, report):
    """``tools/train_distil`` (its main, in process) under
    configs/DistilREGRAD.yaml at its recipe (MinkUNet14D, 768-d, feat_key
    per_obj, batch 16, voxel 1 mm, 8192 voxels; bricks of (2, 2, 2), see
    ``regrad_opts``) for one epoch of 3 steps
    on the ingested scenes, with grounding eval on the seen_val REGRAD
    queries ({name: [ids]}, the ViT-L text tower in bf16, weights from
    seed 0): K1 32 per step and 16 per val batch, step times, peak
    memory, nothing dropped. Keeps the checkpoint for viz_query. Returns
    the K1 and K6 launches."""
    from dropclip_tpu_torch.kernels.brick_conv3 import counter
    from dropclip_tpu_torch.tools import train_distil

    saves = os.path.join(RAW_DIR, "regrad_ckpt")
    argv = ["--config", os.path.join(ROOT, "configs", "DistilREGRAD.yaml"),
            "--opts", *regrad_opts(state), "epochs", "1", "print_freq", "1",
            "eval_task", "grounding", "save_path", saves]
    torch.cuda.reset_peak_memory_stats()
    with Launches() as counted:
        counter.launches = 0
        ckpt = train_distil.main(argv)
        k1 = counter.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(ckpt, "train.log")) as f:
        log = f.read()
    steps = [float(x) for x in re.findall(r"Batch ([0-9.]+) \(", log)]
    evals = re.findall(r"Eval Grounding: Epoch=\[0/1\] (\{[^}]*\})", log)
    metrics = json.loads(evals[0].replace("'", '"')) if evals else {}
    val_batches = 4 * len(state["sids"]["seen_val"]) // 2
    # the trainer logs what capacity or the grid's extent dropped
    dropped = sum(int(x) for x in re.findall(
        r"(\d+) voxels/bricks dropped", log))
    print(f"REGRAD training (DistilREGRAD.yaml, batch 16, 3 steps): "
          f"{counted.wall:.1f} s wall, steps {steps} s, peak {peak:.2f} "
          f"GiB; K1 {k1}, launches {counted.n}; {dropped} voxels/bricks "
          f"dropped; Eval Grounding {metrics}", flush=True)
    check(dropped == 0, f"REGRAD training dropped {dropped} voxels/bricks")
    check(k1 == 32 * 3 + 16 * val_batches,
          f"REGRAD training: K1 {k1}, want {32 * 3 + 16 * val_batches}")
    check(len(steps) == 3 and metrics and all(
        np.isfinite(v) for v in metrics.values()),
        f"REGRAD training: steps {steps}, eval {metrics}")
    state["regrad_ckpt"], state["regrad_saves"] = ckpt, saves
    report["regrad_train"] = dict(wall_s=counted.wall, steps_s=steps,
                                  peak_gib=peak, k1=k1, dropped=dropped,
                                  launches=counted.n, eval=metrics)
    return k1, counted.n["K6"]


def check_rank(order, score, ref_order, ref_score):
    """Card scores within RANK_TOL of max|score| of the CPU's, and the
    top-10 order equal wherever neighbouring CPU scores are more than
    that apart. Returns (max |d| / max|ref|, order equal) without
    raising."""
    order, score = order.cpu(), score.cpu().double()
    ref_score = ref_score.double()
    scale = float(ref_score.abs().max())
    err = float((score - ref_score).abs().max()) / max(scale, 1e-30)
    ranked = ref_score[ref_order]
    gaps = (ranked[1:] - ranked[:-1]) < -RANK_TOL * scale
    clear = torch.ones(len(ranked), dtype=torch.bool)
    clear[1:] &= gaps
    clear[:-1] &= gaps
    clear[10:] = False
    return err, bool(torch.equal(order[clear], ref_order[clear]))


def viz_query_phase(state, report):
    """``tools.make_visualizations`` with ``viz_query`` on the REGRAD
    checkpoint (2 seen_val scenes): K1 16 per student forward, K6 25 per
    text encode (the query and the negatives, cached after the first
    scene), every file; each ``rank_grasps_by_query`` call on the card
    against the CPU on the same inputs (scores within RANK_TOL of
    max|score|, the top-10 order where scores are that far apart), timed;
    planted fault: the radius compared unsquared."""
    from dropclip_tpu_torch.grasp import grasps
    from dropclip_tpu_torch.kernels.brick_conv3 import counter
    from dropclip_tpu_torch.tools import make_visualizations
    from dropclip_tpu_torch.viz import load_pcd

    out = os.path.join(ROOT, "chiprun_out", "raw_viz")
    shutil.rmtree(out, ignore_errors=True)
    inner, calls = grasps.rank_grasps_by_query, []

    def record(*a, **k):
        res = inner(*a, **k)
        calls.append((a, k, res))
        return res

    argv = ["--config", os.path.join(ROOT, "configs", "DistilREGRAD.yaml"),
            "--opts", *regrad_opts(state), "resume", state["regrad_ckpt"],
            "viz_dir", out, "max_scenes", "2", "viz_query", "the red mug"]
    try:
        with mock.patch.object(grasps, "rank_grasps_by_query", record), \
                Launches() as counted:
            counter.launches = 0
            make_visualizations.main(argv)
            k1 = counter.launches
    finally:
        shutil.rmtree(state["regrad_saves"], ignore_errors=True)
    names = sorted(os.listdir(out))
    check(k1 == 16 * 2 and counted.n["K6"] == 25 * 2,
          f"viz_query: K1 {k1} (want 32), K6 {counted.n['K6']} (want 50)")
    check(len(names) == 2 * 9 and len(calls) == 2,
          f"viz_query wrote {names}, ranked {len(calls)} times")
    xyz, col = load_pcd(os.path.join(out, names[0]))
    check(len(xyz) > 0 and np.isfinite(xyz).all() and col is not None,
          f"viz_query: {names[0]} does not read back")
    rows = []
    for a, k, (order, score) in calls:
        cpu = [x.cpu() if torch.is_tensor(x) else x for x in a]
        ref_order, ref_score = inner(*cpu, **k)
        err, same = check_rank(order, score, ref_order, ref_score)
        ferr, fsame = check_rank(*inner(*a, radius=RANK_RADIUS ** 0.5),
                                 ref_order, ref_score)
        ms = cuda_ms(lambda: inner(*a, **k), reps=20)
        rows.append(dict(points=len(a[0]), grasps=len(a[3]), err=err,
                         order_equal=same, fault_err=ferr,
                         fault_order_equal=fsame, ms=ms))
        print(f"rank_grasps_by_query card vs CPU ({len(a[0])} points, "
              f"{len(a[3])} grasps): max |d| {err:.2e} of max|score|, top-10"
              f" order equal {same}, {ms:.3f} ms on the card; planted fault "
              f"(radius unsquared): {ferr:.2e}, order equal {fsame}",
              flush=True)
        check(err <= RANK_TOL and same, "grasp ranking card vs CPU outside "
              "its tolerance")
        check(ferr > RANK_TOL or not fsame, "the ranking check does not see "
              "the radius compared unsquared")
    print(f"viz_query: {len(names)} files, K1 {k1}, launches {counted.n}",
          flush=True)
    report["viz_query"] = dict(files=names, k1=k1, launches=counted.n,
                               ranking=rows)
    return k1, counted.n["K6"]


def raw_check_phase(state, report):
    """The raw datasets' paths after the ingest teacher is gone: REGRAD
    and view-feature card-vs-CPU checks, K1 at the REGRAD trainer's
    layout, REGRAD training, viz_query.
    Deletes build/raw/. Returns the launches of K1 (both trainers and
    viz_query) and K6 (the REGRAD trainer's eval and viz_query)."""
    t = time.time()
    try:
        teachers = two_layer_teachers()
        regrad_cpu_phase(teachers, report)
        view_clip_cpu_phase(teachers, state["mvtod_root"], report)
        del teachers
        state["regrad_train"] = regrad_train_data(
            state["regrad_proc"], state["regrad_root"], state["sids"])
        regrad_k1_phase(state, report)
        k1_train, k6_train = regrad_train_phase(state, report)
        k1_viz, k6_viz = viz_query_phase(state, report)
    finally:
        shutil.rmtree(RAW_DIR, ignore_errors=True)
    secs = state["seconds"] + time.time() - t
    print(f"raw datasets phase: {secs:.1f} s in all", flush=True)
    report["raw_seconds"] = secs
    return state["k1"] + k1_train + k1_viz, k6_train + k6_viz


# the teachers: DINOv2, DINO v1, the RN towers and the extraction CLIs
TEACHER_DIR = os.path.join(ROOT, "build", "teachers")
DINOV2_SIZES = ((336, 448), (518, 518), (672, 896))
TEACHER_COS = 0.999  # card bf16 against CPU float32, min cosine per row
# RN50's pooled features: the attention pool's logits are small on seeded
# weights, so its planted fault (q and k swapped) moves them little
RN_POOL_COS = 0.9999
TEACHER_TAGS = (("K3/K4/K5", "attention_kernel"), ("K6", "_ln_rows"),
                ("K7", "_add_ln_rows"))
DINO_V1_REL = 1e-4  # DINO v1 float32 card against CPU, of max|ref|


def add_launches(total, n):
    for k, v in n.items():
        total[k] = total.get(k, 0) + v


def expect(n, what, **want):
    """The counts ``n`` equal ``want`` (kernels not named: 0)."""
    full = {k: want.get(k, 0) for k in ("K3", "K4", "K5", "K6", "K7")}
    check(n == full, f"{what}: launches {n}, want {full}")


def min_cos(a, b):
    """Min cosine over the last-axis vectors of two tensors (any device,
    any dtype)."""
    a, b = (x.detach().float().cpu().reshape(-1, x.shape[-1])
            for x in (a, b))
    return float(torch.nn.functional.cosine_similarity(a, b).min())


def dinov2_route(t):
    """The kernel the JAX predicates name for DINOv2-L/14 (16 heads of
    64) in bf16 at T tokens."""
    from dropclip_tpu_torch.ops import attention as att

    if att.supports_packed(t, 16, 64, False, itemsize=2):
        return "K3"
    return "K4" if att.supports(t, 64, False, itemsize=2) else "K5"


def npy_frames(frames, tag):
    """The frames as .npy files under build/teachers/<tag>/, which the
    CLIs read with ``np.load`` in place of their cv2 image reader (the
    frames are arrays, and cv2 is optional); returns the glob."""
    d = os.path.join(TEACHER_DIR, tag)
    os.makedirs(d, exist_ok=True)
    for i, f in enumerate(frames):
        np.save(os.path.join(d, f"frame{i:02d}.npy"), f)
    return os.path.join(d, "*.npy")


def npy_outputs(d):
    return {n: np.load(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def dinov2_phase(frames, total, report):
    """DINOv2-L/14 at full width in bf16 from a HuggingFace-layout file
    drawn from SEED, read through ``from_hf_dinov2`` as ``dino_extract``
    does: ``Dinov2Extractor`` on 8 frames at 336x448, 518x518 and
    672x896, each layer's attention on the kernel the JAX predicates name
    (K3, K4, K5), K6 2 and K7 47 per forward; card bf16 against the CPU in
    float32 at a depth cut to 2 layers at each size (cosine >= TEACHER_COS;
    planted fault: LayerScale ls1 dropped); ``dino_extract.main`` in cls
    and patch modes; a profile of one extract at each size. Returns the
    file's path (the caller deletes it)."""
    from dropclip_tpu_torch.teachers import dinov2
    from dropclip_tpu_torch.tools import dino_extract

    path = os.path.join(TEACHER_DIR, "dinov2_vitl14_hf_seed0.pt")
    t = time.time()
    torch.save(dinov2.synthetic_hf_dinov2_state_dict("dinov2_vitl14",
                                                     seed=SEED), path)
    made = time.time() - t
    t = time.time()
    sd = dinov2.from_hf_dinov2(torch.load(path, map_location="cpu"))
    model = dinov2.build_dinov2("dinov2_vitl14", dtype=torch.bfloat16,
                                device="cuda")
    model.load_state_dict(sd)
    load = time.time() - t
    out = dict(file_mib=os.path.getsize(path) / 2 ** 20, made_s=made,
               read_s=load, sizes={})
    print(f"DINOv2-L/14 file (HF layout, float32, {out['file_mib']:.0f} "
          f"MiB): made in {made:.1f} s, read in {load:.1f} s", flush=True)
    outputs = {}
    for size in DINOV2_SIZES:
        ex = dinov2.Dinov2Extractor(model, img_resize=size, batch_size=8)
        ex._run(frames)  # warm-up: cuBLAS heuristics, Triton
        with Launches() as n:
            cls, patch = ex._run(frames)
        add_launches(total, n.n)
        t_tok = (size[0] // 14) * (size[1] // 14) + 1
        route = dinov2_route(t_tok)
        x = torch.randn((8,) + size + (3,), device="cuda")
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(x), 3)
        check(tuple(patch.shape) == (8, size[0] // 14, size[1] // 14, 1024)
              and tuple(cls.shape) == (8, 1024)
              and cls.dtype == patch.dtype == torch.float32
              and bool(torch.isfinite(patch).all()),
              f"DINOv2 at {size}: {tuple(cls.shape)} {tuple(patch.shape)}")
        expect(n.n, f"DINOv2-L/14 at {size} (T={t_tok})",
               **{route: 24, "K6": 2, "K7": 47})
        outputs[size] = (cls, patch)
        out["sizes"][f"{size[0]}x{size[1]}"] = dict(
            t=t_tok, route=route, launches=n.n, extract_wall_s=n.wall,
            forward_ms=fwd_ms)
        print(f"DINOv2-L/14 bf16, 8 frames at {size[0]}x{size[1]} "
              f"(T={t_tok}): {route} per layer, launches {n.n}; extract "
              f"{n.wall:.3f} s wall, forward {fwd_ms:.2f} ms (CUDA events)",
              flush=True)
    del x
    profile_phase(tuple((f"dinov2_{h}x{w}", lambda ex=dinov2.Dinov2Extractor(
        model, img_resize=(h, w), batch_size=8): ex._run(frames))
        for h, w in DINOV2_SIZES), TEACHER_TAGS, report)
    out["vs_cpu"] = dinov2_cpu_check(sd, frames)
    for mode in ("cls", "patch"):
        glob_ = npy_frames(frames, "dinov2_frames")
        dest = os.path.join(TEACHER_DIR, f"dinov2_{mode}")
        read, dino_extract._read_rgb = dino_extract._read_rgb, np.load
        try:
            with Launches() as n:
                dino_extract.main(["--images", glob_, "--out", dest,
                                   "--model", "dinov2_vitl14",
                                   "--checkpoint", path, "--mode", mode,
                                   "--resize", "336", "448",
                                   "--batch-size", "8"])
        finally:
            dino_extract._read_rgb = read
        add_launches(total, n.n)
        files = npy_outputs(dest)
        ref = outputs[(336, 448)][0 if mode == "cls" else 1]
        got = torch.as_tensor(np.stack(list(files.values())))
        cos = min_cos(got, ref)
        expect(n.n, f"dino_extract {mode}", K3=24, K6=2, K7=47)
        check(len(files) == 8 and cos >= 0.99999,
              f"dino_extract {mode}: {len(files)} files, cosine {cos} to "
              "the extractor's")
        out[f"dino_extract_{mode}"] = dict(wall_s=n.wall, files=len(files),
                                          min_cos_to_extractor=cos)
        print(f"dino_extract --mode {mode}: 8 .npy files {got.shape[1:]} "
              f"in {n.wall:.1f} s (model read included), cosine to the "
              f"extractor {cos:.7f}, launches {n.n}", flush=True)
    report["dinov2"] = out
    return path


def dinov2_cpu_check(sd, frames):
    """DINOv2-L/14 cut to 2 layers from the file's weights: the card in
    bf16 against the CPU in float32, one frame at each size, cls and
    patch tokens at cosine >= TEACHER_COS; the planted fault (ls1 dropped
    in both card layers) must fall below it."""
    from dropclip_tpu_torch.teachers import dinov2

    cut = {k: v for k, v in sd.items() if not k.startswith("blocks.")
           or int(k.split(".")[1]) < 2}
    models = {}
    for dev, dtype in (("cuda", torch.bfloat16), ("cpu", torch.float32)):
        models[dev] = dinov2.build_dinov2("dinov2_vitl14", dtype=dtype,
                                          device=dev, layers=2)
        models[dev].load_state_dict(cut)
    res = {}
    for size in DINOV2_SIZES:
        got, ref = (dinov2.Dinov2Extractor(m, img_resize=size)._run(
            frames[:1]) for m in (models["cuda"], models["cpu"]))
        res[f"{size[0]}x{size[1]}"] = min(min_cos(got[0], ref[0]),
                                          min_cos(got[1], ref[1]))
    with torch.no_grad():
        for blk in models["cuda"].blocks:
            blk.ls1.fill_(1.0)
    got = dinov2.Dinov2Extractor(models["cuda"])._run(frames[:1])
    ref = dinov2.Dinov2Extractor(models["cpu"])._run(frames[:1])
    fault = min(min_cos(got[0], ref[0]), min_cos(got[1], ref[1]))
    print(f"DINOv2-L/14 cut to 2 layers, card bf16 vs CPU float32, min "
          f"cosine {res} (limit {TEACHER_COS}); planted fault, ls1 dropped: "
          f"{fault:.6f}", flush=True)
    check(min(res.values()) >= TEACHER_COS, f"DINOv2 card vs CPU {res}")
    check(fault < TEACHER_COS, "the DINOv2 limit does not see ls1 dropped")
    return dict(min_cos=res, limit=TEACHER_COS, planted_ls1_dropped=fault)


def no_pos_trick(model):
    """A planted fault: DINO v1's pos embed resized without the +0.1
    scale trick."""
    from dropclip_tpu_torch.ops.resize import bicubic_resize

    def interp(gh, gw):
        og = model.image_resolution // model.patch_size
        pe = model.pos_embed
        resized = bicubic_resize(pe[0, 1:].reshape(og, og, model.width),
                                 (gh, gw))
        return torch.cat([pe[:, :1], resized.reshape(1, gh * gw, -1)], 1)

    model._interp_pos = interp


def dino_v1_phase(frames, total, report):
    """DINO v1 ViT-S/8 at stride 4 in float32 (the ``ViTExtractor``
    default) from a facebookresearch-layout state dict drawn from SEED:
    key descriptors of layer 11, raw and log-binned, and the saliency,
    on normalised inputs at 224x224 (T = 3026) and 512x512 (T = 16130).
    Each descriptor forward runs 12 K5 launches and 25 K6, each saliency
    forward 11 K5 and one materialised layer. At 224x224 the card against
    the CPU within DINO_V1_REL of max|ref|; planted fault: the +0.1
    pos-embed trick left out. A profile of one descriptor forward at
    512x512. Then ``dino_extract`` on two of ``frames`` (``dino_v1_cli``).
    """
    from dropclip_tpu_torch.teachers import dino_v1

    path = os.path.join(TEACHER_DIR, "dino_vits8_seed0.pt")
    raw = dino_v1.synthetic_dino_v1_state_dict("dino_vits8", seed=SEED)
    torch.save(raw, path)
    sd = dino_v1.from_dino_v1(raw)
    ex = dino_v1.ViTExtractor("dino_vits8", stride=4, state_dict=sd,
                              device="cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    out, batches, card = {}, {}, {}
    for px in (224, 512):
        batch = torch.randn((1, px, px, 3), generator=gen).numpy()
        batches[px] = batch
        t_tok = (1 + (px - 8) // 4) ** 2 + 1
        row = dict(t=t_tok)
        for what, run, want in (
                ("descriptors", lambda: ex.extract_descriptors(batch),
                 dict(K5=12, K6=25)),
                ("binned", lambda: ex.extract_descriptors(batch, bin=True),
                 dict(K5=12, K6=25)),
                ("saliency", lambda: ex.extract_saliency_maps(batch),
                 dict(K5=11, K6=25))):
            run()  # warm-up
            with Launches() as n:
                res = run()
            add_launches(total, n.n)
            expect(n.n, f"DINO v1 {what} at {px}x{px}", **want)
            check(bool(torch.isfinite(res).all()), f"DINO v1 {what} at {px}")
            row[what] = dict(wall_s=n.wall, launches=n.n,
                             shape=list(res.shape))
            print(f"DINO v1 S/8 stride 4 float32 {what} at {px}x{px} "
                  f"(T={t_tok}): {tuple(res.shape)} in {n.wall * 1e3:.2f} "
                  f"ms wall, launches {n.n}", flush=True)
            if px == 224:
                card[what] = res.cpu()
            del res
        x = torch.as_tensor(batch, device="cuda")
        with torch.no_grad():
            row["forward_ms"] = cuda_ms(lambda: ex.model(x), 3)
        print(f"DINO v1 forward at {px}x{px}: {row['forward_ms']:.2f} ms "
              "(CUDA events)", flush=True)
        out[px] = row
    profile_phase((("dino_v1_512", lambda: ex.extract_descriptors(
        batches[512])),), TEACHER_TAGS, report)
    cpu = dino_v1.ViTExtractor("dino_vits8", stride=4, state_dict=sd,
                               device="cpu")
    errs = {}
    for what, run in (("descriptors", cpu.extract_descriptors),
                      ("saliency", cpu.extract_saliency_maps)):
        ref = run(batches[224])
        errs[what] = float((card[what] - ref).abs().max()
                           / ref.abs().max())
    no_pos_trick(cpu.model)
    ref = cpu.extract_descriptors(batches[224])
    fault = float((card["descriptors"] - ref).abs().max() / ref.abs().max())
    print(f"DINO v1 at 224x224, card vs CPU float32: max|d| / max|ref| "
          f"{errs} (limit {DINO_V1_REL}); planted fault, the +0.1 pos-embed "
          f"trick left out: {fault:.3e}", flush=True)
    check(max(errs.values()) <= DINO_V1_REL, f"DINO v1 card vs CPU {errs}")
    check(fault > DINO_V1_REL, "the DINO v1 limit does not see the +0.1 "
          "trick left out")
    report["dino_v1"] = dict(
        rows={str(k): v for k, v in out.items()}, vs_cpu=errs,
        limit=DINO_V1_REL, planted_no_pos_trick=fault,
        dino_extract=dino_v1_cli(ex, path, frames[:2], total))
    return ex


def numpy_cv2():
    """A stand-in module for cv2 where it is not installed (the card's
    machine): ``resize`` samples the nearest source pixel of each output
    pixel's centre, so the same frame gives the same array everywhere."""
    import types

    def resize(image, size, interpolation=None):
        w, h = size
        rows = ((np.arange(h) + 0.5) * image.shape[0] / h).astype(np.int64)
        cols = ((np.arange(w) + 0.5) * image.shape[1] / w).astype(np.int64)
        return np.ascontiguousarray(image[rows][:, cols])

    mod = types.ModuleType("cv2")
    mod.resize, mod.INTER_LANCZOS4 = resize, 4
    return mod


def dino_v1_cli(ex, path, frames, total):
    """``dino_extract.main --family dino_v1`` in process on 480x640 .npy
    frames from the facebookresearch-layout file: layer 11 key
    descriptors at a short side of 224 (224x299, T = 55 x 73 + 1 = 4016,
    K5 12 and K6 25 per frame); cv2 replaced by ``numpy_cv2`` where it is
    absent.
    Each file equals the extractor's descriptors of the same frame within
    1e-6 of max|ref|."""
    import importlib
    import importlib.util

    from dropclip_tpu_torch.tools import dino_extract

    glob_ = npy_frames(frames, "dino_v1_frames")
    dest = os.path.join(TEACHER_DIR, "dino_v1_key")
    stub = importlib.util.find_spec("cv2") is None
    cv2 = "stand-in" if stub else importlib.import_module("cv2").__version__
    read, dino_extract._read_rgb = dino_extract._read_rgb, np.load
    if stub:
        sys.modules["cv2"] = numpy_cv2()
    try:
        with Launches() as n:
            dino_extract.main(["--images", glob_, "--out", dest,
                               "--family", "dino_v1", "--model",
                               "dino_vits8", "--checkpoint", path,
                               "--stride", "4", "--layer", "11", "--facet",
                               "key", "--load-size", "224"])
        refs = [ex.extract_descriptors(ex.preprocess(f, load_size=224)
                                       ).cpu().numpy() for f in frames]
    finally:
        dino_extract._read_rgb = read
        if stub:
            del sys.modules["cv2"]
    add_launches(total, n.n)
    files = list(npy_outputs(dest).values())
    errs = [float(np.abs(g - r).max() / np.abs(r).max())
            for g, r in zip(files, refs)]
    print(f"dino_extract --family dino_v1 (cv2 {cv2}): "
          f"{len(files)} files {files[0].shape} in {n.wall:.1f} s (model "
          f"read included), launches {n.n}; max|d| / max|ref| to the "
          f"extractor {max(errs):.3e}", flush=True)
    expect(n.n, "dino_extract dino_v1", K5=12 * len(frames),
           K6=25 * len(frames))
    check(len(files) == len(frames) and all(
        f.shape == r.shape == (1, 1, 4015, 384) for f, r in zip(files, refs))
        and max(errs) <= 1e-6, f"dino_extract dino_v1: {errs}")
    return dict(wall_s=n.wall, launches=n.n, files=len(files),
                max_rel_to_extractor=max(errs), cv2=cv2)


def swap_qk(attn, q="q_proj", k="k_proj"):
    """A planted fault: an attention's q and k projections swapped."""
    with torch.no_grad():
        for a in ("weight", "bias"):
            qa, ka = getattr(getattr(attn, q), a), getattr(getattr(attn, k), a)
            tmp = qa.clone()
            qa.copy_(ka)
            ka.copy_(tmp)


def rn_phase(total, report):
    """RN50 from an OpenAI-layout fp16 file drawn from SEED, through
    ``build_clip_from``: bf16 on the card against float32 on the CPU for
    ``encode_image`` at 224x224 (cosine >= RN_POOL_COS), the patch
    features at 448x448 and ``encode_text`` (>= TEACHER_COS; K6 25 per
    encode; the text attention is plain, as in JAX). Planted faults: the
    attention pool's q and k swapped (pooled), patch rows shifted by one
    (patch), the first text block's q and k swapped (text). A profile of
    one patch forward. Returns the file's path."""
    from dropclip_tpu_torch.teachers.convert import (
        build_clip_from, synthetic_openai_state_dict)
    from dropclip_tpu_torch.teachers.tokenizer import tokenize

    path = os.path.join(TEACHER_DIR, "clip_rn50_seed0.pt")
    t = time.time()
    torch.save(synthetic_openai_state_dict("RN50", seed=SEED), path)
    made = time.time() - t
    models = {dev: build_clip_from("RN50", path, dtype=dtype, device=dev)
              for dev, dtype in (("cuda", torch.bfloat16),
                                 ("cpu", torch.float32))}
    gen = torch.Generator().manual_seed(SEED + 7)
    inputs = dict(image=torch.randn((4, 224, 224, 3), generator=gen),
                  patch=torch.randn((4, 448, 448, 3), generator=gen),
                  text=torch.as_tensor(tokenize(CLIP_PROMPTS)))
    runs = dict(image=lambda m, x: m.encode_image(x),
                patch=lambda m, x: m.get_patch_encodings(x),
                text=lambda m, x: m.encode_text(x))
    res, times = {}, {}
    with torch.no_grad():
        for what, x in inputs.items():
            runs[what](models["cuda"], x.cuda())  # warm-up
            with Launches() as n:
                got = runs[what](models["cuda"], x.cuda())
            add_launches(total, n.n)
            expect(n.n, f"RN50 {what}", **({"K6": 25} if what == "text"
                                            else {}))
            ref = runs[what](models["cpu"], x)
            res[what] = dict(min_cos=min_cos(got, ref), shape=list(
                got.shape), wall_s=n.wall, launches=n.n, ref=ref)
            xc = x.cuda()
            times[what] = cuda_ms(lambda: runs[what](models["cuda"], xc), 3)
        swap_qk(models["cuda"].visual.attnpool)
        faults = dict(image=min_cos(models["cuda"].encode_image(
            inputs["image"].cuda()), res["image"]["ref"]))
        swap_qk(models["cuda"].visual.attnpool)
        shifted = models["cuda"].visual.attnpool.forward_v
        models["cuda"].visual.attnpool.forward_v = \
            lambda x: torch.roll(shifted(x), 1, dims=1)
        faults["patch"] = min_cos(models["cuda"].get_patch_encodings(
            inputs["patch"].cuda()), res["patch"]["ref"])
        swap_qk(models["cuda"].text.blocks[0].attn)
        faults["text"] = min_cos(models["cuda"].encode_text(
            inputs["text"].cuda()), res["text"]["ref"])
    limits = dict(image=RN_POOL_COS, patch=TEACHER_COS, text=TEACHER_COS)
    for what in res:
        del res[what]["ref"]
        res[what].update(forward_ms=times[what], limit=limits[what])
    print(f"RN50 (OpenAI layout fp16, {os.path.getsize(path) / 2**20:.0f} "
          f"MiB, made in {made:.1f} s), card bf16 vs CPU float32: "
          + "; ".join(f"{w} {r['shape']} cosine {r['min_cos']:.6f}, "
                      f"{r['forward_ms']:.2f} ms" for w, r in res.items())
          + f"; planted faults {faults}", flush=True)
    for what, r in res.items():
        check(r["min_cos"] >= r["limit"], f"RN50 {what}: cosine "
              f"{r['min_cos']} (limit {r['limit']})")
        check(faults[what] < r["limit"], f"the RN50 {what} limit does not "
              "see its planted fault")
    report["rn50"] = dict(rows=res, faults=faults)
    x = inputs["patch"].cuda()
    model = build_clip_from("RN50", path, dtype=torch.bfloat16,
                            device="cuda")
    with torch.no_grad():
        profile_phase((("rn50_patch_448", lambda: model.get_patch_encodings(
            x)),), TEACHER_TAGS, report)
    return path


def clip_extract_phase(frames, rn_path, total, report):
    """``clip_extract.main`` in process on 2 frames: ViT-L/14@336px (seed
    weights) in cls, patch and tiled modes (K3 24 and K7 47 per cls
    forward, 23 and 45 per patch forward), RN50 from its file in patch
    mode; RN50's cls and tiled modes raise (the pool's class path takes
    only its training grid, as in JAX)."""
    from dropclip_tpu_torch.tools import clip_extract, dino_extract

    glob_ = npy_frames(frames[:2], "clip_frames")
    out = {}
    read, dino_extract._read_rgb = dino_extract._read_rgb, np.load
    try:
        for model, ckpt, mode, shape, fwd in (
                ("ViT-L/14@336px", None, "cls", (768,), 1),
                ("ViT-L/14@336px", None, "patch", (24, 32, 768), 1),
                ("ViT-L/14@336px", None, "tiled", (14, 14, 768), 26),
                ("RN50", rn_path, "patch", (10, 14, 1024), 1)):
            dest = os.path.join(TEACHER_DIR, f"clip_{model[:2]}_{mode}")
            args = ["--images", glob_, "--out", dest, "--clip-model", model,
                    "--mode", mode, "--batch-size", "16"]
            if ckpt:
                args += ["--clip-checkpoint", ckpt]
            with Launches() as n:
                clip_extract.main(args)
            add_launches(total, n.n)
            files = npy_outputs(dest)
            check(len(files) == 2 and all(
                f.shape == shape and f.dtype == np.float32
                and np.isfinite(f).all() for f in files.values()),
                f"clip_extract {model} {mode}: "
                f"{[f.shape for f in files.values()]}")
            if model == "RN50":
                expect(n.n, f"clip_extract {model} {mode}")
            elif mode == "patch":
                expect(n.n, f"clip_extract {model} {mode}", K3=23 * fwd,
                       K6=4 * fwd, K7=45 * fwd)
            else:
                expect(n.n, f"clip_extract {model} {mode}", K3=24 * fwd,
                       K6=3 * fwd, K7=47 * fwd)
            out[f"{model} {mode}"] = dict(wall_s=n.wall, launches=n.n)
            print(f"clip_extract {model} --mode {mode}: 2 files {shape} in "
                  f"{n.wall:.1f} s (model build included), launches {n.n}",
                  flush=True)
        for mode in ("cls", "tiled"):
            try:
                clip_extract.main(["--images", glob_, "--out",
                                   os.path.join(TEACHER_DIR, "rn_" + mode),
                                   "--clip-model", "RN50", "--mode", mode,
                                   "--clip-checkpoint", rn_path])
                raised = ""
            except ValueError as e:
                raised = str(e)
            check("training grid" in raised, f"clip_extract RN50 {mode} "
                  "ran at 336x448")
    finally:
        dino_extract._read_rgb = read
    report["clip_extract"] = out


def per_view_phase(total, report):
    """One ingest chunk of the per-view prompt path
    (``DROPCLIP_PACKED_PROMPTS=0``): the first 8 views of a full-width
    ingest scene (480x640, 10 objects, ids 0-31) through the ViT-L/14@336px
    teacher in bf16, one forward of 8 views x 12 objects (K3 24, K7 47,
    K6 3); its present rows against the packed route's at cosine >=
    TEACHER_COS, absent rows zero."""
    args = SimpleNamespace(clip_model="ViT-L/14@336px", clip_checkpoint=None,
                           visual_prompt="crop-mask", crop_num_levels=1,
                           crop_expansion_ratio=0.15, batch_size=32)
    from dropclip_tpu_torch.tools.preprocess_data import build_extractor

    ex = build_extractor(args, device="cuda", seed=SEED)
    raw = make_ingest_scene(1, 8, (480, 640), 10, 400)
    ids = np.arange(32)
    packed, present = ex.extract_obj_prior(raw["images"], raw["segs"],
                                           obj_ids=ids)
    os.environ["DROPCLIP_PACKED_PROMPTS"] = "0"
    try:
        with Launches() as n:
            per_view, present_v = ex.extract_obj_prior(
                raw["images"], raw["segs"], obj_ids=ids)
    finally:
        del os.environ["DROPCLIP_PACKED_PROMPTS"]
    add_launches(total, n.n)
    p = present.cpu().numpy()
    cos = min_cos(per_view[present], packed[present])
    zeros = bool((per_view[~present] == 0).all())
    print(f"per-view prompts (8 views at 480x640, {int(p.sum())} present "
          f"pairs of {int(p.any(0).sum())} objects): {n.wall:.3f} s, "
          f"launches {n.n}; present rows vs the packed route min cosine "
          f"{cos:.6f}, absent rows zero: {zeros}", flush=True)
    expect(n.n, "per-view prompts", K3=24, K6=3, K7=47)
    check(torch.equal(present, present_v) and zeros and cos >= TEACHER_COS,
          f"per-view prompts: cosine {cos}, zeros {zeros}")
    report["per_view_prompts"] = dict(wall_s=n.wall, launches=n.n,
                                      min_cos=cos, pairs=int(p.sum()))


TEACHER_ROW_KEYS = ("b", "t", "h", "dtype", "max_abs_err", "ms", "plain_ms",
                    "library_ms", "bound_ms", "bound_by", "tflops",
                    "bound_share", "limit_share", "bound_f32_cores_ms")


def teacher_attention_phase(report):
    """K5 at the teachers' new shapes against its plain version (float32
    DINO v1 S/8 at stride 4 on 224x224 and 512x512; bf16 DINOv2-L at
    672x896) and K4 at DINOv2-L on 518x518, each with the dropped-key
    control, timed with the plain version, SDPA and the bound; the float32
    rows also read the kernel and the plain version against float64."""
    cases = [("K5 DINO v1 224 f32", 1, 3026, 6, False, torch.float32),
             ("K5 DINO v1 512 f32", 1, 16130, 6, False, torch.float32),
             ("K5 DINOv2 672x896", 8, 3073, 16, False, torch.bfloat16),
             ("K4 DINOv2 518", 8, 1370, 16, False, torch.bfloat16)]
    rows = {c[0]: attention_row(*c, f32_control=True) for c in cases}
    report["teacher_attention"] = rows
    return rows


def ln_fault(x, scale, bias, eps, kind):
    """A planted LayerNorm fault on float32 rows: "pad", the statistics
    taken over the Triton block's next power of two of lanes with the
    masked lanes read as zeros; "row", each row normalised with its
    neighbour's statistics."""
    import torch.nn.functional as F

    xf = x.float()
    if kind == "pad":
        src = F.pad(xf, (0, triton_block(xf.shape[-1]) - xf.shape[-1]))
    else:
        src = xf.roll(1, 0)
    mean = src.mean(-1, keepdim=True)
    var = ((src - mean) ** 2).mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale + bias


def triton_block(c):
    return 1 << (c - 1).bit_length()


def teacher_norm_phase(report):
    """K6 and K7 at the rows, widths, types and eps the teachers give
    them: DINO v1 S/8's float32 (T, 384) norms at 224x224 and 512x512
    (eps 1e-6, the one-warp instance of 512 lanes), RN50's bf16 text
    tower on 4 prompts, (4 x 77, 512) (eps 1e-5, the same instance in
    bf16, within one unfloored bf16 ulp), DINOv2-L's first norm (bf16)
    and final norm (float32) and its K7 residual stream (bf16) over
    8 x 3073 rows at 672x896 (eps 1e-6). Each against its plain version on
    the same card tensors with a planted fault that the rule must see
    (statistics over the padded block at width 384, a neighbour row's
    statistics at 512 and 1024), timed with the plain version,
    ``F.layer_norm`` and the bound:
    back to back between CUDA events (``cuda_ms``, the larger of the host
    and the device time per call) and split into device time
    (``device_ms``, the profiler's median of 51 calls) and host time
    (``host_ms``, the median of 101 calls of each, kernel and library in
    turns)."""
    import torch.nn.functional as F

    from dropclip_tpu_torch.ops.layernorm import (
        add_layer_norm, add_layer_norm_plain, layer_norm, layer_norm_plain)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    big = 2.0 ** -10  # ln_close's floor at large row counts
    cases = (("K6 DINO v1 224 f32", 3026, 384, torch.float32, 1e-6, big),
             ("K6 DINO v1 512 f32", 16130, 384, torch.float32, 1e-6, big),
             ("K6 DINOv2 672x896 bf16", 8 * 3073, 1024, torch.bfloat16, 1e-6,
              big),
             ("K6 DINOv2 672x896 f32", 8 * 3073, 1024, torch.float32, 1e-6,
              big),
             ("K7 DINOv2 672x896 bf16", 8 * 3073, 1024, torch.bfloat16, 1e-6,
              big),
             ("K6 RN50 text bf16", 4 * 77, 512, torch.bfloat16, 1e-5, 1e-30))
    rows = {}
    for tag, n, c, dtype, eps, floor in cases:
        x = (torch.randn((n, c), generator=gen, device="cuda") * 3
             ).to(dtype)
        s = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        sd, bd = s.to(dtype), b.to(dtype)
        es = x.element_size()
        if tag.startswith("K7"):
            d = torch.randn((n, c), generator=gen, device="cuda").to(dtype)
            got_s, got = add_layer_norm(x, d, s, b, eps=eps)
            ref_s, ref = add_layer_norm_plain(x, d, s, b, eps=eps)
            ok = torch.equal(got_s, ref_s)
            fault = ln_fault(ref_s, s, b, eps, "row").to(dtype)
            kernel = lambda: add_layer_norm(x, d, s, b, eps=eps)
            plain = lambda: add_layer_norm_plain(x, d, s, b, eps=eps)

            def library():
                y = x + d
                return y, F.layer_norm(y, (c,), sd, bd, eps)

            nbytes, flops = 4.0 * n * c * es + 2 * c * 4, 10.0 * n * c
        else:
            got = layer_norm(x, s, b, eps=eps)
            ref = layer_norm_plain(x, s, b, eps=eps)
            ok = True
            fault = ln_fault(x, s, b, eps, "pad" if c != triton_block(c)
                             else "row").to(dtype)
            kernel = lambda: layer_norm(x, s, b, eps=eps)
            plain = lambda: layer_norm_plain(x, s, b, eps=eps)
            library = lambda: F.layer_norm(x, (c,), sd, bd, eps)
            nbytes, flops = 2.0 * n * c * es + 2 * c * 4, 9.0 * n * c
        torch.cuda.synchronize()
        err = float((got.float() - ref.float()).abs().max())
        fault_err = float((fault.float() - ref.float()).abs().max())
        ok = ok and ln_close(got, ref, dtype, floor)
        seen = not ln_close(fault, ref, dtype, floor)
        del got, ref, fault
        row = dict(rows=n, c=c, dtype=str(dtype), eps=eps, max_abs_err=err,
                   planted_fault_err=fault_err, ms=cuda_ms(kernel, 20),
                   plain_ms=cuda_ms(plain, 5), library_ms=cuda_ms(library, 20),
                   bound_ms=max(flops / PEAK_FLOPS[dtype],
                                nbytes / PEAK_BYTES) * 1e3, bound_by="bytes")
        row["device_ms"] = device_ms(kernel)
        # the library's K7 is an add and F.layer_norm: two kernels a call
        row["library_device_ms"] = device_ms(library, 1 + tag.startswith(
            "K7"))
        row["host_ms"], row["library_host_ms"] = host_ms((kernel, library))
        rows[tag] = row
        print(f"{tag} ({n}, {c}) eps {eps}: err {err:.3e}, planted fault "
              f"{fault_err:.3e} | kernel {row['ms']:.5f} ms (device "
              f"{row['device_ms']:.5f}, host {row['host_ms']:.5f}) plain "
              f"{row['plain_ms']:.5f} ms library {row['library_ms']:.5f} ms "
              f"(device {row['library_device_ms']:.5f}, host "
              f"{row['library_host_ms']:.5f}) bound {row['bound_ms']:.5f} ms",
              flush=True)
        check(ok, f"{tag} ({n}, {c}): max err {err}")
        check(seen, f"{tag}: the rule does not see the planted fault")
        del x
    report["teacher_norms"] = rows
    return rows


def teachers_phase(report):
    """DINOv2, DINO v1, the RN towers, the extraction CLIs and the
    per-view prompt path at full width; the files go under build/teachers/
    and are deleted afterwards. Returns the K3-K7 launches of the teacher
    paths and the attention rows."""
    t = time.time()
    os.makedirs(TEACHER_DIR, exist_ok=True)
    total = {}
    frames = make_ingest_scene(SEED + 5, 8, (480, 640), 10, 400)["images"]
    try:
        rows = teacher_attention_phase(report)
        rows.update(teacher_norm_phase(report))
        dinov2_phase(frames, total, report)
        torch.cuda.empty_cache()
        dino_v1_phase(frames, total, report)
        torch.cuda.empty_cache()
        rn_path = rn_phase(total, report)
        clip_extract_phase(frames, rn_path, total, report)
        torch.cuda.empty_cache()
        per_view_phase(total, report)
    finally:
        shutil.rmtree(TEACHER_DIR, ignore_errors=True)
    torch.cuda.empty_cache()
    report["teachers_s"] = time.time() - t
    report["teacher_launches"] = total
    print(f"teachers phase: {report['teachers_s']:.1f} s, launches {total}",
          flush=True)
    return total, rows


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
    for name in ("attention_kernel_v3", "attention_kernel_f32x3_wgmma"):
        found = [lines for fn, lines in ptxas_entries(
            ptxas["attention"]).items() if name in fn]
        check(len(found) == 1 and any(
            "0 bytes spill stores, 0 bytes spill loads" in line
            for line in found[0]),
            f"{name} spills registers or was not built: {found}")

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
    n_re = run_eval_phase(extractor, scene, report)
    raw = raw_phase(extractor, report)
    del extractor
    torch.cuda.empty_cache()
    ingest_cpu_phase(report)
    run_eval_cpu_phase(report)
    k1_train_n, k1_train, cli = train_phase(report)
    k1_eval_n, k6_eval_n = eval_phase(cfg, cli, report)
    k1_raw, k6_raw = raw_check_phase(raw, report)
    tn, trows = teachers_phase(report)

    kernels = [
        dict(name="K1 brick_conv3", route="cuda",
             source="dropclip_tpu_torch/csrc/brick_conv3.cu",
             replaces="dropclip_tpu/sparse/pallas_conv.py:125",
             launches=k1_n + k1_train_n + k1_eval_n + k1_raw,
             serve_launches=k1_n, train_launches=k1_train_n,
             eval_launches=k1_eval_n, raw_launches=k1_raw, **k1,
             **k1_train, regrad_layout={
                 k: v for k, v in report["regrad_k1"].items()
                 if k != "rows"}),
        dict(name="K2 pillar_conv3", route="cuda",
             source="dropclip_tpu_torch/csrc/pillar_conv3.cu",
             replaces="dropclip_tpu/sparse/pallas_pillar.py:134",
             launches=k2_n, **k2),
        dict(name="K3 oneshot_attention_packed", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:180",
             launches=n_ing["K3"] + n_re["K3"] + raw["n"]["K3"] + tn["K3"],
             ingest_launches=n_ing["K3"], run_eval_launches=n_re["K3"],
             raw_launches=raw["n"]["K3"], teacher_launches=tn["K3"],
             **att["K3"]),
        dict(name="K4 oneshot_attention", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:93",
             launches=k4_n + tn["K4"], teacher_launches=tn["K4"],
             **att["K4"], teacher_rows={
                 tag: {k: row[k] for k in TEACHER_ROW_KEYS if k in row}
                 for tag, row in trows.items() if tag.startswith("K4")}),
        dict(name="K5 flash_attention_padded", route="cuda",
             source="dropclip_tpu_torch/csrc/attention.cu",
             replaces="dropclip_tpu/ops/attention.py:214",
             launches=k5_n + tn["K5"], teacher_launches=tn["K5"],
             **att["K5"], teacher_rows={
                 tag: {k: row[k] for k in TEACHER_ROW_KEYS if k in row}
                 for tag, row in trows.items() if tag.startswith("K5")}),
        dict(name="K6 layer_norm", route="triton",
             source="dropclip_tpu_torch/ops/layernorm.py",
             replaces="dropclip_tpu/ops/layernorm.py:153",
             launches=(k6_n + k6_np + n_ing["K6"] + n_re["K6"] + k6_eval_n
                       + raw["n"]["K6"] + k6_raw + tn["K6"]),
             run_eval_launches=n_re["K6"], eval_launches=k6_eval_n,
             raw_launches=raw["n"]["K6"] + k6_raw,
             teacher_launches=tn["K6"], **k6, teacher_rows={
                 tag: row for tag, row in trows.items()
                 if tag.startswith("K6")}),
        dict(name="K7 add_layer_norm", route="triton",
             source="dropclip_tpu_torch/ops/layernorm.py",
             replaces="dropclip_tpu/ops/layernorm.py:125",
             launches=n_ing["K7"] + n_re["K7"] + raw["n"]["K7"] + tn["K7"],
             ingest_launches=n_ing["K7"], run_eval_launches=n_re["K7"],
             raw_launches=raw["n"]["K7"], teacher_launches=tn["K7"], **k7,
             teacher_rows={
                 tag: row for tag, row in trows.items()
                 if tag.startswith("K7")}),
    ]
    check(all(kernels[i]["teacher_launches"] > 0 for i in range(2, 7)),
          "a kernel of the teacher paths never launched")
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
