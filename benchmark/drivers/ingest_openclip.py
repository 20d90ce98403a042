"""Closed loop, one process on one card, of the port's MV-TOD ingest with
OpenCLIP ViT-H/14 as the teacher: ``drivers/ingest.py``'s loop (the
loader thread, ``process_scene``, the ``SceneWriter`` thread over a ring
of dense renders), weights, extractor, counting and comparison, with the
tower's sizes from the traffic file (16 heads of 80, exact GELU, the
224 x 294 crop canvas) and the reference ``reference/openclip.py``.

The teacher's attention runs on the kernel's D = 80 instance, whose own
launch counter (``kernels/attention.counters["d80"]``) holds the traced
window's count of ``attention_kernel_d80`` kernels; the traced window
also keeps the program's ``teacher.tower`` spans, one a chunk's ViT
forward, and one scene after it runs with ``sync_timings`` for the phase
times, as in ``drivers/ingest.py``. The program's extractor is built before the ring is rendered,
so that a program without this teacher fails at once. A stand-in
(``STAND_INS``: the fp8 control, quick-GELU in GELU's place, heads of 64
in place of 80) takes the program's place in the comparison for
calibration and tests."""

from __future__ import annotations

import os
import time
from typing import Dict, Optional

import torch

from . import ingest as base
from .. import counting_vit, render, trace
from ..reference import clip_text, openclip
from .train import free

KERNEL = "attention_kernel_d80"


def run(run) -> None:
    from dropclip_tpu_torch.kernels.attention import counters

    counter = counters["d80"]
    dev, tr = run.device, run.traffic
    ing, teacher = tr["ingest"], tr["teacher"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    w = base.draw_teacher(run.config, teacher, run.seed + 1, dev)
    extractor = base.build_extractor(run, w)
    ring = render.make_ring(tr, run.seed, dev)
    job = base.Ingest(extractor, ring, ing)
    job.scenes(0, lambda m: m < 1)          # the warm scene
    job.clear()
    run.setup_done()

    t0 = time.perf_counter()
    k = job.scenes(0, lambda m: time.perf_counter() - t0 < run.seconds)
    wall = time.perf_counter() - t0
    run.e2e["ingest_scenes_per_s"] = k / wall
    run.attempted = k
    run.failed = job.not_finite + sum(
        1 for s in job.stats if s["dropped"] or s["points"] == 0)
    got = {j: dict(scene=job.out[j], fusion={
        name: v.detach().float().cpu() if v.is_floating_point()
        else v.detach().cpu() for name, v in job.fusion[j].items()})
        for j in sorted(job.out)}

    if run.trace:
        work = base.scene_work(run, ring)
        n = len(ring)
        run.work["window_flops"] = sum(work[i % n]["flops"]
                                       for i in range(k))
        run.work["window_s"] = wall
        at = [k]

        def unit():
            first = at[0]
            at[0] += job.scenes(first, lambda m: m < int(
                tr["profile_scenes"]))
            return list(range(first, at[0]))

        before = counter.launches
        run.probe = trace.counted_profile(
            unit, 1, lambda: counter.launches, lambda name: KERNEL in name)
        layers = int(teacher["vision_layers"])
        ran = sum(work[i % n]["chunks"] for i in range(k, at[0])) * layers
        if dev == "cuda" and counter.launches - before != ran:
            raise RuntimeError(
                f"the traced scenes ran {counter.launches - before} d80 "
                f"attention launches; the counting predicts {ran}")
        launches = sum(work[i % n]["chunks"] for u in run.probe.units
                       for i in u) * layers
        one = counting_vit.attention_launch(
            teacher, int(ing["chunk"]) * int(ing["crop_num_levels"]))
        run.work["attention_flops"] = launches * one["flops"]
        run.work["attention_bytes"] = launches * one["bytes"]
        run.work["phases"] = job.timed(at[0] % n)
    if dev == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    del job, extractor
    free()
    run.compare(judge(run, ring, w, got))


def reference_scene(run, w, data: Dict, tok, precision: str = "bf16",
                    fault: Optional[str] = None) -> Dict:
    tr, cfg = run.traffic, run.config
    return openclip.scene(w, base.text_weights(w), tok, data, tr["teacher"],
                          tr["ingest"], int(cfg["text_heads"]), run.device,
                          int(tr["reference_batch"]), precision, fault)


def judge(run, ring, w, got: Dict[int, Dict]) -> Dict[str, float]:
    """``ingest.judge`` with ViT-H/14's reference: each ring scene's
    newest output against the reference's, the worst over the scenes; a
    stand-in's output takes the program's place where one is set."""
    tok = clip_text.Tokenizer(os.path.join(run.root, base.VOCAB))
    nums = dict.fromkeys(base.NUMBERS, 0.0)
    for j, g in got.items():
        r = reference_scene(run, w, ring[j], tok)
        if run.stand_in is not None:
            g = STAND_INS[run.stand_in](run, w, ring[j], tok)
        for name, value in base.compare(run, g, r, ring[j]).items():
            nums[name] = max(nums[name], value)
        del r, g
    return nums


def _stand_in(precision: str = "bf16", fault: Optional[str] = None):
    def stand_in(run, w, data, tok):
        return base._as_program(reference_scene(run, w, data, tok, precision,
                                                fault))
    return stand_in


# the control (both towers one precision below the configuration's bf16)
# and the planted faults of the teacher, judged in the program's place
STAND_INS = {"control_teacher_fp8": _stand_in("fp8"),
             **{f"fault_{f}": _stand_in(fault=f) for f in openclip.FAULTS}}
