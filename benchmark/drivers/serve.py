"""Closed loop, one client, of ``GroundingPipeline.ground_batch`` on the
brick engine: each call grounds a fixed number of scenes, taken in turn
from a ring of clouds made at set-up, against queries drawn from a fixed
set of class prompts whose text features the set-up encoded, as a job
grounding a dataset fills the text cache.

``ground_scenes_per_s`` is every scene of every call the window finished
over its wall time; ``serve.call_p95_ms`` the 95th percentile of every
call's host wall time, from the call to its masks in host numpy. A call
that dropped voxels or returned a score that is not finite counts as
failed. Once the window has closed and the
pipeline is freed, the plain reference grounds a sample of the calls,
drawn from the seed, from the same clouds and weights: the largest gap
of a normalized score against the whole reference; the largest gap
against the reference's student and grounding given the program's own
cached text features, which leaves the student's gap alone; and the
masks' points that disagree where the reference's score lies farther
from the threshold than the first gap's limit. A stand-in
(``STAND_INS``: a control) takes the program's place in that comparison
for calibration and tests."""

from __future__ import annotations

import os
import time
from typing import Dict

import numpy as np
import torch

from .. import counting, gen, trace, weights
from ..reference import clip_text, grounding
from ..reference import minkunet as ref
from .train import arch_of, free, program_cfg

VOCAB = os.path.join("dropclip_tpu_torch", "teachers", "assets",
                     "bpe_simple_vocab_16e6.txt.gz")


def text_shapes(config: Dict) -> Dict[str, tuple]:
    return clip_text.weight_shapes(
        config["text_width"], config["text_layers"], config["text_vocab"],
        config["text_context"], config["embed_dim"])


def draw_text(config: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The text tower's weights, stored as the tower serves them: the
    linears in bf16, the rest in float32."""
    w = weights.draw(text_shapes(config), clip_text.init, seed, device)
    return {k: v.to(torch.bfloat16) if clip_text.is_linear(k) else v
            for k, v in w.items()}


def make_traffic(run) -> Dict:
    """The ring of clouds and the queries of every call, from the seed."""
    cfg, tr = run.config, run.traffic
    rng = gen.rng_for(run.seed, 2)
    coords = gen.make_scenes(tr["scenes"], int(tr["ring"]), rng)
    clouds = [gen.point_cloud(c, float(cfg["voxel_size"]),
                              float(tr["points_per_voxel"]), rng)
              for c in coords]
    prompts = list(tr["prompts"])
    pairs = [tuple(prompts[j] for j in rng.choice(
        len(prompts), int(tr["queries"]), replace=False))
        for _ in range(int(tr["ring"]))]
    return dict(clouds=clouds, prompts=prompts, pairs=pairs,
                negatives=list(tr["negatives"]),
                batch=int(tr["scenes_per_call"]))


def call_args(traffic: Dict, k: int):
    """Call ``k``'s scenes (ring indices) and queries."""
    b, n = traffic["batch"], len(traffic["clouds"])
    idx = [(k * b + j) % n for j in range(b)]
    return idx, traffic["pairs"][k % len(traffic["pairs"])]


def build(run) -> Dict:
    from dropclip_tpu_torch.data.voxelize_np import sparse_quantize_np
    from dropclip_tpu_torch.pipeline import GroundingPipeline
    from dropclip_tpu_torch.similarity import ClipSimilarity
    from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities
    from dropclip_tpu_torch.teachers.clip import build_clip_text

    dev, cfg = run.device, run.config
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    torch.backends.cudnn.allow_tf32 = False
    traffic = make_traffic(run)
    w_student = weights.draw(ref.weight_shapes(arch_of(cfg)),
                             weights.student_init, run.seed, dev)
    w_text = draw_text(cfg, run.seed + 1, dev)
    tower = build_clip_text(cfg["clip_model"], dtype=torch.bfloat16)
    tower.load_state_dict(w_text)
    sim = ClipSimilarity(tower.to(dev), dev, method=cfg["sim_method"],
                         threshold=float(cfg["sim_norm_thresh"]))
    pcfg = program_cfg(cfg)
    pcfg.update(sim_method=cfg["sim_method"],
                sim_norm_thresh=cfg["sim_norm_thresh"])
    pipe = GroundingPipeline(pcfg, clip_sim=sim, device=dev)
    pipe.model.load_state_dict(w_student)
    if pcfg.sparse_backend == "bricks":
        vox = [sparse_quantize_np(xyz - xyz.mean(axis=0), pipe.voxel_size,
                                  pipe.capacity)
               for xyz, _ in traffic["clouds"]]
        pipe.cfg.brick_capacities = list(autotune_brick_capacities(
            np.stack([v.coords for v in vox]),
            np.stack([v.mask for v in vox]),
            slack=float(run.traffic["slack"]),
            brick_shape=tuple(cfg["brick_shape"])))
    for p in traffic["prompts"]:  # the text cache of a grounding job
        sim.encode_text([p])
    sim.encode_text(traffic["negatives"])
    return dict(traffic=traffic, w_student=w_student, w_text=w_text,
                pipe=pipe)


def ground(pipe, traffic, k):
    idx, queries = call_args(traffic, k)
    clouds = [traffic["clouds"][i] for i in idx]
    return pipe.ground_batch([c[0] for c in clouds], [c[1] for c in clouds],
                             list(queries), negatives=traffic["negatives"])


def reference_student(run, w_student, traffic, k,
                      precision: str = "float32"):
    """The reference student's per-voxel features of call ``k``'s scenes
    on the reference's own voxelization: ([(V, C)], [voxelization])."""
    cfg = run.config
    idx, _ = call_args(traffic, k)
    vs, cap = float(cfg["voxel_size"]), int(cfg["voxel_capacity"])
    vox = [grounding.voxelize(*traffic["clouds"][i], vs) for i in idx]
    coords = np.zeros((len(idx), cap, 3), np.int64)
    feats = np.zeros((len(idx), cap, 6), np.float32)
    mask = np.zeros((len(idx), cap), bool)
    for b, (c, f, _) in enumerate(vox):
        coords[b, :len(c)], feats[b, :len(c)], mask[b, :len(c)] = c, f, True
    dev = run.device
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        with torch.no_grad():
            m = torch.as_tensor(mask, device=dev)
            pyr = ref.Pyramid(torch.as_tensor(coords, device=dev), m)
            out = ref.forward(w_student, arch_of(cfg), pyr,
                              torch.as_tensor(feats, device=dev),
                              ref.Norms(w_student, training=False))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return [out[b, :len(v[0])] for b, v in enumerate(vox)], vox


def reference_ground(run, student, traffic, k, emb):
    """(per-point masks, [(Q, V) scores], [voxel of each point]) of call
    ``k`` from the student's features and ``emb``, which maps each
    prompt to its unit text feature."""
    feats, vox = student
    _, queries = call_args(traffic, k)
    with torch.no_grad():
        pos = torch.stack([emb[q] for q in queries])
        neg = torch.stack([emb[q] for q in traffic["negatives"]])
        scores = [grounding.paired_scores(f, pos, neg) for f in feats]
    thr = float(run.config["sim_norm_thresh"])
    masks = [(s > thr).cpu().numpy()[:, v[2]] for s, v in zip(scores, vox)]
    return masks, [s.cpu().numpy() for s in scores], [v[2] for v in vox]


def text_features(run, w_text, prompts, precision: str = "bf16"):
    cfg = run.config
    tok = clip_text.Tokenizer(os.path.join(run.root, VOCAB))
    with torch.no_grad():
        f = clip_text.encode(w_text, tok(prompts).to(run.device),
                             cfg["text_heads"], precision)
    f = f / f.norm(dim=-1, keepdim=True)
    return {p: f[i] for i, p in enumerate(prompts)}


def cached_text(sim, traffic) -> Dict[str, torch.Tensor]:
    """The program's text feature of every prompt, read from the cache
    that set-up filled and the window used (no encode)."""
    emb = {p: sim.encode_text([p])[0] for p in traffic["prompts"]}
    emb.update(zip(traffic["negatives"],
                   sim.encode_text(traffic["negatives"])))
    return emb


def score_gap(got, ref_out) -> float:
    """The largest gap of a normalized score over the calls' scenes,
    queries and voxels."""
    gap = 0.0
    for (_, g_sims), (_, r_sims, _) in zip(got, ref_out):
        for b, r in enumerate(r_sims):
            d = np.abs(g_sims[b][:, :r.shape[1]] - r)
            gap = max(gap, float(np.nan_to_num(d, nan=np.inf).max()))
    return gap


def compare(run, got, ref_out, ref_own) -> Dict[str, float]:
    """``score_gap`` against the whole reference, its text tower
    included; ``student_score_gap`` against the reference's student and
    grounding given the judged side's own text features, which leaves
    the student's gap alone; ``mask_flips``, the points whose masks
    disagree where the reference's score lies farther than the score
    limit from the threshold."""
    thr = float(run.config["sim_norm_thresh"])
    lim = float(run.limits["score_gap"])
    flips = 0
    for (g_masks, _), (r_masks, r_sims, inv) in zip(got, ref_out):
        for b, r in enumerate(r_sims):
            far = np.abs(r[:, inv[b]] - thr) > lim
            flips += int(((g_masks[b] != r_masks[b]) & far).sum())
    return {"score_gap": score_gap(got, ref_out),
            "student_score_gap": score_gap(got, ref_own),
            "mask_flips": float(flips)}


def sample_calls(run, n_calls: int):
    rng = gen.rng_for(run.seed, 3)
    n = min(int(run.traffic["checked_calls"]), n_calls)
    return sorted(rng.choice(n_calls, n, replace=False).tolist())


def run(run) -> None:
    from dropclip_tpu_torch.kernels.brick_conv3 import counter

    dev = run.device
    b = build(run)
    pipe, traffic = b["pipe"], b["traffic"]
    for k in range(int(run.traffic["warm_calls"])):
        ground(pipe, traffic, -1 - k)
    run.setup_done()

    outs, lat, dropped = [], [], []
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < run.seconds:
        t = time.perf_counter()
        masks, sims = ground(pipe, traffic, k)
        lat.append(time.perf_counter() - t)
        outs.append((masks, sims))
        dropped.append(pipe.last_dropped)
        k += 1
    wall = time.perf_counter() - t0
    run.e2e["ground_scenes_per_s"] = k * traffic["batch"] / wall
    run.work["call_p95_ms"] = float(np.percentile(lat, 95)) * 1e3
    run.attempted = k
    run.failed = sum(1 for d, (_, sims) in zip(dropped, outs)
                     if d or not np.isfinite(sims).all())

    if run.trace:
        work = scene_work(run, traffic)
        run.work["window_flops"] = sum(
            work[i]["flops"] for c in range(k) for i in call_args(traffic,
                                                                  c)[0])
        run.work["window_s"] = wall
        at = [k]

        def unit():
            ground(pipe, traffic, at[0])
            at[0] += 1
            return at[0] - 1

        run.probe = trace.counted_profile(
            unit, int(run.traffic["profile_calls"]),
            lambda: counter.launches, lambda n: "brick_conv3" in n)
        scenes = [i for c in run.probe.units for i in call_args(traffic, c)[0]]
        run.work["k1_flops"] = sum(work[i]["k3_flops"] for i in scenes)
        run.work["k1_bytes"] = sum(work[i]["k3_bytes"] for i in scenes)
        run.work["dtype"] = run.config["student_dtype"]
    if dev == "cuda":
        run.memory_peak = torch.cuda.max_memory_allocated()
    w_student, w_text = b["w_student"], b["w_text"]
    checked = sample_calls(run, k)
    got = [outs[i] for i in checked]
    got_text = cached_text(pipe.clip_sim, traffic)
    del b, pipe, outs
    free()
    emb = text_features(run, w_text,
                        traffic["prompts"] + traffic["negatives"])
    if run.stand_in is not None:
        got, got_text = STAND_INS[run.stand_in](run, w_student, w_text, emb,
                                                traffic, checked)
    ref_out, ref_own = [], []
    for i in checked:
        student = reference_student(run, w_student, traffic, i)
        ref_out.append(reference_ground(run, student, traffic, i, emb))
        ref_own.append(reference_ground(run, student, traffic, i, got_text))
        del student
    run.compare(compare(run, got, ref_out, ref_own))


def scene_work(run, traffic) -> list:
    """Per ring scene, the student forward's work (``counting.
    student_work``), counted on the reference's voxelization."""
    arch = arch_of(run.config)
    vs = float(run.config["voxel_size"])
    return [counting.student_work(arch, counting.level_stats(
        [grounding.voxelize(xyz, rgb, vs)[0]]))
        for xyz, rgb in traffic["clouds"]]


def _control(text: str, student: str):
    """The reference one precision below the configuration's in the
    program's place: its text tower in ``text``, its student in
    ``student``; gives (what the comparison takes, its text features)."""
    def stand_in(run, w_student, w_text, emb, traffic, checked):
        if text != "bf16":
            emb = text_features(run, w_text, traffic["prompts"]
                                + traffic["negatives"], text)
        got = []
        for i in checked:
            out = reference_student(run, w_student, traffic, i, student)
            got.append(reference_ground(run, out, traffic, i, emb)[:2])
        return got, emb
    return stand_in


# controls judged in the program's place (calibration and tests): the
# student in TF32, and the text tower in fp8
STAND_INS = {"control_student_tf32": _control("bf16", "tf32"),
             "control_text_fp8": _control("fp8", "float32")}
