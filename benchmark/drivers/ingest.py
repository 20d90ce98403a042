"""Closed loop, one process on one card, of the port's MV-TOD ingest as
``tools/preprocess_data.run_blender`` drives it: a loader thread stages
scene i+1 on the card (``stage_scene``) while ``process_scene`` runs
scene i, and the ``SceneWriter`` thread finalizes scene i-1. Scenes come
in turn from a ring of dense renders made at set-up and held in host
memory (``benchmark/render.py``); each is staged to the card again every
time it comes round, as a dataset read from disk is. The writer keeps
each ring scene's newest output in memory: the h5 write and the raw
dataset reader are bypassed. Set-up ends after one warm scene.

``ingest_scenes_per_s`` is every scene the window started, each waited
for until its finalize finished, over that wall time (a scene in flight
when the window closes is waited for, and the wait counted). A scene
that dropped points, kept none, or fused a feature that is not finite
counts as failed. With ``--trace 1`` a profiled sub-window covers
``profile_scenes`` scenes, and one scene more runs after it, outside
it, with ``sync_timings`` for the phase times.

The teacher's weights are drawn by the benchmark on the card and loaded
into the program's CLIP tower; the extractor takes ``build_extractor``'s
settings (``build_extractor`` itself draws random weights on the CPU).
Once the window has closed and the program is freed, the plain
reference (``benchmark/reference/ingest.py``, ``clip_vision.py``,
``clip_text.py``) ingests each ring scene again from the same host
arrays and weights, and the comparison takes what the window wrote for
each (its newest pass) and what the program's fusion took and gave on
that pass. A stand-in (``STAND_INS``: the control and the planted
faults) takes the program's place in that comparison for calibration
and tests."""

from __future__ import annotations

import contextlib
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional

import numpy as np
import torch

from .. import counting_vit, render, trace, weights
from ..reference import clip_text, clip_vision
from ..reference import ingest as ref
from .train import free

VOCAB = os.path.join("dropclip_tpu_torch", "teachers", "assets",
                     "bpe_simple_vocab_16e6.txt.gz")
TEXT = "text."


def weight_shapes(config: Dict, teacher: Dict) -> Dict[str, tuple]:
    """The teacher's leaves under the program's CLIP names: the vision
    tower, the text tower and the logit scale."""
    shapes = clip_vision.weight_shapes(
        teacher["vision_width"], teacher["vision_layers"],
        teacher["patch_size"], teacher["image_resolution"],
        config["embed_dim"])
    shapes.update({TEXT + k: s for k, s in clip_text.weight_shapes(
        config["text_width"], config["text_layers"], config["text_vocab"],
        config["text_context"], config["embed_dim"]).items()})
    shapes["logit_scale"] = ()
    return shapes


def _init(name: str, shape: tuple) -> tuple:
    if name == "logit_scale":
        return 0.0, 2.6592
    if name.startswith(TEXT):
        return clip_text.init(name[len(TEXT):], shape)
    return clip_vision.init(name, shape)


def _linear(name: str) -> bool:
    return (clip_text.is_linear(name[len(TEXT):]) if name.startswith(TEXT)
            else clip_vision.is_linear(name))


def draw_teacher(config: Dict, teacher: Dict, seed: int, device
                 ) -> Dict[str, torch.Tensor]:
    """The teacher's weights from one draw on the device, stored as the
    tower serves them: the linears in bf16, the rest in float32."""
    w = weights.draw(weight_shapes(config, teacher), _init, seed, device)
    return {k: v.to(torch.bfloat16) if _linear(k) else v
            for k, v in w.items()}


def text_weights(w: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k[len(TEXT):]: v for k, v in w.items() if k.startswith(TEXT)}


def build_extractor(run, w: Dict[str, torch.Tensor]):
    """The program's CLIP in bf16 holding the benchmark's weights, in a
    ``ClipExtractor`` with ``build_extractor``'s settings."""
    from dropclip_tpu_torch.teachers.clip import CLIP, CLIP_CONFIGS
    from dropclip_tpu_torch.teachers.extractor import ClipExtractor

    ing, teacher = run.traffic["ingest"], run.traffic["teacher"]
    with torch.device("meta"):
        model = CLIP(**CLIP_CONFIGS[run.config["clip_model"]],
                     dtype=torch.bfloat16)
    model = model.cast_().to_empty(device=run.device)
    model.load_state_dict(w)
    return ClipExtractor(model.eval(), mode="cls",
                         visual_prompt=ing["visual_prompt"].split(","),
                         crop_num_levels=int(ing["crop_num_levels"]),
                         crop_expansion_ratio=float(
                             ing["crop_expansion_ratio"]),
                         img_resize=tuple(teacher["img_resize"]),
                         batch_size=int(ing["batch_size"]),
                         chunk=int(ing["chunk"]))


class Ingest:
    """The program's ingest over the ring, as ``run_blender`` drives it,
    with the ring scene's newest output (``out``) and what the program's
    object-prior fusion took and gave on that pass (``fusion``)."""

    def __init__(self, extractor, ring, ing: Dict):
        self.ex, self.ring, self.ing = extractor, ring, ing
        self.out: Dict[int, Dict] = {}
        self.fusion: Dict[int, Dict] = {}
        self.stats = []
        self.not_finite = 0   # written scenes with a fused row not finite
        self._current = None

    def clear(self) -> None:
        self.out.clear()
        self.fusion.clear()
        self.stats.clear()
        self.not_finite = 0

    def write(self, path: str, **scene) -> None:
        self.out[int(path)] = scene
        self.not_finite += int(not np.isfinite(scene["obj_feats"]).all())

    def stage(self, j: int) -> Dict:
        from dropclip_tpu_torch.tools.preprocess_data import stage_scene

        s = self.ring[j]
        return stage_scene(s["images"], s["depths"], s["segs"], s["poses"],
                           s["K"], device=self.ex.device)

    def kwargs(self, j: int) -> Dict:
        s, ing = self.ring[j], self.ing
        return dict(images=s["images"], depths=s["depths"], segs=s["segs"],
                    poses=s["poses"], K=s["K"], obj_info=s["obj_info"],
                    out_path=str(j), voxel_size=float(ing["voxel_size"]),
                    cloud_capacity=int(ing["cloud_capacity"]),
                    max_objects=int(ing["max_objects"]),
                    eval_scenario=ing["eval_scenario"],
                    sim_kernel=ing["sim_kernel"],
                    use_visibility=bool(ing["use_visibility"]),
                    use_similarity=bool(ing["use_similarity"]),
                    vis_threshold=float(ing["vis_threshold"]))

    @contextlib.contextmanager
    def recording(self):
        """The program's ``fuse_obj_prior``, as ``process_scene`` calls
        it, wrapped to keep its inputs and outputs by ring scene."""
        from dropclip_tpu_torch.tools import preprocess_data as pd

        real = pd.fuse_obj_prior

        def recorded(points, depths, segs, poses, obj_feats, present,
                     query_embs, K, cfg, obj_valid=None):
            out = real(points, depths, segs, poses, obj_feats, present,
                       query_embs, K, cfg, obj_valid=obj_valid)
            self.fusion[self._current] = dict(
                feats=obj_feats, present=present, query=query_embs,
                weights=out.weights, fused=out.obj_features)
            return out

        pd.fuse_obj_prior = recorded
        try:
            yield
        finally:
            pd.fuse_obj_prior = real

    def scenes(self, first: int, more) -> int:
        """Scenes ``first``, ``first + 1``, ... (ring indices taken
        modulo the ring) through the loader, ``process_scene`` and the
        writer, for as long as ``more(i)`` holds when scene i's successor
        would be staged; returns when the last finalize has finished,
        with the number of scenes run."""
        from dropclip_tpu_torch.tools.preprocess_data import (
            SceneWriter, process_scene)

        n = len(self.ring)
        i = first
        with ThreadPoolExecutor(1) as loader, self.recording():
            with SceneWriter() as writer:
                nxt = loader.submit(self.stage, i % n)
                while nxt is not None:
                    staged = nxt.result()
                    j = i % n
                    nxt = (loader.submit(self.stage, (i + 1) % n)
                           if more(i + 1 - first) else None)
                    self._current = j
                    process_scene(extractor=self.ex, writer=writer,
                                  write=self.write, staged=staged,
                                  **self.kwargs(j))
                    i += 1
            self.stats += [s for _, s in writer.results]
        return i - first

    def timed(self, j: int) -> Dict:
        """One scene with ``sync_timings``: its phase times, finalized
        inline."""
        from dropclip_tpu_torch.tools.preprocess_data import process_scene

        with self.recording():
            self._current = j
            return process_scene(extractor=self.ex, staged=self.stage(j),
                                 write=self.write, sync_timings=True,
                                 **self.kwargs(j))


def scene_work(run, ring) -> list:
    """Per ring scene, counted from the inputs: the teacher's chunks (of
    present (view, object) pairs) and its operations on the crops and
    the query texts."""
    cfg, tr = run.config, run.traffic
    ing, teacher = tr["ingest"], tr["teacher"]
    vit = counting_vit.vit_flops(teacher, int(cfg["embed_dim"]))
    levels = int(ing["crop_num_levels"])
    out = []
    for s in ring:
        pairs = int(ref.present_pairs(s["segs"],
                                      int(ing["max_objects"])).sum())
        texts = sum(len(t) for t in ref.query_texts(s["obj_info"]).values())
        crops = pairs * levels
        out.append(dict(chunks=max(-(-pairs // int(ing["chunk"])), 1),
                        flops=crops * (vit["linear"] + vit["attention"])
                        + counting_vit.text_flops(cfg, texts)))
    return out


def run(run) -> None:
    from dropclip_tpu_torch.ops.attention import oneshot_attention_packed

    dev, tr = run.device, run.traffic
    ing, teacher = tr["ingest"], tr["teacher"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ring = render.make_ring(tr, run.seed, dev)
    w = draw_teacher(run.config, teacher, run.seed + 1, dev)
    job = Ingest(build_extractor(run, w), ring, ing)
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
        work = scene_work(run, ring)
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

        counter = oneshot_attention_packed
        before = counter.launches
        run.probe = trace.counted_profile(
            unit, 1, lambda: counter.launches,
            lambda name: "attention_kernel" in name)
        layers = int(teacher["vision_layers"])
        ran = sum(work[i % n]["chunks"] for i in range(k, at[0])) * layers
        if dev == "cuda" and counter.launches - before != ran:
            raise RuntimeError(
                f"the traced scenes ran {counter.launches - before} "
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
    del job
    free()
    run.compare(judge(run, ring, w, got))


def reference_scene(run, w, data: Dict, tok, precision: str = "bf16",
                    fault: Optional[str] = None) -> Dict:
    tr, cfg = run.traffic, run.config
    return ref.scene(w, text_weights(w), tok, data, tr["teacher"],
                     tr["ingest"], int(cfg["text_heads"]), run.device,
                     int(tr["reference_batch"]), precision, fault)


NUMBERS = ("cloud_gap", "vis_flips", "crop_feat_gap", "query_gap",
           "weight_gap", "weightless_pairs", "fused_own_gap", "view_flips",
           "fused_gap")


def judge(run, ring, w, got: Dict[int, Dict]) -> Dict[str, float]:
    """The comparison of each ring scene's newest output with the
    reference's, the worst over the scenes; a stand-in's output, built
    from the reference, takes the program's place where one is set."""
    tok = clip_text.Tokenizer(os.path.join(run.root, VOCAB))
    nums = dict.fromkeys(NUMBERS, 0.0)
    for j, g in got.items():
        r = reference_scene(run, w, ring[j], tok)
        if run.stand_in is not None:
            g = STAND_INS[run.stand_in](run, w, ring[j], tok)
        for name, value in compare(run, g, r, ring[j]).items():
            nums[name] = max(nums[name], value)
        del r, g
    return nums


def _rel_gap(g: torch.Tensor, r: torch.Tensor) -> float:
    """The largest ``|g - r| / |r|`` over rows; inf where a row is not
    finite on one side only."""
    g, r = g.double(), r.double()
    gap = torch.linalg.vector_norm(g - r, dim=-1) \
        / torch.linalg.vector_norm(r, dim=-1)
    return float(torch.nan_to_num(gap, nan=np.inf).max()) if len(gap) \
        else 0.0


def compare(run, got: Dict, r: Dict, data: Dict) -> Dict[str, float]:
    """One scene's numbers.

    - ``cloud_gap``: the reference's written voxels missing from the
      program's cloud or labelled otherwise, and the program's voxels the
      reference would not write, over the reference's count (a voxel
      whose writing hinges on a borderline visibility left out);
    - ``vis_flips``: the (view, point) visibilities of the program's
      written points that differ from the reference's visibility of the
      same points, where their projection is not borderline;
    - ``crop_feat_gap``, ``query_gap``: the worst relative gap of a
      (view, object) teacher feature, of an object's query;
    - ``weight_gap``: the largest gap of a (view, object) fusion weight
      against the reference's rule given the program's own features and
      queries;
    - ``weightless_pairs``: the present (view, object) pairs the program
      gave no weight, where the rule gives each at least its floor;
    - ``fused_own_gap``: the worst relative gap of a written object
      feature against the reference's weighted mean given the program's
      own features and weights (a never-fused object's row against the
      program's query);
    - ``view_flips``: the (view, object) weights kept or dropped otherwise
      than by the reference, where the reference's margin lies farther
      from the threshold than ``crop_feat_gap``'s limit;
    - ``fused_gap``: the worst relative gap of a written object feature
      against the whole reference."""
    ing = run.traffic["ingest"]
    voxel = float(ing["voxel_size"])
    dev = r["key"].device
    sc, fu = got["scene"], got["fusion"]
    n_real = r["fused"].shape[0]
    xyz = torch.as_tensor(sc["xyz"], device=dev).double()
    g_key = ref.pack(torch.floor(xyz / voxel))
    g_lab = torch.as_tensor(sc["label"], device=dev).long()
    pos = torch.searchsorted(r["key"], g_key).clamp(
        max=len(r["key"]) - 1)
    hit = r["key"][pos] == g_key
    pos, g_lab = pos[hit], g_lab[hit]
    written = torch.zeros_like(r["sel"])
    written[pos[g_lab == r["label"][pos]]] = True
    sel = r["sel"] & ~r["doubt"]
    extra = int((~hit).sum()) + int((~r["sel"][pos] & ~r["doubt"][pos]).sum())
    cloud_gap = (int((sel & ~written).sum()) + extra) \
        / max(int(r["sel"].sum()), 1)
    vis, border = ref.visibility(xyz, data["depths"], data["poses"],
                                 data["K"], float(ing["vis_threshold"]))
    g_vis = torch.as_tensor(sc["vis_mask"], device=dev)
    out = dict(cloud_gap=cloud_gap,
               vis_flips=float(((g_vis != vis) & ~border).sum()))

    pres = fu["present"][:, :n_real].to(dev)
    if not torch.equal(pres, r["present"]):
        return {**out, **dict.fromkeys(NUMBERS[2:], np.inf)}
    g_feats = fu["feats"][:, :n_real].to(dev)
    g_query = fu["query"][:n_real].to(dev)
    g_w = fu["weights"][:n_real].T.to(dev).double()
    g_out = torch.as_tensor(sc["obj_feats"], device=dev)
    own_w, _ = ref.fuse(g_feats, pres, g_query,
                        use_similarity=bool(ing["use_similarity"]))
    own = ref.weighted_mean(g_feats, g_w)
    own = torch.where(torch.isnan(own).any(-1, keepdim=True),
                      g_query.double(), own)
    keep = g_w > 1e-6
    far = (r["margins"] - 1e-6).abs() > float(run.limits["crop_feat_gap"])
    return {**out,
            "crop_feat_gap": _rel_gap(g_feats[pres], r["feats"][pres]),
            "query_gap": _rel_gap(g_query, r["query"]),
            "weight_gap": float((g_w - own_w).abs().max()),
            "weightless_pairs": float(((g_w <= 0) & pres).sum()),
            "fused_own_gap": _rel_gap(g_out, own),
            "view_flips": float(((keep != (r["margins"] > 1e-6)) & pres
                                 & far).sum()),
            "fused_gap": _rel_gap(g_out, r["obj_feats"])}


def _as_program(r: Dict) -> Dict:
    """A reference scene in the shape of what the program wrote and its
    fusion took and gave."""
    sel = r["sel"]
    return dict(
        scene=dict(xyz=r["xyz"][sel].float().cpu().numpy(),
                   label=r["label"][sel].cpu().numpy(),
                   vis_mask=r["vis"][:, sel].cpu().numpy(),
                   obj_feats=r["obj_feats"].float().cpu().numpy()),
        fusion=dict(feats=r["feats"].cpu(), present=r["present"].cpu(),
                    query=r["query"].cpu(),
                    weights=r["weights"].T.float().cpu(),
                    fused=r["fused"].float().cpu()))


def _stand_in(precision: str = "bf16", fault: Optional[str] = None):
    """The reference in the program's place, at ``precision`` or with
    ``fault`` planted."""
    def stand_in(run, w, data, tok):
        return _as_program(reference_scene(run, w, data, tok, precision,
                                           fault))
    return stand_in


# the control (the teacher and text tower one precision below the
# configuration's bf16) and the planted faults, judged in the program's
# place (calibration and tests)
STAND_INS = {"control_teacher_fp8": _stand_in("fp8"),
             **{f"fault_{f}": _stand_in(fault=f) for f in ref.FAULTS}}
