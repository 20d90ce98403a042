"""Evaluation loops: grounding (text-query 3D masks) and semantic
segmentation.

Port of ``dropclip_tpu/distill/evaluate.py`` (reference
engine/distil.py:235-532 and tools/validate_blender.py:80-263). The host
assembles each scene's queries into padded (Qmax, ...) tensors on the
device (positives, per-query negative sets, ground-truth masks), and one
batched set of tensor ops scores every query of the scene
(``make_grounding_scorer``), where the reference calls CLIP.predict per
query in a Python loop.

Every scene of a batch is scored; ``compat_last_scene_only=True``
reproduces the reference, which scores only the last scene of each batch
(engine/distil.py:436-460, validate_blender.py:150-189).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.metrics import grounding_metrics, intersection_and_union
from ..similarity import NEGATIVE_PROMPT_GENERIC, predict_queries

PR_IOUS = (0.25, 0.5, 0.75)


def scene_query_plan(obj_queries: Dict, sim_negatives: str = "generic",
                     cls_list: Optional[Sequence[str]] = None
                     ) -> List[Tuple[str, List[int], Optional[List[str]]]]:
    """A scene's query dict as (text, gt_obj_ids, negatives) rows.

    Blender ``{obj_id: [texts]}`` (validate_blender.py:154-189: one query
    per text, gt = that object) and REGRAD ``{name: [obj_ids]}``
    (engine/distil.py:439-459: gt = their union). ``sim_negatives``:
    "generic", "scene" (the scene's other queries), "no" (None) or "all"
    (every class of ``cls_list`` but the query's own text).
    """
    plan = []
    for key, val in obj_queries.items():
        blender = isinstance(key, (int, np.integer))
        if blender:
            if int(key) == 0:
                continue
            texts, gt_ids = list(val), [int(key)]
        else:
            texts, gt_ids = [str(key)], [int(x) for x in val]
        for text in texts:
            if sim_negatives == "generic":
                negs: Optional[List[str]] = list(NEGATIVE_PROMPT_GENERIC)
            elif sim_negatives == "scene":
                negs = []
                for k2, v2 in obj_queries.items():
                    if k2 in (0, key):
                        continue
                    negs.extend(list(v2) if blender else [str(k2)])
            elif sim_negatives == "no":
                negs = None
            elif sim_negatives == "all":
                if cls_list is None:
                    raise ValueError("sim_negatives=all needs cls_list")
                negs = [x for x in cls_list if x != text]
            else:
                raise ValueError(f"unknown sim_negatives {sim_negatives!r}")
            plan.append((text, gt_ids, negs))
    return plan


def make_grounding_scorer(method: str, threshold: float):
    """``score(out, mask, pos, negs, nmask, use_negs, gts, qmask) ->
    (miou, prs)`` for one scene: out (M, C) features, mask (M,), pos
    (Q, C), negs (Q, K, C) with real rows ``nmask`` (Q, K), use_negs (Q,)
    (False: the query has no negatives), gts (Q, M), qmask (Q,) real
    queries. Every query in one batched pass; metrics as device
    scalars."""

    def score(out, mask, pos, negs, nmask, use_negs, gts, qmask):
        pred_n, _ = predict_queries(out, pos, negs, mask=mask, method=method,
                                    threshold=threshold, neg_mask=nmask)
        pred_0, _ = predict_queries(out, pos, None, mask=mask, method=method,
                                    threshold=threshold)
        preds = torch.where(use_negs[:, None], pred_n, pred_0)
        return grounding_metrics(preds.float(), gts & mask, query_mask=qmask,
                                 point_mask=mask, pr_ious=PR_IOUS)

    return score


def _pad_queries(clip_sim, plan, labels: np.ndarray, q_cap: int, k_cap: int,
                 feat_dim: int, device):
    """One scene's query plan as padded (q_cap, ...) tensors on
    ``device``; the last item says whether queries past q_cap were
    dropped."""
    pos = torch.zeros((q_cap, feat_dim), dtype=torch.float32, device=device)
    negs = torch.zeros((q_cap, k_cap, feat_dim), dtype=torch.float32,
                       device=device)
    nmask = np.zeros((q_cap, k_cap), bool)
    use_negs = np.zeros((q_cap,), bool)
    gts = np.zeros((q_cap, labels.shape[0]), bool)
    qmask = np.zeros((q_cap,), bool)
    for i, (text, gt_ids, neg_texts) in enumerate(plan[:q_cap]):
        pos[i] = clip_sim.encode_text([text])[0]
        if neg_texts is not None:
            neg_texts = neg_texts or list(NEGATIVE_PROMPT_GENERIC)
            k = min(len(neg_texts), k_cap)
            negs[i, :k] = clip_sim.encode_text(neg_texts)[:k]
            nmask[i, :k] = True
            use_negs[i] = True
        gts[i] = np.isin(labels, gt_ids)
        qmask[i] = True
    put = lambda a: torch.as_tensor(a).to(device)
    return (pos, negs, put(nmask), put(use_negs), put(gts), put(qmask),
            len(plan) > q_cap)


def validate_grounding(loader, forward: Callable, clip_sim, cfg,
                       cls_list: Optional[Sequence[str]] = None,
                       compat_last_scene_only: bool = False,
                       max_queries: int = 32, max_negatives: int = 64
                       ) -> Dict:
    """mIoU, Pr@{25,50,75} and the mean DistilLoss over ``loader``.
    ``forward(batch) -> ((B, M, C) features, distil loss)``: the student,
    or the fused targets for the upper-bound eval
    (validate_upper_bound.py:191-192)."""
    method = cfg.sim_method or "paired"
    threshold = float(cfg.sim_norm_thresh or 0.7)
    scorer = make_grounding_scorer(method, threshold)
    sim_negatives = cfg.sim_negatives or "generic"

    ious, prs, dlosses = [], [], []
    dropped = 0
    for batch in loader:
        out, dloss = forward(batch)
        dlosses.append(float(dloss))
        b = out.shape[0]
        mask = torch.as_tensor(np.asarray(batch["mask"])).to(out.device)
        for s in ([b - 1] if compat_last_scene_only else range(b)):
            plan = scene_query_plan(batch["queries"][s], sim_negatives,
                                    cls_list)
            if not plan:
                continue
            labels = np.asarray(batch["labels"][s])
            *query, over = _pad_queries(clip_sim, plan, labels, max_queries,
                                        max_negatives, out.shape[-1],
                                        out.device)
            dropped += int(over)
            miou, pr = scorer(out[s], mask[s], *query)
            ious.append(float(miou))
            prs.append(pr.cpu().numpy())
    if dropped:
        print(f"[validate_grounding] {dropped} scenes exceeded "
              f"max_queries={max_queries}; extra queries skipped")
    prs = np.mean(np.stack(prs), axis=0) if prs else np.zeros(3)
    return {
        "mIoU": float(np.mean(ious)) if ious else 0.0,
        "Pr@25": float(prs[0]), "Pr@50": float(prs[1]), "Pr@75": float(prs[2]),
        "DistilLoss": float(np.mean(dlosses)) if dlosses else 0.0,
    }


def validate_segmentation(loader, forward: Callable, cls_embs: torch.Tensor,
                          cfg) -> Dict:
    """Zero-shot semantic segmentation: per-point argmax over class text
    embeddings -> histogram mIoU/mAcc/allAcc (reference engine/distil.py:
    235-346). ``cls_embs``: (n_classes, C) text embeddings, normalized
    here (:245-247); batches must carry ``labels_cls`` (the REGRAD
    dataset's class ids)."""
    n_classes = int(cfg.n_classes)
    ignore = int(cfg.ignore_label or 255)
    cls_n = (cls_embs / torch.linalg.vector_norm(cls_embs, dim=-1,
                                                 keepdim=True)).float()
    inter = np.zeros(n_classes)
    union = np.zeros(n_classes)
    target = np.zeros(n_classes)
    dlosses = []
    for batch in loader:
        if "labels_cls" not in batch:
            raise KeyError("segmentation eval needs labels_cls in every "
                           "batch (per-point class ids)")
        out, dloss = forward(batch)
        dlosses.append(float(dloss))
        put = lambda k: torch.as_tensor(np.asarray(batch[k])).to(out.device)
        mask, labels, labels_cls = put("mask"), put("labels"), \
            put("labels_cls")
        for s in range(out.shape[0]):
            valid = mask[s] & (labels[s] != 0)  # drop the table (:281-285)
            pred = (out[s].float() @ cls_n.T.to(out.device)).argmax(-1)
            i, u, t = intersection_and_union(pred, labels_cls[s], n_classes,
                                             ignore_index=ignore,
                                             valid_mask=valid)
            inter += i.cpu().numpy()
            union += u.cpu().numpy()
            target += t.cpu().numpy()
    iou_class = inter / (union + 1e-10)
    acc_class = inter / (target + 1e-10)
    return {
        "mIoU": float(np.mean(iou_class)),
        "mAcc": float(np.mean(acc_class)),
        "allAcc": float(inter.sum() / (target.sum() + 1e-10)),
        "SimLoss": float(np.mean(dlosses)) if dlosses else 0.0,
    }
