"""Grasp containers + language-conditioned ranking.

Port of ``dropclip_tpu/grasp/grasps.py``. ``SceneGrasps`` ports the reference 6-DoF container (reference
utils/grasp.py:147-257): filter by score (> 3 x thresh, :200-206) or by
instance labels (:208-226), top-k / random subsets. ``Grasp2D`` /
``SceneGrasps2D`` port the 2D rectangle helpers (:70-144).

``rank_grasps_by_query`` implements the language-guided grasp ranking
capability (BASELINE config 5): ground a free-form text query in the
student's per-point CLIP features, then score each grasp by the grounded
similarity mass near its approach point, blended with its geometric
quality score, in torch ops on the device of the features.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np


class SceneGrasps:
    """Container over (N, 4, 4) poses + scores + instance labels."""

    def __init__(self, indices, poses, scores, labels):
        self.indices = np.asarray(indices)
        self.poses = np.asarray(poses)
        self.scores = np.asarray(scores)
        self.labels = np.asarray(labels)

    def __len__(self) -> int:
        return self.poses.shape[0]

    size = property(__len__)

    def filter(self, sel) -> "SceneGrasps":
        return SceneGrasps(self.indices[sel], self.poses[sel],
                           self.scores[sel], self.labels[sel])

    def filter_by_score(self, score_thresh: float) -> "SceneGrasps":
        """reference :200-206 — keeps scores > 3 * thresh."""
        return self.filter(self.scores > 3 * score_thresh)

    def filter_by_labels(self, obj_ids: Union[int, Sequence[int]]
                         ) -> "SceneGrasps":
        if isinstance(obj_ids, (int, np.integer)):
            obj_ids = [obj_ids]
        return self.filter(np.isin(self.labels, list(obj_ids)))

    def select_topk(self, k: int) -> "SceneGrasps":
        order = np.argsort(self.scores)[::-1][: min(k, len(self))]
        return self.filter(order)

    def sample(self, population: int,
               rng: Optional[np.random.Generator] = None) -> "SceneGrasps":
        rng = rng or np.random.default_rng()
        sel = rng.choice(len(self), size=min(population, len(self)),
                         replace=False)
        return self.filter(sel)

    def to_meshes(self, gripper_type: str = "marker"):
        """Gripper meshes posed at each grasp (reference :246-257)."""
        from .gripper import make

        v, f = make(gripper_type)
        out = []
        for p in self.poses:
            vh = np.c_[v, np.ones(len(v))] @ p.T
            out.append((vh[:, :3], f))
        return out

    def __repr__(self) -> str:
        return (f"SceneGrasps(n={len(self)}, score range "
                f"[{self.scores.min():.3f}, {self.scores.max():.3f}])"
                if len(self) else "SceneGrasps(empty)")


class Grasp2D:
    """Oriented 2D grasp rectangle (reference utils/grasp.py:70-94)."""

    def __init__(self, center, angle, quality, width, height=None,
                 deg: bool = False):
        self.center = center
        self.theta = angle if deg else np.rad2deg(angle)
        self.q = quality
        self.width = width
        self.height = height or 2 * self.width

    def as_tuple(self):
        return [self.center[0], self.center[1], self.width, self.height,
                self.theta]

    def as_rect(self) -> np.ndarray:
        import cv2

        cx, cy, w, h, t = [int(x) for x in self.as_tuple()]
        box = cv2.boxPoints(((cx, cy), (w, h), -(t + 180)))
        return np.intp(box)


class SceneGrasps2D:
    """List container over Grasp2D (reference :97-144)."""

    def __init__(self, grasps_input: List[Dict]):
        self.grasps = [Grasp2D(g["center"], g["angle"], g["quality"],
                               g["width"], g.get("height")) for g in grasps_input]

    def __len__(self) -> int:
        return len(self.grasps)

    @property
    def centers(self):
        return [g.center for g in self.grasps]

    @property
    def qualities(self):
        return [g.q for g in self.grasps]

    def get_rects(self):
        return [g.as_rect() for g in self.grasps]


def rank_grasps_by_query(
    points,
    point_feats,
    point_mask,
    grasp_positions,
    grasp_scores,
    pos_emb,
    neg_embs=None,
    radius: float = 0.05,
    sim_weight: float = 0.7,
    method: str = "paired",
):
    """Language-guided grasp ranking on the device of ``point_feats``.

    points: (N, 3); point_feats: (N, C) student per-point CLIP features;
    point_mask: (N,) valid points; grasp_positions: (G, 3) grasp
    translation components; grasp_scores: (G,) geometric quality;
    pos_emb (C,) and neg_embs (K, C) normalized text embeddings. Returns
    (order (G,) best-first, score (G,)) as tensors:
    score = sim_weight * (mean grounded similarity of the valid points
    within ``radius`` of the grasp) + (1 - sim_weight) * quality. Equal
    scores leave ``order`` to the sort, so compare orders only where the
    scores differ.
    """
    import torch

    from ..similarity import predict_from_embeddings

    feats = torch.as_tensor(point_feats)
    dev = feats.device
    as_dev = lambda x, dt=torch.float32: torch.as_tensor(x).to(dev, dt)
    mask = as_dev(point_mask, torch.bool)
    _, sims = predict_from_embeddings(
        feats, as_dev(pos_emb),
        None if neg_embs is None else as_dev(neg_embs), mask=mask,
        method=method)
    d2 = ((as_dev(grasp_positions)[:, None, :]
           - as_dev(points)[None, :, :]) ** 2).sum(-1)
    w = ((d2 <= radius * radius) & mask[None, :]).to(torch.float32)
    sim_mass = (w * sims[None, :]).sum(1) / w.sum(1).clamp_min(1.0)
    score = sim_weight * sim_mass + (1 - sim_weight) * as_dev(grasp_scores)
    order = torch.argsort(-score)
    return order, score
