"""Text-query grounding head: CLIP-feature vs prompt similarity -> 3D mask.

Port of ``dropclip_tpu/similarity.py`` (reference models/similarity.py:
8-101), with the same deliberate reference quirks:

- the "paired" score is softmax over [pos broadcast x N_neg, negs],
  first column: exp(p/T) / (N exp(p/T) + sum exp(n_i/T));
- the argmax path min-max-normalizes pos - mean(negs) but thresholds by
  class argmax.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

NEGATIVE_PROMPT_GENERIC = ["object", "thing", "texture", "stuff"]
SOFTMAX_TEMP = 0.1


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 0.0
                 ) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=dim, keepdim=True) + eps)


def paired_softmax_probs(vis_norm: torch.Tensor, pos_emb: torch.Tensor,
                         neg_embs: torch.Tensor, temp: float = SOFTMAX_TEMP,
                         neg_mask: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """(..., C) x (C,) x (K, C) -> (...,) positive probability (reference
    similarity.py:49-62): softmax over [pos x K_real, negs], first
    column. ``neg_mask`` (K,) marks the real rows of a padded negative
    set: padded rows add neither a negative term nor a positive copy."""
    pos = vis_norm @ pos_emb
    neg = vis_norm @ neg_embs.T
    if neg_mask is None:
        neg_mask = torch.ones(neg_embs.shape[0], dtype=torch.bool,
                              device=neg_embs.device)
    n_real = neg_mask.to(torch.float32).sum()
    hi = torch.maximum(pos, torch.where(neg_mask, neg, -torch.inf).amax(-1))
    e_pos = torch.exp((pos - hi) / temp)
    e_neg = torch.where(neg_mask, torch.exp((neg - hi[..., None]) / temp),
                        0.0)
    return torch.nan_to_num(e_pos / (n_real * e_pos + e_neg.sum(-1)))


def _masked_minmax(x: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Min-max normalize each row of (Q, N) over its valid entries (x/max
    when a row is constant)."""
    if mask is None:
        lo = x.amin(-1, keepdim=True)
        hi = x.amax(-1, keepdim=True)
    else:
        lo = torch.where(mask, x, torch.inf).amin(-1, keepdim=True)
        hi = torch.where(mask, x, -torch.inf).amax(-1, keepdim=True)
    return torch.where(hi != lo, (x - lo) / (hi - lo),
                       x / torch.where(hi == 0, 1.0, hi))


def predict_queries(
    vis_feats: torch.Tensor,
    pos_embs: torch.Tensor,
    neg_embs: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    method: str = "paired",
    threshold: float = 0.7,
    temp: float = SOFTMAX_TEMP,
    norm_vis_feat: bool = True,
    neg_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point binary masks + normalized similarities for Q queries at
    once (the JAX package's ``vmap`` of ``predict_from_embeddings``).

    vis_feats (N, C); pos_embs (Q, C) normalized; neg_embs (K, C) shared
    by every query or (Q, K, C) per query, normalized, or None; neg_mask
    (K,) or (Q, K) marks the real rows of a padded negative set (padded
    rows contribute neither a negative term nor a broadcast positive
    copy); mask (N,) validity of padded points. Returns (pred bool (Q, N),
    sims_norm f32 (Q, N)).
    """
    if norm_vis_feat:
        vis_feats = l2_normalize(vis_feats)
    vis = vis_feats.float()
    pos = pos_embs.float() @ vis.T  # (Q, N)

    if neg_embs is None:
        sims_norm = _masked_minmax(pos, mask)
        pred = sims_norm > threshold
    else:
        if neg_embs.dim() == 2:  # shared: (N, K) broadcast over queries
            neg = (vis @ neg_embs.float().T)[None]
        else:
            neg = torch.einsum("nc,qkc->qnk", vis, neg_embs.float())
        if neg_mask is None:
            neg_mask = torch.ones(neg_embs.shape[:-1], dtype=torch.bool,
                                  device=vis.device)
        nmask = (neg_mask if neg_mask.dim() == 2 else neg_mask[None])[:, None]
        n_real = nmask.float().sum(-1)  # (Q or 1, 1)
        if method == "paired":
            # softmax over [pos x K_real, negs], first column
            hi = torch.maximum(pos, torch.where(nmask, neg, -torch.inf)
                               .amax(-1))
            e_pos = torch.exp((pos - hi) / temp)
            e_neg = torch.where(nmask, torch.exp((neg - hi[..., None])
                                                 / temp), 0.0)
            sims = torch.nan_to_num(e_pos / (n_real * e_pos + e_neg.sum(-1)))
            sims_norm = _masked_minmax(sims, mask)
            pred = sims_norm > threshold
        elif method == "argmax":
            mean_neg = torch.where(nmask, neg, 0.0).sum(-1) / \
                n_real.clamp(min=1.0)
            sims_norm = _masked_minmax(pos - mean_neg, mask)
            pred = pos > torch.where(nmask, neg, -torch.inf).amax(-1)
        else:
            raise ValueError(f"unknown method {method!r}")

    if mask is not None:
        pred = pred & mask
    return pred, sims_norm.float()


def predict_from_embeddings(
    vis_feats: torch.Tensor,
    pos_emb: torch.Tensor,
    neg_embs: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    method: str = "paired",
    threshold: float = 0.7,
    temp: float = SOFTMAX_TEMP,
    norm_vis_feat: bool = True,
    neg_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point binary mask + normalized similarity for one query.

    vis_feats (N, C); pos_emb (C,) normalized; neg_embs (K, C) normalized
    or None; mask (N,) validity of padded rows. Returns (pred bool (N,),
    sims_norm f32 (N,)).
    """
    pred, sims = predict_queries(vis_feats, pos_emb[None], neg_embs, mask,
                                 method, threshold, temp, norm_vis_feat,
                                 neg_mask)
    return pred[0], sims[0]


class ClipSimilarity:
    """Prompts -> cached L2-normalized text embeddings -> per-point
    prediction (``predict``).

    ``model`` is a ``teachers.clip.CLIPTextTransformer`` on ``device``;
    ``method``, ``threshold`` and ``norm_vis_feat`` are ``predict``'s
    defaults. ``encodes`` counts text-tower runs (cache misses)."""

    def __init__(self, model, device, method: str = "paired",
                 threshold: float = 0.7, norm_vis_feat: bool = True):
        self.model = model
        self.device = torch.device(device)
        self.method = method
        self.threshold = threshold
        self.norm_vis_feat = norm_vis_feat
        self.encodes = 0
        self._cache = {}

    @torch.no_grad()
    def encode_text(self, prompts: Sequence[str]) -> torch.Tensor:
        """(K, C) L2-normalized float32 prompt embeddings, cached."""
        from .teachers.tokenizer import tokenize

        key = tuple(prompts)
        if key not in self._cache:
            toks = torch.as_tensor(tokenize(list(prompts)),
                                   device=self.device)
            emb = self.model(toks)
            self.encodes += 1
            self._cache[key] = l2_normalize(emb.float())
        return self._cache[key]

    def predict(self, vis_feats: torch.Tensor, qpos: str,
                qneg: Optional[List[str]] = None,
                mask: Optional[torch.Tensor] = None,
                norm_vis_feat: Optional[bool] = None,
                method: Optional[str] = None,
                threshold: Optional[float] = None):
        """(pred (N,), sims_norm (N,)) of query ``qpos`` against ``qneg``
        (an empty list takes the generic negatives, None none)."""
        method = method or self.method
        threshold = threshold if threshold is not None else self.threshold
        if norm_vis_feat is None:
            norm_vis_feat = self.norm_vis_feat
        pos_emb = self.encode_text([qpos])[0]
        neg_embs = None
        if qneg is not None:
            neg_embs = self.encode_text(qneg if len(qneg)
                                        else NEGATIVE_PROMPT_GENERIC)
        return predict_from_embeddings(
            vis_feats, pos_emb, neg_embs, mask=mask, method=method,
            threshold=threshold, norm_vis_feat=norm_vis_feat)
