"""Text-query grounding head: CLIP-feature vs prompt similarity -> 3D mask.

Port of ``dropclip_tpu/similarity.py`` (reference models/similarity.py:
8-101), with the same deliberate reference quirks:

- the "paired" score is softmax over [pos broadcast x N_neg, negs],
  first column: exp(p/T) / (N exp(p/T) + sum exp(n_i/T));
- the argmax path min-max-normalizes pos - mean(negs) but thresholds by
  class argmax.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

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
    """(..., C) x (C,) x (K, C) -> (...,) positive probability; padded
    negative rows (``neg_mask`` False) contribute nothing."""
    pos = vis_norm @ pos_emb
    neg = vis_norm @ neg_embs.T
    if neg_mask is None:
        neg_mask = torch.ones(neg_embs.shape[0], dtype=torch.bool,
                              device=neg.device)
    n_real = neg_mask.float().sum()
    hi = torch.maximum(pos, torch.where(neg_mask, neg, -torch.inf).amax(-1))
    e_pos = torch.exp((pos - hi) / temp)
    e_neg = torch.where(neg_mask, torch.exp((neg - hi[..., None]) / temp),
                        0.0)
    denom = n_real * e_pos + e_neg.sum(-1)
    return torch.nan_to_num(e_pos / denom)


def _masked_minmax(x: torch.Tensor, mask: Optional[torch.Tensor]
                   ) -> torch.Tensor:
    """Min-max normalize over valid entries (x/max when constant)."""
    if mask is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.where(mask, x, torch.inf).min()
        hi = torch.where(mask, x, -torch.inf).max()
    return torch.where(hi != lo, (x - lo) / (hi - lo),
                       x / torch.where(hi == 0, 1.0, hi))


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
    if norm_vis_feat:
        vis_feats = l2_normalize(vis_feats)
    vis_feats = vis_feats.float()

    if neg_embs is None:
        sims_norm = _masked_minmax(vis_feats @ pos_emb, mask)
        pred = sims_norm > threshold
    elif method == "paired":
        sims = paired_softmax_probs(vis_feats, pos_emb, neg_embs, temp,
                                    neg_mask=neg_mask)
        sims_norm = _masked_minmax(sims, mask)
        pred = sims_norm > threshold
    elif method == "argmax":
        if neg_mask is None:
            neg_mask = torch.ones(neg_embs.shape[0], dtype=torch.bool,
                                  device=vis_feats.device)
        raw_pos = vis_feats @ pos_emb
        raw_neg = vis_feats @ neg_embs.T
        n_real = torch.clamp(neg_mask.float().sum(), min=1.0)
        mean_neg = torch.where(neg_mask, raw_neg, 0.0).sum(-1) / n_real
        sims_norm = _masked_minmax(raw_pos - mean_neg, mask)
        pred = raw_pos > torch.where(neg_mask, raw_neg, -torch.inf).amax(-1)
    else:
        raise ValueError(f"unknown method {method!r}")

    if mask is not None:
        pred = pred & mask
    return pred, sims_norm.float()


class ClipSimilarity:
    """Prompts -> cached L2-normalized text embeddings.

    ``model`` is a ``teachers.clip.CLIPTextTransformer`` on ``device``.
    ``encodes`` counts text-tower runs (cache misses)."""

    def __init__(self, model, device):
        self.model = model
        self.device = torch.device(device)
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
