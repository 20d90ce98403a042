"""Distillation losses, masked and fixed-shape.

Port of ``dropclip_tpu/distill/loss.py`` (same masked means, the same
``_COS_EPS`` and the same closed forms):

- cosine distillation loss: ``(1 - CosineSimilarity(out, targets)).mean()``
  over valid voxels (reference engine/distil.py:154-156, torch eps 1e-8);
- L1 variant (engine/distil.py:157-158);
- per-object hinge auxiliary loss (engine/distil.py:52-96
  ``batch_aux_hinge_loss``): within-object cohesion plus a margin against
  the other objects' mean features, over a static ``max_labels`` axis with
  presence masks; the within-object mean pairwise cosine is
  ``||sum f^||^2 / n^2`` (torch's ``cos_sim.mean()`` includes the
  diagonal, so this is exact);
- classification-head cross entropy with ignore_index
  (engine/distil.py:116,187-192);
- supervised contrastive and triplet-KL losses
  (models/distil/loss.py:4-101).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_COS_EPS = 1e-8  # torch.nn.CosineSimilarity default


def _cosine_similarity(a: torch.Tensor, b: torch.Tensor,
                       eps: float = _COS_EPS) -> torch.Tensor:
    # sqrt(sum^2 + tiny) keeps the gradient finite at exactly-zero rows (a
    # relu stack can output an all-zero row for a real voxel)
    na = torch.sqrt((a * a).sum(-1) + 1e-24).clamp(min=eps)
    nb = torch.sqrt((b * b).sum(-1) + 1e-24).clamp(min=eps)
    return (a * b).sum(-1) / (na * nb)


def cosine_distil_loss(out: torch.Tensor, targets: torch.Tensor,
                       mask: torch.Tensor,
                       count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(1 - cos(out, target)) summed over valid voxels, over ``count`` of
    them (this batch's by default; the global batch's under a process
    group, so the ranks' losses sum to the global mean). Padded rows are
    replaced with ones before the norm, so no NaN gradient reaches them."""
    m = mask[..., None]
    safe_out = torch.where(m, out.float(), 1.0)
    safe_tgt = torch.where(m, targets.float(), 1.0)
    cos = _cosine_similarity(safe_out, safe_tgt)
    w = mask.float()
    n = w.sum() if count is None else count
    return ((1.0 - cos) * w).sum() / n.clamp(min=1.0)


def l1_distil_loss(out: torch.Tensor, targets: torch.Tensor,
                   mask: torch.Tensor,
                   count: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Absolute error summed over valid voxel-feature entries, over
    ``count`` valid voxels (default this batch's) times the width."""
    w = mask.float()[..., None]
    err = (out.float() - targets.float()).abs() * w
    n = w.sum() if count is None else count
    return err.sum() / (n * out.shape[-1]).clamp(min=1.0)


def _hinge_single(features: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor, max_labels: int, margin: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-scene (pos_loss, margin_loss), batched over a leading scene
    axis: features (B, M, C), labels and mask (B, M) -> (B,), (B,)
    (reference engine/distil.py:64-93)."""
    mf = mask[..., None]
    f32 = torch.where(mf, features.float(), 1.0)
    fnorm = torch.sqrt((f32 * f32).sum(-1, keepdim=True) + 1e-24)
    fhat = f32 / fnorm.clamp(min=1e-12) * mf

    onehot = F.one_hot(labels.long().clamp(0, max_labels - 1),
                       max_labels).float()
    # jax.nn.one_hot gives a zero row for an out-of-range label
    onehot = onehot * ((labels >= 0) & (labels < max_labels))[..., None]
    onehot = onehot * mf
    counts = onehot.sum(1)                                  # (B, L)
    present = counts > 0
    presf = present.float()
    k = presf.sum(-1).clamp(min=1.0)                        # (B,)

    sums = onehot.transpose(1, 2) @ fhat                    # (B, L, C)
    safe_counts = counts.clamp(min=1.0)
    mean_feats = torch.where(present[..., None],
                             sums / safe_counts[..., None], 1.0)
    mnorm = torch.sqrt((mean_feats ** 2).sum(-1, keepdim=True) + 1e-24)
    mean_hat = mean_feats / mnorm.clamp(min=_COS_EPS) * presf[..., None]

    pos_cos = (sums * sums).sum(-1) / safe_counts ** 2      # (B, L)
    cross = sums @ mean_hat.transpose(1, 2)                 # (B, L, L)
    cross = cross * (1.0 - torch.eye(max_labels, device=cross.device))
    cross = cross * presf[:, None, :]
    neg_cos = cross.sum(-1) / (safe_counts * k[:, None])

    pos_loss = ((1.0 - pos_cos) * presf).sum(-1) / k
    margin_loss = ((-pos_cos + neg_cos + margin).clamp(min=0.0)
                   * presf).sum(-1) / k
    return pos_loss, margin_loss


def aux_hinge_loss(features: torch.Tensor, labels: torch.Tensor,
                   mask: torch.Tensor, max_labels: int,
                   margin: float = 0.05, n_scenes: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched per-object hinge auxiliary loss. features (B, M, C); labels
    (B, M) int in [0, max_labels); mask (B, M). Returns (pos_loss,
    margin_loss) scalars, each summed over the scenes and divided by
    ``n_scenes`` (default B: the batch mean, reference
    ``batch_aux_hinge_loss``)."""
    pos, mar = _hinge_single(features, labels, mask, max_labels, margin)
    n = pos.shape[0] if n_scenes is None else n_scenes
    return pos.sum() / n, mar.sum() / n


def cross_entropy_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                           mask: torch.Tensor, ignore_label: int = 255,
                           count: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Per-voxel CE with an ignore index (reference
    engine/distil.py:116,187-192), summed and divided by ``count``
    labelled voxels (default this batch's)."""
    valid = mask & (labels != ignore_label)
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    w = valid.float()
    n = w.sum() if count is None else count
    return (nll * w).sum() / n.clamp(min=1.0)


def average_cosine_distance(out: torch.Tensor, targets: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Eval-side alias of the cosine loss (reference
    models/distil/loss.py:104-123)."""
    return cosine_distil_loss(out, targets, mask)


def supervised_contrastive_loss(features: torch.Tensor, labels: torch.Tensor,
                                mask: torch.Tensor, temperature: float = 0.07,
                                base_temperature: float = 0.07
                                ) -> torch.Tensor:
    """SupCon over labeled points (reference models/distil/loss.py:4-56,
    Khosla et al. 2020), masked for padded rows. features (K, C); labels
    (K,); mask (K,). Anchors with no positives contribute 0."""
    f32 = torch.where(mask[:, None], features.float(), 1.0)
    fhat = f32 / torch.linalg.vector_norm(f32, dim=-1,
                                          keepdim=True).clamp(min=1e-12)
    k = labels.shape[0]
    valid_pair = mask[:, None] & mask[None, :]
    eye = torch.eye(k, dtype=torch.bool, device=labels.device)
    pos_mask = (labels[:, None] == labels[None, :]) & ~eye & valid_pair
    logits_mask = ~eye & valid_pair

    logits = (fhat @ fhat.T) / temperature
    # a padded anchor has no valid pair; its row max is taken as 0 (its
    # terms are all masked) so no inf reaches exp or the gradient
    row_max = torch.where(valid_pair, logits, -torch.inf).amax(
        1, keepdim=True)
    row_max = torch.where(mask[:, None], row_max, 0.0)
    logits = logits - row_max.detach()
    exp_logits = torch.where(logits_mask, torch.exp(logits), 0.0)
    log_prob = logits - torch.log(exp_logits.sum(1, keepdim=True).clamp(
        min=1e-12))

    n_pos = pos_mask.sum(1)
    mean_log_prob = torch.where(pos_mask, log_prob, 0.0).sum(1) / \
        n_pos.clamp(min=1)
    per_anchor = -(temperature / base_temperature) * mean_log_prob
    w = (mask & (n_pos > 0)).float()
    return (per_anchor * w).sum() / w.sum().clamp(min=1.0)


def triplet_kl_loss(anchor: torch.Tensor, positive: torch.Tensor,
                    negative: torch.Tensor, margin: float = 1.0,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Triplet loss over softmax distributions with KL divergence
    (reference models/distil/loss.py:60-101): relu(KL(a||p) - KL(a||n) +
    m), with the reference's argument order to F.kl_div (the anchor is
    the log-distribution input)."""
    a = torch.softmax(anchor.float(), dim=1)
    p = torch.softmax(positive.float(), dim=1)
    n = torch.softmax(negative.float(), dim=1)
    log_a = torch.log(a.clamp(min=1e-30))

    def kl(target):
        return (target * (torch.log(target.clamp(min=1e-30)) - log_a)).sum(1)

    losses = torch.relu(kl(p) - kl(n) + margin)
    if mask is not None:
        w = mask.float()
        return (losses * w).sum() / w.sum().clamp(min=1.0)
    return losses.mean()
