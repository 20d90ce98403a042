"""Evaluation metrics, masked and batch-vectorized.

Port of ``dropclip_tpu/core/metrics.py`` in torch ops on any device.
Definitions match the reference exactly:
- grounding: per-query binary-mask IoU with a 0.35 binarization threshold
  and Pr@{0.25,0.5,0.75} (reference utils/misc.py:22-50 ``trainMetricPC``);
- segmentation: K-class histogram intersection/union with an ignore index
  (reference utils/misc.py:186-199 ``intersectionAndUnionGPU``).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch


def grounding_metrics(
    pred: torch.Tensor,
    target: torch.Tensor,
    query_mask: Optional[torch.Tensor] = None,
    point_mask: Optional[torch.Tensor] = None,
    threshold: float = 0.35,
    pr_ious: Sequence[float] = (0.25, 0.5, 0.75),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean IoU (%) and Pr@iou (%) over per-query binary 3D masks.

    pred (Q, N) scores; target (Q, N) ground-truth masks; query_mask (Q,)
    real query rows; point_mask (Q, N) or (N,) real points. Returns
    (mean_iou_pct, pr_pct) with pr_pct shaped (len(pr_ious),).
    """
    pred = torch.as_tensor(pred)
    target = torch.as_tensor(target).bool()
    if pred.dim() == 1:
        pred, target = pred[None], target[None]
    q = pred.shape[0]
    if query_mask is None:
        query_mask = torch.ones((q,), dtype=torch.bool, device=pred.device)
    if point_mask is None:
        point_mask = torch.ones(pred.shape, dtype=torch.bool,
                                device=pred.device)
    point_mask = torch.as_tensor(point_mask).bool().expand(pred.shape)

    pred_bin = (pred >= threshold) & point_mask
    target = target & point_mask
    inter = (pred_bin & target).sum(1).float()
    union = (pred_bin | target).sum(1).float()
    iou = inter / (union + 1e-6)

    qvalid = torch.as_tensor(query_mask).float()
    # the reference starts its count at 1e-6 and divides the IoU sum by a
    # further +1e-6 (utils/misc.py:27-47); kept, so numbers compare with
    # reference logs
    count = qvalid.sum() + 1e-6
    mean_iou = (iou * qvalid).sum() / (count + 1e-6)
    prs = torch.stack([((iou > t).float() * qvalid).sum() / count
                       for t in pr_ious])
    return 100.0 * mean_iou, 100.0 * prs


def intersection_and_union(
    output: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    ignore_index: int = 255,
    valid_mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-class (intersection, union, target) histograms, each
    (num_classes,). Accumulate over batches, then mIoU = mean(inter /
    union), mAcc = mean(inter / target), allAcc = sum(inter) /
    sum(target)."""
    output = torch.as_tensor(output).reshape(-1).long()
    target = torch.as_tensor(target).reshape(-1).long()
    if valid_mask is not None:
        valid = torch.as_tensor(valid_mask).reshape(-1).bool()
    else:
        valid = torch.ones(output.shape, dtype=torch.bool,
                           device=output.device)
    valid = valid & (target != ignore_index)
    # masked elements go to an out-of-range bin
    output = torch.where(valid, output, num_classes)
    target = torch.where(valid, target, num_classes)
    inter_vals = torch.where(output == target, output, num_classes)
    n = num_classes + 1
    area_inter = torch.bincount(inter_vals, minlength=n)[:num_classes]
    area_out = torch.bincount(output, minlength=n)[:num_classes]
    area_tgt = torch.bincount(target, minlength=n)[:num_classes]
    return area_inter, area_out + area_tgt - area_inter, area_tgt


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None
                ) -> torch.Tensor:
    """Mean of ``x`` over the elements where ``mask`` is true."""
    mask = torch.as_tensor(mask).expand(x.shape).to(x.dtype)
    if axis is None:
        return (x * mask).sum() / mask.sum().clamp(min=1e-12)
    return (x * mask).sum(axis) / mask.sum(axis).clamp(min=1e-12)
