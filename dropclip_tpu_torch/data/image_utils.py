"""2D mask and box utilities on the host (numpy, cv2 where the reference
uses it).

Port of ``dropclip_tpu/data/image_utils.py`` (reference utils/image.py):
seg <-> binary masks, bbox, contour, centre and ellipse of a mask,
oriented bounding boxes, aspect-ratio padding. cv2 is imported inside the
functions that need it. The device versions of mask2box and its
expansion live in ``teachers/prompting.py``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def seg_mask_to_binary(seg: np.ndarray) -> np.ndarray:
    """(H, W) instance seg -> (K, H, W) binary masks, one per unique id
    (reference utils/image.py:6-8)."""
    ids = np.unique(seg)
    return np.stack([seg == i for i in ids])


def binary_masks_to_seg(masks: np.ndarray, ids: Optional[np.ndarray] = None
                        ) -> np.ndarray:
    """(K, H, W) + ids -> (H, W) seg; overlaps resolve to the MAX id
    (reference utils/image.py:11-15 ``np.max(masks * ids)``)."""
    if ids is None:
        ids = np.arange(masks.shape[0], dtype=np.uint8)
    ids = np.asarray(ids)
    return np.max(masks.astype(ids.dtype) * ids[:, None, None], axis=0)


def seg_continuous_ids(seg: np.ndarray) -> np.ndarray:
    """Remap arbitrary instance ids to 0..K-1 in sorted-id order
    (reference utils/image.py:18-22)."""
    _, new_ids = np.unique(seg, return_inverse=True)
    return new_ids.reshape(seg.shape).astype(np.uint8)


def mask2box(mask: np.ndarray) -> Optional[Tuple[int, int, int, int]]:
    """(x1, y1, x2, y2) exclusive, or None for an empty mask (reference
    utils/image.py:45-54)."""
    cols = np.nonzero(mask.sum(axis=0))[0]
    rows = np.nonzero(mask.sum(axis=1))[0]
    if len(cols) == 0:
        return None
    return int(cols.min()), int(rows.min()), int(cols.max()) + 1, \
        int(rows.max()) + 1


def mask2box_multi_level(mask: np.ndarray, level: int,
                         expansion_ratio: float = 0.1
                         ) -> Tuple[int, int, int, int]:
    """Expanded boxes per level (reference utils/image.py:77-86)."""
    x1, y1, x2, y2 = mask2box(mask)
    if level == 0:
        return x1, y1, x2, y2
    h, w = mask.shape
    xe = int(abs(x2 - x1) * expansion_ratio) * level
    ye = int(abs(y2 - y1) * expansion_ratio) * level
    return max(0, x1 - xe), max(0, y1 - ye), min(w, x2 + xe), min(h, y2 + ye)


def add_borders_to_image(image: np.ndarray, target_ratio: float,
                         use_color) -> np.ndarray:
    """Pad to a target W/H ratio with a fill color (reference
    utils/image.py:57-74)."""
    h, w = image.shape[:2]
    cur = w / h
    if cur > target_ratio:
        nh = int(w / target_ratio)
        p = (nh - h) // 2
        out = np.ones((nh, w) + image.shape[2:], image.dtype) * use_color
        out[p:p + h] = image
    elif cur < target_ratio:
        nw = int(h * target_ratio)
        p = (nw - w) // 2
        out = np.ones((h, nw) + image.shape[2:], image.dtype) * use_color
        out[:, p:p + w] = image
    else:
        out = image
    return out


def get_mask_contour(mask: np.ndarray) -> np.ndarray:
    """Largest external contour (reference utils/image.py:25-35)."""
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8) * 255,
                                   cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    return sorted(contours, key=cv2.contourArea, reverse=True)[0]


def get_mask_bbox(mask: np.ndarray) -> List[int]:
    """[x, y, w, h] of the largest contour (reference :38-42)."""
    import cv2

    return list(cv2.boundingRect(get_mask_contour(mask)))


def get_mask_center(mask: np.ndarray) -> Tuple[int, int]:
    """reference utils/image.py:96-98."""
    x, y, w, h = get_mask_bbox(mask)
    return int(x + w / 2), int(y + h / 2)


def get_mask_ellipse(mask: np.ndarray):
    """Fitted ellipse, bbox fallback (reference :88-95)."""
    import cv2

    cont = get_mask_contour(mask)
    try:
        return cv2.fitEllipse(cont)
    except cv2.error:
        x, y, w, h = cv2.boundingRect(cont)
        return ((x, y), (w, h), 0)


def get_oriented_bounding_box(mask: np.ndarray) -> np.ndarray:
    """minAreaRect corners over all contours (reference :105-119)."""
    import cv2

    contours, _ = cv2.findContours(mask.astype(np.uint8) * 255,
                                   cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    rect = cv2.minAreaRect(np.vstack(contours))
    return np.intp(cv2.boxPoints(rect))
