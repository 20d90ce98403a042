"""``dropclip_tpu_torch.data.image_utils`` (host numpy and cv2) against
``dropclip_tpu.data.image_utils`` on the cases of tests/test_image_utils.py
and a few more: every one of the 11 functions, results held equal."""

import numpy as np
import pytest

from dropclip_tpu.data import image_utils as jiu
from dropclip_tpu_torch.data import image_utils as tiu

NAMES = ("seg_mask_to_binary", "binary_masks_to_seg", "seg_continuous_ids",
         "mask2box", "mask2box_multi_level", "add_borders_to_image",
         "get_mask_contour", "get_mask_bbox", "get_mask_center",
         "get_mask_ellipse", "get_oriented_bounding_box")


def _same(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _masks():
    m = np.zeros((40, 50), np.uint8)
    m[10:30, 5:25] = 1
    blob = np.zeros((40, 50), np.uint8)
    yy, xx = np.mgrid[:40, :50]
    blob[(yy - 20) ** 2 / 120.0 + (xx - 28) ** 2 / 300.0 < 1] = 1
    blob[2:6, 40:47] = 1  # a second, smaller contour
    line = np.zeros((40, 50), np.uint8)
    line[12, 10:14] = 1  # too few points for an ellipse: the bbox fallback
    return [m, blob, line]


def test_every_function_is_ported():
    for name in NAMES:
        assert callable(getattr(tiu, name)), name


def test_seg_and_binary_masks():
    rng = np.random.RandomState(0)
    seg = rng.randint(0, 4, (20, 30)).astype(np.int32)
    masks = tiu.seg_mask_to_binary(seg)
    _same(masks, jiu.seg_mask_to_binary(seg))
    ids = np.unique(seg)
    _same(tiu.binary_masks_to_seg(masks, ids),
          jiu.binary_masks_to_seg(masks, ids))
    assert np.array_equal(tiu.binary_masks_to_seg(masks, ids), seg)
    _same(tiu.binary_masks_to_seg(masks), jiu.binary_masks_to_seg(masks))
    sparse_ids = np.where(seg == 3, 17, seg * 5)
    _same(tiu.seg_continuous_ids(sparse_ids),
          jiu.seg_continuous_ids(sparse_ids))


@pytest.mark.parametrize("level,ratio", [(0, 0.1), (1, 0.1), (2, 0.2),
                                         (3, 0.5)])
def test_boxes(level, ratio):
    for m in _masks():
        _same(tiu.mask2box(m), jiu.mask2box(m))
        _same(tiu.mask2box_multi_level(m, level, ratio),
              jiu.mask2box_multi_level(m, level, ratio))
    assert tiu.mask2box(np.zeros((5, 5), bool)) is None


@pytest.mark.parametrize("shape,ratio", [((10, 30, 3), 1.0),
                                         ((30, 10, 3), 1.0),
                                         ((12, 16, 3), 4 / 3),
                                         ((9, 20), 0.5)])
def test_add_borders(shape, ratio):
    img = (np.arange(np.prod(shape)) % 251).reshape(shape).astype(np.uint8)
    color = np.array([3, 4, 5], np.uint8) if len(shape) == 3 else 9
    _same(tiu.add_borders_to_image(img, ratio, color),
          jiu.add_borders_to_image(img, ratio, color))


def test_cv2_helpers():
    pytest.importorskip("cv2")
    for m in _masks():
        _same(tiu.get_mask_contour(m), jiu.get_mask_contour(m))
        _same(tiu.get_mask_bbox(m), jiu.get_mask_bbox(m))
        _same(tiu.get_mask_center(m), jiu.get_mask_center(m))
        _same(tiu.get_mask_ellipse(m), jiu.get_mask_ellipse(m))
        _same(tiu.get_oriented_bounding_box(m),
              jiu.get_oriented_bounding_box(m))
    x, y, w, h = tiu.get_mask_bbox(_masks()[0])
    assert (x, y, w, h) == (5, 10, 20, 20)
