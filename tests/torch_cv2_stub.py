"""cv2 for the tests that resize, read or write images: the real module
where it is installed, else a stand-in. Its ``resize`` samples the
nearest source pixel of each output pixel's centre; ``imwrite`` stores
the array itself (``np.save`` into the named file, whatever its
extension) and ``imread`` gives it back, three channels unless
``IMREAD_UNCHANGED``; ``boxPoints`` gives the corners of a rotated
rectangle. Both packages import cv2 inside the functions that use it, so
the stand-in in ``sys.modules`` reaches both and they read, write and
resize the same arrays."""

import importlib.util
import os
import sys
import types

import numpy as np

IMREAD_UNCHANGED = -1


def resize(image, size, interpolation=None):
    w, h = size
    rows = ((np.arange(h) + 0.5) * image.shape[0] / h).astype(np.int64)
    cols = ((np.arange(w) + 0.5) * image.shape[1] / w).astype(np.int64)
    return np.ascontiguousarray(image[rows][:, cols])


def imwrite(path, image):
    with open(path, "wb") as f:
        np.save(f, np.asarray(image))
    return True


def imread(path, flags=1):
    if not os.path.exists(path):
        return None
    with open(path, "rb") as f:
        image = np.load(f)
    if flags != IMREAD_UNCHANGED and image.ndim == 2:
        image = np.repeat(image[..., None], 3, axis=-1)
    return image


def boxPoints(box):
    (cx, cy), (w, h), angle = box
    a = np.deg2rad(angle)
    u = np.array([np.cos(a), np.sin(a)]) * w / 2
    v = np.array([-np.sin(a), np.cos(a)]) * h / 2
    c = np.array([cx, cy])
    return np.stack([c - u + v, c - u - v, c + u - v, c + u + v]).astype(
        np.float32)


def use_cv2(monkeypatch) -> bool:
    """Makes ``import cv2`` work while ``monkeypatch`` lasts; True when
    that is the stand-in."""
    if importlib.util.find_spec("cv2") is not None:
        return False
    mod = types.ModuleType("cv2")
    mod.resize, mod.INTER_LANCZOS4 = resize, 4
    mod.imread, mod.imwrite, mod.boxPoints = imread, imwrite, boxPoints
    mod.IMREAD_UNCHANGED = IMREAD_UNCHANGED
    monkeypatch.setitem(sys.modules, "cv2", mod)
    return True
