"""cv2 for the DINO v1 resize tests: the real module where it is
installed, else a stand-in whose ``resize`` samples the nearest source
pixel of each output pixel's centre. Both packages import cv2 inside the
functions that resize, so the stand-in in ``sys.modules`` reaches both and
they resize a frame to the same array."""

import importlib.util
import sys
import types

import numpy as np


def resize(image, size, interpolation=None):
    w, h = size
    rows = ((np.arange(h) + 0.5) * image.shape[0] / h).astype(np.int64)
    cols = ((np.arange(w) + 0.5) * image.shape[1] / w).astype(np.int64)
    return np.ascontiguousarray(image[rows][:, cols])


def use_cv2(monkeypatch) -> bool:
    """Makes ``import cv2`` work for one test; True when that is the
    stand-in."""
    if importlib.util.find_spec("cv2") is not None:
        return False
    mod = types.ModuleType("cv2")
    mod.resize, mod.INTER_LANCZOS4 = resize, 4
    monkeypatch.setitem(sys.modules, "cv2", mod)
    return True
