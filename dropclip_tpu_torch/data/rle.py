"""COCO mask codec, in place of pycocotools' C extension.

Port of ``dropclip_tpu/data/rle.py``: the reference decodes instance masks
from COCO annotations during raw ingest (reference data/blender.py:65-85
via pycocotools.mask). Formats:

- compressed RLE: base-48 chars, 5 value bits + continuation bit per char,
  run-length deltas from position -2 (the pycocotools ``rleFrString``
  encoding), column-major runs alternating 0/1;
- uncompressed RLE: explicit ``counts`` list;
- polygons: rasterized with cv2.fillPoly (cv2 imported there only).

The compressed codec runs in C (``native/rle.c``, built under
``build/native/``) and falls back to numpy where no C compiler is found;
``native.route()`` says which ran.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Sequence, Union

import numpy as np

from .. import native


def _counts_from_string(s: Union[str, bytes]) -> List[int]:
    if isinstance(s, bytes):
        s = s.decode("ascii")
    cnts: List[int] = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(cnts) > 2:
            x += cnts[-2]
        cnts.append(x)
    return cnts


def _string_from_counts(cnts: Sequence[int]) -> str:
    out = []
    for i, cnt in enumerate(cnts):
        x = int(cnt)
        if i > 2:
            x -= int(cnts[i - 2])
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = (x != -1) if (c & 0x10) else (x != 0)
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _mask_from_counts(cnts: Sequence[int], h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in cnts:
        flat[pos: pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape((h, w), order="F")


def _counts_from_mask(mask: np.ndarray) -> List[int]:
    flat = np.asarray(mask, np.uint8).reshape(-1, order="F")
    change = np.flatnonzero(np.diff(flat)) + 1
    runs = np.diff(np.concatenate([[0], change, [flat.size]]))
    cnts = runs.tolist()
    if flat[0] == 1:  # counts always start with a zero-run
        cnts = [0] + cnts
    return cnts


def encode_rle(mask: np.ndarray) -> Dict:
    """Binary (H, W) mask -> compressed COCO RLE dict."""
    h, w = mask.shape
    lib = native.load()
    if lib is not None:
        flat = np.ascontiguousarray(np.asarray(mask, np.uint8).reshape(
            -1, order="F"))
        cap = 2 * h * w + 64
        buf = ctypes.create_string_buffer(cap)
        n = lib.rle_encode(flat.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), h, w, buf, cap)
        if n >= 0:
            return {"size": [h, w], "counts": buf.raw[:n].decode("ascii")}
    return {"size": [h, w],
            "counts": _string_from_counts(_counts_from_mask(mask))}


def decode_rle(segm: Dict) -> np.ndarray:
    """COCO RLE dict (compressed or uncompressed) -> (H, W) uint8 mask."""
    h, w = segm["size"]
    counts = segm["counts"]
    if isinstance(counts, (list, tuple)):
        return _mask_from_counts([int(c) for c in counts], h, w)
    lib = native.load()
    if lib is not None:
        s = counts.encode("ascii") if isinstance(counts, str) else counts
        out = np.zeros(h * w, np.uint8)
        n = lib.rle_decode(s, len(s), out.ctypes.data_as(
            ctypes.POINTER(ctypes.c_uint8)), h, w)
        if n >= 0:
            return out.reshape((h, w), order="F")
    return _mask_from_counts(_counts_from_string(counts), h, w)


def anno_to_mask(anno: Dict, h: int, w: int) -> np.ndarray:
    """COCO annotation (polygon / uncompressed / compressed RLE) ->
    (H, W) uint8 mask (reference data/blender.py:65-85 semantics)."""
    segm = anno["segmentation"]
    if isinstance(segm, list):  # polygon(s)
        import cv2

        mask = np.zeros((h, w), np.uint8)
        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2)
            cv2.fillPoly(mask, [np.round(pts).astype(np.int32)], 1)
        return mask
    return decode_rle(segm)
