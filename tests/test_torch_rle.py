"""The port's COCO mask codec (``dropclip_tpu_torch.data.rle``) against the
JAX package's (``dropclip_tpu.data.rle``) on masks drawn from a seed: the
same compressed strings and masks, round trips, uncompressed counts and
polygons; the C codec built under ``build/native/`` (never inside either
package) against the numpy codec; the JAX codec runs its numpy path, as
its C loader would build inside the JAX package. Exact equality
throughout."""

import os

import numpy as np
import pytest

from dropclip_tpu.data import rle as jrle
from dropclip_tpu_torch import native
from dropclip_tpu_torch.data import rle

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def jax_numpy_codec():
    """The JAX package's RLE codec on its numpy path: its C loader builds
    inside dropclip_tpu/native/, where these tests write nothing."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jrle, "_native", lambda: None)
        yield


def _masks(seed=0, n=6, h=48, w=64):
    rng = np.random.default_rng(seed)
    out = [np.zeros((7, 5), np.uint8), np.ones((7, 5), np.uint8)]
    for _ in range(n):
        m = np.zeros((h, w), np.uint8)
        for _ in range(4):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 8)
            m[y:y + rng.integers(2, 8), x:x + rng.integers(2, 8)] = 1
        out.append(m)
    out.append((rng.random((480, 640)) > 0.5).astype(np.uint8))
    return out


def test_native_builds_under_build_only():
    """The library lands in build/native/ of the checkout, named by a
    hash of the source; nothing is written beside the port's source."""
    lib = native.library_path()
    assert lib.parent == native.BUILD_DIR
    assert str(native.BUILD_DIR).startswith(os.path.join(ROOT, "build"))
    before = set(os.listdir(os.path.dirname(native.__file__)))
    assert native.load() is not None, "cc is on this machine"
    assert native.route() == f"native {lib}" and lib.exists()
    assert set(os.listdir(os.path.dirname(native.__file__))) <= before | {
        "__pycache__"}
    assert not any(f.endswith(".so") for f in before)


@pytest.mark.parametrize("seed", [0, 1])
def test_codec_matches_jax(seed):
    """Compressed strings equal the JAX package's, and both packages'
    decoders give the mask back from either string."""
    for m in _masks(seed):
        got, ref = rle.encode_rle(m), jrle.encode_rle(m)
        assert got == ref
        np.testing.assert_array_equal(rle.decode_rle(ref), m)
        np.testing.assert_array_equal(jrle.decode_rle(got), m)
        cnts = rle._counts_from_mask(m)
        assert cnts == jrle._counts_from_mask(m)
        assert rle._counts_from_string(got["counts"]) == cnts
        bytes_ = {"size": got["size"], "counts": got["counts"].encode()}
        np.testing.assert_array_equal(rle.decode_rle(bytes_), m)


def test_native_matches_numpy_codec():
    """The C codec's strings and masks equal the numpy codec's."""
    assert native.load() is not None
    for m in _masks(2):
        py = rle._string_from_counts(rle._counts_from_mask(m))
        assert rle.encode_rle(m)["counts"] == py
        np.testing.assert_array_equal(
            rle.decode_rle({"size": list(m.shape), "counts": py}), m)
        np.testing.assert_array_equal(
            rle._mask_from_counts(rle._counts_from_string(py), *m.shape), m)


def test_numpy_fallback_without_native(monkeypatch):
    """Where no library loads, the numpy codec gives the same strings."""
    monkeypatch.setattr(native, "load", lambda: None)
    assert native.route() == "numpy"
    for m in _masks(3):
        enc = rle.encode_rle(m)
        assert enc == jrle.encode_rle(m)
        np.testing.assert_array_equal(rle.decode_rle(enc), m)


def test_uncompressed_counts_and_polygons():
    pytest.importorskip("cv2")
    segm = {"size": [3, 4], "counts": [5, 2, 5]}
    np.testing.assert_array_equal(rle.decode_rle(segm),
                                  jrle.decode_rle(segm))
    for anno in ({"segmentation": [[2, 2, 20, 3, 18, 30, 4, 25]]},
                 {"segmentation": [[1, 1, 9, 1, 9, 9], [30, 5, 40, 5, 35, 20]]},
                 {"segmentation": segm},
                 {"segmentation": jrle.encode_rle(_masks(4)[3])}):
        h, w = (3, 4) if anno["segmentation"] is segm else (48, 64)
        got = rle.anno_to_mask(anno, h, w)
        np.testing.assert_array_equal(got, jrle.anno_to_mask(anno, h, w))
        assert got.dtype == np.uint8 and got.shape == (h, w)
