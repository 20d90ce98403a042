"""The extraction CLIs: dropclip_tpu_torch.tools.dino_extract and
clip_extract against the JAX package's, each ``main()`` run in process on
the same .npy frames and the same checkpoint file, with each package's
``dino_extract._read_rgb`` replaced by a numpy reader (the JAX files are
not touched). float32 outputs must agree within 1e-5 of max|ref|, bf16
ones at cosine >= 0.999 per feature vector."""

import glob
import os
import sys

import numpy as np
import pytest
import torch

from dropclip_tpu.tools import clip_extract as jclip_extract
from dropclip_tpu.tools import dino_extract as jdino_extract
from dropclip_tpu_torch.teachers import convert, dino_v1, dinov2
from dropclip_tpu_torch.tools import clip_extract, dino_extract
from torch_cv2_stub import use_cv2


@pytest.fixture
def frames(tmp_path, monkeypatch):
    """Three 80x96 RGB frames as .npy files; both packages read them
    with np.load."""
    rs = np.random.RandomState(0)
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(3):
        np.save(d / f"f{i}.npy",
                (rs.rand(80, 96, 3) * 255).astype(np.uint8))
    for mod in (jdino_extract, dino_extract):
        monkeypatch.setattr(mod, "_read_rgb", np.load)
    return str(d / "*.npy")


def _run(tmp_path, monkeypatch, jmain, main, args):
    """Both CLIs on ``args``; {name: (jax array, port array)}."""
    outs = {}
    for tag, run in (("jax", jmain), ("port", main)):
        out = str(tmp_path / tag)
        full = args + ["--out", out]
        if tag == "jax":
            monkeypatch.setattr(sys, "argv", ["cli"] + full)
            run()
        else:
            run(full + ["--device", "cpu"])
        outs[tag] = {os.path.basename(f): np.load(f) for f in
                     sorted(glob.glob(os.path.join(out, "*.npy")))}
    assert outs["jax"].keys() == outs["port"].keys() and outs["jax"]
    return {k: (_f32(outs["jax"][k]), outs["port"][k]) for k in outs["jax"]}


def _f32(a):
    """A .npy array as float32; bf16 arrays come back as 2-byte voids."""
    if a.dtype.kind == "V":
        import ml_dtypes

        a = a.view(ml_dtypes.bfloat16)
    return a.astype(np.float32)


def _within(pairs, rel=1e-5):
    for name, (ref, got) in pairs.items():
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        err = np.abs(got - ref).max()
        assert err <= rel * np.abs(ref).max(), (name, err)


def _cosine(pairs, limit=0.999):
    for name, (ref, got) in pairs.items():
        assert got.dtype == np.float32 and got.shape == ref.shape, name
        r = ref.reshape(-1, ref.shape[-1])
        g = got.reshape(-1, got.shape[-1])
        cos = (r * g).sum(-1) / (np.linalg.norm(r, axis=-1)
                                 * np.linalg.norm(g, axis=-1))
        assert cos.min() >= limit, (name, cos.min())


@pytest.mark.parametrize("mode", ["cls", "patch"])
def test_dino_extract_dinov2_matches_jax(tmp_path, monkeypatch, frames,
                                         mode):
    """DINOv2 tiny-test in bf16 from a HuggingFace-layout file, batches of
    2 over 3 frames resized to 28x42."""
    ckpt = str(tmp_path / "dinov2.pt")
    torch.save(dinov2.synthetic_hf_dinov2_state_dict("tiny-test", seed=1),
               ckpt)
    pairs = _run(tmp_path, monkeypatch, jdino_extract.main,
                 dino_extract.main,
                 ["--images", frames, "--model", "tiny-test", "--checkpoint",
                  ckpt, "--mode", mode, "--resize", "28", "42",
                  "--batch-size", "2"])
    shape = (64,) if mode == "cls" else (2, 3, 64)
    assert all(p[1].shape == shape for p in pairs.values())
    _cosine(pairs)


@pytest.mark.parametrize("extra", [[], ["--bin"], ["--facet", "token"]])
def test_dino_extract_dino_v1_matches_jax(tmp_path, monkeypatch, frames,
                                          extra):
    """DINO v1 tiny-test at stride 2 from a facebookresearch/dino-layout
    file, layer 1 key (binned) or token descriptors, frames resized to a
    short side of 16 (cv2, or its stand-in in both packages where cv2 is
    not installed): float32 within 1e-5."""
    use_cv2(monkeypatch)
    ckpt = str(tmp_path / "dino_v1.pt")
    torch.save(dino_v1.synthetic_dino_v1_state_dict("tiny-test", seed=2),
               ckpt)
    pairs = _run(tmp_path, monkeypatch, jdino_extract.main,
                 dino_extract.main,
                 ["--images", frames, "--model", "tiny-test", "--family",
                  "dino_v1", "--checkpoint", ckpt, "--stride", "2",
                  "--layer", "1", "--load-size", "16"] + extra)
    _within(pairs)


@pytest.fixture(scope="module")
def clip_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("clip")
    out = {}
    for name in ("tiny-test", "tiny-test-rn"):
        out[name] = str(d / f"{name}.pt")
        torch.save(convert.synthetic_openai_state_dict(name, seed=3),
                   out[name])
    return out


@pytest.mark.parametrize("model,mode", [
    ("tiny-test", "cls"), ("tiny-test", "patch"), ("tiny-test", "tiled"),
    ("tiny-test-rn", "patch")])
def test_clip_extract_matches_jax(tmp_path, monkeypatch, frames,
                                  clip_files, model, mode):
    """The ingest extractor in bf16 at 336x448 from an OpenAI-layout file,
    ViT or RN; tiled mode: a 64-pixel centre crop in 32-pixel tiles."""
    pairs = _run(tmp_path, monkeypatch, jclip_extract.main,
                 clip_extract.main,
                 ["--images", frames, "--clip-model", model,
                  "--clip-checkpoint", clip_files[model], "--mode", mode,
                  "--crop-size", "64", "--tile", "32", "--batch-size", "2"])
    grid = {"ViT": (21, 28), "RN": (10, 14)}["RN" if "rn" in model else
                                             "ViT"]
    shape = {"cls": (16,), "patch": grid + (16,), "tiled": (2, 2, 16)}[mode]
    assert all(p[1].shape == shape for p in pairs.values())
    _cosine(pairs)


def test_clip_extract_rn_cls_needs_the_training_grid(tmp_path, frames,
                                                     clip_files):
    """An RN tower's class path takes only its training grid: cls mode at
    336x448 raises, as in the JAX package."""
    with pytest.raises(ValueError, match="training grid"):
        clip_extract.main(["--images", frames, "--out", str(tmp_path),
                           "--clip-model", "tiny-test-rn",
                           "--clip-checkpoint", clip_files["tiny-test-rn"],
                           "--mode", "cls", "--device", "cpu"])


def test_patchify_image_matches_jax():
    img = (np.random.RandomState(1).rand(80, 96, 3) * 255).astype(np.uint8)
    got = clip_extract.patchify_image(img, 64, 16)
    ref = jclip_extract.patchify_image(img, 64, 16)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    with pytest.raises(AssertionError, match="exceeds image"):
        clip_extract.patchify_image(img, 96, 32)


def test_list_images_takes_a_directory(tmp_path, frames):
    d = os.path.dirname(frames)
    assert dino_extract._list_images(d) == jdino_extract._list_images(d)
    with pytest.raises(AssertionError, match="no images"):
        dino_extract._list_images(str(tmp_path / "none" / "*.png"))
