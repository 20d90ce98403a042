"""Batch DINO descriptor extraction for image folders.

Port of ``dropclip_tpu/tools/dino_extract.py`` (reference
tools/dino_extract.py:34-71 and models/features/dino/dino_vit_extractor.py:
338-364): DINOv2 cls or patch tokens in bf16, or the hi-res DINO v1
stride-patched facet descriptors (optionally log-binned) in float32. Saves
one float32 .npy per image. Runs on the card (DINOv2 through K3, K4 or K5
by the token count, K6 and K7; DINO v1 through K5 or K4 and K6) unless
``--device`` says otherwise.

Usage:
  python -m dropclip_tpu_torch.tools.dino_extract --images "DIR/*.png" \\
      --out OUT [--model dinov2_vits14] [--checkpoint hf_dinov2.pt] \\
      [--mode patch] [--device cpu]
  python -m dropclip_tpu_torch.tools.dino_extract --images ... --out OUT \\
      --model dino_vits8 --stride 4 --facet key --layer 11 [--bin] \\
      [--load-size 224] [--checkpoint dino_vits8.pt]
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np
import torch


def _list_images(pattern: str):
    if os.path.isdir(pattern):  # a directory is shorthand for dir/*
        pattern = os.path.join(pattern, "*")
    files = [f for f in sorted(glob.glob(pattern)) if os.path.isfile(f)]
    assert files, f"no images match {pattern}"
    return files


def _read_rgb(path: str) -> np.ndarray:
    import cv2

    im = cv2.imread(path)
    assert im is not None, f"unreadable image file: {path}"
    return np.ascontiguousarray(im[:, :, ::-1])


def _load_state_dict(path: str):
    obj = torch.load(path, map_location="cpu", weights_only=False)
    return obj.state_dict() if hasattr(obj, "state_dict") else obj


def _save(out_dir: str, path: str, feat: torch.Tensor) -> str:
    name = os.path.splitext(os.path.basename(path))[0]
    np.save(os.path.join(out_dir, f"{name}.npy"),
            feat.float().cpu().numpy())
    return name


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dropclip_tpu_torch DINO feature extraction")
    p.add_argument("--images", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--model", default="dinov2_vits14")
    p.add_argument("--checkpoint", default=None,
                   help="HuggingFace Dinov2Model or facebookresearch/dino "
                        "state dict (.pt); random weights from seed 0 if "
                        "omitted (smoke mode)")
    p.add_argument("--mode", choices=["cls", "patch"], default="patch")
    p.add_argument("--resize", type=int, nargs=2, default=(336, 448))
    p.add_argument("--batch-size", type=int, default=16)
    # hi-res DINO v1 options (reference dino_vit_extractor.py:338-353)
    p.add_argument("--stride", type=int, default=4,
                   help="patch-conv stride for dino_vits/vitb models")
    p.add_argument("--facet", default="key",
                   choices=["key", "query", "value", "token"])
    p.add_argument("--layer", type=int, default=11)
    p.add_argument("--bin", action="store_true",
                   help="log-binned descriptors")
    p.add_argument("--load-size", type=int, default=224)
    p.add_argument("--family", choices=["auto", "dinov2", "dino_v1"],
                   default="auto")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    # hi-res DINO v1 / timm models take the stride-patched path; dinov2
    # (and, by default, the shared "tiny-test" smoke config) the featurizer
    if a.family == "dino_v1" or (
            a.family == "auto" and a.model.startswith(("dino_vit", "vit_"))):
        return _main_dino_v1(a)

    from ..teachers.dinov2 import Dinov2Extractor, build_dinov2, \
        from_hf_dinov2

    model = build_dinov2(a.model, dtype=torch.bfloat16, device=a.device,
                         generator=torch.Generator().manual_seed(0))
    if a.checkpoint:
        model.load_state_dict(from_hf_dinov2(_load_state_dict(a.checkpoint)))
    else:
        print("WARNING: no --checkpoint; RANDOM weights (smoke mode)")
    ex = Dinov2Extractor(model, mode=a.mode, img_resize=tuple(a.resize),
                         batch_size=a.batch_size)
    files = _list_images(a.images)
    os.makedirs(a.out, exist_ok=True)
    for i in range(0, len(files), a.batch_size):
        chunk = files[i: i + a.batch_size]
        feats = ex.extract(np.stack([_read_rgb(f) for f in chunk]))
        for f, feat in zip(chunk, feats):
            _save(a.out, f, feat)
        print(f"{i + len(chunk)}/{len(files)}")


def _main_dino_v1(a) -> None:
    """The hi-res stride-patched descriptor path (reference
    dino_vit_extractor.py:356-364)."""
    from ..teachers.dino_v1 import ViTExtractor, from_dino_v1

    sd = None
    if a.checkpoint:
        sd = from_dino_v1(_load_state_dict(a.checkpoint))
    else:
        print("WARNING: no --checkpoint; RANDOM weights (smoke mode)")
    ex = ViTExtractor(a.model, stride=a.stride, state_dict=sd,
                      device=a.device)
    files = _list_images(a.images)
    os.makedirs(a.out, exist_ok=True)
    for f in files:
        batch = ex.preprocess(_read_rgb(f), load_size=a.load_size)
        desc = ex.extract_descriptors(batch, layer=a.layer, facet=a.facet,
                                      bin=a.bin)
        name = _save(a.out, f, desc)
        print(f"{name}: descriptors {tuple(desc.shape)}")


if __name__ == "__main__":
    main()
