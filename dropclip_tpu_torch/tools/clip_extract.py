"""Batch dense CLIP feature extraction for image folders.

Port of ``dropclip_tpu/tools/clip_extract.py`` (reference
tools/clip_extract.py:25-83): load images, run the MaskCLIP patch path (or
the class token, or per-tile class tokens) at [336, 448] without a centre
crop, save (h, w, C) feature maps as float32 .npy. The teacher is the
ingest extractor (``preprocess_data.build_extractor``, bf16), ViT or RN;
it runs on the card unless ``--device`` says otherwise. An RN tower's
class path takes only its training grid, so RN models run ``--mode
patch`` (cls and tiled raise, as in the JAX package).

Usage:
  python -m dropclip_tpu_torch.tools.clip_extract --images "DIR/*.png" \\
      --out OUT [--clip-model RN50] [--clip-checkpoint clip.pt] \\
      [--mode patch|cls|tiled] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch

from . import dino_extract


def patchify_image(image: np.ndarray, crop_size: int, tile: int):
    """Centre-crop to ``crop_size`` and split into a (crop/tile)^2 grid of
    tiles (reference tools/extract_multiview_features.py:191-203: each
    tile runs through CLIP as a whole image, and its class token is a
    coarse dense feature)."""
    assert crop_size % tile == 0, (crop_size, tile)
    h, w = image.shape[:2]
    assert crop_size <= min(h, w), (
        f"crop_size {crop_size} exceeds image {h}x{w}; pass --crop-size "
        f"<= {min(h, w)} (a multiple of tile={tile})")
    sx = h // 2 - crop_size // 2
    sy = w // 2 - crop_size // 2
    c = image[sx: sx + crop_size, sy: sy + crop_size]
    g = crop_size // tile
    tiles = (c.reshape(g, tile, g, tile, 3).swapaxes(1, 2)
             .reshape(-1, tile, tile, 3))
    return tiles, c


def extract_tiled(ex, image: np.ndarray, crop_size: int, tile: int,
                  batch_size: int = 64) -> torch.Tensor:
    """(H, W, 3) -> (crop/tile, crop/tile, C) tiled class-token map."""
    tiles, _ = patchify_image(image, crop_size, tile)
    ex.set_mode("cls")
    feats = [ex.extract(tiles[i: i + batch_size])
             for i in range(0, len(tiles), batch_size)]
    g = crop_size // tile
    return torch.cat(feats).reshape(g, g, -1)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("dropclip_tpu_torch CLIP feature extraction")
    p.add_argument("--images", required=True, help="glob of image files")
    p.add_argument("--out", required=True)
    p.add_argument("--clip-model", default="ViT-L/14@336px")
    p.add_argument("--clip-checkpoint", default=None)
    p.add_argument("--mode", choices=["cls", "patch", "tiled"],
                   default="patch")
    p.add_argument("--crop-size", type=int, default=448,
                   help="tiled mode: centre-crop edge")
    p.add_argument("--tile", type=int, default=32,
                   help="tiled mode: tile edge (crop-size % tile == 0)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)

    from .preprocess_data import build_extractor

    ex = build_extractor(SimpleNamespace(
        clip_model=a.clip_model, clip_checkpoint=a.clip_checkpoint,
        visual_prompt="crop-mask", crop_num_levels=1,
        crop_expansion_ratio=0.15, batch_size=a.batch_size),
        device=a.device)
    files = dino_extract._list_images(a.images)
    os.makedirs(a.out, exist_ok=True)

    if a.mode == "tiled":
        for i, f in enumerate(files):
            feat = extract_tiled(ex, dino_extract._read_rgb(f), a.crop_size,
                                 a.tile, a.batch_size)
            dino_extract._save(a.out, f, feat)
            print(f"{i + 1}/{len(files)}")
        return

    ex.set_mode(a.mode)
    for i in range(0, len(files), a.batch_size):
        chunk = files[i: i + a.batch_size]
        feats = ex.extract(np.stack([dino_extract._read_rgb(f)
                                     for f in chunk]))
        for f, feat in zip(chunk, feats):
            dino_extract._save(a.out, f, feat)
        print(f"{i + len(chunk)}/{len(files)}")


if __name__ == "__main__":
    main()
