"""Batched teacher feature extraction (the offline ingest hot path).

Port of ``dropclip_tpu/teachers/extractor.py`` (reference
models/features/extractor.py:79-181, 253-480): CLIP features of whole
images (``extract``, class token or MaskCLIP patches), of text prompts
(``encode_text``), of per-object query sets (``encode_queries``), and of
every present (view, object) pair with a visual prompt
(``extract_obj_prior``: the packed present-pair path, or with
``DROPCLIP_PACKED_PROMPTS=0`` the per-view path, which runs every view's
objects in chunks of 8 views; each chunk's ViT forward is the span
``teacher.tower``). The model is a ``teachers.clip.CLIP``
already on its device; inputs move there. ``on_device`` gives a replica
on another device (multi-card ingest).
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from .prompting import CLIP_MEAN, CLIP_STD, build_prompts, normalize
from ..core.spans import span
from ..ops.resize import resize_image

CHUNK = 96  # present pairs per ViT forward (the measured-good JAX batch)
VIEW_CHUNK = 8  # views per ViT forward on the per-view path


class ClipExtractor:
    """CLIP feature extractor over images and (image, instance-mask)
    pairs. ``chunk`` is the number of (view, object) prompts per ViT
    forward; chunks are padded to it, and no row's value depends on it."""

    def __init__(self, model, mode: str = "cls",
                 visual_prompt: Sequence[str] = ("crop-mask",),
                 crop_num_levels: int = 1,
                 crop_expansion_ratio: float = 0.15, blur_kernel: int = 41,
                 img_resize: Tuple[int, int] = (336, 448),
                 batch_size: int = 32, chunk: int = CHUNK):
        if isinstance(visual_prompt, str):
            visual_prompt = tuple(visual_prompt.split(","))
        self.model = model
        self.device = next(model.parameters()).device
        self.visual_prompt = tuple(visual_prompt)
        self.crop_num_levels = crop_num_levels
        self.crop_expansion_ratio = crop_expansion_ratio
        self.blur_kernel = blur_kernel
        self.img_resize = tuple(img_resize)
        self.batch_size = batch_size
        self.chunk = chunk
        self.patch_size = model.vision_patch_size
        self.patch_hw = (img_resize[0] // self.patch_size,
                         img_resize[1] // self.patch_size)
        self.chunks = 0  # obj-prior ViT forwards run
        self.set_mode(mode)

    def set_mode(self, mode: str) -> None:
        if mode not in ("cls", "patch"):
            raise ValueError("Set mode to either ['cls', 'patch']")
        self.mode = mode

    def on_device(self, device) -> "ClipExtractor":
        """A copy of this extractor whose model is replicated on
        ``device``; settings are shared."""
        rep = copy.copy(self)
        rep.model = copy.deepcopy(self.model).to(device)
        rep.device = torch.device(device)
        return rep

    def _to_device(self, x) -> torch.Tensor:
        return torch.as_tensor(x).to(self.device)

    def _preprocess(self, images: torch.Tensor) -> torch.Tensor:
        x = resize_image(images.to(torch.float32), self.img_resize)
        return normalize(x / 255.0, CLIP_MEAN, CLIP_STD)

    @torch.no_grad()
    def extract(self, images) -> torch.Tensor:
        """Images (V, H, W, 3) uint8 -> (V, C) class-token features or
        (V, ph, pw, C) patch features, in batches of ``batch_size``."""
        images = self._to_device(images)
        outs = []
        for i in range(0, images.shape[0], self.batch_size):
            batch = self._preprocess(images[i: i + self.batch_size])
            if self.mode == "cls":
                outs.append(self.model.encode_image(batch))
            else:
                out = self.model.get_patch_encodings(batch)
                outs.append(out.reshape(out.shape[0], *self.patch_hw,
                                        out.shape[-1]))
        return torch.cat(outs, dim=0)

    def _obj_prior_packed(self, images, seg, vidx, oids) -> torch.Tensor:
        """A chunk of present (view, object) pairs -> (C, E) prompt-averaged
        class-token embeddings. Pad rows repeat a real view (the caller
        drops them)."""
        masks = seg[vidx] == oids[:, None, None]
        prompts = build_prompts(
            images[vidx], masks, kinds=self.visual_prompt,
            crop_num_levels=self.crop_num_levels,
            crop_expansion_ratio=self.crop_expansion_ratio,
            blur_kernel=self.blur_kernel, out_hw=self.img_resize)
        c, l = prompts.shape[:2]
        with span("teacher.tower"):
            emb = self.model.encode_image(prompts.reshape(
                c * l, *prompts.shape[2:]))
        self.chunks += 1
        return emb.reshape(c, l, -1).mean(dim=1)

    def _obj_prior_views(self, images, segs, obj_ids) -> torch.Tensor:
        """A chunk of views (Vc, H, W, 3) with their segs (Vc, H, W) and
        (K,) object ids -> (Vc, K, E) prompt-averaged class-token
        embeddings, one ViT forward over the Vc * K * L prompts."""
        prompts = torch.stack([build_prompts(
            image, seg[None] == obj_ids[:, None, None],
            kinds=self.visual_prompt, crop_num_levels=self.crop_num_levels,
            crop_expansion_ratio=self.crop_expansion_ratio,
            blur_kernel=self.blur_kernel, out_hw=self.img_resize)
            for image, seg in zip(images, segs)])
        vc, k, l = prompts.shape[:3]
        with span("teacher.tower"):
            emb = self.model.encode_image(prompts.reshape(
                vc * k * l, *prompts.shape[3:]))
        self.chunks += 1
        return emb.reshape(vc, k, l, -1).mean(dim=2)

    @torch.no_grad()
    def extract_obj_prior(self, images, seg_masks, obj_ids,
                          present_hint=None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-view per-object prompt-averaged embeddings.

        images (V, H, W, 3) uint8, seg_masks (V, H, W) int instance ids,
        obj_ids (K,) ids (row k of the output is object obj_ids[k]); pass
        the host copy of the segs as ``present_hint`` to skip a fetch.
        Returns (feats (V, K, C), present (V, K) bool); absent rows are
        zero. The packed path sends only the pairs the segmentation
        contains to the ViT, in chunks of ``chunk`` padded with view index
        V. The per-view path (``DROPCLIP_PACKED_PROMPTS=0``) runs chunks
        of up to 8 views, each at the ids present anywhere in the scene,
        and zeroes the rows absent from a view."""
        images = self._to_device(images)
        seg = self._to_device(seg_masks)
        seg_host = np.asarray(present_hint if present_hint is not None
                              else seg.cpu().numpy())
        obj_ids = np.asarray(obj_ids)
        v, k = images.shape[0], len(obj_ids)
        # membership excluding the background/table id 0 by value
        present = np.stack([
            np.isin(obj_ids, np.setdiff1d(np.unique(seg_host[i]), [0]))
            for i in range(v)])
        if os.environ.get("DROPCLIP_PACKED_PROMPTS", "1") == "0":
            return self._obj_prior_per_view(images, seg, obj_ids, present)
        pairs = np.argwhere(present)  # (P, 2) view-major
        n_chunks = max(-(-len(pairs) // self.chunk), 1)
        vidx = np.full((n_chunks * self.chunk,), v, np.int64)  # pad -> drop
        kidx = np.zeros((n_chunks * self.chunk,), np.int64)
        vidx[: len(pairs)] = pairs[:, 0]
        kidx[: len(pairs)] = pairs[:, 1]
        oids = self._to_device(obj_ids[kidx].astype(np.int64)).to(seg.dtype)
        vdev = self._to_device(np.minimum(vidx, v - 1))  # gather clamp
        embs = torch.cat([self._obj_prior_packed(
            images, seg, vdev[i: i + self.chunk], oids[i: i + self.chunk])
            for i in range(0, len(vidx), self.chunk)])
        out = torch.zeros((v, k, embs.shape[-1]), dtype=embs.dtype,
                          device=self.device)
        real = len(pairs)
        out[self._to_device(vidx[:real]), self._to_device(kidx[:real])] = \
            embs[:real]
        return out, self._to_device(present)

    def _obj_prior_per_view(self, images, seg, obj_ids, present):
        v, k = present.shape
        used = np.flatnonzero(present.any(axis=0))
        if not len(used):  # nothing present: one row keeps the shapes
            used = np.zeros(1, np.int64)
        ids = self._to_device(obj_ids[used].astype(np.int64)).to(seg.dtype)
        packed = torch.cat([self._obj_prior_views(
            images[i: i + VIEW_CHUNK], seg[i: i + VIEW_CHUNK], ids)
            for i in range(0, v, VIEW_CHUNK)])
        out = torch.zeros((v, k, packed.shape[-1]), dtype=packed.dtype,
                          device=self.device)
        out[:, self._to_device(used)] = packed
        present = self._to_device(present)
        return out * present[..., None].to(out.dtype), present

    @torch.no_grad()
    def _encode_tokens(self, texts: Sequence[str]) -> torch.Tensor:
        """Tokens padded to a multiple of 32 rows (the JAX package's
        compile buckets; pad rows repeat the last prompt) -> embeddings
        of every row."""
        from .tokenizer import tokenize

        toks = tokenize(list(texts))
        pad = (-toks.shape[0]) % 32
        if pad:
            toks = np.concatenate([toks, np.tile(toks[-1:], (pad, 1))])
        return self.model.encode_text(self._to_device(toks))

    def encode_text(self, texts: Sequence[str]) -> torch.Tensor:
        """(Q,) prompts -> (Q, C) unnormalised text embeddings."""
        return self._encode_tokens(texts)[: len(texts)]

    def encode_queries(self, queries: Dict[int, Sequence[str]],
                       n_segments: int) -> torch.Tensor:
        """{segment_id: [texts]} -> (n_segments, C) float32 L2-normalised
        mean text embedding per segment id; zero rows for absent ids.
        Pad rows carry segment id ``n_segments`` and fall off."""
        flat, seg = [], []
        for key, texts in queries.items():
            if not 0 <= int(key) < n_segments:
                raise ValueError(f"query id {key} outside [0, {n_segments})")
            flat.extend(texts)
            seg.extend([int(key)] * len(texts))
        embs = self._encode_tokens(flat).to(torch.float32)
        seg += [n_segments] * (embs.shape[0] - len(seg))
        seg_t = self._to_device(np.asarray(seg, np.int64))
        sums = torch.zeros((n_segments + 1, embs.shape[-1]),
                           dtype=torch.float32, device=self.device)
        sums.index_add_(0, seg_t, embs)
        cnt = torch.zeros((n_segments + 1,), dtype=torch.float32,
                          device=self.device)
        cnt.index_add_(0, seg_t, torch.ones_like(seg_t, dtype=torch.float32))
        sums, cnt = sums[:n_segments], cnt[:n_segments]
        mean = sums / cnt.clamp_min(1.0)[:, None]
        q = mean / torch.linalg.vector_norm(
            mean, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.where((cnt > 0)[:, None], q, torch.zeros_like(q))
