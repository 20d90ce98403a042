"""MinkUNet on the brick-dense engine (``sparse.bricks``), eval mode.

Port of ``dropclip_tpu/sparse/unet_bricks.py``. Module and parameter
names follow the flax tree (``block1_0.conv1.kernel``,
``bn0.scale``/``bn0.mean`` ...), so ``convert.student_state_dict`` maps a
JAX checkpoint onto ``load_state_dict`` one to one; sparse kernels stay
(K, Cin, Cout) in lexicographic offset order.

Serving is single-process, so the forward always folds the scene batch
into one brick axis (``bricks.fold_topology``). Every k3 conv goes through
``kernels.brick_conv3`` (K1 on CUDA tensors, its plain version on CPU);
the k5 stem and the k2s2 down/up convs are plain torch ops, as they were
XLA ops outside any kernel in the JAX package. Training (batch statistics,
dropout, remat) comes with the trainer in a later slice.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.brick_conv3 import brick_conv3
from .bricks import (BrickLevel, BrickTopology, brick_conv, brick_down_conv,
                     brick_up_conv, fold_topology, gather_points,
                     scatter_points)
from .unet import (UNET_ARCHS, ConvKernel, MaskedBatchNorm,
                   reset_student_parameters)


class BConv(ConvKernel):
    """Stride-1 submanifold conv; ksize 3 runs K1."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__(ksize ** 3, cin, cout)
        self.ksize = ksize

    def forward(self, x: torch.Tensor, level: BrickLevel) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if self.ksize == 3:
            return brick_conv3(x, level.nbr, w, level.occ)
        return brick_conv(x, level, w, ksize=self.ksize)


class BConvDown(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(8, cin, cout)

    def forward(self, x, group_map, coarse_level):
        return brick_down_conv(x, group_map, coarse_level,
                               self.kernel.to(x.dtype))


class BConvUp(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(8, cin, cout)

    def forward(self, x, parent_map, octant, fine_level):
        return brick_up_conv(x, parent_map, octant, fine_level,
                             self.kernel.to(x.dtype))


class BConv1x1(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(1, cin, cout)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel[0].to(x.dtype)
        return y * occ[..., None].to(x.dtype)


class BasicBlockB(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = BConv(cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = BConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        if cin != planes * self.expansion:
            self.downsample_conv = BConv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x: torch.Tensor, level: BrickLevel) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(x, level), level.occ))
        out = self.norm2(self.conv2(out, level), level.occ)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(
                self.downsample_conv(x, level.occ), level.occ)
        return F.relu(out + residual)


class BottleneckB(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = BConv1x1(cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = BConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = BConv1x1(planes, planes * self.expansion)
        self.norm3 = MaskedBatchNorm(planes * self.expansion)
        if cin != planes * self.expansion:
            self.downsample_conv = BConv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x: torch.Tensor, level: BrickLevel) -> torch.Tensor:
        occ = level.occ
        out = F.relu(self.norm1(self.conv1(x, occ), occ))
        out = F.relu(self.norm2(self.conv2(out, level), occ))
        out = self.norm3(self.conv3(out, occ), occ)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, occ), occ)
        return F.relu(out + residual)


_BLOCKS_B = {"basic": BasicBlockB, "bottleneck": BottleneckB}


class MinkUNetBricks(nn.Module):
    """forward(topo: BrickTopology (batched), x (B, M, Cin)) ->
    (B, M, out_channels) per-voxel features [+ logits if use_cls_head]."""

    def __init__(self, in_channels: int, out_channels: int,
                 block: str = "basic", layers: Sequence[int] = (1,) * 8,
                 planes: Sequence[int] = (32, 64, 128, 256, 384, 384, 384, 384),
                 init_dim: int = 32, use_cls_head: bool = False,
                 n_classes: int = 0):
        super().__init__()
        block_cls = _BLOCKS_B[block]
        exp = block_cls.expansion
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.use_cls_head = use_cls_head
        self.conv0p1s1 = BConv(in_channels, init_dim, ksize=5)
        self.bn0 = MaskedBatchNorm(init_dim)
        ch, enc_out = init_dim, []
        for s in range(4):
            setattr(self, f"conv{s + 1}", BConvDown(ch, ch))
            setattr(self, f"bn{s + 1}", MaskedBatchNorm(ch))
            ch = self._add_stage(f"block{s + 1}", block_cls, ch,
                                 self.planes[s], self.layers[s], exp)
            enc_out.append(ch)
        skip_ch = [enc_out[2], enc_out[1], enc_out[0], init_dim]
        for d in range(4):
            p = self.planes[4 + d]
            setattr(self, f"convtr{4 + d}", BConvUp(ch, p))
            setattr(self, f"bntr{4 + d}", MaskedBatchNorm(p))
            ch = self._add_stage(f"block{5 + d}", block_cls, p + skip_ch[d],
                                 p, self.layers[4 + d], exp)
        self.final = BConv1x1(ch, out_channels)
        if use_cls_head:
            self.cls_head = BConv1x1(ch, n_classes)

    def _add_stage(self, name, block_cls, cin, planes, n_blocks, exp) -> int:
        for i in range(n_blocks):
            setattr(self, f"{name}_{i}", block_cls(cin, planes))
            cin = planes * exp
        return cin

    def _stage(self, name, x, level, n_blocks):
        for i in range(n_blocks):
            x = getattr(self, f"{name}_{i}")(x, level)
        return x

    def forward(self, topo: BrickTopology, x: torch.Tensor):
        bsz, m = x.shape[0], x.shape[1]
        cap0 = topo.levels[0].occ.shape[1]
        bshape0 = tuple(topo.levels[0].occ.shape[2:5])
        topo = fold_topology(topo)
        lv = topo.levels
        dense = scatter_points(x.reshape(bsz * m, -1), topo.point_row,
                               topo.point_within, bsz * cap0, bshape0)

        out = self.conv0p1s1(dense, lv[0])
        out_p1 = F.relu(self.bn0(out, lv[0].occ))
        skips, out = [], out_p1
        for s in range(4):
            out = getattr(self, f"conv{s + 1}")(out, topo.group_maps[s],
                                                lv[s + 1])
            out = F.relu(getattr(self, f"bn{s + 1}")(out, lv[s + 1].occ))
            out = self._stage(f"block{s + 1}", out, lv[s + 1], self.layers[s])
            skips.append(out)

        skip_feats = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            out = getattr(self, f"convtr{4 + d}")(
                out, topo.parent_maps[lvl], topo.octants[lvl], lv[lvl])
            out = F.relu(getattr(self, f"bntr{4 + d}")(out, lv[lvl].occ))
            out = torch.cat([out, skip_feats[d]], dim=-1)
            out = self._stage(f"block{5 + d}", out, lv[lvl],
                              self.layers[4 + d])

        def to_points(f):
            return gather_points(f, topo.point_row,
                                 topo.point_within).reshape(bsz, m, -1)

        feats = to_points(self.final(out, lv[0].occ))
        if self.use_cls_head:
            return feats, to_points(self.cls_head(out, lv[0].occ))
        return feats


def build_student_bricks(cfg: Any, in_channels: Optional[int] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> MinkUNetBricks:
    """Brick-backend student (same archs as the JAX factory), in eval
    mode, weights drawn from ``generator``. ``in_channels`` defaults to
    xyz (+rgb when ``cfg.use_color``)."""
    arch = cfg.arch_3d or "MinkUNet14D"
    if arch not in UNET_ARCHS:
        raise ValueError(f"architecture {arch} not supported")
    block, layers, planes = UNET_ARCHS[arch]
    if cfg.planes is not None:
        planes = tuple(int(p) for p in cfg.planes)
    if cfg.layers is not None:
        layers = tuple(int(l) for l in cfg.layers)
    if in_channels is None:
        in_channels = 6 if cfg.use_color else 3
    model = MinkUNetBricks(
        in_channels=in_channels, out_channels=int(cfg.feat_dim or 768),
        block=block, layers=layers, planes=planes,
        init_dim=int(cfg.init_dim or 32),
        use_cls_head=bool(cfg.use_cls_head),
        n_classes=int(cfg.n_classes or 0))
    reset_student_parameters(model, generator)
    return model.eval()
