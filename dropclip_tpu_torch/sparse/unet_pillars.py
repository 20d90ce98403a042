"""MinkUNet on the pillar engine, eval mode: the inference backend for
volumetric scenes.

Port of ``dropclip_tpu/sparse/unet_pillars.py``. Same architecture,
module and parameter names and parameter shapes as
``unet_bricks.MinkUNetBricks`` (kernels stay ``(K^3, Cin, Cout)`` in
lexicographic offset order, modules register in the same order), so one
state dict loads into either engine and one seed draws the same weights.

Every k3 conv goes through ``kernels.pillar_conv3`` (K2 on CUDA tensors,
its plain version on CPU) at any Z, C and Cout; the JAX package gated its
Pallas kernel on Mosaic's tiling and left it off by default. On the card
the forward computes K2's row schedule once per level
(``level_schedule``) and every k3 conv of the level shares it. The k5 stem,
the k2s2 down/up convs and the 1x1 convs are plain torch ops, as they were
XLA ops outside any kernel in the JAX package. K2 gets each level's
occupancy, so it computes only occupied (pillar, z) slots; the masked
batch norm that follows every conv zeroes the others anyway, so block
outputs equal the JAX package's unmasked-conv order.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.pillar_conv3 import Schedule, pillar_conv3, row_order
from .pillar_ops import pillar_conv_xla, pillar_down_conv, pillar_up_conv
from .pillar_topology import (PillarLevel, PillarTopology,
                              gather_points_pillar, scatter_points_pillar)
from .unet import (ConvKernel, MaskedBatchNorm, arch_of,
                   reset_student_parameters)


class PConv(ConvKernel):
    """k3 submanifold pillar conv through K2 (canonical (27, C, Co))."""

    def __init__(self, cin: int, cout: int):
        super().__init__(27, cin, cout)

    def forward(self, x: torch.Tensor, level: PillarLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        c, co = self.kernel.shape[1:]
        w = self.kernel.to(x.dtype).reshape(9, 3, c, co)
        return pillar_conv3(x, level.nbr9, w, level.occ, relu=False,
                            schedule=schedule)


def level_schedule(level: PillarLevel) -> Optional[Schedule]:
    """K2's row schedule of a level on the card (``row_order``), shared by
    every k3 conv of the level. None on the CPU."""
    return row_order(level.occ) if level.occ.is_cuda else None


class PConv5(ConvKernel):
    """Stem k5 conv over the level-0 nbr25 table."""

    def __init__(self, cin: int, cout: int):
        super().__init__(125, cin, cout)

    def forward(self, x: torch.Tensor, nbr25: torch.Tensor) -> torch.Tensor:
        c, co = self.kernel.shape[1:]
        return pillar_conv_xla(x, nbr25, self.kernel.to(x.dtype)
                               .reshape(25, 5, c, co))


class PConvDown(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(8, cin, cout)

    def forward(self, x: torch.Tensor, child: torch.Tensor) -> torch.Tensor:
        c, co = self.kernel.shape[1:]
        return pillar_down_conv(x, child, self.kernel.to(x.dtype)
                                .reshape(4, 2, c, co))


class PConvUp(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(8, cin, cout)

    def forward(self, x, parent, parity) -> torch.Tensor:
        c, co = self.kernel.shape[1:]
        return pillar_up_conv(x, parent, parity, self.kernel.to(x.dtype)
                              .reshape(4, 2, c, co))


class PConv1x1(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(1, cin, cout)

    def forward(self, x: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel[0].to(x.dtype)
        return y * occ[..., None].to(x.dtype)


class PBasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = PConv(cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = PConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        if cin != planes * self.expansion:
            self.downsample_conv = PConv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x: torch.Tensor, level: PillarLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        occ = level.occ
        out = F.relu(self.norm1(self.conv1(x, level, schedule), occ))
        out = self.norm2(self.conv2(out, level, schedule), occ)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, occ), occ)
        return F.relu(out + residual)


class PBottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = PConv1x1(cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = PConv(planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = PConv1x1(planes, planes * self.expansion)
        self.norm3 = MaskedBatchNorm(planes * self.expansion)
        if cin != planes * self.expansion:
            self.downsample_conv = PConv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x: torch.Tensor, level: PillarLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        occ = level.occ
        out = F.relu(self.norm1(self.conv1(x, occ), occ))
        out = F.relu(self.norm2(self.conv2(out, level, schedule), occ))
        out = self.norm3(self.conv3(out, occ), occ)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, occ), occ)
        return F.relu(out + residual)


_BLOCKS_P = {"basic": PBasicBlock, "bottleneck": PBottleneck}


class MinkUNetPillars(nn.Module):
    """forward(topo: PillarTopology, x (M, Cin)) -> (M, out_channels)
    per-voxel features of ONE scene."""

    def __init__(self, in_channels: int, out_channels: int,
                 block: str = "basic", layers: Sequence[int] = (1,) * 8,
                 planes: Sequence[int] = (32, 64, 128, 256, 384, 384, 384, 384),
                 init_dim: int = 32):
        super().__init__()
        block_cls = _BLOCKS_P[block]
        exp = block_cls.expansion
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.conv0p1s1 = PConv5(in_channels, init_dim)
        self.bn0 = MaskedBatchNorm(init_dim)
        ch, enc_out = init_dim, []
        for s in range(4):
            setattr(self, f"conv{s + 1}", PConvDown(ch, ch))
            setattr(self, f"bn{s + 1}", MaskedBatchNorm(ch))
            ch = self._add_stage(f"block{s + 1}", block_cls, ch,
                                 self.planes[s], self.layers[s], exp)
            enc_out.append(ch)
        skip_ch = [enc_out[2], enc_out[1], enc_out[0], init_dim]
        for d in range(4):
            p = self.planes[4 + d]
            setattr(self, f"convtr{4 + d}", PConvUp(ch, p))
            setattr(self, f"bntr{4 + d}", MaskedBatchNorm(p))
            ch = self._add_stage(f"block{5 + d}", block_cls, p + skip_ch[d],
                                 p, self.layers[4 + d], exp)
        self.final = PConv1x1(ch, out_channels)

    def _add_stage(self, name, block_cls, cin, planes, n_blocks, exp) -> int:
        for i in range(n_blocks):
            setattr(self, f"{name}_{i}", block_cls(cin, planes))
            cin = planes * exp
        return cin

    def _stage(self, name, x, level, schedule, n_blocks):
        for i in range(n_blocks):
            x = getattr(self, f"{name}_{i}")(x, level, schedule)
        return x

    def forward(self, topo: PillarTopology, x: torch.Tensor) -> torch.Tensor:
        lv = topo.levels
        sched = [level_schedule(level) for level in lv]
        dense = scatter_points_pillar(x, topo)
        out = self.conv0p1s1(dense, topo.nbr25)
        out_p1 = F.relu(self.bn0(out, lv[0].occ))
        skips, out = [], out_p1
        for s in range(4):
            out = getattr(self, f"conv{s + 1}")(out, topo.child[s])
            out = F.relu(getattr(self, f"bn{s + 1}")(out, lv[s + 1].occ))
            out = self._stage(f"block{s + 1}", out, lv[s + 1],
                              sched[s + 1], self.layers[s])
            skips.append(out)

        skip_feats = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            out = getattr(self, f"convtr{4 + d}")(
                out, topo.parent[lvl], topo.xy_parity[lvl])
            out = F.relu(getattr(self, f"bntr{4 + d}")(out, lv[lvl].occ))
            out = torch.cat([out, skip_feats[d]], dim=-1)
            out = self._stage(f"block{5 + d}", out, lv[lvl], sched[lvl],
                              self.layers[4 + d])
        return gather_points_pillar(self.final(out, lv[0].occ), topo)


def build_student_pillars(cfg: Any, in_channels: Optional[int] = None,
                          generator: Optional[torch.Generator] = None
                          ) -> MinkUNetPillars:
    """Pillar-backend student (same archs as the brick factory), in eval
    mode, weights drawn from ``generator``. An inference engine: no
    dropout and no classification head."""
    block, layers, planes = arch_of(cfg)
    if cfg.use_cls_head:
        raise ValueError("the pillar engine serves features only: "
                         "use_cls_head is not supported")
    if in_channels is None:
        in_channels = 6 if cfg.use_color else 3
    model = MinkUNetPillars(
        in_channels=in_channels, out_channels=int(cfg.feat_dim or 768),
        block=block, layers=layers, planes=planes,
        init_dim=int(cfg.init_dim or 32))
    reset_student_parameters(model, generator)
    return model.eval()
