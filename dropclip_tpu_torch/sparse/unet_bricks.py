"""MinkUNet on the brick-dense engine (``sparse.bricks``).

Port of ``dropclip_tpu/sparse/unet_bricks.py``. Module and parameter
names follow the flax tree (``block1_0.conv1.kernel``,
``bn0.scale``/``bn0.mean`` ...), so ``convert.student_state_dict`` maps a
JAX checkpoint onto ``load_state_dict`` one to one; sparse kernels stay
(K, Cin, Cout) in lexicographic offset order.

Each process owns its local batch on one device, so the forward always
folds its scenes into one brick axis (``bricks.fold_topology``); under a
process group of several ranks this stays right, as the batch norms sum
their moments over the ranks (the JAX ``_auto_fold`` fault, folding a
batch sharded across devices, has no counterpart here). Every k3 conv
goes through ``kernels.brick_conv3.BrickConv3Fn`` (K1 on CUDA tensors for
the forward and the input gradient, the plain version on CPU); the k5
stem and the k2s2 down/up convs are plain torch ops under native
autograd, as they were XLA ops outside any kernel in the JAX package.

Training mode (``model.train()``) takes batch statistics in the masked
batch norms, applies dropout after each stage (``dropout_rate``, drawn
from the forward's ``generator``) and, with ``remat``, recomputes each
block and each stem/down/up conv in the backward
(``torch.utils.checkpoint``, JAX's ``nn.remat`` at
``unet_bricks.py:202-216``) instead of holding their activations.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.brick_conv3 import BrickConv3Fn, Schedule, row_order
from .bricks import (BrickLevel, BrickTopology, brick_conv, brick_down_conv,
                     brick_up_conv, fold_topology, gather_points,
                     scatter_points)
from .unet import (ConvKernel, MaskedBatchNorm, arch_of,
                   reset_student_parameters, stage_dropout)


class BConv(ConvKernel):
    """Stride-1 submanifold conv; ksize 3 runs K1 (``BrickConv3Fn``)."""

    def __init__(self, cin: int, cout: int, ksize: int = 3):
        super().__init__(ksize ** 3, cin, cout)
        self.ksize = ksize

    def forward(self, x: torch.Tensor, level: BrickLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        w = self.kernel.to(x.dtype)
        if self.ksize == 3:
            return BrickConv3Fn.apply(x, w, level.nbr, level.occ, schedule)
        return brick_conv(x, level, w, ksize=self.ksize)


def level_schedule(level: BrickLevel) -> Optional[Schedule]:
    """K1's row schedule of a level on the card (``row_order``), shared by
    every k3 conv of the level: each of their inputs vanishes off ``occ``,
    as ``brick_conv3``'s contract asks. None on the CPU."""
    if not level.occ.is_cuda:
        return None
    return Schedule(*row_order(level.occ, level.nbr))


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

    def forward(self, x: torch.Tensor, level: BrickLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        out = F.relu(self.norm1(self.conv1(x, level, schedule), level.occ))
        out = self.norm2(self.conv2(out, level, schedule), level.occ)
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

    def forward(self, x: torch.Tensor, level: BrickLevel,
                schedule: Optional[Schedule] = None) -> torch.Tensor:
        occ = level.occ
        out = F.relu(self.norm1(self.conv1(x, occ), occ))
        out = F.relu(self.norm2(self.conv2(out, level, schedule), occ))
        out = self.norm3(self.conv3(out, occ), occ)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, occ), occ)
        return F.relu(out + residual)


_BLOCKS_B = {"basic": BasicBlockB, "bottleneck": BottleneckB}


def _set_stats_update(module: nn.Module, on: bool) -> None:
    for m in module.modules():
        if isinstance(m, MaskedBatchNorm):
            m.update_stats = on


def rematerialized(module: nn.Module, *args: Any) -> Any:
    """``module(*args)`` whose activations are recomputed in the backward
    (``torch.utils.checkpoint``) instead of held. The recomputation leaves
    the batch norms' running statistics alone: they moved once, in the
    forward."""
    calls = []

    def run(*a):
        if not calls:
            calls.append(1)
            return module(*a)
        _set_stats_update(module, False)
        try:
            return module(*a)
        finally:
            _set_stats_update(module, True)

    # nothing rematerialised draws random numbers (dropout follows a
    # stage, outside), so no RNG state is stashed: a CUDA graph capture
    # cannot read the generator's state
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class MinkUNetBricks(nn.Module):
    """forward(topo: BrickTopology (batched), x (B, M, Cin)) ->
    (B, M, out_channels) per-voxel features [+ logits if use_cls_head].
    The k3 convs' weight gradients take the topology's ``wgrad_rows``
    where it is set."""

    def __init__(self, in_channels: int, out_channels: int,
                 block: str = "basic", layers: Sequence[int] = (1,) * 8,
                 planes: Sequence[int] = (32, 64, 128, 256, 384, 384, 384, 384),
                 init_dim: int = 32, use_cls_head: bool = False,
                 n_classes: int = 0, dropout_rate: float = 0.0,
                 remat: bool = False):
        super().__init__()
        block_cls = _BLOCKS_B[block]
        exp = block_cls.expansion
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.use_cls_head = use_cls_head
        self.dropout_rate = float(dropout_rate)
        self.remat = bool(remat)
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

    def _call(self, module: nn.Module, *args: Any) -> torch.Tensor:
        """A block or a stem/down/up conv, rematerialised under ``remat``
        in training (no effect on inference, as in JAX)."""
        if self.remat and self.training and torch.is_grad_enabled():
            return rematerialized(module, *args)
        return module(*args)

    def _stage(self, name, x, level, schedule, n_blocks):
        for i in range(n_blocks):
            x = self._call(getattr(self, f"{name}_{i}"), x, level, schedule)
        return x

    def _dropout(self, x: torch.Tensor,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        return stage_dropout(x, self.dropout_rate, self.training, generator)

    def forward(self, topo: BrickTopology, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        bsz, m = x.shape[0], x.shape[1]
        cap0 = topo.levels[0].occ.shape[1]
        bshape0 = tuple(topo.levels[0].occ.shape[2:5])
        topo = fold_topology(topo)
        lv = topo.levels
        sched = [level_schedule(level) for level in lv]
        if topo.wgrad_rows is not None:  # static bounds for the wgrads
            sched = [s if s is None else s._replace(wgrad_rows=n)
                     for s, n in zip(sched, topo.wgrad_rows)]
        dense = scatter_points(x.reshape(bsz * m, -1), topo.point_row,
                               topo.point_within, bsz * cap0, bshape0)

        out = self._call(self.conv0p1s1, dense, lv[0])
        out_p1 = F.relu(self.bn0(out, lv[0].occ))
        skips, out = [], out_p1
        for s in range(4):
            out = self._call(getattr(self, f"conv{s + 1}"), out,
                             topo.group_maps[s], lv[s + 1])
            out = F.relu(getattr(self, f"bn{s + 1}")(out, lv[s + 1].occ))
            out = self._dropout(self._stage(f"block{s + 1}", out, lv[s + 1],
                                            sched[s + 1], self.layers[s]),
                                generator)
            skips.append(out)

        skip_feats = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            out = self._call(getattr(self, f"convtr{4 + d}"), out,
                             topo.parent_maps[lvl], topo.octants[lvl],
                             lv[lvl])
            out = F.relu(getattr(self, f"bntr{4 + d}")(out, lv[lvl].occ))
            out = torch.cat([out, skip_feats[d]], dim=-1)
            out = self._dropout(self._stage(f"block{5 + d}", out, lv[lvl],
                                            sched[lvl], self.layers[4 + d]),
                                generator)

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
    mode (a trainer calls ``.train()``), weights drawn from ``generator``.
    ``in_channels`` defaults to xyz (+rgb when ``cfg.use_color``);
    ``remat`` defaults to True when ``cfg.remat`` is unset, as in JAX."""
    block, layers, planes = arch_of(cfg)
    if in_channels is None:
        in_channels = 6 if cfg.use_color else 3
    model = MinkUNetBricks(
        in_channels=in_channels, out_channels=int(cfg.feat_dim or 768),
        block=block, layers=layers, planes=planes,
        init_dim=int(cfg.init_dim or 32),
        use_cls_head=bool(cfg.use_cls_head),
        n_classes=int(cfg.n_classes or 0),
        dropout_rate=float(cfg.dropout_rate or 0.0),
        remat=bool(cfg.remat) if cfg.remat is not None else True)
    reset_student_parameters(model, generator)
    return model.eval()
