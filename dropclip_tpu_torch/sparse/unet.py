"""MinkUNet on the gather engine, and the pieces every engine shares.

Port of ``dropclip_tpu/sparse/unet.py`` (reference architecture:
models/distil/minkunet.py:30-263, blocks resnet_base.py:82-118): the
architecture table, the seeded init, the masked batch norm (SyncBN under
a process group), stage dropout, and the gather-engine ``MinkUNet`` over
``sparse.topology``'s kernel maps (the MinkUNet14D default: stem k5, four
k2s2 down-convs, four k2s2 transposed up-convs with skip concats, 1x1
head). Module and parameter names follow the flax tree, and every engine
registers its modules in the same order, so one state dict
(``convert.student_state_dict``) and one seed serve the gather, brick and
pillar students alike.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..core.distributed import all_reduce_sum_diff
from ..core.mesh import distributed
from .ops import sparse_conv, sparse_conv_transpose
from .topology import UNetTopology


def _kaiming_fan_out(shape: Sequence[int],
                     generator: Optional[torch.Generator] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Kaiming-normal, fan_out, relu gain (ME.utils.kaiming_normal_
    analogue, reference models/distil/resnet_base.py:73-77). shape
    (K, Cin, Cout). Draws on the CPU so a seed gives the same weights on
    every device."""
    fan_out = shape[0] * shape[-1]
    std = (2.0 / fan_out) ** 0.5
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


class ConvKernel(nn.Module):
    """A sparse conv holding one (K, Cin, Cout) ``kernel`` parameter."""

    def __init__(self, taps: int, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(taps, cin, cout))


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class MaskedBatchNorm(nn.Module):
    """BatchNorm over valid voxels (``unet.py:38-78``), over the global
    batch under a process group (SyncBN, reference
    tools/train_distil.py:124-126).

    Parameters ``scale``/``bias`` and running buffers ``mean``/``var``
    keep the flax names. In training mode (``self.training``) the
    statistics are float32 masked moments over every non-channel axis,
    ``n = max(sum(mask), 1)``, and the running buffers move with
    torch-convention momentum 0.1 toward the mean and the unbiased
    variance ``var * n / max(n - 1, 1)`` (ME.MinkowskiBatchNorm's
    defaults), unless ``update_stats`` is False (a rematerialised forward
    must not move them twice). In eval mode the running buffers serve.
    The arithmetic keeps JAX's order: the f32 stats cast to ``x.dtype``
    first, then rsqrt, scale, bias and the mask; ``torch.nn.BatchNorm*``
    cannot stand in, it does not mask padding.

    Under a process group the moments are the global batch's, in JAX's
    two passes: ``[sum(x w), sum(w)]`` summed over the ranks, the mean,
    then ``sum(w (x - mean)^2)`` summed over the ranks. Both sums are
    differentiable (``all_reduce_sum_diff``), so the gradient through the
    statistics reaches every rank's voxels as in the global-batch step,
    and every rank moves its running buffers by the same amount. A
    rematerialised forward sums again in the backward, in the same order
    on every rank (the same graph).
    """

    MOMENTUM = 0.1

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            reduce = all_reduce_sum_diff if distributed() else _same
            w = mask.float()[..., None]
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            sums = reduce(torch.cat([(xf * w).sum(axes), w.sum()[None]]))
            n = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / n
            var = reduce((w * (xf - mean) ** 2).sum(axes)) / n
            if self.update_stats:
                with torch.no_grad():
                    m = self.MOMENTUM
                    unbiased = var * n / (n - 1.0).clamp(min=1.0)
                    self.mean.copy_((1 - m) * self.mean + m * mean)
                    self.var.copy_((1 - m) * self.var + m * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        y = y * self.scale.to(x.dtype) + self.bias.to(x.dtype)
        return y * mask[..., None].to(x.dtype)


def reset_student_parameters(model: nn.Module,
                             generator: Optional[torch.Generator] = None
                             ) -> None:
    """Seeded student init: kaiming fan-out conv kernels (drawn on the CPU
    in module order, so engines that register the same modules in the same
    order draw the same weights), unit BN scale/var, zero BN bias/mean."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, ConvKernel):
                mod.kernel.copy_(_kaiming_fan_out(tuple(mod.kernel.shape),
                                                  generator))
            elif isinstance(mod, MaskedBatchNorm):
                mod.scale.fill_(1.0)
                mod.bias.zero_()
                mod.mean.zero_()
                mod.var.fill_(1.0)


# name -> (block, LAYERS, PLANES) — reference minkunet.py:197-263
UNET_ARCHS: Dict[str, Tuple[str, Tuple[int, ...], Tuple[int, ...]]] = {
    "MinkUNet14A": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet14B": ("basic", (1,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet14C": ("basic", (1,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet14D": ("basic", (1,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18A": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet18B": ("basic", (2,) * 8, (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet18C": ("basic", (2,) * 8, (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet18D": ("basic", (2,) * 8, (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet18E": ("basic", (2,) * 8, (96, 192, 384, 768, 384, 192, 96, 96)),
    "MinkUNet34A": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 64)),
    "MinkUNet34B": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 64, 32)),
    "MinkUNet34C": ("basic", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet50": ("bottleneck", (2, 3, 4, 6, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    # upstream MinkowskiNet's MinkUNet101 spec and its A-E width variants
    # (the reference's bare MinkUNet50/101 classes are not constructible)
    "MinkUNet101": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 256, 128, 96, 96)),
    "MinkUNet101A": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 96, 96)),
    "MinkUNet101B": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 128, 128, 128, 128)),
    "MinkUNet101C": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 192, 192, 128, 128)),
    "MinkUNet101D": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (32, 64, 128, 256, 384, 384, 384, 384)),
    "MinkUNet101E": ("bottleneck", (2, 3, 4, 23, 2, 2, 2, 2), (96, 192, 384, 768, 384, 192, 96, 96)),
    # miniature archs for tests/smoke runs
    "tiny": ("basic", (1,) * 8, (4, 4, 8, 8, 8, 8, 4, 4)),
    "tiny_bn": ("bottleneck", (1,) * 8, (4, 4, 8, 8, 8, 8, 4, 4)),
}


def stage_dropout(x: torch.Tensor, rate: float, training: bool,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """Dropout after a stage in training (JAX ``_dropout``, flax
    ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate)), the mask drawn from ``generator``."""
    if rate <= 0 or not training:
        return x
    if rate >= 1:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class SparseConv(ConvKernel):
    """Sparse conv over a kernel map (a level's k3/k5 map or a down map)."""

    def forward(self, x, nbr_map, out_mask):
        return sparse_conv(x, nbr_map, self.kernel.to(x.dtype), out_mask)


class SparseConvTranspose(ConvKernel):
    def __init__(self, cin: int, cout: int):
        super().__init__(8, cin, cout)

    def forward(self, x, up_parent, up_offset, out_mask):
        return sparse_conv_transpose(x, up_parent, up_offset,
                                     self.kernel.to(x.dtype), out_mask)


class Conv1x1(ConvKernel):
    """Kernel-size-1 sparse conv: a per-voxel matmul, no bias (ME)."""

    def __init__(self, cin: int, cout: int):
        super().__init__(1, cin, cout)

    def forward(self, x, out_mask):
        y = x @ self.kernel[0].to(x.dtype)
        return y * out_mask[..., None].to(x.dtype)


class BasicBlock(nn.Module):
    """ME resnet BasicBlock: conv3-bn-relu-conv3-bn (+1x1 downsample),
    relu."""

    expansion = 1

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = SparseConv(27, cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(27, planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        if cin != planes * self.expansion:
            self.downsample_conv = Conv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x, nbr_map, mask):
        out = F.relu(self.norm1(self.conv1(x, nbr_map, mask), mask))
        out = self.norm2(self.conv2(out, nbr_map, mask), mask)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, mask),
                                            mask)
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """ME resnet Bottleneck: 1x1, 3x3, 1x1 with expansion 4."""

    expansion = 4

    def __init__(self, cin: int, planes: int):
        super().__init__()
        self.conv1 = Conv1x1(cin, planes)
        self.norm1 = MaskedBatchNorm(planes)
        self.conv2 = SparseConv(27, planes, planes)
        self.norm2 = MaskedBatchNorm(planes)
        self.conv3 = Conv1x1(planes, planes * self.expansion)
        self.norm3 = MaskedBatchNorm(planes * self.expansion)
        if cin != planes * self.expansion:
            self.downsample_conv = Conv1x1(cin, planes * self.expansion)
            self.downsample_norm = MaskedBatchNorm(planes * self.expansion)

    def forward(self, x, nbr_map, mask):
        out = F.relu(self.norm1(self.conv1(x, mask), mask))
        out = F.relu(self.norm2(self.conv2(out, nbr_map, mask), mask))
        out = self.norm3(self.conv3(out, mask), mask)
        residual = x
        if hasattr(self, "downsample_conv"):
            residual = self.downsample_norm(self.downsample_conv(x, mask),
                                            mask)
        return F.relu(out + residual)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class MinkUNet(nn.Module):
    """forward(topo: UNetTopology, x (B, M, Cin) in input row order) ->
    (B, M, out_channels) in input row order [+ (B, M, n_classes) logits
    with ``use_cls_head``]. The levels run in key-sorted order: x is
    taken through ``topo.order`` and the output put back through it, so
    inputs need not come key-sorted (``data.voxelize_np`` gives them
    sorted, and then ``order`` is the identity on the occupied rows)."""

    def __init__(self, in_channels: int, out_channels: int,
                 block: str = "basic", layers: Sequence[int] = (1,) * 8,
                 planes: Sequence[int] = (32, 64, 128, 256, 384, 384, 384, 384),
                 init_dim: int = 32, dropout_rate: float = 0.0,
                 use_cls_head: bool = False, n_classes: int = 0):
        super().__init__()
        block_cls = _BLOCKS[block]
        exp = block_cls.expansion
        self.layers, self.planes = tuple(layers), tuple(planes)
        self.dropout_rate = float(dropout_rate)
        self.use_cls_head = use_cls_head
        self.conv0p1s1 = SparseConv(125, in_channels, init_dim)
        self.bn0 = MaskedBatchNorm(init_dim)
        ch, enc_out = init_dim, []
        for s in range(4):
            setattr(self, f"conv{s + 1}", SparseConv(8, ch, ch))
            setattr(self, f"bn{s + 1}", MaskedBatchNorm(ch))
            ch = self._add_stage(f"block{s + 1}", block_cls, ch,
                                 self.planes[s], self.layers[s], exp)
            enc_out.append(ch)
        skip_ch = [enc_out[2], enc_out[1], enc_out[0], init_dim]
        for d in range(4):
            p = self.planes[4 + d]
            setattr(self, f"convtr{4 + d}", SparseConvTranspose(ch, p))
            setattr(self, f"bntr{4 + d}", MaskedBatchNorm(p))
            ch = self._add_stage(f"block{5 + d}", block_cls, p + skip_ch[d],
                                 p, self.layers[4 + d], exp)
        self.final = Conv1x1(ch, out_channels)
        if use_cls_head:
            self.cls_head = Conv1x1(ch, n_classes)

    def _add_stage(self, name, block_cls, cin, planes, n_blocks, exp) -> int:
        for i in range(n_blocks):
            setattr(self, f"{name}_{i}", block_cls(cin, planes))
            cin = planes * exp
        return cin

    def _stage(self, name, x, nbr_map, mask, n_blocks, generator):
        for i in range(n_blocks):
            x = getattr(self, f"{name}_{i}")(x, nbr_map, mask)
        return stage_dropout(x, self.dropout_rate, self.training, generator)

    def forward(self, topo: UNetTopology, x: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        order = topo.order
        x = torch.gather(x, 1, order[..., None].expand(-1, -1, x.shape[-1]))
        masks = [lv.mask for lv in topo.levels]
        out = self.conv0p1s1(x, topo.stem_map, masks[0])
        out_p1 = F.relu(self.bn0(out, masks[0]))
        skips, out = [], out_p1
        for s in range(4):
            out = getattr(self, f"conv{s + 1}")(out, topo.down_maps[s],
                                                masks[s + 1])
            out = F.relu(getattr(self, f"bn{s + 1}")(out, masks[s + 1]))
            out = self._stage(f"block{s + 1}", out, topo.k3_maps[s + 1],
                              masks[s + 1], self.layers[s], generator)
            skips.append(out)
        skip_feats = [skips[2], skips[1], skips[0], out_p1]
        for d in range(4):
            lvl = 3 - d
            out = getattr(self, f"convtr{4 + d}")(
                out, topo.up_parent[lvl], topo.up_offset[lvl], masks[lvl])
            out = F.relu(getattr(self, f"bntr{4 + d}")(out, masks[lvl]))
            out = torch.cat([out, skip_feats[d]], dim=-1)
            out = self._stage(f"block{5 + d}", out, topo.k3_maps[lvl],
                              masks[lvl], self.layers[4 + d], generator)

        def unsorted(f):
            return torch.zeros_like(f).scatter_(
                1, order[..., None].expand(-1, -1, f.shape[-1]), f)

        feats = unsorted(self.final(out, masks[0]))
        if self.use_cls_head:
            return feats, unsorted(self.cls_head(out, masks[0]))
        return feats


def arch_of(cfg: Any) -> Tuple[str, Tuple[int, ...], Tuple[int, ...]]:
    """(block, layers, planes) of ``cfg.arch_3d`` (MinkUNet14D by
    default) with the ``planes``/``layers`` overrides."""
    arch = cfg.arch_3d or "MinkUNet14D"
    if arch not in UNET_ARCHS:
        raise ValueError(f"architecture {arch} not supported")
    block, layers, planes = UNET_ARCHS[arch]
    if cfg.planes is not None:
        planes = tuple(int(p) for p in cfg.planes)
    if cfg.layers is not None:
        layers = tuple(int(l) for l in cfg.layers)
    return block, layers, planes


def build_student(cfg: Any, in_channels: Optional[int] = None,
                  generator: Optional[torch.Generator] = None) -> MinkUNet:
    """Gather-engine student (DisNet, reference models/distil/disnet.py:
    24-39), in eval mode, weights drawn from ``generator``;
    ``in_channels`` defaults to xyz (+rgb with ``cfg.use_color``)."""
    block, layers, planes = arch_of(cfg)
    if in_channels is None:
        in_channels = 6 if cfg.use_color else 3
    model = MinkUNet(
        in_channels=in_channels, out_channels=int(cfg.feat_dim or 768),
        block=block, layers=layers, planes=planes,
        init_dim=int(cfg.init_dim or 32),
        dropout_rate=float(cfg.dropout_rate or 0.0),
        use_cls_head=bool(cfg.use_cls_head),
        n_classes=int(cfg.n_classes or 0))
    reset_student_parameters(model, generator)
    return model.eval()
