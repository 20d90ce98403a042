"""MinkUNet with basic blocks (MinkowskiEngine's MinkUNet14D and kin) in
plain PyTorch over a dict of weights, in float32.

Sparse semantics as MinkowskiEngine defines them, written from its
description and not from the program: level l+1 holds the unique
``floor(c / 2)`` of level l, per scene; a submanifold conv of kernel k
sums, for every occupied voxel, ``x[v + o] @ W[o]`` over the offsets o
of the cube in (x, y, z) lexicographic order whose voxel is occupied; the
k2s2 down conv sums each coarse voxel's children ``x[2c + o] @ W[o]``
(o in {0, 1}^3, index ``4 ox + 2 oy + oz``); the transposed conv gives
each fine voxel ``x[f >> 1] @ W[f & 1]``; a 1x1 conv is ``x @ W[0]``.
Batch norm takes the mean and biased variance over the batch's occupied
voxels in training, moves the running statistics by momentum 0.1
towards the mean and the unbiased variance, and uses the running ones in
eval. Weight names are ``counting.unet_convs``' names with ``.kernel``,
and ``scale``/``bias``/``mean``/``var`` of each norm.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from ..counting import offsets, unet_convs

_BITS = 18


def _pack(scene: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    c = c.long() + (1 << (_BITS - 1))
    return (((scene.long() << _BITS | c[:, 0]) << _BITS | c[:, 1])
            << _BITS | c[:, 2])


class Level:
    """The occupied voxels of one level: sorted keys, coords, scenes."""

    def __init__(self, scene: torch.Tensor, coords: torch.Tensor):
        keys = _pack(scene, coords)
        self.keys, inv = torch.unique(keys, sorted=True, return_inverse=True)
        n = self.keys.numel()
        first = torch.full((n,), keys.numel(), dtype=torch.long,
                           device=keys.device)
        first.scatter_reduce_(0, inv, torch.arange(keys.numel(),
                                                   device=keys.device),
                              "amin")
        self.scene, self.coords = scene[first], coords[first]
        self.inverse = inv

    def __len__(self):
        return self.keys.numel()

    def find(self, scene: torch.Tensor, coords: torch.Tensor):
        """(hit mask, row) of each (scene, coords) query."""
        q = _pack(scene, coords)
        idx = torch.searchsorted(self.keys, q).clamp(max=len(self) - 1)
        return self.keys[idx] == q, idx

    def pairs(self, size: int) -> List[tuple]:
        """Per offset of a cube of ``size``: (source rows, output rows)."""
        out = []
        for o in torch.as_tensor(offsets(size), device=self.keys.device):
            hit, idx = self.find(self.scene, self.coords + o)
            rows = hit.nonzero()[:, 0]
            out.append((idx[rows], rows))
        return out


class Pyramid:
    """Every level of a batch, with the maps between them."""

    def __init__(self, coords: torch.Tensor, mask: torch.Tensor,
                 n_levels: int = 5):
        b, m = mask.shape
        scene = torch.arange(b, device=mask.device)[:, None].expand(b, m)
        self.rows = mask.reshape(-1).nonzero()[:, 0]
        lv = Level(scene.reshape(-1)[self.rows],
                   coords.reshape(-1, 3)[self.rows].long())
        self.shape = (b, m)
        self.levels = [lv]
        self.parent, self.octant = [], []
        for _ in range(1, n_levels):
            fine = self.levels[-1]
            coarse = Level(fine.scene, fine.coords >> 1)
            _, parent = coarse.find(fine.scene, fine.coords >> 1)
            o = fine.coords & 1
            self.parent.append(parent)
            self.octant.append(o[:, 0] * 4 + o[:, 1] * 2 + o[:, 2])
            self.levels.append(coarse)
        self.k3 = [level.pairs(3) for level in self.levels]
        self.k5 = self.levels[0].pairs(5)

    def to_rows(self, feats: torch.Tensor) -> torch.Tensor:
        """(N0, C) level-0 features -> (B, M, C) in input rows, zero on
        padding."""
        b, m = self.shape
        out = feats.new_zeros((b * m, feats.shape[-1]))
        out[self.rows] = feats[self.levels[0].inverse]
        return out.reshape(b, m, -1)

    def from_rows(self, x: torch.Tensor) -> torch.Tensor:
        """(B, M, C) input rows -> (N0, C) level-0 voxels (one row each)."""
        flat = x.reshape(-1, x.shape[-1])[self.rows]
        out = flat.new_zeros((len(self.levels[0]), flat.shape[-1]))
        return out.index_copy(0, self.levels[0].inverse, flat)


def submanifold(x, pairs, w):
    out = x.new_zeros((x.shape[0], w.shape[-1]))
    for k, (src, dst) in enumerate(pairs):
        if dst.numel():
            out = out.index_add(0, dst, x[src] @ w[k])
    return out


def down(x, parent, octant, n_coarse, w):
    out = x.new_zeros((n_coarse, w.shape[-1]))
    for o in range(8):
        sel = (octant == o).nonzero()[:, 0]
        out = out.index_add(0, parent[sel], x[sel] @ w[o])
    return out


def up(x, parent, octant, w):
    out = x.new_zeros((parent.numel(), w.shape[-1]))
    for o in range(8):
        sel = (octant == o).nonzero()[:, 0]
        out = out.index_copy(0, sel, x[parent[sel]] @ w[o])
    return out


class Norms:
    """Batch norms over a weights dict: training statistics, or the
    running ones; ``moved`` collects the running statistics a training
    forward moves to (name -> (mean, var))."""

    def __init__(self, weights: Dict[str, torch.Tensor], training: bool,
                 eps: float = 1e-5, momentum: float = 0.1):
        self.w, self.training, self.eps, self.m = (weights, training, eps,
                                                   momentum)
        self.moved: Dict[str, tuple] = {}

    def __call__(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w = self.w
        if self.training:
            n = x.shape[0]
            mean = x.mean(0)
            var = ((x - mean) ** 2).mean(0)
            with torch.no_grad():
                m = self.m
                self.moved[name] = (
                    (1 - m) * w[f"{name}.mean"] + m * mean.detach(),
                    (1 - m) * w[f"{name}.var"]
                    + m * var.detach() * n / max(n - 1, 1))
        else:
            mean, var = w[f"{name}.mean"], w[f"{name}.var"]
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * w[f"{name}.scale"] + w[f"{name}.bias"]


def forward(weights: Dict[str, torch.Tensor], arch: Dict, pyr: Pyramid,
            x_rows: torch.Tensor, norms: Norms) -> torch.Tensor:
    """(B, M, Cin) input rows -> (B, M, feat_dim) output rows."""
    w = {k: v for k, v in weights.items()}
    relu = torch.relu
    lv = pyr.levels
    convs = {c["name"]: c for c in unet_convs(arch)}

    def block(name, x, level):
        out = relu(norms(f"{name}.norm1",
                         submanifold(x, pyr.k3[level],
                                     w[f"{name}.conv1.kernel"])))
        out = norms(f"{name}.norm2", submanifold(out, pyr.k3[level],
                                                 w[f"{name}.conv2.kernel"]))
        res = x
        if f"{name}.downsample_conv" in convs:
            res = norms(f"{name}.downsample_norm",
                        x @ w[f"{name}.downsample_conv.kernel"][0])
        return relu(out + res)

    x = pyr.from_rows(x_rows)
    out_p1 = relu(norms("bn0", submanifold(x, pyr.k5,
                                           w["conv0p1s1.kernel"])))
    out, skips = out_p1, []
    for s in range(4):
        out = down(out, pyr.parent[s], pyr.octant[s], len(lv[s + 1]),
                   w[f"conv{s + 1}.kernel"])
        out = relu(norms(f"bn{s + 1}", out))
        for i in range(arch["layers"][s]):
            out = block(f"block{s + 1}_{i}", out, s + 1)
        skips.append(out)
    skip = [skips[2], skips[1], skips[0], out_p1]
    for d in range(4):
        lvl = 3 - d
        out = up(out, pyr.parent[lvl], pyr.octant[lvl],
                 w[f"convtr{4 + d}.kernel"])
        out = relu(norms(f"bntr{4 + d}", out))
        out = torch.cat([out, skip[d]], -1)
        for i in range(arch["layers"][4 + d]):
            out = block(f"block{5 + d}_{i}", out, lvl)
    return pyr.to_rows(out @ w["final.kernel"][0])


def weight_shapes(arch: Dict) -> Dict[str, tuple]:
    """Every weight and statistic of the student, in module order."""
    taps = {"k5": 125, "k3": 27, "down": 8, "up": 8, "1x1": 1}
    shapes = {}
    norm_of = {"conv0p1s1": "bn0", **{f"conv{s}": f"bn{s}"
                                      for s in range(1, 5)},
               **{f"convtr{s}": f"bntr{s}" for s in range(4, 8)}}
    for c in unet_convs(arch):
        name = c["name"]
        shapes[f"{name}.kernel"] = (taps[c["kind"]], c["C"], c["Cout"])
        if name == "final":
            continue
        # a block's convN pairs with normN, downsample_conv with
        # downsample_norm
        norm = norm_of.get(name) or name.replace("conv", "norm")
        for k in ("scale", "bias", "mean", "var"):
            shapes[f"{norm}.{k}"] = (c["Cout"],)
    return shapes


def cosine_loss(out: torch.Tensor, targets: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``1 - cos(out, target)`` over the occupied rows."""
    o, t = out[mask], targets[mask]
    cos = (o * t).sum(-1) / (o.norm(dim=-1).clamp(min=1e-8)
                             * t.norm(dim=-1).clamp(min=1e-8))
    return (1 - cos).mean()
