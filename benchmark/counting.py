"""The work of the student, counted from the voxel coordinates the
benchmark generated, whatever implements it.

Levels follow MinkowskiEngine's coordinate manager: level l+1 holds the
unique ``floor(c / 2)`` of level l, per scene. A submanifold conv of
kernel k pairs every occupied output voxel with each occupied voxel at
one of its k**3 offsets; a k2s2 down conv pairs each fine voxel with its
parent (one tap); the transposed conv each fine voxel with its parent; a
1x1 conv each voxel with itself. A product over a pair costs
``2 * C * Cout`` operations. Bytes are each input read once and each
output written once: features, weights, outputs, in the compute dtype.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

_BIAS = 1 << 20  # keeps every axis non-negative before packing


def _keys(c: np.ndarray) -> np.ndarray:
    c = c.astype(np.int64) + _BIAS
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def offsets(size: int) -> np.ndarray:
    """Offsets of a cubic kernel in (x, y, z) lexicographic order: odd
    sizes centred, even sizes over [0, size)."""
    r = (np.arange(-(size // 2), size // 2 + 1) if size % 2
         else np.arange(size))
    g = np.stack(np.meshgrid(r, r, r, indexing="ij"), -1)
    return g.reshape(-1, 3).astype(np.int64)


def scene_levels(coords: np.ndarray, n_levels: int = 5) -> List[np.ndarray]:
    """Unique voxel coords (N_l, 3) of each level of one scene."""
    lv = [np.unique(np.asarray(coords, np.int64), axis=0)]
    for _ in range(1, n_levels):
        lv.append(np.unique(lv[-1] >> 1, axis=0))
    return lv


def pairs(level: np.ndarray, size: int) -> int:
    """Occupied (voxel, tap) pairs of a submanifold conv of kernel
    ``size`` over one level of one scene."""
    keys = np.sort(_keys(level))
    total = 0
    for o in offsets(size):
        q = _keys(level + o)
        idx = np.searchsorted(keys, q).clip(max=len(keys) - 1)
        total += int((keys[idx] == q).sum())
    return total


def level_stats(scenes: Sequence[np.ndarray], n_levels: int = 5) -> Dict:
    """Per level, summed over ``scenes`` (each (N, 3) unique coords):
    voxels, k3 pairs; and the level-0 k5 pairs of the stem."""
    vox = np.zeros(n_levels, np.int64)
    k3 = np.zeros(n_levels, np.int64)
    k5 = 0
    for c in scenes:
        lv = scene_levels(c, n_levels)
        k5 += pairs(lv[0], 5)
        for i, l in enumerate(lv):
            vox[i] += len(l)
            k3[i] += pairs(l, 3)
    return {"voxels": vox, "k3_pairs": k3, "k5_pairs": k5}


def unet_convs(arch: Dict) -> List[Dict]:
    """Every conv of a MinkUNet with basic blocks, in forward order:
    {name, kind ("k5", "k3", "down", "up", "1x1"), level, C, Cout}."""
    planes, layers = arch["planes"], arch["layers"]
    init, cin0, out = arch["init_dim"], arch["in_channels"], arch["feat_dim"]
    convs = [dict(name="conv0p1s1", kind="k5", level=0, C=cin0, Cout=init)]

    def stage(name, level, cin, p, n):
        for i in range(n):
            convs.append(dict(name=f"{name}_{i}.conv1", kind="k3",
                              level=level, C=cin, Cout=p))
            convs.append(dict(name=f"{name}_{i}.conv2", kind="k3",
                              level=level, C=p, Cout=p))
            if cin != p:
                convs.append(dict(name=f"{name}_{i}.downsample_conv",
                                  kind="1x1", level=level, C=cin, Cout=p))
            cin = p
        return cin

    ch, enc = init, []
    for s in range(4):
        convs.append(dict(name=f"conv{s + 1}", kind="down", level=s + 1,
                          C=ch, Cout=ch))
        ch = stage(f"block{s + 1}", s + 1, ch, planes[s], layers[s])
        enc.append(ch)
    skips = [enc[2], enc[1], enc[0], init]
    for d in range(4):
        lvl, p = 3 - d, planes[4 + d]
        convs.append(dict(name=f"convtr{4 + d}", kind="up", level=lvl, C=ch,
                          Cout=p))
        ch = stage(f"block{5 + d}", lvl, p + skips[d], p, layers[4 + d])
    convs.append(dict(name="final", kind="1x1", level=0, C=ch, Cout=out))
    return convs


def conv_pairs(conv: Dict, stats: Dict) -> int:
    """Pairs of one conv over the counted scenes. A down conv's pairs are
    its fine voxels (level - 1), an up conv's its fine voxels (level)."""
    kind, lvl = conv["kind"], conv["level"]
    if kind == "k5":
        return int(stats["k5_pairs"])
    if kind == "k3":
        return int(stats["k3_pairs"][lvl])
    if kind == "down":
        return int(stats["voxels"][lvl - 1])
    return int(stats["voxels"][lvl])


def conv_work(conv: Dict, stats: Dict, itemsize: int = 4):
    """(operations, bytes) of one conv over the counted scenes."""
    c, cout, lvl = conv["C"], conv["Cout"], conv["level"]
    flops = 2 * conv_pairs(conv, stats) * c * cout
    n_out = int(stats["voxels"][lvl])
    n_in = int(stats["voxels"][lvl - 1 if conv["kind"] == "down"
                                else lvl + 1 if conv["kind"] == "up"
                                else lvl])
    taps = {"k5": 125, "k3": 27, "down": 8, "up": 8, "1x1": 1}[conv["kind"]]
    nbytes = itemsize * (n_in * c + n_out * cout + taps * c * cout)
    return flops, nbytes


def student_work(arch: Dict, stats: Dict, itemsize: int = 4) -> Dict:
    """The forward's work: ``flops`` of every conv, and ``k3_flops`` /
    ``k3_bytes`` / ``k3_convs`` of its k3 convs alone (K1's share)."""
    out = dict(flops=0, k3_flops=0, k3_bytes=0, k3_convs=0)
    for conv in unet_convs(arch):
        f, b = conv_work(conv, stats, itemsize)
        out["flops"] += f
        if conv["kind"] == "k3":
            out["k3_flops"] += f
            out["k3_bytes"] += b
            out["k3_convs"] += 1
    return out
