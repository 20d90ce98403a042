"""The benchmark's pair, operation and byte counts against brute force."""

import itertools

import numpy as np
import pytest

from benchmark import counting, peaks


def brute_pairs(coords, size):
    occ = {tuple(c) for c in coords.tolist()}
    r = range(-(size // 2), size // 2 + 1)
    return sum((c[0] + dx, c[1] + dy, c[2] + dz) in occ
               for c in occ for dx, dy, dz in itertools.product(r, r, r))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("size", [3, 5])
def test_pairs_match_brute_force(seed, size):
    rng = np.random.default_rng(seed)
    coords = np.unique(rng.integers(-4, 4, (60, 3)), axis=0)
    assert counting.pairs(coords, size) == brute_pairs(coords, size)


def test_offsets_are_lexicographic():
    off = counting.offsets(3)
    assert off.shape == (27, 3)
    assert off[0].tolist() == [-1, -1, -1] and off[13].tolist() == [0, 0, 0]
    assert off[1].tolist() == [-1, -1, 0] and off[26].tolist() == [1, 1, 1]
    assert counting.offsets(2).tolist()[4] == [1, 0, 0]


def test_levels_halve_with_floor():
    c = np.array([[-1, 0, 0], [-2, 0, 0], [1, 1, 1], [3, 3, 3]])
    lv = counting.scene_levels(c, 3)
    assert lv[1].tolist() == [[-1, 0, 0], [0, 0, 0], [1, 1, 1]]
    assert lv[2].tolist() == [[-1, 0, 0], [0, 0, 0]]


def test_student_work_by_hand():
    """Two adjacent voxels through a toy UNet: each conv's pairs by hand."""
    arch = dict(planes=(2,) * 8, layers=(1,) * 8, init_dim=2,
                in_channels=3, feat_dim=4)
    st = counting.level_stats([np.array([[0, 0, 0], [1, 0, 0]])])
    assert st["voxels"].tolist() == [2, 1, 1, 1, 1]
    assert st["k3_pairs"].tolist() == [4, 1, 1, 1, 1]
    assert st["k5_pairs"] == 4
    convs = counting.unet_convs(arch)
    by = {c["name"]: c for c in convs}
    assert counting.conv_pairs(by["conv1"], st) == 2   # two children
    assert counting.conv_pairs(by["convtr7"], st) == 2  # two fine voxels
    f, b = counting.conv_work(by["conv0p1s1"], st)
    assert f == 2 * 4 * 3 * 2
    assert b == 4 * (2 * 3 + 2 * 2 + 125 * 3 * 2)
    w = counting.student_work(arch, st)
    assert w["k3_convs"] == 16
    # every k3 conv is 2 -> 2 channels except the decoder's first (4 -> 2)
    k3 = [c for c in convs if c["kind"] == "k3"]
    assert w["k3_flops"] == sum(
        2 * st["k3_pairs"][c["level"]] * c["C"] * c["Cout"] for c in k3)


def test_least_seconds_picks_the_bound():
    t, what = peaks.least_seconds(165e12, 0, "float32")
    assert t == pytest.approx(1.0) and what == "operations"
    t, what = peaks.least_seconds(1, 3.35e12, "bfloat16")
    assert t == pytest.approx(1.0) and what == "bytes"
