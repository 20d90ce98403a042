"""Pillar topology: dropclip_tpu_torch.sparse.pillar_topology against the
JAX builder (dropclip_tpu/sparse/pillar_topology.py) on the same voxel
sets: every table equal element for element. Also the faults of the
reference the port does not copy: an empty cloud builds empty levels, and
a scene taller than a frozen z0 raises a ValueError naming pillar_z0."""

import numpy as np
import pytest
import torch

from dropclip_tpu.sparse.pillar_topology import \
    build_pillar_topology as j_build
from dropclip_tpu_torch.data.synthetic import make_volumetric_coords
from dropclip_tpu_torch.sparse.pillar_topology import (
    build_pillar_topology, gather_points_pillar, scatter_points_pillar)


def _scene(seed, m=512, n_occ=400, z_shift=0):
    coords, mask = make_volumetric_coords(np.random.RandomState(seed), 1, m,
                                          n_occ=n_occ, ext=8, zext=16)
    coords = coords[0] + np.array([0, 0, z_shift], np.int32) * mask[0, :,
                                                                    None]
    return coords, mask[0]


def _assert_same(t, j):
    assert len(t.levels) == len(j.levels)
    for lt, lj in zip(t.levels, j.levels):
        for name in ("xy", "occ", "nbr9", "mask"):
            a, b = getattr(lt, name).numpy(), np.asarray(getattr(lj, name))
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("child", "parent", "xy_parity"):
        for a, b in zip(getattr(t, name), getattr(j, name)):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    for name in ("nbr25", "point_pillar", "point_z"):
        a, b = getattr(t, name).numpy(), np.asarray(getattr(j, name))
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert t.z_offset == j.z_offset
    assert t.dropped == int(j.dropped)


@pytest.mark.parametrize("case", ["exact", "padded", "truncating",
                                  "z_shift", "z0"])
def test_tables_equal_jax(case):
    coords, mask = _scene(1, z_shift=-7 if case == "z_shift" else 0)
    kw = {}
    if case in ("padded", "truncating"):
        exact = j_build(coords, mask)
        kw["site_capacities"] = [
            lv.occ.shape[0] + 13 if case == "padded"
            else max(1, lv.occ.shape[0] * 2 // 3) for lv in exact.levels]
    if case == "z0":
        kw["z0"] = 48
    t = build_pillar_topology(coords, mask, device="cpu", **kw)
    j = j_build(coords, mask, **kw)
    _assert_same(t, j)
    if case == "truncating":
        assert t.dropped > 0
        # points of dropped sites read the pad row
        assert (t.point_pillar.numpy()[mask] == t.levels[0].occ.shape[0]
                ).any()
    if case == "z_shift":
        assert t.z_offset % 16 == 0 and t.z_offset < 0


def test_points_round_trip():
    """scatter then gather returns each valid point's features; masked
    points (all on the pad row) read zeros."""
    coords, mask = _scene(2)
    t = build_pillar_topology(coords, mask, device="cpu")
    feats = torch.randn(len(coords), 5, generator=torch.Generator()
                        .manual_seed(0)) * torch.as_tensor(mask)[:, None]
    dense = scatter_points_pillar(feats, t)
    assert tuple(dense.shape) == tuple(t.levels[0].occ.shape) + (5,)
    assert torch.equal(gather_points_pillar(dense, t), feats)
    assert int((dense.abs().sum(-1) > 0).sum()) <= int(t.levels[0].occ.sum())


def test_empty_cloud_builds_empty_levels():
    """The JAX builder asserts on an empty scene; the port builds empty
    levels (all-miss tables at the given capacities) and sends every point
    to the pad row."""
    coords = np.zeros((32, 3), np.int32)
    mask = np.zeros(32, bool)
    t = build_pillar_topology(coords, mask, site_capacities=[16] * 5,
                              device="cpu")
    assert t.dropped == 0 and t.z_offset == 0
    for lvl, lv in enumerate(t.levels):
        assert tuple(lv.occ.shape) == (16, 16 >> lvl)
        assert not lv.occ.any() and not lv.mask.any()
        assert bool((lv.nbr9 == 16).all())
    assert bool((t.point_pillar == 16).all())
    exact = build_pillar_topology(coords, mask, device="cpu")
    assert all(lv.occ.shape[0] == 0 for lv in exact.levels)


def test_frozen_z0_too_small_names_pillar_z0():
    coords, mask = _scene(3, z_shift=-7)  # spans 25 slots above z = -16
    assert build_pillar_topology(coords, mask, device="cpu").levels[0] \
        .occ.shape[1] == 32
    with pytest.raises(ValueError, match="pillar_z0"):
        build_pillar_topology(coords, mask, z0=16, device="cpu")
    with pytest.raises(ValueError, match="pillar_z0"):
        build_pillar_topology(coords, mask, z0=40, device="cpu")
