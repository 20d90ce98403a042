"""The gather engine's topology (dropclip_tpu_torch.sparse.topology)
against dropclip_tpu.sparse.topology: every level's coords, keys and mask
and every kernel map equal element for element, at the default
capacities and where the coarse levels overflow theirs; the port counts
what it drops (coarse voxels past capacity, voxels past the keys' range),
where the JAX builder reports nothing; ``order`` puts unsorted input back
in key order."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.sparse.topology import build_unet_topology as j_build
from dropclip_tpu.sparse.topology import kernel_offsets as j_offsets
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.geom.voxelize import INVALID_KEY
from dropclip_tpu_torch.sparse.topology import (build_unet_topology,
                                                kernel_offsets, unravel_key)

MAPS = ("stem_map", "k3_maps", "down_maps", "up_parent", "up_offset")


def _scenes(seed=0, batch=2, cap=256):
    return make_tabletop_coords(np.random.RandomState(seed), batch, cap,
                                n_occ=180, ext=10)


def _assert_tables_equal(got, ref):
    for lg, lr in zip(got.levels, ref.levels, strict=True):
        for f in ("coords", "keys", "mask"):
            np.testing.assert_array_equal(getattr(lg, f).numpy(),
                                          np.asarray(getattr(lr, f)), f)
    for name in MAPS:
        g, r = getattr(got, name), getattr(ref, name)
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        r if isinstance(r, tuple) else (r,), strict=True):
            assert a.dtype == torch.int32, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)


def test_kernel_offsets_match_jax():
    for size in (2, 3, 5):
        np.testing.assert_array_equal(kernel_offsets(size), j_offsets(size))


@pytest.mark.parametrize("caps", [None, (256, 64, 16, 8, 4)])
def test_tables_match_jax(caps):
    """Default capacities (nothing dropped) and capacities the coarse
    levels overflow: the same tables, and the port's ``dropped`` counts
    exactly the unique coarse keys past each level's capacity."""
    coords, mask = _scenes()
    ref = jax.tree_util.tree_map(np.asarray, j_build(
        jnp.asarray(coords), jnp.asarray(mask), capacities=caps))
    got = build_unet_topology(torch.as_tensor(coords), torch.as_tensor(mask),
                              capacities=caps)
    _assert_tables_equal(got, ref)
    want = np.zeros((2, 5), np.int32)
    if caps is not None:
        lv = got.levels
        for b in range(2):
            for level in range(1, 5):
                parents = lv[level - 1].coords[b][lv[level - 1].mask[b]] >> 1
                n = len(np.unique(parents.numpy(), axis=0))
                want[b, level] = max(n - caps[level], 0)
        assert want.sum() > 0
    np.testing.assert_array_equal(got.dropped.numpy(), want)


def test_out_of_range_voxels_are_counted():
    """Voxels past the keys' 10 bits an axis (|c| >= 512) are masked out
    of level 0 by both builders; the port counts them at level 0."""
    coords, mask = _scenes(seed=1, batch=1)
    coords = coords.copy()
    far = np.flatnonzero(mask[0])[:5]
    coords[0, far, 0] += 600
    ref = jax.tree_util.tree_map(np.asarray, j_build(
        jnp.asarray(coords), jnp.asarray(mask)))
    got = build_unet_topology(torch.as_tensor(coords), torch.as_tensor(mask))
    _assert_tables_equal(got, ref)
    assert int(got.dropped[0, 0]) == 5
    assert int(got.levels[0].mask.sum()) == int(mask.sum()) - 5


def test_order_and_single_scene():
    """Shuffled input rows give the key-sorted tables of the sorted input,
    and ``order`` names each slot's input row; an unbatched input is a
    batch of one; keys unravel to the level's coords."""
    coords, mask = _scenes(seed=2, batch=1)
    perm = np.random.RandomState(3).permutation(coords.shape[1])
    sorted_topo = build_unet_topology(torch.as_tensor(coords[0]),
                                      torch.as_tensor(mask[0]))
    shuffled = build_unet_topology(torch.as_tensor(coords[:, perm]),
                                   torch.as_tensor(mask[:, perm]))
    for name in MAPS:
        for a, b in zip(*(getattr(t, name) if isinstance(getattr(t, name),
                                                         tuple)
                          else (getattr(t, name),)
                          for t in (sorted_topo, shuffled))):
            assert torch.equal(a, b), name
    lv = shuffled.levels[0]
    order = shuffled.order[0].numpy()
    m = lv.mask[0].numpy()
    np.testing.assert_array_equal(coords[0, perm][order][m],
                                  lv.coords[0].numpy()[m])
    keys = lv.keys[0][lv.mask[0]]
    assert (keys != INVALID_KEY).all()
    np.testing.assert_array_equal(unravel_key(keys).numpy(),
                                  lv.coords[0][lv.mask[0]].numpy())


def test_capacities_must_fit_the_input():
    coords, mask = _scenes(batch=1)
    with pytest.raises(ValueError, match="level 0"):
        build_unet_topology(torch.as_tensor(coords), torch.as_tensor(mask),
                            capacities=(128, 64, 32, 16, 8))
