"""Brick engine parity: dropclip_tpu_torch.sparse.bricks (and K1's plain
version) against dropclip_tpu.sparse.bricks on the same numpy inputs."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.sparse import bricks as jb
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.kernels.brick_conv3 import (brick_conv3,
                                                    brick_conv3_plain,
                                                    counter)
from dropclip_tpu_torch.sparse import bricks as tb


def _scenes(seed, batch=2, capacity=512, n_occ=400, ext=12):
    return make_tabletop_coords(np.random.RandomState(seed), batch, capacity,
                                n_occ=n_occ, ext=ext)


def _topos(coords, mask, caps, bshape):
    jt = jb.build_brick_topology(jnp.asarray(coords), jnp.asarray(mask),
                                 brick_capacities=caps, brick_shape=bshape)
    tt = tb.build_brick_topology(torch.as_tensor(coords),
                                 torch.as_tensor(mask),
                                 brick_capacities=caps, brick_shape=bshape)
    return jt, tt


def _assert_topo_equal(jt, tt):
    for l, (a, b) in enumerate(zip(jt.levels, tt.levels)):
        for f in a._fields:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(),
                                          err_msg=f"level {l} {f}")
    for f in ("point_row", "point_within", "dropped"):
        np.testing.assert_array_equal(np.asarray(getattr(jt, f)),
                                      getattr(tt, f).numpy(), err_msg=f)
    for f in ("group_maps", "parent_maps", "octants"):
        assert len(getattr(jt, f)) == len(getattr(tt, f))
        for a, b in zip(getattr(jt, f), getattr(tt, f)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f)


@pytest.mark.parametrize("bshape", [(4, 4, 4), (4, 4, 2)])
@pytest.mark.parametrize("overflow", [False, True])
def test_topology_parity(bshape, overflow):
    """nbr, occ, coords, maps and dropped counters equal exactly; the
    overflow case (tiny capacities) truncates and counts identically."""
    coords, mask = _scenes(0)
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    assert caps == jb.autotune_brick_capacities(coords, mask,
                                                brick_shape=bshape)
    if overflow:
        caps = (16, 8, 8, 8, 8)
    jt, tt = _topos(coords, mask, caps, bshape)
    _assert_topo_equal(jt, tt)
    assert (int(tt.dropped.sum()) > 0) == overflow


def test_topology_extent_overflow_and_unbatched():
    """Voxels outside the grid extent are dropped and counted; an
    unbatched (M, 3) input gives the batched result's first scene."""
    coords, mask = _scenes(1, batch=1)
    coords[0, :5] = [[200, 0, 0], [-300, 4, 1], [0, 0, 140], [1, 1, -140],
                     [0, 999, 0]]
    jt, tt = _topos(coords[0], mask[0], None, (4, 4, 2))
    _assert_topo_equal(jt, tt)
    assert int(tt.dropped[0]) >= 5


@pytest.mark.parametrize("bshape", [(4, 4, 2), (2, 2, 2)])
def test_grid_bits_for_keeps_a_scene_past_the_default_extent(bshape):
    """A scene moved past the default grid's +-64 voxels (by a multiple of
    every level's brick, so the bricks stay the same) loses voxels at
    grid_bits 5; at ``grid_bits_for``'s grid it keeps them all, and its
    topology is the unmoved scene's (JAX's) with the coords moved."""
    coords, mask = _scenes(4, batch=2)
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    jt, tt = _topos(coords, mask, caps, bshape)
    _assert_topo_equal(jt, tt)
    assert tb.grid_bits_for(torch.as_tensor(coords),
                            torch.as_tensor(mask)) == 5
    shift = np.array([192, -192, 128])
    far_c, far_m = torch.as_tensor(coords + shift), torch.as_tensor(mask)
    bits = tb.grid_bits_for(far_c, far_m)
    assert bits == 7
    lost = tb.build_brick_topology(far_c, far_m, brick_capacities=caps,
                                   brick_shape=bshape)
    assert int(lost.dropped[:, 0].sum()) > 0
    far = tb.build_brick_topology(far_c, far_m, grid_bits=bits,
                                  brick_capacities=caps, brick_shape=bshape)
    assert int(far.dropped.sum()) == 0
    brick = shift // np.array(bshape)
    for l, (a, b) in enumerate(zip(tt.levels, far.levels)):
        for f in ("mask", "occ", "nbr"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (l, f)
        moved = torch.where(a.mask[..., None],
                            a.coords + torch.as_tensor(brick >> l).int(), 0)
        assert torch.equal(moved, b.coords), l
    for f in ("point_row", "point_within"):
        assert torch.equal(getattr(tt, f), getattr(far, f)), f
    for f in ("group_maps", "parent_maps", "octants"):
        for a, b in zip(getattr(tt, f), getattr(far, f)):
            assert torch.equal(a, b), f


def test_fold_topology_parity():
    coords, mask = _scenes(2, batch=3)
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=(4, 4, 2))
    jt, tt = _topos(coords, mask, caps, (4, 4, 2))
    _assert_topo_equal(jb.fold_topology(jt), tb.fold_topology(tt))


def _folded_level(bshape, seed=3):
    coords, mask = _scenes(seed, batch=2, capacity=256, n_occ=160, ext=8)
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    jt, tt = _topos(coords, mask, caps, bshape)
    return jb.fold_topology(jt), tb.fold_topology(tt)


def _rand_feats(rng, level_occ, c):
    shape = tuple(level_occ.shape) + (c,)
    return (rng.randn(*shape).astype(np.float32)
            * np.asarray(level_occ)[..., None])


def test_k1_plain_matches_jax_brick_conv_folded():
    """K1's plain version (what CPU tensors run) == JAX brick_conv(ksize=3)
    at the production brick shape (4, 4, 2) and the decoder's widest conv
    (416 -> 384), on a folded two-scene topology. f32 both sides;
    tolerance rtol 1e-5 plus atol 1e-5 * max|ref| (summation order)."""
    jf, tf = _folded_level((4, 4, 2))
    rng = np.random.RandomState(4)
    lvl = 1
    x = _rand_feats(rng, tf.levels[lvl].occ, 416)
    w = (rng.randn(27, 416, 384) * (2.0 / (27 * 384)) ** 0.5).astype(
        np.float32)
    ref = np.asarray(jb.brick_conv(jnp.asarray(x), jf.levels[lvl],
                                   jnp.asarray(w), ksize=3))
    tl = tf.levels[lvl]
    got = brick_conv3(torch.as_tensor(x), tl.nbr, torch.as_tensor(w),
                      tl.occ).numpy()
    assert counter.launches == 0  # CPU tensors never launch K1
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bshape", [(4, 4, 4), (4, 4, 2), (2, 2, 2)])
def test_k1_plain_brick_shapes(bshape):
    """Any power-of-two brick shape: plain K1 == JAX brick_conv(ksize=3),
    bf16-free f32, small widths (rtol 1e-5, atol 1e-5 * max|ref|)."""
    jf, tf = _folded_level(bshape, seed=5)
    rng = np.random.RandomState(6)
    x = _rand_feats(rng, tf.levels[0].occ, 12)
    w = rng.randn(27, 12, 20).astype(np.float32) * 0.1
    ref = np.asarray(jb.brick_conv(jnp.asarray(x), jf.levels[0],
                                   jnp.asarray(w), ksize=3))
    got = brick_conv3_plain(torch.as_tensor(x), tf.levels[0].nbr,
                            torch.as_tensor(w), tf.levels[0].occ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


def test_stem_down_up_convs_match_jax():
    """k5 stem, k2s2 down conv and transposed up conv == their JAX
    counterparts on a folded (4, 4, 2) topology (f32, rtol 1e-5, atol
    1e-5 * max|ref|)."""
    jf, tf = _folded_level((4, 4, 2), seed=7)
    rng = np.random.RandomState(8)
    tol = lambda ref: dict(rtol=1e-5, atol=1e-5 * np.abs(ref).max())

    x0 = _rand_feats(rng, tf.levels[0].occ, 6)
    w5 = rng.randn(125, 6, 16).astype(np.float32) * 0.1
    ref = np.asarray(jb.brick_conv(jnp.asarray(x0), jf.levels[0],
                                   jnp.asarray(w5), ksize=5))
    got = tb.brick_conv(torch.as_tensor(x0), tf.levels[0],
                        torch.as_tensor(w5), ksize=5).numpy()
    np.testing.assert_allclose(got, ref, **tol(ref))

    x1 = _rand_feats(rng, tf.levels[0].occ, 8)
    wd = rng.randn(8, 8, 12).astype(np.float32) * 0.2
    ref = np.asarray(jb.brick_down_conv(jnp.asarray(x1), jf.group_maps[0],
                                        jf.levels[1], jnp.asarray(wd)))
    got = tb.brick_down_conv(torch.as_tensor(x1), tf.group_maps[0],
                             tf.levels[1], torch.as_tensor(wd),
                             tf.parent_maps[0], tf.octants[0]).numpy()
    np.testing.assert_allclose(got, ref, **tol(ref))

    x2 = _rand_feats(rng, tf.levels[1].occ, 12)
    wu = rng.randn(8, 12, 8).astype(np.float32) * 0.2
    ref = np.asarray(jb.brick_up_conv(jnp.asarray(x2), jf.parent_maps[0],
                                      jf.octants[0], jf.levels[0],
                                      jnp.asarray(wu)))
    got = tb.brick_up_conv(torch.as_tensor(x2), tf.parent_maps[0],
                           tf.octants[0], tf.levels[0],
                           torch.as_tensor(wu), tf.group_maps[0]).numpy()
    np.testing.assert_allclose(got, ref, **tol(ref))


@pytest.mark.parametrize("gather", ["down", "up", "points"])
@pytest.mark.parametrize("dropped", [False, True], ids=["padded", "dropped"])
@pytest.mark.parametrize("bshape", [(2, 2, 2), (4, 4, 2)], ids=str)
def test_gather_input_gradients_match_jax(bshape, dropped, gather):
    """The down conv's, the up conv's and the points' gathers: the input
    gradient through the inverse maps == jax.vjp of the JAX op on the
    same inputs and cotangent, at every level of a folded topology with
    padded points, and with two thirds of each level's bricks kept (f32,
    rtol 1e-5, atol 1e-5 * max|ref|)."""
    coords, mask = _scenes(11, capacity=256, n_occ=160, ext=8)
    assert not mask.all()
    if dropped:
        worst = tb.autotune_brick_capacities(coords, mask, slack=1.0,
                                             multiple=1, floor=1,
                                             brick_shape=bshape)
        caps = tuple(max(c * 2 // 3, 1) for c in worst)
    else:
        caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    jt, tt = _topos(coords, mask, caps, bshape)
    assert (int(tt.dropped[:, 1:].sum()) > 0) == dropped
    jf, tf = jb.fold_topology(jt), tb.fold_topology(tt)
    rng = np.random.RandomState(12)
    if gather == "points":
        cases = [(tf.levels[0].occ, None, jb.gather_points,
                  (jf.point_row, jf.point_within), tb.gather_points,
                  (tf.point_row, tf.point_within))]
    else:
        cases = []
        for l in range(len(tf.levels) - 1):
            w = rng.randn(8, 3, 4).astype(np.float32)
            if gather == "down":
                cases.append((tf.levels[l].occ, w, jb.brick_down_conv,
                              (jf.group_maps[l], jf.levels[l + 1]),
                              tb.brick_down_conv,
                              (tf.group_maps[l], tf.levels[l + 1])))
            else:
                cases.append((tf.levels[l + 1].occ, w, jb.brick_up_conv,
                              (jf.parent_maps[l], jf.octants[l],
                               jf.levels[l]),
                              tb.brick_up_conv,
                              (tf.parent_maps[l], tf.octants[l],
                               tf.levels[l])))
    for l, (occ, w, jfn, jargs, tfn, targs) in enumerate(cases):
        x = rng.randn(*tuple(occ.shape), 3).astype(np.float32)
        wargs = () if w is None else (w,)
        out, vjp = jax.vjp(lambda a: jfn(a, *jargs, *map(jnp.asarray, wargs)),
                           jnp.asarray(x))
        g = rng.randn(*out.shape).astype(np.float32)
        (ref,) = vjp(jnp.asarray(g))
        ref = np.asarray(ref)
        xt = torch.as_tensor(x).requires_grad_()
        inverse = {"down": (tf.parent_maps[l], tf.octants[l]),
                   "up": (tf.group_maps[l],), "points": ()}[gather]
        got = tfn(xt, *targs, *map(torch.as_tensor, wargs), *inverse)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(out),
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(out)).max())
        (gt,) = torch.autograd.grad(got, xt, torch.as_tensor(g))
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(gt.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"{gather} level {l}")


def test_scatter_gather_halo_match_jax():
    """scatter_points / gather_points / halo_exchange (pad 1 and 2) are
    exact copies of the JAX ops' data movement."""
    coords, mask = _scenes(9, batch=1, capacity=256, n_occ=150, ext=8)
    jt, tt = _topos(coords[0], mask[0], None, (4, 4, 2))
    cap = tt.levels[0].occ.shape[0]
    x = np.random.RandomState(10).randn(256, 5).astype(np.float32)
    ref = np.asarray(jb.scatter_points(jnp.asarray(x), jt.point_row,
                                       jt.point_within, cap, (4, 4, 2)))
    got = tb.scatter_points(torch.as_tensor(x), tt.point_row,
                            tt.point_within, cap, (4, 4, 2)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        tb.gather_points(torch.as_tensor(got), tt.point_row,
                         tt.point_within).numpy(),
        np.asarray(jb.gather_points(jnp.asarray(ref), jt.point_row,
                                    jt.point_within)))
    for pad in (1, 2):
        np.testing.assert_array_equal(
            tb.halo_exchange(torch.as_tensor(got), tt.levels[0].nbr,
                             pad).numpy(),
            np.asarray(jb.halo_exchange(jnp.asarray(ref), jt.levels[0].nbr,
                                        pad)))


def test_k1_wrapper_checks_shapes_on_cpu_path():
    """The plain path takes any power-of-two shape; the CUDA path's
    argument checks reject what the kernel does not take."""
    from dropclip_tpu_torch.kernels.brick_conv3 import _check

    feats = torch.zeros(4, 4, 4, 2, 8)
    nbr = torch.zeros(4, 27, dtype=torch.int32)
    occ = torch.ones(4, 4, 4, 2, dtype=torch.bool)
    w = torch.zeros(27, 8, 16)
    assert _check(feats, nbr, w, occ) == (4, 4, 4, 2, 8, 16)
    with pytest.raises(TypeError):
        _check(feats, nbr.long(), w, occ)
    with pytest.raises(ValueError):
        _check(feats, nbr, torch.zeros(9, 8, 16), occ)
    with pytest.raises(ValueError):
        _check(torch.zeros(4, 3, 4, 2, 8), nbr, w, occ[:, :3])
    with pytest.raises(ValueError):
        _check(feats, nbr.t().contiguous().t(), w, occ)


@pytest.mark.slow  # Pallas interpret mode at C=128 is compile-heavy
def test_k1_plain_matches_pallas_interpret():
    """K1's plain version == the TPU kernel itself (pallas_brick_conv3 in
    interpret mode, as tests/test_pallas_conv.py runs it) at 4^3, C=128,
    bf16 inputs (5e-3 of max|ref|, the Pallas test's own tolerance)."""
    from dropclip_tpu.sparse.pallas_conv import pallas_brick_conv3

    rng = np.random.RandomState(11)
    bm, c, cout = 16, 128, 128
    x = rng.randn(bm, 4, 4, 4, c).astype(np.float32)
    nbr = rng.randint(0, bm + 1, size=(bm, 27)).astype(np.int32)
    nbr[:, 13] = np.arange(bm)
    occ = rng.rand(bm, 4, 4, 4) > 0.5
    w = (rng.randn(27, c, cout) * 0.05).astype(np.float32)
    ref = np.asarray(pallas_brick_conv3(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(nbr),
        jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(occ),
        interpret=True), np.float32)
    got = brick_conv3(torch.as_tensor(x).bfloat16(), torch.as_tensor(nbr),
                      torch.as_tensor(w).bfloat16(),
                      torch.as_tensor(occ)).float().numpy()
    assert np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0) < 5e-3
