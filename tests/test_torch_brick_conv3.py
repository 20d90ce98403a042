"""K1's schedule and numerics on the CPU: the row order by tap mask that
``kernels/brick_conv3.py`` hands the kernel, the instance it picks, and
the accuracy argument for its float32 instance (3xTF32), each held
against the JAX package's ``brick_conv`` or the plain float32 version."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.sparse import bricks as jb
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.kernels.brick_conv3 import (_tap_tables,
                                                    brick_conv3_plain,
                                                    instance, row_order,
                                                    tap_masks)
from dropclip_tpu_torch.sparse import bricks as tb


def _levels(bshape, seed, n_occ=160, capacity=256, ext=8):
    """The folded two-scene topology from both packages."""
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), 2,
                                        capacity, n_occ=n_occ, ext=ext)
    caps = tb.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    jt = jb.build_brick_topology(jnp.asarray(coords), jnp.asarray(mask),
                                 brick_capacities=caps, brick_shape=bshape)
    tt = tb.build_brick_topology(torch.as_tensor(coords),
                                 torch.as_tensor(mask),
                                 brick_capacities=caps, brick_shape=bshape)
    return jb.fold_topology(jt), tb.fold_topology(tt)


def _feats(rng, occ, c, masked=True):
    x = rng.randn(*tuple(occ.shape), c).astype(np.float32)
    return x * np.asarray(occ)[..., None] if masked else x


@pytest.mark.parametrize("bshape", [(4, 4, 2), (2, 2, 2), (8, 8, 4)])
def test_tap_masks_are_the_halo_of_live(bshape):
    """Bit t of a voxel's mask is the live flag of its tap-t source, as
    ``halo_exchange`` of the live flags gives it (misses read False)."""
    _, tf = _levels(bshape, seed=1)
    lv = tf.levels[0]
    live = lv.occ & (torch.rand(lv.occ.shape,
                                generator=torch.Generator().manual_seed(0))
                     > 0.2)
    masks = tap_masks(live, lv.nbr)
    halo = tb.halo_exchange(live[..., None].to(torch.uint8), lv.nbr, 1)
    bx, by, bz = bshape
    for t in range(27):
        dx, dy, dz = t // 9, t // 3 % 3, t % 3
        want = halo[:, dx:dx + bx, dy:dy + by, dz:dz + bz, 0].bool()
        assert torch.equal((masks >> t & 1).bool(), want), t


@pytest.mark.parametrize("bshape,level", [((4, 4, 2), 0), ((4, 4, 2), 1),
                                          ((2, 2, 2), 0)])
def test_row_order_groups_occupied_rows_by_mask(bshape, level):
    """A permutation of all rows: the n_occ occupied rows first, sorted by
    (tap mask, row), then the empty rows ascending."""
    _, tf = _levels(bshape, seed=2)
    lv = tf.levels[level]
    order, n_occ, masks = row_order(lv.occ, lv.nbr)
    occ = lv.occ.reshape(-1)
    n = int(n_occ)
    assert order.dtype == torch.int32 and n_occ.dtype == torch.int32
    assert n == int(occ.sum()) and 0 < n < occ.numel()
    assert torch.equal(torch.sort(order.long()).values,
                       torch.arange(occ.numel()))
    head, tail = order[:n].long(), order[n:].long()
    assert bool(occ[head].all()) and not bool(occ[tail].any())
    assert bool((tail[1:] > tail[:-1]).all())
    key = masks[head].long() * occ.numel() + head  # (mask, row)
    assert bool((key[1:] > key[:-1]).all())
    assert torch.equal(masks, tap_masks(lv.occ, lv.nbr).reshape(-1))
    # the grouping the kernel relies on: far fewer distinct masks than rows
    assert len(torch.unique(masks[head])) < n


def _scheduled_conv(feats, nbr, w, occ):
    """K1's schedule in plain torch: every occupied row, in ``row_order``
    order, sums ``source row @ w[t]`` over the taps its mask has (live =
    features not all zero); empty rows are zero."""
    bm, bx, by, bz, c = feats.shape
    v = bx * by * bz
    order, n_occ, masks = row_order(occ, nbr, feats.any(-1))
    source = _tap_tables((bx, by, bz), feats.device)[0]
    rows = order[:int(n_occ)].long()
    b, vox = rows // v, rows % v
    src = nbr.long()[b[:, None], source[vox] // v] * v + source[vox] % v
    bits = (masks[rows, None] >> torch.arange(27)) & 1
    flat = feats.reshape(-1, c)
    acc = torch.zeros(len(rows), w.shape[2])
    for t in range(27):
        sel = bits[:, t].bool()
        acc[sel] += flat[src[sel, t]] @ w[t]
    out = torch.zeros(bm * v, w.shape[2])
    out[rows] = acc
    return out.reshape(bm, bx, by, bz, -1)


@pytest.mark.parametrize("bshape,masked", [((4, 4, 2), True),
                                           ((4, 4, 2), False),
                                           ((2, 2, 2), True)])
def test_scheduled_k1_matches_jax_brick_conv(bshape, masked):
    """The sums over the reordered rows, with the taps the masks skip,
    equal the JAX brick_conv (rtol 1e-5, atol 1e-5 * max|ref|): skipping
    a source whose features are all zero changes no sum, whether the
    features are zero off the occupied voxels (the student's case) or
    not."""
    jf, tf = _levels(bshape, seed=3)
    rng = np.random.RandomState(4)
    lvl = 1
    x = _feats(rng, tf.levels[lvl].occ, 24, masked)
    w = (rng.randn(27, 24, 40) * 0.2).astype(np.float32)
    ref = np.asarray(jb.brick_conv(jnp.asarray(x), jf.levels[lvl],
                                   jnp.asarray(w), ksize=3))
    tl = tf.levels[lvl]
    got = _scheduled_conv(torch.as_tensor(x), tl.nbr, torch.as_tensor(w),
                          tl.occ).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("dtype,c,cout,aligned,want", [
    (torch.float32, 416, 384, True, "tf32x3"),
    (torch.float32, 32, 32, True, "tf32x3"),
    (torch.float32, 3, 200, True, "tf32x3_ragged"),
    (torch.float32, 32, 30, True, "tf32x3_ragged"),
    (torch.float32, 32, 32, False, "tf32x3_ragged"),
    (torch.bfloat16, 416, 384, True, "bf16"),
    (torch.bfloat16, 12, 32, True, "bf16_ragged"),
    (torch.bfloat16, 3, 200, True, "bf16_ragged"),
    (torch.bfloat16, 32, 32, False, "bf16_ragged")])
def test_instance_picks_the_route(dtype, c, cout, aligned, want):
    """float32 takes 3xTF32, bf16 the bf16 tensor-core instance; 16-byte
    copies need C and Cout multiples of 16 bytes and aligned tensors."""
    assert instance(dtype, c, cout, aligned) == want


def test_instance_refuses_other_dtypes():
    with pytest.raises(TypeError):
        instance(torch.float16, 32, 32)


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero: cvt.rna.tf32.f32."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_conv(x, lv, w, passes):
    """Plain K1 over the occupied rows with TF32 operands: 1 pass is
    hi(x) @ hi(w); 3 passes add hi(x) @ lo(w) + lo(x) @ hi(w), where
    lo = tf32(v - hi(v)). Products exact and sums in round-to-nearest
    float32, as K1 adds each short chain of tensor-core products."""
    bm, bx, by, bz, c = x.shape
    halo = tb.halo_exchange(x, lv.nbr, 1)
    patches = (halo.unfold(1, 3, 1).unfold(2, 3, 1).unfold(3, 3, 1)
               .permute(0, 1, 2, 3, 5, 6, 7, 4).reshape(-1, 27 * c))
    a = patches[lv.occ.reshape(-1)]
    b = w.reshape(27 * c, -1)
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        out = a_hi @ _tf32(b - b_hi) + _tf32(a - a_hi) @ b_hi + out
    return out


def test_3xtf32_meets_the_float32_limit_and_1xtf32_does_not():
    """The accuracy argument for K1's float32 instance at the widest
    main-path conv (416 -> 384), with the chip run's inputs (unit normal
    features on the occupied voxels, He-scaled weights): against the
    plain float32 K1, 3xTF32 stays inside the float32 limit (rtol 1e-4
    plus atol 1e-4 * max|ref|) and 1xTF32 falls outside it, so the limit
    sees a kernel that drops the split. The margin is the largest
    |err| / (atol + rtol * |ref|): below 1 passes."""
    _, tf = _levels((4, 4, 2), seed=5, n_occ=400, capacity=512, ext=12)
    lv = tf.levels[0]
    rng = np.random.RandomState(6)
    c, cout = 416, 384
    x = torch.as_tensor(_feats(rng, lv.occ, c))
    w = torch.as_tensor((rng.randn(27, c, cout) * (2.0 / (27 * cout)) ** 0.5
                         ).astype(np.float32))
    ref = brick_conv3_plain(x, lv.nbr, w, lv.occ).reshape(-1, cout)
    ref = ref[lv.occ.reshape(-1)]
    scale = float(ref.abs().max())

    def margin(got):
        return float(((got - ref).abs() / (1e-4 * scale + 1e-4 * ref.abs()))
                     .max())

    three, one = margin(_tf32_conv(x, lv, w, 3)), margin(_tf32_conv(x, lv,
                                                                     w, 1))
    assert three < 0.1, three
    assert one > 1.0, one
