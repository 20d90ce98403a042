"""K2's schedule and numerics on the CPU: the row order that
``kernels/pillar_conv3.py`` hands the kernel, the wrapper given a shared
schedule, and the accuracy argument for its float32 instance (3xTF32),
each held against the JAX package's pillar topology and
``pillar_conv3_xla`` or the plain float32 version."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from dropclip_tpu.sparse.pallas_pillar import pillar_conv3_xla
from dropclip_tpu.sparse.pillar_topology import \
    build_pillar_topology as j_build
from dropclip_tpu_torch.data.synthetic import make_volumetric_coords
from dropclip_tpu_torch.kernels.pillar_conv3 import (pillar_conv3,
                                                     pillar_conv3_plain,
                                                     row_order)
from dropclip_tpu_torch.sparse.pillar_ops import gather_rows, z_shift
from dropclip_tpu_torch.sparse.pillar_topology import build_pillar_topology


def _topologies(seed, z0=None, n_occ=600, ext=10, zext=20):
    """One volumetric scene's pillar pyramid from both packages."""
    coords, mask = make_volumetric_coords(np.random.RandomState(seed), 1,
                                          1024, n_occ=n_occ, ext=ext,
                                          zext=zext)
    return (j_build(coords[0], mask[0], z0=z0),
            build_pillar_topology(coords[0], mask[0], z0=z0, device="cpu"))


def _brute_order(occ):
    """The occupied slots ascending, then the empty ones ascending."""
    flat = np.asarray(occ).reshape(-1)
    slots = np.arange(flat.size)
    return np.concatenate([slots[flat], slots[~flat]]), int(flat.sum())


@pytest.mark.parametrize("z0", [None, 48, 80])
def test_row_order_is_occupied_then_empty(z0):
    """At every level of the pyramid (Z from z0 down to 3 or 5, odd at the
    deepest levels) ``row_order`` of the port's occupancy is the
    brute-force order of the JAX builder's occupancy, with its count."""
    jt, tt = _topologies(seed=1, z0=z0)
    zs = []
    for jl, tl in zip(jt.levels, tt.levels):
        order, n_occ = row_order(tl.occ)
        want, count = _brute_order(jl.occ)
        assert order.dtype == torch.int32 and n_occ.dtype == torch.int32
        assert n_occ.dim() == 0 and int(n_occ) == count > 0
        np.testing.assert_array_equal(order.numpy(), want)
        zs.append(tl.occ.shape[1])
    assert any(z % 2 for z in zs), zs


def test_row_order_of_random_occupancy():
    """Any bool occupancy, an odd Z, none and every slot occupied."""
    rng = np.random.RandomState(2)
    for occ in (rng.rand(37, 7) < 0.3, np.zeros((5, 3), bool),
                np.ones((4, 9), bool)):
        order, n_occ = row_order(torch.as_tensor(occ))
        want, count = _brute_order(occ)
        np.testing.assert_array_equal(order.numpy(), want)
        assert int(n_occ) == count


@pytest.mark.parametrize("level,c,cout,relu", [(0, 16, 24, True),
                                               (1, 24, 8, False),
                                               (3, 8, 16, True)])
def test_scheduled_wrapper_matches_jax(level, c, cout, relu):
    """The wrapper given the level's shared schedule on the CPU (it takes
    the plain version) equals ``pillar_conv3_xla`` on the JAX builder's
    level, within 1e-5 of max|ref|; without scale and bias it equals the
    XLA version with unit scale and zero bias."""
    jt, tt = _topologies(seed=3)
    jl, tl = jt.levels[level], tt.levels[level]
    rng = np.random.RandomState(4)
    p, z = tl.occ.shape
    x = (rng.randn(p, z, c) * np.asarray(jl.occ)[..., None]).astype(
        np.float32)
    w = (rng.randn(9, 3, c, cout) * 0.1).astype(np.float32)
    s = (rng.rand(cout) + 0.5).astype(np.float32)
    b = (rng.randn(cout) * 0.1).astype(np.float32)
    sched = row_order(tl.occ)
    for affine in ((s, b), (None, None)):
        ref = np.asarray(pillar_conv3_xla(
            jnp.asarray(x), jl.nbr9, jnp.asarray(w), jl.occ,
            jnp.asarray(s if affine[0] is not None else np.ones_like(s)),
            jnp.asarray(b if affine[1] is not None else np.zeros_like(b)),
            relu=relu))
        got = pillar_conv3(torch.as_tensor(x), tl.nbr9, torch.as_tensor(w),
                           tl.occ, *[None if a is None else torch.as_tensor(a)
                                     for a in affine],
                           relu=relu, schedule=sched).numpy()
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_wrapper_refuses_a_schedule_of_another_level():
    """A schedule is checked for shape, dtype and device on every device;
    scale and bias come together or not at all."""
    _, tt = _topologies(seed=5)
    lv, other = tt.levels[1], tt.levels[2]
    x = torch.zeros(tuple(lv.occ.shape) + (8,))
    w = torch.zeros((9, 3, 8, 8))
    for bad in (row_order(other.occ),
                (row_order(lv.occ)[0].long(), row_order(lv.occ)[1])):
        with pytest.raises(ValueError):
            pillar_conv3(x, lv.nbr9, w, lv.occ, schedule=bad)
    with pytest.raises(ValueError):
        pillar_conv3(x, lv.nbr9, w, lv.occ, torch.ones(8))


def _tf32(x):
    """Round float32 to TF32 (10 mantissa bits) to nearest, ties away from
    zero: cvt.rna.tf32.f32, as the kernel's integer rounding gives it."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(torch.float32)


def _tf32_pillar_conv(x, lv, w, passes):
    """Plain K2 (no affine step) over the occupied slots with TF32
    operands: 1 pass is hi(x) @ hi(w); 3 passes add hi(x) @ lo(w) +
    lo(x) @ hi(w), where lo = tf32(v - hi(v)). Products exact and sums in
    round-to-nearest float32, as K2 adds each short chain of tensor-core
    products."""
    p, z, c = x.shape
    cols = gather_rows(x, lv.nbr9)  # (P, 9, Z, C)
    taps = torch.stack([z_shift(cols, dz - 1) for dz in range(3)], 2)
    a = taps.permute(0, 3, 1, 2, 4).reshape(p * z, 27 * c)
    a = a[lv.occ.reshape(-1)]
    b = w.reshape(27 * c, -1)
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if passes == 3:
        out = a_hi @ _tf32(b - b_hi) + _tf32(a - a_hi) @ b_hi + out
    return out


def test_3xtf32_meets_the_float32_limit_and_1xtf32_does_not():
    """The accuracy argument for K2's float32 instance at the widest
    pillar conv (level 0, 416 -> 384), with the chip run's inputs (unit
    normal features on the occupied slots, He-scaled weights): against the
    plain float32 K2, 3xTF32 stays inside the float32 limit (rtol 1e-4
    plus atol 1e-4 * max|ref|) with a margin under 0.1, and 1xTF32 falls
    outside it, so the limit sees a kernel that drops the split. The
    margin is the largest |err| / (atol + rtol * |ref|): below 1
    passes."""
    _, tt = _topologies(seed=6, n_occ=500, ext=8, zext=24)
    lv = tt.levels[0]
    rng = np.random.RandomState(7)
    c, cout = 416, 384
    p, z = lv.occ.shape
    x = torch.as_tensor((rng.randn(p, z, c) * np.asarray(lv.occ)[..., None])
                        .astype(np.float32))
    w = torch.as_tensor((rng.randn(9, 3, c, cout) * (2.0 / (27 * cout))
                         ** 0.5).astype(np.float32))
    ref = pillar_conv3_plain(x, lv.nbr9, w, lv.occ, relu=False)
    ref = ref.reshape(-1, cout)[lv.occ.reshape(-1)]
    scale = float(ref.abs().max())

    def margin(got):
        return float(((got - ref).abs() / (1e-4 * scale + 1e-4 * ref.abs()))
                     .max())

    three = margin(_tf32_pillar_conv(x, lv, w, 3))
    one = margin(_tf32_pillar_conv(x, lv, w, 1))
    assert three < 0.1, three
    assert one > 1.0, one
