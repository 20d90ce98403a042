"""MinkowskiEngine checkpoint conversion (``sparse/convert_student.py``)
against the JAX converter on the CPU: the trees key by key for both
kernel-offset orders and both tiny archs (basic and bottleneck blocks),
the exact round trip, and the converted student against the JAX student
on the same input, on both engines."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import engine as jengine
from dropclip_tpu.sparse import convert_student as jconv
from dropclip_tpu_torch.convert import student_trees
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill import engine
from dropclip_tpu_torch.sparse import convert_student as conv
from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

ORDERS = ("x_fastest", "z_fastest")
ARCHS = ("tiny", "tiny_bn")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's torch ops in two threads: the tier-1 run shares the
    box's cores among several test processes, where more threads only
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg(arch, backend="bricks", **over):
    return dict(arch_3d=arch, feat_dim=16, use_color=True,
                sparse_backend=backend, brick_shape=[4, 4, 2], remat=False,
                fold_batch=True, **over)


def _student(arch, seed=3, backend="bricks"):
    """A seeded port student whose BN statistics are moved off their
    initial values, so that the statistics' mapping shows."""
    net = engine.build_student_for(CfgNode(_cfg(arch, backend)),
                                   generator=torch.Generator().manual_seed(
                                       seed))
    with torch.no_grad():
        for i, (name, buf) in enumerate(net.named_buffers()):
            buf.add_(0.001 * i + (0.2 if name.endswith("var") else 0.0))
    return net


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _assert_same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("order", ORDERS)
def test_trees_equal_the_jax_converter(arch, order):
    """From one student's trees: ``to_minkowski_state_dict`` gives the JAX
    converter's state dict key by key (names, shapes, values), and
    ``from_minkowski_state_dict`` of it gives the JAX converter's
    (params, batch_stats) key by key."""
    params, stats = student_trees(_student(arch).state_dict())
    sd = conv.to_minkowski_state_dict(params, stats, arch=arch,
                                      offset_order=order)
    jsd = jconv.to_minkowski_state_dict(params, stats, arch=arch,
                                        offset_order=order)
    assert set(sd) == set(jsd)
    assert all(k.startswith("module.net3d.") for k in sd)
    for k in sd:
        np.testing.assert_array_equal(sd[k], jsd[k], err_msg=k)
    got = conv.from_minkowski_state_dict(sd, arch=arch, offset_order=order)
    want = jconv.from_minkowski_state_dict(jsd, arch=arch,
                                           offset_order=order)
    for g, w in zip(got, want):
        _assert_same(g, w)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("order", ORDERS)
def test_round_trip_is_exact(arch, order):
    """``to_`` then ``from_`` gives the trees back exactly, with or without
    the ``module.net3d.`` prefix and from torch tensors as a ``.pth``
    holds them; ``minkowski_student_state_dict`` gives the student's
    state dict back exactly and loads strictly."""
    net = _student(arch)
    params, stats = student_trees(net.state_dict())
    for wrap in (True, False):
        sd = conv.to_minkowski_state_dict(params, stats, arch=arch,
                                          offset_order=order, wrap=wrap)
        sd = {k: torch.as_tensor(v) for k, v in sd.items()}
        p2, s2 = conv.from_minkowski_state_dict(sd, arch=arch,
                                                offset_order=order)
        _assert_same(p2, params)
        _assert_same(s2, stats)
        back = conv.minkowski_student_state_dict(sd, arch=arch,
                                                 offset_order=order)
        ref = net.state_dict()
        assert set(back) == set(ref)
        assert all(torch.equal(back[k], ref[k]) for k in ref)
        net.load_state_dict(back)


def test_orders_differ():
    """The two orders are genuinely different permutations of the k3 and
    k5 kernels (a 1x1 kernel is left alone)."""
    for k in (3, 5):
        p = conv._perm(k, "x_fastest")
        assert not np.array_equal(p, np.arange(k ** 3))
        assert sorted(p.tolist()) == list(range(k ** 3))
        np.testing.assert_array_equal(p, jconv._perm(k, "x_fastest"))
        np.testing.assert_array_equal(conv._perm(k, "z_fastest"),
                                      np.arange(k ** 3))


@pytest.mark.parametrize("order", ORDERS)
def test_converted_student_equals_the_jax_student(order):
    """A MinkowskiEngine state dict (a seeded student written out in that
    layout) converted by the port, in the brick student and the gather
    student, against the JAX brick student with the JAX converter's trees
    on the same input (eval): 1e-5 of max|ref|."""
    rng = np.random.RandomState(5)
    coords, mask = make_tabletop_coords(rng, 2, 256, n_occ=180, ext=10)
    feats = (rng.randn(2, 256, 6) * mask[..., None]).astype(np.float32)
    caps = list(autotune_brick_capacities(coords, mask,
                                          brick_shape=(4, 4, 2)))
    params, stats = student_trees(_student("tiny", seed=9).state_dict())
    sd = conv.to_minkowski_state_dict(params, stats, arch="tiny",
                                      offset_order=order)
    jcfg = JCfg(_cfg("tiny", brick_capacities=caps))
    jp, js = jconv.from_minkowski_state_dict(sd, arch="tiny",
                                             offset_order=order)
    jmodel = jengine.build_student_for(jcfg)
    jtopo = jengine.build_topology(jcfg, jnp.asarray(coords),
                                   jnp.asarray(mask))
    ref = np.asarray(jax.jit(lambda v, t, f: jmodel.apply(
        v, t, f, train=False))({"params": jp, "batch_stats": js}, jtopo,
                               jnp.asarray(feats)))
    scale = np.abs(ref).max()
    assert scale > 1e-2
    for backend in ("bricks", "gather"):
        cfg = CfgNode(_cfg("tiny", backend, brick_capacities=caps))
        net = engine.build_student_for(cfg)
        net.load_state_dict(conv.minkowski_student_state_dict(
            sd, arch="tiny", offset_order=order))
        topo = engine.build_topology(cfg, torch.as_tensor(coords),
                                     torch.as_tensor(mask))
        with torch.no_grad():
            got = net(topo, torch.as_tensor(feats)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=backend)
