"""MinkUNet on pillars: dropclip_tpu_torch.sparse.unet_pillars against the
JAX MinkUNetPillars with the same weights (JAX model.init, BN statistics
perturbed, carried across by dropclip_tpu_torch.convert) on the same
volumetric scene, eval mode; and against the port's own brick student on
the same weights. Cases follow tests/test_unet_pillars.py."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.sparse.pillar_topology import \
    build_pillar_topology as j_build
from dropclip_tpu.sparse.unet_pillars import MinkUNetPillars as JPillars
from dropclip_tpu_torch.convert import student_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import make_volumetric_coords
from dropclip_tpu_torch.distill.engine import (build_student_for,
                                               build_topology)
from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities
from dropclip_tpu_torch.sparse.pillar_topology import build_pillar_topology
from dropclip_tpu_torch.sparse.unet import UNET_ARCHS
from dropclip_tpu_torch.sparse.unet_pillars import (MinkUNetPillars,
                                                    build_student_pillars)


def _perturb_bn(tree, rng):
    """Random BN scale/bias/mean/var so eval-mode BN is not the identity."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _perturb_bn(v, rng)
        elif k in ("scale", "var"):
            out[k] = (0.5 + rng.rand(*v.shape)).astype(np.float32)
        elif k in ("bias", "mean") and v.ndim == 1:
            out[k] = (0.2 * rng.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


def _scene(seed, m=512, n_occ=400, z_shift=0):
    coords, mask = make_volumetric_coords(np.random.RandomState(seed), 1, m,
                                          n_occ=n_occ, ext=8, zext=16)
    coords = coords + np.array([0, 0, z_shift], np.int32) * mask[..., None]
    feats = (np.random.RandomState(seed + 1).randn(1, m, 6)
             .astype(np.float32) * mask[..., None])
    return coords, mask, feats


def _arch(name):
    block, layers, planes = UNET_ARCHS[name]
    return dict(out_channels=16, block=block, layers=layers, planes=planes,
                init_dim=4)


def _jax_variables(arch, jtopo, feats, seed):
    net = JPillars(**arch)
    v = net.init(jax.random.PRNGKey(seed), jtopo, jnp.asarray(feats),
                 train=False)
    v = jax.tree_util.tree_map(np.asarray, v)
    rng = np.random.RandomState(seed + 7)
    return net, _perturb_bn(v["params"], rng), _perturb_bn(
        v["batch_stats"], rng)


@pytest.mark.parametrize("arch,z_shift,padded", [
    ("tiny", 0, False), ("tiny", -7, False), ("tiny", 0, True),
    ("tiny_bn", 0, False)])
def test_pillar_unet_matches_jax(arch, z_shift, padded):
    """Per-point outputs agree within 1e-4 absolute (float32 both sides,
    sums in another order); padded site capacities change nothing."""
    coords, mask, feats = _scene(0, z_shift=z_shift)
    caps = None
    if padded:
        caps = [lv.occ.shape[0] + 19 for lv in j_build(coords[0],
                                                       mask[0]).levels]
    jtopo = j_build(coords[0], mask[0], site_capacities=caps)
    net, params, bstats = _jax_variables(_arch(arch), jtopo, feats[0], 0)
    ref = np.asarray(jax.jit(lambda v, t, f: net.apply(v, t, f, train=False))(
        {"params": params, "batch_stats": bstats}, jtopo,
        jnp.asarray(feats[0])))

    model = MinkUNetPillars(in_channels=6, **_arch(arch)).eval()
    model.load_state_dict(student_state_dict(params, bstats))
    topo = build_pillar_topology(coords[0], mask[0], site_capacities=caps,
                                 device="cpu")
    with torch.no_grad():
        got = model(topo, torch.as_tensor(feats[0])).numpy()
    assert got.shape == ref.shape == (512, 16)
    assert np.abs(ref[mask[0]]).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.abs(got[~mask[0]]).max() == 0.0


@pytest.mark.parametrize("arch", ["tiny", "tiny_bn"])
def test_pillar_unet_matches_port_bricks(arch):
    """The port's two engines on one state dict and one volumetric scene:
    within 1e-4 absolute (the JAX package holds its engines to 5e-3 of
    max|out|; both sides here are float32)."""
    coords, mask, feats = _scene(4, z_shift=-3)
    cfg = CfgNode(dict(arch_3d=arch, feat_dim=16, init_dim=4, use_color=True,
                       sparse_backend="bricks", brick_shape=[4, 4, 2],
                       brick_capacities=list(autotune_brick_capacities(
                           coords, mask, brick_shape=(4, 4, 2)))))
    gen = torch.Generator().manual_seed(3)
    bricks = build_student_for(cfg, generator=gen)
    sd = bricks.state_dict()
    for k, v in sd.items():  # BN away from the identity
        if k.endswith((".scale", ".var")):
            v.uniform_(0.5, 1.5, generator=gen)
        elif k.endswith((".bias", ".mean")):
            v.normal_(0, 0.2, generator=gen)
    bricks.load_state_dict(sd)
    pillars = build_student_pillars(cfg)
    pillars.load_state_dict(sd)
    with torch.no_grad():
        ref = bricks(build_topology(cfg, torch.as_tensor(coords),
                                    torch.as_tensor(mask)),
                     torch.as_tensor(feats))[0].numpy()
        got = pillars(build_pillar_topology(coords[0], mask[0],
                                            device="cpu"),
                      torch.as_tensor(feats[0])).numpy()
    assert np.abs(ref[mask[0]]).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_same_seed_draws_the_brick_students_weights():
    """Modules register in the brick student's order, so one seed gives
    one set of weights, and one state dict fits both engines."""
    cfg = CfgNode(dict(arch_3d="MinkUNet14D", feat_dim=24, use_color=True,
                       sparse_backend="bricks"))
    b = build_student_for(cfg, generator=torch.Generator().manual_seed(5))
    p = build_student_pillars(cfg, generator=torch.Generator().manual_seed(5))
    sb, sp = b.state_dict(), p.state_dict()
    assert list(sb) == list(sp)
    assert all(torch.equal(sb[k], sp[k]) for k in sb)


def test_pillar_student_refuses_a_cls_head():
    cfg = CfgNode(dict(arch_3d="tiny", use_cls_head=True, n_classes=3))
    with pytest.raises(ValueError, match="use_cls_head"):
        build_student_pillars(cfg)


def test_state_dict_from_the_jax_pillar_tree():
    """convert.student_state_dict maps the JAX pillar student's tree (the
    same tree as the brick student's) onto exactly the port's pillar
    state dict, shape for shape."""
    coords, mask, feats = _scene(1, m=128, n_occ=60)
    jtopo = j_build(coords[0], mask[0])
    arch = dict(_arch("tiny_bn"), out_channels=12)
    shapes = jax.eval_shape(lambda t, f: JPillars(**arch).init(
        jax.random.PRNGKey(0), t, f, train=False), jtopo,
        jnp.asarray(feats[0]))
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)
    sd = student_state_dict(v["params"], v["batch_stats"])
    model = MinkUNetPillars(in_channels=6, **arch)
    assert set(sd) == set(model.state_dict())
    for k, t in model.state_dict().items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
