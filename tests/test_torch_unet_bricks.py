"""MinkUNet on bricks: dropclip_tpu_torch.sparse.unet_bricks against the
JAX MinkUNetBricks with the same weights (JAX model.init, carried across
by dropclip_tpu_torch.convert) on the same voxel set, eval mode."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill.engine import build_student_for as j_student
from dropclip_tpu.distill.engine import build_topology as j_topology
from dropclip_tpu_torch.convert import student_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill.engine import (build_student_for,
                                               build_topology,
                                               topology_dropped)
from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities


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


def _run_both(cfg_dict, seed, batch=2, bshape=(4, 4, 2)):
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), batch,
                                        256, n_occ=180, ext=10)
    caps = autotune_brick_capacities(coords, mask, brick_shape=bshape)
    cfg_dict = dict(cfg_dict, use_color=True, sparse_backend="bricks",
                    brick_shape=list(bshape), brick_capacities=list(caps),
                    remat=False, fold_batch=True)
    rng = np.random.RandomState(seed + 1)
    feats = (rng.randn(batch, 256, 6).astype(np.float32)
             * mask[..., None])

    jcfg = JCfg(dict(cfg_dict))
    model = j_student(jcfg)
    jtopo = j_topology(jcfg, jnp.asarray(coords), jnp.asarray(mask))
    variables = jax.jit(lambda t, f: model.init(
        jax.random.PRNGKey(seed), t, f, train=False))(jtopo,
                                                      jnp.asarray(feats))
    variables = jax.tree_util.tree_map(np.asarray, variables)
    params = variables["params"]
    bstats = _perturb_bn(variables["batch_stats"], rng)
    params = _perturb_bn(params, rng)
    ref = np.asarray(jax.jit(lambda v, t, f: model.apply(
        v, t, f, train=False))({"params": params, "batch_stats": bstats},
                               jtopo, jnp.asarray(feats)))

    cfg = CfgNode(dict(cfg_dict))
    net = build_student_for(cfg)
    net.load_state_dict(student_state_dict(params, bstats))
    topo = build_topology(cfg, torch.as_tensor(coords),
                          torch.as_tensor(mask))
    assert int(topology_dropped(topo)) == 0
    with torch.no_grad():
        got = net(topo, torch.as_tensor(feats)).numpy()
    return got, ref, mask


@pytest.mark.parametrize("arch", ["tiny", "tiny_bn"])
def test_tiny_archs_match_jax(arch):
    """Per-voxel outputs agree (atol 1e-4, f32 both sides)."""
    got, ref, mask = _run_both(dict(arch_3d=arch, feat_dim=16), seed=0)
    assert got.shape == ref.shape == (2, 256, 16)
    assert np.abs(ref[mask]).max() > 1e-2  # not a trivially-zero output
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert np.abs(got[~mask]).max() == 0.0


def test_minkunet14d_narrowed_matches_jax():
    """MinkUNet14D's topology and block structure (basic blocks, the
    16 k3 convs, stem, 4 down / 4 up convs, skip concats) at narrowed
    planes, isotropic 4^3 bricks; atol 1e-4."""
    got, ref, mask = _run_both(
        dict(arch_3d="MinkUNet14D", feat_dim=24, init_dim=8,
             planes=[8, 12, 16, 16, 16, 16, 12, 12]),
        seed=3, bshape=(4, 4, 4))
    assert np.abs(ref[mask]).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


def test_state_dict_covers_every_parameter():
    """The converter fills exactly the port module's state dict."""
    cfg = CfgNode(dict(arch_3d="tiny_bn", feat_dim=16, use_color=True,
                       use_cls_head=True, n_classes=5))
    net = build_student_for(cfg, generator=torch.Generator().manual_seed(0))
    jmodel = j_student(JCfg(dict(cfg, sparse_backend="bricks", remat=False,
                                 fold_batch=True)))
    coords = jnp.zeros((1, 64, 3), jnp.int32)
    mask = jnp.zeros((1, 64), bool).at[:, :8].set(True)
    jtopo = j_topology(JCfg(dict(cfg)), coords, mask)
    shapes = jax.eval_shape(lambda t: jmodel.init(
        jax.random.PRNGKey(0), t, jnp.zeros((1, 64, 6)), train=False), jtopo)
    v = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                               shapes)
    sd = student_state_dict(v["params"], v["batch_stats"])
    assert set(sd) == set(net.state_dict())
    for k, t in net.state_dict().items():
        assert tuple(sd[k].shape) == tuple(t.shape), k
