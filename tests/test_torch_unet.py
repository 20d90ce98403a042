"""The gather-engine MinkUNet (dropclip_tpu_torch.sparse.unet) against the
JAX package's, with the weights of JAX's own init carried across by
dropclip_tpu_torch.convert (one converter for every engine), on key-sorted
voxel sets as the data path gives them: eval and train outputs and the
batch statistics after one train forward at the tiny and tiny_bn archs;
one optimizer step of the gather student; then the port's gather engine
against its brick engine on the same weights (the JAX package's
cross-engine oracle, tests/test_unet_bricks.py), through the model and
through GroundingPipeline."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import engine as jengine
from dropclip_tpu_torch.convert import _flatten, student_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill import engine
from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                    make_optimizer)
from dropclip_tpu_torch.geom.voxelize import ravel_grid_coords
from dropclip_tpu_torch.pipeline import GroundingPipeline
from dropclip_tpu_torch.sparse.bricks import autotune_brick_capacities

from test_torch_train_step import _jax_flat_state, _jax_state
from test_torch_unet_bricks import _perturb_bn

B, M, FEAT = 2, 256, 16


def _sorted_batch(seed):
    """Tabletop scenes in ascending key order (``sparse_quantize_np``'s
    order), xyz+rgb features, unit targets."""
    rng = np.random.RandomState(seed)
    coords, mask = make_tabletop_coords(rng, B, M, n_occ=180, ext=10)
    keys = ravel_grid_coords(torch.as_tensor(coords),
                             valid=torch.as_tensor(mask)).numpy()
    order = np.argsort(keys, axis=1, kind="stable")
    coords = np.take_along_axis(coords, order[..., None], 1)
    mask = np.take_along_axis(mask, order, 1)
    feats = (rng.randn(B, M, 6) * mask[..., None]).astype(np.float32)
    tgt = (rng.randn(B, M, FEAT) * mask[..., None]).astype(np.float32)
    return coords, mask, feats, tgt


def _cfg(arch, **over):
    return dict(dict(arch_3d=arch, feat_dim=FEAT, use_color=True,
                     sparse_backend="gather", base_lr=3e-4, min_lr=1e-4,
                     epochs=2, weight_decay=1e-5, max_norm=5.0), **over)


def _jax_model(cfg_dict, coords, mask, feats, seed=0):
    jcfg = JCfg(dict(cfg_dict))
    model = jengine.build_student_for(jcfg)
    topo = jengine.build_topology(jcfg, jnp.asarray(coords),
                                  jnp.asarray(mask))
    variables = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda t, f: model.init(jax.random.PRNGKey(seed), t, f,
                                train=False))(topo, jnp.asarray(feats)))
    return model, topo, variables


@pytest.mark.parametrize("arch", ["tiny", "tiny_bn"])
def test_gather_unet_matches_jax(arch):
    """Eval mode with random BN statistics: 1e-5 of max|ref|; train mode
    (batch statistics): 1e-5 of max|ref|; the running statistics after
    one train forward: 1e-5; padded rows are zero."""
    coords, mask, feats, _ = _sorted_batch(0)
    d = _cfg(arch)
    model, jtopo, v = _jax_model(d, coords, mask, feats)
    rng = np.random.RandomState(1)
    v = {"params": _perturb_bn(v["params"], rng),
         "batch_stats": _perturb_bn(v["batch_stats"], rng)}
    ref = np.asarray(model.apply(v, jtopo, jnp.asarray(feats), train=False))
    ref_t, upd = model.apply(v, jtopo, jnp.asarray(feats), train=True,
                             mutable=["batch_stats"])
    net = engine.build_student_for(CfgNode(d))
    net.load_state_dict(student_state_dict(v["params"], v["batch_stats"]))
    topo = engine.build_topology(CfgNode(d), torch.as_tensor(coords),
                                 torch.as_tensor(mask))
    assert int(engine.topology_dropped(topo)) == 0
    with torch.no_grad():
        got = net(topo, torch.as_tensor(feats)).numpy()
        net.train()
        got_t = net(topo, torch.as_tensor(feats)).numpy()
    assert got.shape == ref.shape == (B, M, FEAT)
    assert np.abs(ref[mask]).max() > 1e-2 and not got[~mask].any()
    for g, r in ((got, ref), (got_t, np.asarray(ref_t))):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-5 * np.abs(r).max())
    sd = net.state_dict()
    for k, r in _flatten(jax.tree_util.tree_map(
            np.asarray, upd["batch_stats"])).items():
        np.testing.assert_allclose(sd[k].numpy(), r, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_gather_train_step_matches_jax():
    """One optimizer step of the gather student from the same weights,
    with the cls head: losses 1e-5 relative, grad norm 1e-4 relative, the
    parameters and BN statistics 1e-5 where AMSGrad's first update is
    well conditioned (test_torch_train_step's rule for the rest)."""
    coords, mask, feats, tgt = _sorted_batch(2)
    labels = (np.random.RandomState(3).randint(0, 3, (B, M)) * mask
              ).astype(np.int32)
    d = _cfg("tiny", use_cls_head=True, n_classes=3)
    cfg, jcfg = CfgNode(d), JCfg(dict(d))
    net = engine.build_student_for(cfg,
                                   generator=torch.Generator().manual_seed(4))
    jstate = _jax_state(jcfg, net, iters=2)
    arrays = dict(coords=coords, mask=mask, in_feats=feats, targets=tgt,
                  labels=labels, labels_cls=labels)
    # the JAX state's arrays share memory with ``net``'s parameters: wait
    # for the JAX step before the port's step updates them in place
    jstate, jm = jax.block_until_ready(jax.jit(jengine.make_train_step(jcfg))(
        jstate, jengine.DistilBatch(**{k: jnp.asarray(a)
                                       for k, a in arrays.items()})))
    state = create_train_state(net, make_optimizer(cfg, 2))
    _, m = engine.make_train_step(cfg)(state, engine.DistilBatch(
        **{k: torch.as_tensor(a) for k, a in arrays.items()}))
    for k in ("distil_loss", "aux_loss", "total_loss"):
        assert float(m[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert int(m["dropped_voxels"]) == 0
    ref, lr = _jax_flat_state(jstate), cfg.base_lr
    got = net.state_dict()
    assert set(got) == set(ref)
    for k, r in ref.items():
        d_ = np.abs(got[k].numpy() - r)
        ok = d_ <= 1e-5 + 1e-5 * np.abs(r)
        if k.endswith((".mean", ".var")):
            assert ok.all(), k
        else:
            ill = state.opt_state["moments"][k]["nu_max"].numpy() < 1e-12
            assert (ok | ill).all() and (d_ <= 2 * lr + 1e-5).all(), k


@pytest.mark.parametrize("train", [False, True])
def test_gather_engine_matches_brick_engine(train):
    """One seed gives both engines the same weights (they register the
    same modules in the same order) and one converted state dict loads
    into both; on shuffled (not key-sorted) input rows the gather student
    answers in input order, as the brick student does: 1e-5 of max|ref|
    in eval and train mode."""
    coords, mask, feats, _ = _sorted_batch(5)
    perm = np.random.RandomState(6).permutation(M)
    coords, mask, feats = coords[:, perm], mask[:, perm], feats[:, perm]
    caps = autotune_brick_capacities(coords, mask, brick_shape=(4, 4, 2))
    gcfg = CfgNode(_cfg("tiny"))
    bcfg = CfgNode(_cfg("tiny", sparse_backend="bricks", brick_shape=[4, 4, 2],
                        brick_capacities=list(caps), remat=False))
    gnet = engine.build_student_for(gcfg,
                                    generator=torch.Generator().manual_seed(7))
    bnet = engine.build_student_for(bcfg,
                                    generator=torch.Generator().manual_seed(7))
    sd = gnet.state_dict()
    assert set(sd) == set(bnet.state_dict())
    assert all(torch.equal(v, bnet.state_dict()[k]) for k, v in sd.items())
    bnet.load_state_dict(student_state_dict(
        {k: v.numpy() for k, v in sd.items()
         if not k.endswith((".mean", ".var"))},
        {k: v.numpy() for k, v in sd.items() if k.endswith((".mean",
                                                            ".var"))}))
    outs = []
    for cfg, net in ((gcfg, gnet), (bcfg, bnet)):
        net.train(train)
        topo = engine.build_topology(cfg, torch.as_tensor(coords),
                                     torch.as_tensor(mask))
        assert int(engine.topology_dropped(topo)) == 0
        with torch.no_grad():
            outs.append(net(topo, torch.as_tensor(feats)).numpy())
    scale = np.abs(outs[1]).max()
    assert scale > 1e-2
    np.testing.assert_allclose(outs[0], outs[1], rtol=0, atol=1e-5 * scale)


def test_gather_pipeline_matches_brick_pipeline():
    """GroundingPipeline(engine="gather") on the CPU against the brick
    engine with the same seed on the same cloud: per-voxel features
    1e-5 of max|ref|, nothing dropped on either."""
    rng = np.random.RandomState(8)
    xy = rng.uniform(-0.4, 0.4, (1500, 2))
    xyz = np.concatenate([xy, 0.05 * np.sin(4 * xy[:, :1])], 1
                         ).astype(np.float32)  # a gently curved table
    rgb = rng.rand(1500, 3).astype(np.float32)
    cfg = CfgNode(dict(_cfg("tiny"), voxel_capacity=512, voxel_size=0.05,
                       brick_shape=[4, 4, 2], brick_capacities=[512] * 5))
    feats = {}
    for eng in ("gather", "bricks"):
        pipe = GroundingPipeline(cfg, engine=eng, device="cpu", seed=3)
        feats[eng], vmask, _ = pipe.featurize(xyz, rgb)
        assert pipe.last_dropped == 0 and pipe.cfg.sparse_backend == eng
    assert cfg.sparse_backend == "gather"
    ref = feats["bricks"].numpy()
    assert np.abs(ref[vmask]).max() > 1e-2
    np.testing.assert_allclose(feats["gather"].numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
