"""The port's train path against the JAX package on the CPU: train-mode
MaskedBatchNorm, the k3 conv under autograd (``BrickConv3Fn``, whose
input gradient is K1's conv with mirrored taps), and whole optimizer
steps of the brick student (``distill.engine.make_train_step``) from the
same weights and batches, then the eval step."""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import engine as jengine
from dropclip_tpu.distill.train_state import DistilTrainState as JTrainState
from dropclip_tpu.distill.train_state import make_optimizer as j_optimizer
from dropclip_tpu.sparse.unet import MaskedBatchNorm as JBN
from dropclip_tpu_torch.convert import amsgrad_opt_state, student_state_dict
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import make_tabletop_coords
from dropclip_tpu_torch.distill import engine
from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                    make_optimizer)
from dropclip_tpu_torch.kernels import brick_conv3 as k1
from dropclip_tpu_torch.sparse import bricks
from dropclip_tpu_torch.sparse.unet import MaskedBatchNorm


@pytest.mark.parametrize("shape", [(300, 5), (6, 4, 4, 2, 3)])
def test_bn_train_mode_matches_jax(shape):
    """Batch statistics over the masked voxels, the output and both
    running statistics after two updates: 1e-6."""
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(*shape[:-1]) < 0.6
    c = shape[-1]
    scale = (0.5 + rng.rand(c)).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    jbn = JBN()
    variables = {"params": {"scale": scale, "bias": bias},
                 "batch_stats": {"mean": np.zeros(c, np.float32),
                                 "var": np.ones(c, np.float32)}}
    bn = MaskedBatchNorm(c).train()
    with torch.no_grad():
        bn.scale.copy_(torch.as_tensor(scale))
        bn.bias.copy_(torch.as_tensor(bias))
    for _ in range(2):
        ref, upd = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                             True, mutable=["batch_stats"])
        variables = {"params": variables["params"], **upd}
        got = bn(torch.as_tensor(x), torch.as_tensor(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               rtol=1e-6, atol=1e-6)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   rtol=1e-6, atol=1e-6)
    # eval mode reads the running statistics
    bn.eval()
    ref = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask), False)
    np.testing.assert_allclose(
        bn(torch.as_tensor(x), torch.as_tensor(mask)).detach().numpy(),
        np.asarray(ref), rtol=1e-6, atol=1e-6)


def _level(bshape=(4, 4, 2), level=0, seed=0):
    coords, mask = make_tabletop_coords(np.random.RandomState(seed), 2, 256,
                                        n_occ=180, ext=10)
    caps = bricks.autotune_brick_capacities(coords, mask, brick_shape=bshape)
    topo = bricks.build_brick_topology(
        torch.as_tensor(coords), torch.as_tensor(mask),
        brick_capacities=caps, brick_shape=bshape)
    return bricks.fold_topology(topo).levels[level]


def _conv_grads(lv, x_raw, w, dy, fn):
    """(dX_raw, dW) of sum(conv(x_raw * occ, w) * dy) through ``fn``."""
    x_raw = x_raw.clone().requires_grad_(True)
    w = w.clone().requires_grad_(True)
    out = fn(x_raw * lv.occ[..., None], w)
    (out * dy).sum().backward()
    return x_raw.grad, w.grad


@pytest.mark.parametrize("shared_schedule", [False, True])
@pytest.mark.parametrize("level,c,cout", [(0, 5, 7), (1, 16, 8)])
def test_brick_conv3_fn_grads_match_autograd(level, c, cout,
                                             shared_schedule):
    """BrickConv3Fn's dgrad (the plain conv of dY * occ with mirrored
    taps, as K1 runs it on the card) and wgrad (gathered products over
    the occupied rows, with or without the level's shared schedule)
    against native autograd of the plain brick_conv on masked inputs:
    1e-5."""
    lv = _level(level=level)
    g = torch.Generator().manual_seed(level)
    x = torch.randn(tuple(lv.occ.shape) + (c,), generator=g)
    w = torch.randn((27, c, cout), generator=g) * 0.3
    dy = torch.randn(tuple(lv.occ.shape) + (cout,), generator=g)
    sched = k1.row_order(lv.occ, lv.nbr) if shared_schedule else None
    gx, gw = _conv_grads(lv, x, w, dy, lambda a, b: k1.BrickConv3Fn.apply(
        a, b, lv.nbr, lv.occ, sched))
    rx, rw = _conv_grads(lv, x, w, dy, lambda a, b: bricks.brick_conv(
        a, lv, b, ksize=3))
    assert float(rx.abs().max()) > 0 and float(rw.abs().max()) > 0
    np.testing.assert_allclose(gx.numpy(), rx.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), rw.numpy(), rtol=1e-5, atol=1e-5)


def test_dgrad_limit_sees_unmirrored_taps(monkeypatch):
    """The planted fault of the dgrad identity, taps transposed but not
    mirrored, reads far past the 1e-5 limit."""
    lv = _level()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(tuple(lv.occ.shape) + (6,), generator=g)
    w = torch.randn((27, 6, 4), generator=g)
    dy = torch.randn(tuple(lv.occ.shape) + (4,), generator=g)
    monkeypatch.setattr(k1, "mirror_taps",
                        lambda t: t.transpose(1, 2).contiguous())
    gx, _ = _conv_grads(lv, x, w, dy, lambda a, b: k1.BrickConv3Fn.apply(
        a, b, lv.nbr, lv.occ, None))
    rx, _ = _conv_grads(lv, x, w, dy, lambda a, b: bricks.brick_conv(
        a, lv, b, ksize=3))
    assert float((gx - rx).abs().max()) > 0.1 * float(rx.abs().max())


# ------------------------------------------------------------ train steps

B, M, FEAT = 2, 256, 16


def _cfg_dict(coords, mask, **over):
    caps = bricks.autotune_brick_capacities(coords, mask, brick_shape=(4, 4, 2))
    d = dict(arch_3d="tiny", feat_dim=FEAT, use_color=True,
             sparse_backend="bricks", brick_shape=[4, 4, 2],
             brick_capacities=list(caps), remat=False, fold_batch=True,
             base_lr=3e-4, min_lr=1e-4, epochs=2, weight_decay=1e-5,
             max_norm=5.0, loss_type="cosine", max_objects=8)
    d.update(over)
    return d


def _batches(n, seed=0):
    rng = np.random.RandomState(seed)
    coords, mask = make_tabletop_coords(rng, n * B, M, n_occ=180, ext=10)
    out = []
    for i in range(n):
        c, m = coords[i * B:(i + 1) * B], mask[i * B:(i + 1) * B]
        out.append(dict(
            coords=c, mask=m,
            in_feats=(rng.randn(B, M, 6) * m[..., None]).astype(np.float32),
            targets=(rng.randn(B, M, FEAT) * m[..., None]).astype(np.float32),
            labels=(rng.randint(0, 5, (B, M)) * m).astype(np.int32),
            labels_cls=(rng.randint(0, 3, (B, M)) * m).astype(np.int32)))
    return out, coords, mask


def _j_batch(b):
    return jengine.DistilBatch(**{k: jnp.asarray(v) for k, v in b.items()})


def _t_batch(b):
    return engine.DistilBatch(**{k: torch.as_tensor(v) for k, v in b.items()})


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _unflatten(sd, keys):
    tree = {}
    for name in keys:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = sd[name].numpy()
    return tree


def _jax_state(jcfg, net, iters=3):
    """The JAX train state holding the port model's initial weights (its
    state dict is the flax tree flattened, ``convert.student_state_dict``
    read backwards), so no JAX init has to be compiled."""
    sd = net.state_dict()
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    params = _unflatten(sd, [k for k in sd if k not in stats])
    model = jengine.build_student_for(jcfg)
    tx = j_optimizer(jcfg, iters)
    return JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                       batch_stats=_unflatten(sd, stats),
                       opt_state=tx.init(params), tx=tx,
                       apply_fn=model.apply)


def _jax_flat_state(jstate):
    ref = _flat(jax.tree_util.tree_map(np.asarray, jstate.params))
    ref.update(_flat(jax.tree_util.tree_map(np.asarray, jstate.batch_stats)))
    return ref


@pytest.fixture(scope="module")
def three_steps():
    """Three optimizer steps of the tiny brick student over three batches
    in both packages from the same weights: once free-running, and once
    with the port's model and optimizer state set to the JAX state before
    each step (``convert.student_state_dict``, ``convert.amsgrad_opt_state``),
    so each step is compared from one state; then one eval batch through
    each package's eval step on the JAX-trained weights."""
    batches, coords, mask = _batches(4)
    cfg_dict = _cfg_dict(coords, mask)
    cfg, jcfg = CfgNode(dict(cfg_dict)), JCfg(dict(cfg_dict))
    net = engine.build_student_for(
        cfg, generator=torch.Generator().manual_seed(1))
    free = create_train_state(copy.deepcopy(net), make_optimizer(cfg, 3))
    synced = create_train_state(net, make_optimizer(cfg, 3))
    jstep = jax.jit(jengine.make_train_step(jcfg))
    step = engine.make_train_step(cfg)
    jfree = jsync = _jax_state(jcfg, net)
    free_losses, steps = [], []
    for b in batches[:3]:
        jfree, jm = jstep(jfree, _j_batch(b))
        _, m = step(free, _t_batch(b))
        free_losses.append((float(m["distil_loss"]),
                            float(jm["distil_loss"])))
        amsgrad = jsync.opt_state[1]
        net.load_state_dict(student_state_dict(
            *(jax.tree_util.tree_map(np.asarray, t)
              for t in (jsync.params, jsync.batch_stats))))
        synced.opt_state = amsgrad_opt_state(
            *(jax.tree_util.tree_map(np.asarray, t) for t in
              (amsgrad.mu, amsgrad.nu, amsgrad.nu_max, amsgrad.count)))
        synced.step = int(jsync.step)
        jsync, jm = jstep(jsync, _j_batch(b))
        _, m = step(synced, _t_batch(b))
        ill = {n: st["nu_max"] < 1e-12
               for n, st in synced.opt_state["moments"].items()}
        steps.append(dict(
            metrics=({k: float(v) for k, v in m.items()},
                     {k: float(v) for k, v in jm.items()}),
            got={k: v.clone() for k, v in net.state_dict().items()},
            ref=_jax_flat_state(jsync), ill=ill))
    jout, jm = jax.jit(jengine.make_eval_step(jcfg))(jsync,
                                                     _j_batch(batches[3]))
    net.load_state_dict(student_state_dict(
        *(jax.tree_util.tree_map(np.asarray, t)
          for t in (jsync.params, jsync.batch_stats))))
    out, m = engine.make_eval_step(cfg)(synced, _t_batch(batches[3]))
    return dict(free_losses=free_losses, steps=steps, lr=cfg.base_lr,
                counts=(synced.step, free.step, int(jfree.step)),
                eval=(out, float(m["distil_loss"]), np.asarray(jout),
                      float(jm["distil_loss"])), training=net.training)


def test_train_step_losses_match_jax(three_steps):
    """Free-running over three steps, the distil loss: 1e-5 relative;
    from one state, each step's distil and total loss: 1e-5 relative, and
    its grad norm 1e-4 relative (as on the card: the stem's kernel
    gradient, which dominates the norm, is a sum over every voxel that
    cancels to 1e-5 of its largest element in float32); nothing
    dropped."""
    for got, ref in three_steps["free_losses"]:
        assert got == pytest.approx(ref, rel=1e-5)
    for st in three_steps["steps"]:
        m, jm = st["metrics"]
        for k in ("distil_loss", "total_loss"):
            assert m[k] == pytest.approx(jm[k], rel=1e-5), k
        assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
        assert m["dropped_voxels"] == jm["dropped_voxels"] == 0
    assert three_steps["counts"] == (3, 3, 3)


def test_train_step_bn_stats_match_jax(three_steps):
    """The running BN statistics after each step: 1e-5."""
    for st in three_steps["steps"]:
        got, ref = st["got"], st["ref"]
        stats = [k for k in ref if k.endswith((".mean", ".var"))]
        assert set(got) == set(ref) and len(stats) > 0
        for k in stats:
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-5,
                                       atol=1e-5, err_msg=k)


def test_train_step_params_match_jax(three_steps):
    """The parameters after each step: 1e-5 where AMSGrad's update is
    well conditioned. The update is mu_hat / (sqrt(nu_max) + 1e-8), so
    where sqrt(nu_max) stays below 1e-6 (100 eps: a gradient that was
    below 1e-6 at every step so far, e.g. a tap of the coarsest level
    that no voxel pair uses) float32 summation-order noise in the
    gradient (1e-5 of the tensor's largest) moves the parameter by up to
    2 * lr; those elements are held to 2 * lr + 1e-5."""
    lr = three_steps["lr"]
    for st in three_steps["steps"]:
        got, ref, ill = st["got"], st["ref"], st["ill"]
        for k, bad in ill.items():
            d = np.abs(got[k].numpy() - ref[k])
            bad = bad.numpy()
            ok = d <= 1e-5 + 1e-5 * np.abs(ref[k])
            assert (ok | bad).all(), (k, float(d[~bad].max()))
            assert (d <= 2 * lr + 1e-5).all(), k


def test_eval_step_matches_jax(three_steps):
    """The eval step (running statistics, no grad) on the JAX-trained
    weights: features and distil loss 1e-5."""
    out, loss, jout, jloss = three_steps["eval"]
    assert not three_steps["training"] and not out.requires_grad
    np.testing.assert_allclose(out.numpy(), jout, rtol=1e-5, atol=1e-5)
    assert loss == pytest.approx(jloss, rel=1e-5)


@pytest.mark.parametrize("over", [
    dict(use_aux_loss=True, max_objects=6),
    dict(use_cls_head=True, n_classes=3, loss_type="l1")])
def test_compute_losses_match_jax(over):
    """The step's loss composition (aux hinge with its baseline on the
    detached targets, cls-head CE, L1) and its gradient w.r.t. the model
    output: 1e-6."""
    rng = np.random.RandomState(4)
    b = _batches(1, seed=4)[0][0]
    out = rng.randn(B, M, FEAT).astype(np.float32)
    logits = rng.randn(B, M, 3).astype(np.float32)
    cfg = dict(over, loss_weight_aux=0.7, loss_weight_cls=0.2)

    def jloss(o, lg):
        mo = (o, lg) if over.get("use_cls_head") else o
        return jengine._compute_losses(mo, _j_batch(b), JCfg(dict(cfg)))

    (jl, jm), (jg, jgl) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(out, logits)
    o = torch.as_tensor(out).requires_grad_(True)
    lg = torch.as_tensor(logits).requires_grad_(True)
    mo = (o, lg) if over.get("use_cls_head") else o
    tl, tm = engine._compute_losses(mo, _t_batch(b), CfgNode(dict(cfg)))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-6)
    assert set(tm) == set(jm)
    for k in tm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6), k
    np.testing.assert_allclose(o.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    if over.get("use_cls_head"):
        np.testing.assert_allclose(lg.grad.numpy(), np.asarray(jgl),
                                   rtol=1e-6, atol=1e-6)
def test_remat_and_dropout_in_the_port():
    """remat recomputes blocks and convs in the backward with the same
    gradients and running statistics as without (2e-6); dropout draws its
    mask from the step's generator (same seed, same step; rate 0 equals
    no dropout)."""
    batches, coords, mask = _batches(1, seed=2)
    outs = {}
    for remat, rate in ((False, 0.0), (True, 0.0), (False, 0.3),
                        (False, 0.3)):
        cfg = CfgNode(_cfg_dict(coords, mask, remat=remat,
                                dropout_rate=rate))
        net = engine.build_student_for(
            cfg, generator=torch.Generator().manual_seed(0))
        state = create_train_state(net, make_optimizer(cfg, 3))
        _, m = engine.make_train_step(cfg)(
            state, _t_batch(batches[0]), torch.Generator().manual_seed(5))
        outs.setdefault((remat, rate), []).append(
            (float(m["distil_loss"]), net.state_dict()))
    (l0, sd0), = outs[(False, 0.0)]
    (l1, sd1), = outs[(True, 0.0)]
    assert l0 == pytest.approx(l1, rel=2e-6)
    for k in sd0:
        np.testing.assert_allclose(sd1[k].numpy(), sd0[k].numpy(),
                                   rtol=2e-6, atol=2e-6, err_msg=k)
    (la, sda), (lb, sdb) = outs[(False, 0.3)]
    assert la == lb and la != l0
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k


def test_every_parameter_gets_a_gradient():
    """Every parameter of the student, the k3 convs' kernels and all
    upstream of them included, gets a nonzero gradient through
    BrickConv3Fn; the optimizer refuses a parameter without one."""
    batches, coords, mask = _batches(1, seed=3)
    cfg = CfgNode(_cfg_dict(coords, mask))
    net = engine.build_student_for(cfg,
                                   generator=torch.Generator().manual_seed(0))
    state = create_train_state(net, make_optimizer(cfg, 3))
    engine.make_train_step(cfg)(state, _t_batch(batches[0]))
    for name, p in net.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
    net.conv0p1s1.kernel.grad = None
    with pytest.raises(RuntimeError, match="conv0p1s1.kernel"):
        state.apply_gradients()
