"""The scanned trainer (``distill.engine.make_scanned_train``) on the CPU,
where its captured step runs eagerly row by row: against the JAX
package's ``lax.scan`` trainer and the port's own eager loop on the same
staged data, schedule and weights; the weight gradient with a static row
bound against the count-read one; the optimizer's update with a device
count against its update with the state's count; and ``train_distil --opts scan_epochs``."""

import copy
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import engine as jengine
from dropclip_tpu.distill.train_state import DistilTrainState as JTrainState
from dropclip_tpu.distill.train_state import make_optimizer as j_optimizer
from dropclip_tpu_torch.convert import amsgrad_opt_state, student_state_dict
from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.data.synthetic import (make_tabletop_coords,
                                               write_fake_processed_dataset)
from dropclip_tpu_torch.distill import engine
from dropclip_tpu_torch.distill.train_state import (create_train_state,
                                                    make_optimizer)
from dropclip_tpu_torch.kernels import brick_conv3 as k1
from dropclip_tpu_torch.sparse import bricks
from dropclip_tpu_torch.tools import train_distil

S, M, FEAT, B = 4, 256, 16, 2
SCHEDULE = np.array([[0, 1], [2, 3], [1, 2], [3, 0], [0, 2], [1, 3]])
WARM = np.array([[1, 0], [3, 2], [2, 1]])


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """This file's torch ops in two threads: the tier-1 run shares the
    box's cores among several test processes, where more threads only
    wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _unflatten(sd, keys):
    tree = {}
    for name in keys:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = sd[name].numpy()
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def staged():
    """Four staged tabletop scenes, the tiny brick student's config and
    weights."""
    rng = np.random.RandomState(2)
    coords, mask = make_tabletop_coords(rng, S, M, n_occ=180, ext=10)
    caps = bricks.autotune_brick_capacities(coords, mask,
                                            brick_shape=(4, 4, 2))
    cfg_dict = dict(arch_3d="tiny", feat_dim=FEAT, use_color=True,
                    sparse_backend="bricks", brick_shape=[4, 4, 2],
                    brick_capacities=list(caps), remat=False,
                    base_lr=3e-4, min_lr=1e-4, epochs=2, weight_decay=1e-5,
                    max_norm=5.0, loss_type="cosine", dropout_rate=0.0)
    arrays = dict(
        coords=coords, mask=mask,
        in_feats=(rng.randn(S, M, 6) * mask[..., None]).astype(np.float32),
        targets=(rng.randn(S, M, FEAT) * mask[..., None]).astype(np.float32),
        labels=np.zeros((S, M), np.int32),
        labels_cls=np.zeros((S, M), np.int32))
    cfg = CfgNode(dict(cfg_dict))
    net = engine.build_student_for(
        cfg, generator=torch.Generator().manual_seed(1))
    return cfg_dict, arrays, net


@pytest.fixture(scope="module")
def runs(staged):
    """The same six steps three ways from one mid-training state: the
    port's scanned trainer in two chunks of three, the port's eager loop,
    and the JAX scanned trainer in the same two chunks. The state is the
    JAX trainer's after three steps of WARM from the port student's
    weights, handed to the port (``convert.student_state_dict``,
    ``convert.amsgrad_opt_state``): from zero moments AMSGrad's first
    updates are g / |g| element by element, which turns float32 noise in
    a near-zero gradient into up to 2 * lr of parameter, so a shared warm
    start keeps those flips out of the comparison."""
    cfg_dict, arrays, net = staged
    cfg, jcfg = CfgNode(dict(cfg_dict)), JCfg(dict(cfg_dict))
    data = engine.DistilBatch(**{k: torch.as_tensor(v)
                                 for k, v in arrays.items()})
    jdata = jengine.DistilBatch(**{k: jnp.asarray(v)
                                   for k, v in arrays.items()})

    sd = net.state_dict()
    stats = [k for k in sd if k.endswith((".mean", ".var"))]
    params = _unflatten(sd, [k for k in sd if k not in stats])
    tx = j_optimizer(jcfg, 3)
    jstate = JTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=_unflatten(sd, stats), opt_state=tx.init(params), tx=tx,
        apply_fn=jengine.build_student_for(jcfg).apply)
    # the warm-up steps run through the same jitted chunk (one compile)
    jchunk = jax.jit(jengine.make_scanned_train(jcfg))
    key = jax.random.PRNGKey(7)
    jstate, key, _ = jchunk(jstate, jdata, jnp.asarray(WARM), key)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    amsgrad = jstate.opt_state[1]
    warm_sd = student_state_dict(to_np(jstate.params),
                                 to_np(jstate.batch_stats))

    def port_state():
        st = create_train_state(copy.deepcopy(net), make_optimizer(cfg, 3))
        st.model.load_state_dict(warm_sd)
        st.opt_state = amsgrad_opt_state(*(to_np(t) for t in (
            amsgrad.mu, amsgrad.nu, amsgrad.nu_max, amsgrad.count)))
        st.step = len(WARM)
        return st

    scanned = port_state()
    chunk = engine.make_scanned_train(cfg)
    losses, metrics = [], []
    for rows in (SCHEDULE[:3], SCHEDULE[3:]):
        _, _, m = chunk(scanned, data, rows)
        losses += m["distil_loss"].tolist()
        metrics.append(m)

    eager = port_state()
    step = engine.make_train_step(cfg)
    eager_losses = [float(step(eager, engine.DistilBatch(
        *(t[torch.as_tensor(r)] for t in data)))[1]["distil_loss"])
        for r in SCHEDULE]

    jlosses = []
    for rows in (SCHEDULE[:3], SCHEDULE[3:]):
        jstate, key, jm = jchunk(jstate, jdata, jnp.asarray(rows), key)
        jlosses += np.asarray(jm["distil_loss"]).tolist()
    jflat = _flat(to_np(jstate.params))
    jflat.update(_flat(to_np(jstate.batch_stats)))
    ill = {n: st["nu_max"] < 1e-12
           for n, st in scanned.opt_state["moments"].items()}
    return dict(losses=losses, eager_losses=eager_losses, jlosses=jlosses,
                metrics=metrics, scanned=scanned, eager=eager, jax=jflat,
                jstep=int(jstate.step), ill=ill, lr=cfg_dict["base_lr"],
                chunk=chunk)


def test_scanned_losses_match_jax_and_eager_loop(runs):
    """Every step's distil loss, stacked per chunk: 1e-5 relative against
    the JAX ``make_scanned_train`` and against the port's eager loop; the
    step count and the optimizer's count advance by the chunk's steps;
    nothing dropped."""
    np.testing.assert_allclose(runs["losses"], runs["jlosses"], rtol=1e-5)
    np.testing.assert_allclose(runs["losses"], runs["eager_losses"],
                               rtol=1e-5)
    st, n = runs["scanned"], len(WARM) + len(SCHEDULE)
    assert st.step == runs["jstep"] == runs["eager"].step == n
    assert st.opt_state["count"] == n
    for m in runs["metrics"]:
        assert set(m) == {"distil_loss", "total_loss", "grad_norm",
                          "dropped_voxels"}
        assert m["distil_loss"].shape == (3,)
        assert int(m["dropped_voxels"].sum()) == 0


def test_scanned_params_match_jax_and_eager_loop(runs):
    """The parameters and BN statistics after the two chunks: equal to
    the port's eager loop (the same arithmetic on the CPU); against the
    JAX scanned trainer 1e-5 where AMSGrad's update is well conditioned,
    and 2 * lr per step plus 1e-5 where sqrt(nu_max) stayed below 1e-6
    (float32 summation-order noise in a near-zero gradient moves such an
    element by up to 2 * lr a step, as ``test_torch_train_step``
    explains)."""
    got = runs["scanned"].model.state_dict()
    eager = runs["eager"].model.state_dict()
    for k, v in got.items():
        assert torch.equal(v, eager[k]), k
    ref, lr = runs["jax"], runs["lr"]
    assert set(ref) == set(got)
    for k, v in got.items():
        d = np.abs(v.numpy() - ref[k])
        ok = d <= 1e-5 + 1e-5 * np.abs(ref[k])
        if k in runs["ill"]:
            bad = runs["ill"][k].numpy()
            assert (ok | bad).all(), (k, float(d[~bad].max()))
            assert (d <= 2 * lr * len(SCHEDULE) + 1e-5).all(), k
        else:
            assert ok.all(), (k, float(d.max()))


def test_scanned_bounds_cover_every_batch(staged, runs):
    """The static weight-gradient row bounds the scanned trainer took
    from the staged scenes (B times one scene's most occupied voxels per
    level) hold every batch of the schedule, and the grid holds every
    voxel (nothing dropped)."""
    cfg_dict, arrays, _ = staged
    cfg = CfgNode(dict(cfg_dict))
    cache = runs["chunk"].cache
    assert cache["grid_bits"] == 5 and len(cache["bounds"]) == 5
    for r in SCHEDULE:
        topo = bricks.fold_topology(engine.build_topology(
            cfg, torch.as_tensor(arrays["coords"][r]),
            torch.as_tensor(arrays["mask"][r]), cache["grid_bits"]))
        for lv, bound in zip(topo.levels, cache["bounds"]):
            assert int(lv.occ.sum()) <= bound
        assert int(topo.dropped.sum()) == 0


@pytest.mark.parametrize("level,c,cout", [(0, 5, 7), (1, 16, 8), (2, 8, 8)])
def test_wgrad_static_bound_equals_count_read(level, c, cout):
    """``brick_conv3_wgrad`` over the schedule's first ``n_rows`` rows, at
    the occupied count, past it and at every row, against the count-read
    weight gradient: 1e-6 of max|ref| (the rows past the count are empty,
    where the output gradient is zero, so they add exact zeros; only the
    product's order of summation moves)."""
    coords, mask = make_tabletop_coords(np.random.RandomState(0), 2, 256,
                                        n_occ=180, ext=10)
    caps = bricks.autotune_brick_capacities(coords, mask,
                                            brick_shape=(4, 4, 2))
    lv = bricks.fold_topology(bricks.build_brick_topology(
        torch.as_tensor(coords), torch.as_tensor(mask),
        brick_capacities=caps, brick_shape=(4, 4, 2))).levels[level]
    g = torch.Generator().manual_seed(level)
    occ = lv.occ[..., None].float()
    x = torch.randn(tuple(lv.occ.shape) + (c,), generator=g) * occ
    dy = torch.randn(tuple(lv.occ.shape) + (cout,), generator=g) * occ
    sched = k1.row_order(lv.occ, lv.nbr)
    ref = k1.brick_conv3_wgrad(x, dy, lv.nbr, lv.occ, sched)
    n_occ, rows = int(sched[1]), sched[0].numel()
    assert float(ref.abs().max()) > 0 and n_occ < rows
    for n in (n_occ, (n_occ + rows) // 2, rows):
        got = k1.brick_conv3_wgrad(x, dy, lv.nbr, lv.occ, sched, n_rows=n)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


def test_update_with_device_count_matches_state_count(staged):
    """``AmsgradChain.update`` with the count as a device tensor (the
    scanned trainer's call) against the same update with the state's
    int count, over three steps of the same gradients: parameters and
    moments equal (one arithmetic), the count tensor advanced in place
    and the state's left alone, the moment tensors never replaced."""
    cfg_dict, _, net = staged
    cfg = CfgNode(dict(cfg_dict, epochs=1))
    a = create_train_state(copy.deepcopy(net), make_optimizer(cfg, 2))
    b = create_train_state(copy.deepcopy(net), make_optimizer(cfg, 2))
    ids = [{n: [id(t) for t in st.values()]
            for n, st in s.opt_state["moments"].items()} for s in (a, b)]
    count = torch.zeros((), dtype=torch.int64)
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        for sa, sb in zip(a.model.parameters(), b.model.parameters()):
            sa.grad = torch.randn(sa.shape, generator=g)
            sb.grad = sa.grad.clone()
        na = a.tx.update(a.model, a.opt_state)
        nb = b.tx.update(b.model, b.opt_state, count)
        assert float(na) == float(nb)
    assert int(count) == a.opt_state["count"] == 3
    assert b.opt_state["count"] == 0
    for (n, pa), pb in zip(a.model.named_parameters(),
                           b.model.parameters()):
        assert torch.equal(pb, pa), n
        for k in ("mu", "nu", "nu_max"):
            assert torch.equal(b.opt_state["moments"][n][k],
                               a.opt_state["moments"][n][k]), (n, k)
    assert ids == [{n: [id(t) for t in st.values()]
                    for n, st in s.opt_state["moments"].items()}
                   for s in (a, b)]


def _cli(data, save, *extra):
    return ["--config", "configs/DistilBlender.yaml", "--device", "cpu",
            "--opts", "root_dir", data, "arch_3d", "tiny", "feat_dim", "16",
            "voxel_capacity", "256", "voxel_size", "0.02", "batch_size", "2",
            "batch_size_val", "2", "workers", "1", "workers_val", "1",
            "save_path", save, *extra]


def test_scan_epochs_cli_matches_step_count_and_resumes(tmp_path):
    """``train_distil --opts scan_epochs 2`` on a fake .npz dataset of 6
    scenes at batch 2: two epochs in one chunk reach the per-step loop's
    step count (its loader's length, 3, a epoch) and write a checkpoint of
    epoch 1; a run resumes it and trains the third epoch as its own
    chunk; every weight is finite."""
    from dropclip_tpu_torch.core.config import load_cfg, merge_cfg_from_list
    from dropclip_tpu_torch.data import build_dataset_for
    from dropclip_tpu_torch.data.loader import DataLoader

    data = str(tmp_path / "data")
    write_fake_processed_dataset(data, n_scenes=6, feat_dim=16, fmt="npz")
    first = train_distil.main(_cli(data, str(tmp_path / "a"), "epochs", "2",
                                   "scan_epochs", "2", "evaluate", "False"))
    cfg = merge_cfg_from_list(load_cfg("configs/DistilBlender.yaml"),
                              _cli(data, "", "evaluate", "False")[5:])
    train_ds, _, collate = build_dataset_for(cfg, "cpu")
    per_step = 2 * len(DataLoader(train_ds, 2, collate))
    ck = restore_checkpoint(first)
    assert ck["step"] == per_step == 6 and ck["epoch"] == 1
    assert ck["opt_state"]["count"] == 6
    assert all(torch.isfinite(v).all() for v in ck["model"].values())
    second = train_distil.main(_cli(data, str(tmp_path / "c"), "epochs",
                                    "3", "scan_epochs", "2", "resume",
                                    first, "evaluate", "False"))
    ck2 = restore_checkpoint(second)
    assert ck2["step"] == 9 and ck2["epoch"] == 2
    with open(os.path.join(second, "train.log")) as f:
        log = f.read()
    assert f"resumed from {first} @ epoch 2" in log
    assert "scan epochs [2..3): 3 steps" in log
