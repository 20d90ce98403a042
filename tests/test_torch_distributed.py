"""The port's data-parallel trainer at world size 2 (two gloo processes on
127.0.0.1) on the CPU: three optimizer steps with 2 rows a rank equal the
JAX package's single-process steps on the 4-row global batch and the
port's own steps at world size 1 (SyncBN, the global loss and the summed
gradients); the host collectives and the loader's shards at world size
2; the trainer CLI under the JAX package's ``dist_coordinator`` keys,
with checkpoints from rank 0 alone."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from dropclip_tpu.core.config import CfgNode as JCfg
from dropclip_tpu.distill import engine as jengine
from dropclip_tpu_torch.convert import amsgrad_opt_state, student_state_dict
from dropclip_tpu_torch.core.checkpoint import restore_checkpoint
from dropclip_tpu_torch.core.config import CfgNode
from dropclip_tpu_torch.core.mesh import (all_reduce_mean_host,
                                          concat_all_gather_host)
from dropclip_tpu_torch.data.loader import DataLoader
from dropclip_tpu_torch.data.synthetic import (make_tabletop_coords,
                                               write_fake_processed_dataset)
from dropclip_tpu_torch.distill import engine

from test_torch_train_step import _cfg_dict, _jax_flat_state, _jax_state
from torch_ddp_worker import ROOT, TIMEOUT, free_port, launch

WORKER = os.path.join(ROOT, "tests", "torch_ddp_worker.py")
GLOBAL_B, M, FEAT, STEPS = 4, 256, 16, 3


def _batches(seed=0):
    rng = np.random.RandomState(seed)
    coords, mask = make_tabletop_coords(rng, STEPS * GLOBAL_B, M, n_occ=180,
                                        ext=10)
    out = []
    for i in range(STEPS):
        sl = slice(i * GLOBAL_B, (i + 1) * GLOBAL_B)
        c, m = coords[sl], mask[sl]
        out.append(dict(
            coords=c, mask=m,
            in_feats=(rng.randn(GLOBAL_B, M, 6) * m[..., None]
                      ).astype(np.float32),
            targets=(rng.randn(GLOBAL_B, M, FEAT) * m[..., None]
                     ).astype(np.float32),
            labels=(rng.randint(0, 5, (GLOBAL_B, M)) * m).astype(np.int32),
            labels_cls=(rng.randint(0, 3, (GLOBAL_B, M)) * m
                        ).astype(np.int32)))
    return out, coords, mask


def _port_start(jstate):
    """A JAX train state as the port's (state dict, AMSGrad state, step)."""
    amsgrad = jstate.opt_state[1]
    tree = [jax.tree_util.tree_map(np.asarray, t) for t in
            (jstate.params, jstate.batch_stats, amsgrad.mu, amsgrad.nu,
             amsgrad.nu_max, amsgrad.count)]
    return dict(model=student_state_dict(tree[0], tree[1]),
                opt_state=amsgrad_opt_state(*tree[2:]),
                step=int(jstate.step))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's three steps on the global batches (free-running,
    and the state before each step), then the port's worker at world size
    2 (two ranks) and at world size 1 (a gloo group of one, so that every
    collective runs), all three processes at once.
    Dropout 0, remat on (each rank's backward recomputes the blocks and
    sums the BN moments again, in the same order), the aux hinge on (its
    clip is taken on global means)."""
    tmp = tmp_path_factory.mktemp("ddp")
    batches, coords, mask = _batches()
    cfg_dict = _cfg_dict(coords, mask, use_aux_loss=True, max_objects=6,
                         dropout_rate=0.0, remat=True)
    cfg, jcfg = CfgNode(dict(cfg_dict)), JCfg(dict(cfg_dict))
    net = engine.build_student_for(
        cfg, generator=torch.Generator().manual_seed(1))
    jstate = _jax_state(jcfg, net, iters=STEPS)
    jstep = jax.jit(jengine.make_train_step(jcfg))
    starts, ref = [], []
    for b in batches:
        starts.append(_port_start(jstate))
        jstate, jm = jstep(jstate, jengine.DistilBatch(
            **{k: jnp.asarray(v) for k, v in b.items()}))
        ref.append(dict(metrics={k: float(v) for k, v in jm.items()},
                        state=_jax_flat_state(jstate),
                        ill={n: np.asarray(v) < 1e-12 for n, v in
                             _flat_moments(jstate).items()}))
    src = str(tmp / "in.pt")
    torch.save(dict(cfg=dict(cfg_dict), batches=batches,
                    init=net.state_dict(), starts=starts, iters=STEPS), src)
    cmd = [sys.executable, WORKER, src, str(tmp)]
    one = tmp / "one"
    one.mkdir()
    procs = [subprocess.Popen([sys.executable, WORKER, src, str(one),
                               f"127.0.0.1:{free_port()}"],
                              cwd=ROOT, text=True, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE,
                              env=dict(os.environ, OMP_NUM_THREADS="2"))]
    two = launch([cmd, cmd], 2)
    so, se = procs[0].communicate(timeout=TIMEOUT)
    for rc, _, err in two + [(procs[0].returncode, so, se)]:
        assert rc == 0, err[-3000:]
    load = lambda p: torch.load(p, weights_only=False)  # noqa: E731
    return dict(ref=ref, lr=cfg.base_lr,
                two=[load(tmp / f"rank-{r}.pt") for r in range(2)],
                one=load(one / "rank-0.pt"))


def _flat_moments(jstate):
    from test_torch_train_step import _flat

    return _flat(jax.tree_util.tree_map(np.asarray,
                                        jstate.opt_state[1].nu_max))


def _hold_params(got, ref, ill, lr):
    """1e-5 where AMSGrad's update is well conditioned, 2 * lr + 1e-5
    where sqrt(nu_max) < 1e-6 (test_torch_train_step's rule)."""
    for k, bad in ill.items():
        d = np.abs(got[k].numpy() - ref[k])
        ok = d <= 1e-5 + 1e-5 * np.abs(ref[k])
        assert (ok | bad).all(), (k, float(d[~bad].max()))
        assert (d <= 2 * lr + 1e-5).all(), k


def test_world2_steps_match_jax_global_batch(runs):
    """Each of the 3 steps from the JAX state before it: distil, aux and
    total loss 1e-5 relative, grad norm 1e-4 relative (the global norm of
    the summed gradients), the parameters (``_hold_params``) and the BN
    running statistics 1e-5, on both ranks; free-running, the distil loss
    of each step 1e-5 relative."""
    for r in range(2):
        res = runs["two"][r]
        assert res["world"] == 2
        for got, ref in zip(res["synced"], runs["ref"]):
            m, jm = got["metrics"], ref["metrics"]
            for k in ("distil_loss", "aux_loss", "total_loss"):
                assert m[k] == pytest.approx(jm[k], rel=1e-5), k
            assert m["grad_norm"] == pytest.approx(jm["grad_norm"], rel=1e-4)
            assert m["dropped_voxels"] == 0
            _hold_params(got["state"], ref["state"], ref["ill"], runs["lr"])
            for k in ref["state"]:
                if k.endswith((".mean", ".var")):
                    np.testing.assert_allclose(
                        got["state"][k].numpy(), ref["state"][k], rtol=1e-5,
                        atol=1e-5, err_msg=k)
        for got, ref in zip(res["free"], runs["ref"]):
            assert got["distil_loss"] == pytest.approx(
                ref["metrics"]["distil_loss"], rel=1e-5)


def test_world2_steps_match_world1(runs):
    """The port at world size 2 against the port at world size 1 (in a
    group of one, every collective the identity) on the same global
    batches: each synced step's losses 1e-5 relative, its
    parameters (``_hold_params``, conditioned on the JAX step's moments)
    and BN statistics 1e-5; the two ranks hold bitwise the same weights
    after three free-running steps (one all-reduced gradient, one update
    rule)."""
    one, two = runs["one"], runs["two"]
    assert one["world"] == 1 and one["group"]
    for got, ref, jref in zip(two[0]["synced"], one["synced"], runs["ref"]):
        for k in ("distil_loss", "aux_loss", "total_loss"):
            assert got["metrics"][k] == pytest.approx(ref["metrics"][k],
                                                      rel=1e-5), k
        want = {k: v.numpy() for k, v in ref["state"].items()}
        _hold_params(got["state"], want, jref["ill"], runs["lr"])
    for k, v in two[0]["free_state"].items():
        assert torch.equal(v, two[1]["free_state"][k]), k


def test_world2_host_collectives_and_loader_shards(runs):
    """all_reduce_mean_host averages and concat_all_gather_host
    concatenates in rank order on both ranks; the two loader shards of an
    epoch are disjoint and together are one process's epoch (10 items,
    batch 2 a rank: 8 of them); at world size 1 both helpers return their
    input unchanged."""
    two = runs["two"]
    want = np.concatenate([np.full((2, 3), r) + np.arange(3)
                           for r in range(2)])
    for res in two:
        np.testing.assert_allclose(res["mean"], [0.5, 1.0])
        np.testing.assert_array_equal(res["gathered"], want)
    a, b = (set(res["shard"].tolist()) for res in two)
    single = DataLoader(list(range(10)), 4, lambda s: np.asarray(s),
                        shuffle=True, num_workers=1, seed=3)
    single.set_epoch(1)
    assert not a & b and len(a) == len(b) == 4
    assert a | b == set(np.concatenate(list(single)).tolist())
    vals = [1.0, 2.0]
    assert all_reduce_mean_host(vals) is vals
    arr = np.arange(4)
    assert concat_all_gather_host(arr) is arr


def test_world2_cli_with_coordinator_keys(tmp_path):
    """``tools.train_distil`` in two processes joined by the JAX package's
    config keys (``dist_coordinator``, ``num_processes``, ``process_id``)
    on gloo: one epoch of 2 global steps; only rank 0 writes checkpoints
    (its directory holds the .pt files and train.log, rank 1 adds only
    train.rank-1.log) and both ranks log the same validation loss."""
    data = str(tmp_path / "data")
    write_fake_processed_dataset(data, n_scenes=4, n_objects=2, feat_dim=16,
                                 fmt="npz")
    coord = f"127.0.0.1:{free_port()}"
    cmds = [[sys.executable, "-m", "dropclip_tpu_torch.tools.train_distil",
             "--config", os.path.join(ROOT, "configs", "DistilBlender.yaml"),
             "--device", "cpu", "--opts", "root_dir", data, "arch_3d",
             "tiny", "feat_dim", "16", "voxel_capacity", "256", "voxel_size",
             "0.02", "batch_size", "2", "batch_size_val", "2", "workers",
             "1", "workers_val", "1", "epochs", "1", "print_freq", "1",
             "save_path", str(tmp_path / "exp"), "dist_coordinator", coord,
             "num_processes", "2", "process_id", str(r)] for r in range(2)]
    out = launch(cmds, 1)
    for rc, _, err in out:
        assert rc == 0, err[-3000:]
    err0 = out[0][2]
    save = err0.split("checkpoints in ")[-1].strip()
    assert "rank 0 of 2, backend gloo" in err0
    assert "config:" not in out[1][2]  # rank 1 logs to its file only
    assert sorted(os.listdir(save)) == ["best_sim_loss_model.pt",
                                        "last_model.pt", "train.log",
                                        "train.rank-1.log"]
    ck = restore_checkpoint(save)
    assert (ck["epoch"], ck["step"]) == (0, 2)
    with open(os.path.join(save, "train.rank-1.log")) as f:
        log1 = f.read()
    val = [line.split("DistilLoss=")[-1] for line in (err0 + log1)
           .splitlines() if "Eval: Epoch" in line]
    assert len(val) == 2 and val[0] == val[1]
