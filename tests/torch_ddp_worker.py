"""One rank of the port's data-parallel trainer on the CPU, for
tests/test_torch_distributed.py (run as a script, imports no jax), and
``launch``, which starts the ranks of a CPU process group for the tests.

    python tests/torch_ddp_worker.py IN.pt OUT_DIR [HOST:PORT]

``IN.pt`` holds the config dict, the global batches, the initial state
dict and the start states of the synced steps. With WORLD_SIZE > 1 in the
environment (torchrun's variables) the process joins a gloo group and
takes rows ``rank::world`` of every global batch, as the sharded loader
does; with ``HOST:PORT`` it forms a gloo group of one there (the
``dist_coordinator`` keys), where every collective runs as the
identity. It writes ``OUT_DIR/rank-<r>.pt``: free-running metrics and the
final state dict, each synced step's metrics and state, and (at world
size > 1) what the host collectives and the loader gave this rank.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))  # the repo root, when run as a script

from dropclip_tpu_torch.core.config import CfgNode  # noqa: E402
from dropclip_tpu_torch.core.distributed import \
    maybe_initialize_distributed  # noqa: E402
from dropclip_tpu_torch.core.mesh import (all_reduce_mean_host,  # noqa: E402
                                          concat_all_gather_host,
                                          distributed, process_count,
                                          process_index)
from dropclip_tpu_torch.data.loader import DataLoader  # noqa: E402
from dropclip_tpu_torch.distill import engine  # noqa: E402
from dropclip_tpu_torch.distill.train_state import (  # noqa: E402
    create_train_state, make_optimizer)


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 240  # seconds, per process: a hang fails its test, not the suite


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(cmds, world, timeout=TIMEOUT):
    """Start one process per command (rank = its index) from the repo root
    with torchrun's variables for ``world`` ranks on 127.0.0.1 at a free
    port, and wait for each within ``timeout`` (then kill the rest);
    returns [(returncode, stdout, stderr)]."""
    port = free_port()
    procs = []
    for r, cmd in enumerate(cmds):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), WORLD_SIZE=str(world), RANK=str(r),
                   LOCAL_RANK=str(r), OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    out = []
    try:
        for p in procs:
            so, se = p.communicate(timeout=timeout)
            out.append((p.returncode, so, se))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def local_rows(batch, rank, world):
    return engine.DistilBatch(**{k: torch.as_tensor(v[rank::world])
                                 for k, v in batch.items()})


def collectives(rank, world):
    """What the host helpers and a sharded loader give this rank."""
    loader = DataLoader(list(range(10)), 2, lambda s: np.asarray(s),
                        shuffle=True, num_workers=1, seed=3,
                        shard_index=rank, num_shards=world)
    loader.set_epoch(1)
    return dict(
        mean=np.asarray(all_reduce_mean_host([float(rank), 2.0 * rank])),
        gathered=concat_all_gather_host(
            np.full((2, 3), rank, np.int64) + np.arange(3)),
        shard=np.concatenate(list(loader)))


def main(src, out_dir, coordinator=None):
    maybe_initialize_distributed(CfgNode(
        dict(dist_coordinator=coordinator, num_processes=1, process_id=0)
        if coordinator else {}))
    rank, world = process_index(), process_count()
    data = torch.load(src, weights_only=False)
    cfg = CfgNode(dict(data["cfg"]))
    net = engine.build_student_for(cfg)
    step = engine.make_train_step(cfg)
    res = {"world": world, "group": distributed()}

    net.load_state_dict(data["init"])
    state = create_train_state(net, make_optimizer(cfg, data["iters"]))
    res["free"] = []
    for b in data["batches"]:
        _, m = step(state, local_rows(b, rank, world))
        res["free"].append({k: float(v) for k, v in m.items()})
    res["free_state"] = {k: v.clone() for k, v in net.state_dict().items()}

    res["synced"] = []
    for b, start in zip(data["batches"], data["starts"]):
        net.load_state_dict(start["model"])
        state = create_train_state(net, make_optimizer(cfg, data["iters"]),
                                   start["opt_state"])
        state.step = start["step"]
        _, m = step(state, local_rows(b, rank, world))
        res["synced"].append(dict(
            metrics={k: float(v) for k, v in m.items()},
            state={k: v.clone() for k, v in net.state_dict().items()}))
    if world > 1:
        res.update(collectives(rank, world))
    torch.save(res, os.path.join(out_dir, f"rank-{rank}.pt"))
    if distributed():
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(*sys.argv[1:4])
