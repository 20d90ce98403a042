"""The data axis for one device per process: rank, world size and the
host-side collectives.

Port of the parts of ``dropclip_tpu/core/mesh.py`` that have a meaning
when each process drives one device (reference tools/train_distil.py:
98-144, NCCL DDP). The JAX package's ``make_mesh``, ``batch_sharding``,
``point_sharding``, ``replicated`` and ``shard_batch_pytree`` place one
program's arrays on a mesh of devices; here every process owns its local
batch and its replica of the weights, so they have no counterpart (and
the ``point`` axis, which shards fusion's segment reductions, is out of
scope; ROADMAP). The host collectives take and give numpy arrays, give
back their input without a process group, and otherwise run on the
process group's device: the card under NCCL, host tensors under gloo
(a group of one rank runs them too, as the identity).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


def distributed() -> bool:
    """Whether a process group is formed: the collectives run under one
    of any size, and are skipped without one."""
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """Ranks in the process group (1 without one)."""
    return dist.get_world_size() if distributed() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if distributed() else 0


def _comm_device() -> torch.device:
    """Where a numpy array goes for a collective: the card under NCCL,
    which takes nothing else; the host otherwise."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_mean_host(values):
    """Mean over the ranks of per-rank scalar metrics (the reference's
    all_reduce then divide, engine/distil.py:475-493): float32 numpy out;
    ``values`` unchanged without a process group."""
    if not distributed():
        return values
    t = torch.tensor(np.asarray(values, np.float32), device=_comm_device())
    dist.all_reduce(t)
    return (t / process_count()).cpu().numpy()


def concat_all_gather_host(array):
    """Every rank's array (equal shapes), concatenated along axis 0 in
    rank order (the reference's concat_all_gather, utils/misc.py:85-97);
    ``array`` unchanged without a process group."""
    if not distributed():
        return array
    n = process_count()
    t = torch.tensor(np.asarray(array), device=_comm_device())
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return torch.cat([p.reshape((-1,) + tuple(t.shape[1:])) for p in parts]
                     ).cpu().numpy()


def broadcast_host(array, src: int = 0):
    """Rank ``src``'s array on every rank (same shape and dtype
    everywhere); ``array`` unchanged without a process group."""
    if not distributed():
        return array
    t = torch.tensor(np.asarray(array), device=_comm_device())
    dist.broadcast(t, src)
    return t.cpu().numpy()
