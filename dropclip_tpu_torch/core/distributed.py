"""Multi-process data parallelism: the process group and its collectives.

Port of ``dropclip_tpu/core/distributed.py``. The JAX package joins
processes with ``jax.distributed.initialize`` behind the config keys
``dist_coordinator`` ("host:port" of process 0; reference ``dist_url``),
``num_processes`` (``world_size``) and ``process_id`` (``rank``),
reference config/DistilBlender.yaml:81-86. The port keeps those keys and
also takes torchrun's ``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; either forms a ``torch.distributed`` process group with
one device per process: NCCL on the card, gloo on the CPU, or the
config's ``dist_backend`` where it names one.

A process on the card uses ``cuda:<LOCAL_RANK>`` (modulo the visible
cards: on a one-card machine every rank shares card 0, which NCCL
refuses, so two ranks on one card run ``dist_backend gloo``, whose
all_reduce and broadcast take the card's tensors as they are).

The collectives the trainer needs are ``all_reduce_sum`` (out of place,
no gradient), ``all_reduce_sum_diff`` (differentiable: its backward sums
the incoming gradient over the ranks; SyncBN's moments),
``all_reduce_gradients`` (one flattened sum over every parameter's
gradient) and ``broadcast_module`` (rank 0's weights to every rank).
They run under any process group, of one rank too, where they are the
identity (``mesh.distributed`` says whether there is one).
"""

from __future__ import annotations

import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn
from torch import nn

from .mesh import process_index


def local_rank() -> int:
    """This process's index on its host: torchrun's LOCAL_RANK, else the
    rank."""
    return int(os.environ.get("LOCAL_RANK", process_index()))


def local_device(device: torch.device) -> torch.device:
    """``device`` with this rank's card: ``cuda`` becomes
    ``cuda:<LOCAL_RANK mod visible cards>``; an explicit index or the CPU
    stays as it is."""
    if device.type != "cuda" or device.index is not None:
        return device
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


def maybe_initialize_distributed(cfg, device: Optional[torch.device] = None
                                 ) -> bool:
    """Form the process group when the config's ``dist_coordinator`` keys
    name one (of any size) or torchrun's environment asks for more than
    one process. Returns True if this call formed it; a second call, or a
    single process without those keys, is a no-op (False).

    ``device`` picks the default backend (NCCL for a CUDA device, gloo
    otherwise); ``cfg.dist_backend`` overrides it."""
    if dist.is_initialized():
        return False
    coord = cfg.dist_coordinator
    if coord:
        if cfg.process_id is None or cfg.num_processes is None:
            raise ValueError("dist_coordinator needs num_processes and "
                             "process_id")
        init = f"tcp://{coord}"
        world, rank_ = int(cfg.num_processes), int(cfg.process_id)
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
        if world <= 1:
            return False
        init, rank_ = "env://", int(os.environ["RANK"])
    device = device or torch.device("cpu")
    backend = cfg.dist_backend or (
        "nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(local_device(device))
    dist.init_process_group(backend, init_method=init, world_size=world,
                            rank=rank_)
    return True


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks, out of place, no gradient."""
    out = t.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out)
    return out


def all_reduce_sum_diff(t: torch.Tensor) -> torch.Tensor:
    """``all_reduce_sum`` that autograd differentiates through: a rank's
    input receives every rank's gradient of the summed value."""
    return dist_fn.all_reduce(t)


@torch.no_grad()
def all_reduce_gradients(params: Iterable[nn.Parameter]) -> None:
    """Replace every parameter's gradient by its sum over the ranks, in
    one flattened all-reduce."""
    grads = [p.grad for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]))
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


@torch.no_grad()
def broadcast_module(module: nn.Module) -> None:
    """Rank 0's parameters and buffers to every rank (what DDP does when
    it wraps a module)."""
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, 0)
