"""Backend dispatch for the student (``dropclip_tpu/distill/engine.py``).

Only the brick engine is ported so far; the gather backend and the
train/eval steps come with later slices.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..sparse.bricks import BrickTopology, build_brick_topology


def _require_bricks(cfg) -> None:
    backend = cfg.sparse_backend or "bricks"
    if backend != "bricks":
        raise NotImplementedError(
            f"sparse_backend {backend!r} is not ported yet: the gather "
            "engine comes with slice 3 (ROADMAP queue 1 item 22)")


def build_topology(cfg, coords: torch.Tensor, mask: torch.Tensor
                   ) -> BrickTopology:
    """Brick topology for (B, M, 3) coords on their device; brick
    capacities from ``cfg.brick_capacities`` (None -> the M//8 rule)."""
    _require_bricks(cfg)
    caps = cfg.brick_capacities
    return build_brick_topology(
        coords, mask, num_levels=int(cfg.num_levels or 5),
        brick_capacities=tuple(caps) if caps else None,
        brick_shape=brick_shape_of(cfg))


def brick_shape_of(cfg) -> tuple:
    """cfg.brick_shape ([4, 4, 2] or "4,4,2") -> static tuple; default
    isotropic (4, 4, 4)."""
    bs = cfg.brick_shape
    if bs is None:
        return (4, 4, 4)
    if isinstance(bs, str):
        bs = bs.split(",")
    return tuple(int(v) for v in bs)


def build_student_for(cfg, generator: Optional[torch.Generator] = None):
    """Student factory honouring cfg.sparse_backend (bricks only)."""
    _require_bricks(cfg)
    from ..sparse.unet_bricks import build_student_bricks

    return build_student_bricks(cfg, generator=generator)


def topology_dropped(topo) -> torch.Tensor:
    """Scalar count of units the topology truncated (capacity overflow /
    out-of-extent); 0 for a topology without counters."""
    d = getattr(topo, "dropped", None)
    if d is None:
        return torch.zeros((), dtype=torch.int64)
    return d.sum()
