"""Learning-rate schedules as pure functions of fractional epoch or step.

Port of ``dropclip_tpu/core/schedule.py``. The
reference steps a torch ``CosineAnnealingWarmRestarts(T_0=epochs,
eta_min=min_lr)`` per iteration with ``epoch + i/iters`` (reference
engine/distil.py:206, tools/train_distil.py:133-135); with T_0 equal to
the total epochs this is a single cosine period. The general
warm-restarts form is kept so configs with shorter periods behave the
same.
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def sgdr_tensor(base_lr: float, eta_min: float = 0.0, t_0: float = 1.0,
                t_mult: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return ``lr(t)`` on a float32 tensor ``t`` of fractional epochs
    (SGDR, Loshchilov & Hutter), as torch's
    ``CosineAnnealingWarmRestarts`` stepped with fractional epochs: tensor
    ops only, on ``t``'s device, with no host read, so a captured CUDA
    graph can compute the rate from a step counter on the card. Float32,
    in the JAX function's order."""
    if t_0 <= 0:
        raise ValueError(f"t_0 must be positive, got {t_0}")
    if t_mult < 1:
        raise ValueError(f"t_mult must be >= 1, got {t_mult}")

    def lr_at(t: torch.Tensor) -> torch.Tensor:
        if t_mult == 1:
            t_cur = torch.remainder(t, t_0)
            t_i = torch.full_like(t, t_0)
        else:
            n = torch.where(t > 0, torch.floor(torch.log(
                t / t_0 * (t_mult - 1) + 1) / math.log(t_mult)), t * 0)
            t_start = t_0 * (t_mult ** n - 1) / (t_mult - 1)
            t_i = t_0 * t_mult ** n
            t_cur = t - t_start
        return eta_min + (base_lr - eta_min) * (
            1 + torch.cos(math.pi * t_cur / t_i)) / 2

    return lr_at


def cosine_annealing_warm_restarts(
    base_lr: float,
    eta_min: float = 0.0,
    t_0: float = 1.0,
    t_mult: int = 1,
) -> Callable[[float], float]:
    """Return ``lr(t)`` (a Python float) for fractional epoch ``t``:
    ``sgdr_tensor`` on a float32 CPU tensor, so both packages' optimizers
    scale by the same float32 rate."""
    on_tensor = sgdr_tensor(base_lr, eta_min, t_0, t_mult)

    def lr_at(t: float) -> float:
        return float(on_tensor(torch.tensor(t, dtype=torch.float32)))

    return lr_at


def poly_learning_rate(base_lr: float, curr_iter: int, max_iter: int,
                       power: float = 0.9) -> float:
    """Poly LR policy (reference utils/misc.py:15-18)."""
    return base_lr * (1 - float(curr_iter) / max_iter) ** power


def step_learning_rate(base_lr: float, epoch: int, step_epoch: int,
                       multiplier: float = 0.1) -> float:
    """Step LR policy (reference utils/misc.py:422-425)."""
    return base_lr * (multiplier ** (epoch // step_epoch))
