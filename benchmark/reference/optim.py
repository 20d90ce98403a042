"""The distillation recipe's optimizer in plain PyTorch: optax's
``clip_by_global_norm(max_norm) -> scale_by_amsgrad() ->
add_decayed_weights(wd) -> scale_by_learning_rate(sgdr)`` (optax 0.2.6:
both moments bias-corrected by ``1 - b**t`` with t counted from 1, the
running maximum taken over the corrected second moment), with the rate of
``CosineAnnealingWarmRestarts(T_0=epochs, eta_min=min_lr)`` stepped at
``count / iters_per_epoch`` epochs, count from 0, in float32."""

from __future__ import annotations

import math
from typing import Dict

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


def sgdr(count: int, base_lr: float, min_lr: float, epochs: int,
         iters_per_epoch: int) -> float:
    t = torch.tensor(count / iters_per_epoch, dtype=torch.float32)
    t_cur = torch.remainder(t, float(epochs))
    return float(min_lr + (base_lr - min_lr)
                 * (1 + torch.cos(math.pi * t_cur / epochs)) / 2)


class Amsgrad:
    """One state over a dict of leaves; ``step`` updates them in place
    from their ``.grad`` and returns (clipped gradients, norm)."""

    def __init__(self, leaves: Dict[str, torch.Tensor], recipe: Dict):
        self.r = recipe
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in leaves.items()}
        self.nu_max = {k: torch.zeros_like(v) for k, v in leaves.items()}

    @torch.no_grad()
    def step(self, leaves: Dict[str, torch.Tensor]):
        r = self.r
        grads = {k: v.grad for k, v in leaves.items()}
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        if float(norm) >= r["max_norm"]:
            grads = {k: g * (r["max_norm"] / norm) for k, g in grads.items()}
        lr = sgdr(self.count, r["base_lr"], r["min_lr"], r["epochs"],
                  r["iters_per_epoch"])
        t = self.count + 1
        c1, c2 = 1 - B1 ** t, 1 - B2 ** t
        for k, p in leaves.items():
            g = grads[k]
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g * g + B2 * self.nu[k]
            self.nu_max[k] = torch.maximum(self.nu_max[k], self.nu[k] / c2)
            u = (self.mu[k] / c1) / (torch.sqrt(self.nu_max[k]) + EPS)
            u = u + r["weight_decay"] * p
            p -= lr * u
        self.count += 1
        return grads, float(norm)
