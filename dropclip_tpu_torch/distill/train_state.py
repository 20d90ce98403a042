"""Training state and optimizer: the reference recipe, written out.

Port of ``dropclip_tpu/distill/train_state.py``. The reference recipe
(tools/train_distil.py:131-136, config/DistilBlender.yaml:42-75) is
AdamW(amsgrad, lr 3e-4, wd 1e-5) with CosineAnnealingWarmRestarts
(T_0=epochs, eta_min=1e-4) stepped per iteration and grad-clip 5.0. The
JAX package builds it as an optax chain; ``AmsgradChain`` computes that
chain's arithmetic, in the same order, over the model's named
parameters:

1. ``optax.clip_by_global_norm(max_norm)``: scale every gradient by
   ``max_norm / norm`` unless ``norm < max_norm``, the norm taken with
   nothing added (``torch.nn.utils.clip_grad_norm_`` adds 1e-6);
2. ``optax.scale_by_amsgrad()`` as optax 0.2.6 computes it
   (``optax/_src/transform.py::scale_by_amsgrad``, ``update_fn``):
   ``mu = (1-b1) g + b1 mu``, ``nu = (1-b2) g^2 + b2 nu``, both
   bias-corrected by ``1 - b**count`` (count after the increment), and
   ``nu_max = max(nu_max, nu_hat)`` over the *bias-corrected* second
   moment; the update is ``mu_hat / (sqrt(nu_max) + eps)``.
   ``torch.optim.AdamW(amsgrad=True)`` takes the max of the raw moment
   and corrects afterwards, a different trajectory;
3. ``optax.add_decayed_weights(wd)``: ``+ wd * param``, before the rate;
4. ``optax.scale_by_learning_rate(sgdr(count / iters_per_epoch))`` with
   the count before the increment (0 at the first step).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..core.schedule import cosine_annealing_warm_restarts

OptState = Dict[str, Any]


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor, in float32
    (``optax.global_norm``)."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


class AmsgradChain:
    """clip -> amsgrad -> decoupled weight decay -> scheduled rate, as one
    in-place update of a module's parameters. The state is a plain dict
    of tensors keyed by parameter name (``init``), so it saves with
    ``torch.save`` and maps from optax's (``convert.amsgrad_opt_state``)."""

    # optax.scale_by_amsgrad's defaults, the recipe's
    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, learning_rate: Callable[[int], float],
                 max_norm: float = 0.0, weight_decay: float = 0.0):
        self.learning_rate = learning_rate
        self.max_norm = max_norm
        self.weight_decay = weight_decay

    def init(self, model: nn.Module) -> OptState:
        zeros = {n: {k: torch.zeros_like(p, dtype=torch.float32)
                     for k in ("mu", "nu", "nu_max")}
                 for n, p in model.named_parameters()}
        return {"count": 0, "moments": zeros}

    @torch.no_grad()
    def update(self, model: nn.Module, opt_state: OptState) -> torch.Tensor:
        """One step from the parameters' ``.grad``; returns the global norm
        of the gradients before clipping. Raises if a parameter has no
        gradient: optax updates every leaf, so a missing one is a fault."""
        named = list(model.named_parameters())
        missing = [n for n, p in named if p.grad is None]
        if missing:
            raise RuntimeError(f"no gradient reached {missing[:5]} "
                               f"({len(missing)} parameters)")
        grads = [p.grad.float() for _, p in named]
        norm = global_norm(grads)
        if self.max_norm > 0:
            clip = ~(norm < self.max_norm)
            grads = [torch.where(clip, g / norm * self.max_norm, g)
                     for g in grads]
        count = opt_state["count"]
        lr = self.learning_rate(count)
        b1, b2 = self.b1, self.b2
        dev = grads[0].device
        c1 = 1 - torch.tensor(b1, device=dev) ** (count + 1)
        c2 = 1 - torch.tensor(b2, device=dev) ** (count + 1)
        for (name, p), g in zip(named, grads):
            st = opt_state["moments"][name]
            mu = (1 - b1) * g + b1 * st["mu"]
            nu = (1 - b2) * g ** 2 + b2 * st["nu"]
            nu_max = torch.maximum(st["nu_max"], nu / c2)
            u = (mu / c1) / (torch.sqrt(nu_max) + self.eps)
            if self.weight_decay > 0:
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() + u * (-lr))
            st["mu"], st["nu"], st["nu_max"] = mu, nu, nu_max
        opt_state["count"] = count + 1
        return norm


def make_optimizer(cfg: Any, iters_per_epoch: int) -> AmsgradChain:
    """clip(max_norm) -> amsgrad -> decoupled weight decay -> SGDR rate
    per iteration (``count / iters_per_epoch`` epochs)."""
    base_lr = float(cfg.base_lr or 3e-4)
    min_lr = float(cfg.min_lr or 0.0)
    epochs = int(cfg.epochs or 200)
    sgdr = cosine_annealing_warm_restarts(base_lr, eta_min=min_lr,
                                          t_0=epochs)
    iters = max(iters_per_epoch, 1)
    return AmsgradChain(lambda count: sgdr(count / iters),
                        max_norm=float(cfg.max_norm or 0.0),
                        weight_decay=float(cfg.weight_decay or 0.0))


@dataclass
class DistilTrainState:
    """step, the student (parameters and BN running stats), the chain and
    its state. ``apply_gradients`` updates the model in place."""

    step: int
    model: nn.Module
    tx: AmsgradChain
    opt_state: OptState

    def apply_gradients(self) -> torch.Tensor:
        norm = self.tx.update(self.model, self.opt_state)
        self.step += 1
        return norm


def create_train_state(model: nn.Module, tx: AmsgradChain,
                       opt_state: Optional[OptState] = None
                       ) -> DistilTrainState:
    """A fresh state at step 0 (zero moments unless ``opt_state`` is
    given, e.g. converted from optax)."""
    return DistilTrainState(step=0, model=model, tx=tx,
                            opt_state=opt_state or tx.init(model))
