"""Optimizer: AdamW, the cosine warm-restart schedule, weight clipping.

Counterpart of ``instageo_tpu/train/optim.py``. ``optax.adamw(lr,
weight_decay=wd)`` (b1 0.9, b2 0.999, eps 1e-8, decay on every parameter)
is ``torch.optim.AdamW`` with the same settings over one parameter group.
A frozen backbone is left out of the optimizer, so it gets neither an
update nor a decay. The schedule maps the global step to a fractional
epoch in closed form, and the trainer sets the rate before every step.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def cosine_warm_restarts(base_lr: float, steps_per_epoch: int, t_0: int = 10,
                         t_mult: int = 2, eta_min: float = 0.0
                         ) -> Callable[[int], float]:
    """step -> learning rate of ``CosineAnnealingWarmRestarts(T_0, T_mult,
    eta_min)`` at the fractional epoch ``step / steps_per_epoch``."""

    def schedule(step: int) -> float:
        epoch = step / max(1, steps_per_epoch)
        if t_mult == 1:
            t_cur, t_i = epoch % t_0, t_0
        else:
            # Restart cycle n: the largest with Σ_{i<n} t_0·t_mult^i <= epoch.
            n = math.floor(math.log1p((t_mult - 1.0) * epoch / t_0) / math.log(t_mult))
            cycle_start = t_0 * (float(t_mult) ** n - 1.0) / (t_mult - 1.0)
            t_i = t_0 * float(t_mult) ** n
            t_cur = epoch - cycle_start
        return eta_min + (base_lr - eta_min) * (1 + math.cos(math.pi * t_cur / t_i)) / 2

    return schedule


@torch.no_grad()
def clip_params(model: nn.Module, clip_range: Optional[Sequence[float]]) -> None:
    """Clamp every parameter of ``model`` to [min, max], in place."""
    if clip_range is None:
        return
    lo, hi = clip_range
    for p in model.parameters():
        p.clamp_(lo, hi)


def make_optimizer(model: nn.Module, learning_rate: float, weight_decay: float = 1e-2,
                   freeze_backbone: bool = False,
                   frozen_prefix: str = "prithvi_encoder") -> torch.optim.AdamW:
    """AdamW over the trainable parameters (all but ``frozen_prefix.*``
    when the backbone is frozen)."""
    params = [p for name, p in model.named_parameters()
              if not (freeze_backbone and name.split(".")[0] == frozen_prefix)]
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)
