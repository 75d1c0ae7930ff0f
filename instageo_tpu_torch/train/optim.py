"""Optimizer: AdamW, the cosine warm-restart schedule, weight clipping.

Counterpart of ``instageo_tpu/train/optim.py``. ``optax.adamw(lr,
weight_decay=wd)`` (b1 0.9, b2 0.999, eps 1e-8, decay on every parameter)
is ``torch.optim.AdamW`` with the same settings over one parameter group.
A frozen backbone is left out of the optimizer, so it gets neither an
update nor a decay. The schedule maps the global step to a fractional
epoch in closed form, and the trainer sets the rate before every step.

On a CUDA device the optimizer is built ``capturable``: its step counts
and its learning rate are device tensors, so a step recorded into a CUDA
graph reads the rate the trainer wrote before each replay and advances its
own bias corrections; nothing in ``step()`` reads back to the host.
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
    when the backbone is frozen); ``capturable``, with the rate a float32
    device tensor, when the parameters lie on a CUDA device."""
    params = [p for name, p in model.named_parameters()
              if not (freeze_backbone and name.split(".")[0] == frozen_prefix)]
    device = params[0].device if params else torch.device("cpu")
    if device.type == "cuda":
        lr = torch.tensor(learning_rate, dtype=torch.float32, device=device)
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=weight_decay, capturable=True)
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr) -> None:
    """Write ``lr`` into every parameter group: into the device tensor of
    a capturable optimizer (a float, or a device scalar copied without a
    host read), else as a float."""
    for group in optimizer.param_groups:
        if isinstance(group["lr"], torch.Tensor):
            if isinstance(lr, torch.Tensor):
                group["lr"].copy_(lr)
            else:
                group["lr"].fill_(lr)
        else:
            group["lr"] = float(lr)


def load_optimizer_state(optimizer: torch.optim.Optimizer, state: dict) -> None:
    """``optimizer.load_state_dict(state)`` that keeps a capturable
    optimizer capturable: a checkpoint holds the rate and the step counts as
    they were saved (read back to the CPU, or saved from a CPU run), so the
    groups get their device rate tensor back, with the saved value, and the
    step counts go to the parameters' device."""
    kept = [(g["lr"], g.get("capturable", False)) for g in optimizer.param_groups]
    optimizer.load_state_dict(state)
    for group, (lr, capturable) in zip(optimizer.param_groups, kept):
        if not capturable:
            continue
        lr.fill_(float(group["lr"]))
        group["lr"], group["capturable"] = lr, True
        for p in group["params"]:
            st = optimizer.state.get(p)
            if st and "step" in st:
                st["step"] = st["step"].to(dtype=torch.float32, device=p.device)
